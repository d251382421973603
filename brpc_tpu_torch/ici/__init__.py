"""ici — the mesh of logical ranks, the ici:// transport, the device plane
with its copy kernel (the rdma/ analogue), and the collectives layer with
its ring kernels."""
from .mesh import IciMesh, ShardedTensor
from .transport import IciSocket, ici_listen, ici_unlisten, ici_connect
from . import device_plane
from .device_plane import DevicePlane, DeviceTransfer, DevicePlaneError
from .p2p_copy import p2p_copy, p2p_copy_plain
from .collective import Collectives, default_collectives
from .ring import ring_all_reduce, RingStream
from . import pallas_ring
from . import ring_attention
from .pod import Pod, PodMember
