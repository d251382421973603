"""ici — the mesh of logical ranks, the ici:// transport and the device
plane with its copy kernel (the rdma/ analogue)."""
from .mesh import IciMesh
from .transport import IciSocket, ici_listen, ici_unlisten, ici_connect
from . import device_plane
from .device_plane import DevicePlane, DeviceTransfer, DevicePlaneError
from .p2p_copy import p2p_copy, p2p_copy_plain
