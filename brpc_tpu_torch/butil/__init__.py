"""butil — base utilities (reference: src/butil/)."""
from .iobuf import (IOBuf, IOPortal, IOBufCutter, IOBufAppender, Block,
                    BlockRef, HOST, USER, DEVICE, DEFAULT_BLOCK_SIZE)
from .resource_pool import (ResourcePool, INVALID_ID, make_id, id_slot,
                            id_version)
from .doubly_buffered import DoublyBufferedData
from .containers import FlatMap, CaseIgnoredFlatMap, BoundedQueue, MRUCache
from .endpoint import (EndPoint, parse_endpoint, endpoint2str,
                       SCHEME_TCP, SCHEME_ICI, SCHEME_MEM)
from .flags import (define_flag, get_flag, set_flag, list_flags, flag_object,
                    positive_integer, non_negative_integer)
from .misc import (fast_rand, fast_rand_less_than, fast_rand_in, crc32c,
                   gettimeofday_us, monotonic_time_ns, cpuwide_time_us, Timer)
from . import logging
from . import block_pool
