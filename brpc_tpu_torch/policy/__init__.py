"""policy — wire protocols.  Importing this package registers them in the
reference's order (global.cpp): tpu_std, http, redis, memcache, mongo,
thrift, grpc, nshead, hulu and sofa, nova, public_pbrpc, esp, ubrpc and
rtmp (after amf, its codec).
The messenger tries them in this order on a connection, so a server port
serves them all side by side.  The load balancers, limiters and naming
services are bound here too, as in :mod:`brpc_tpu.policy`."""
from . import tpu_std
from . import limiters
from . import load_balancers
from . import naming
from . import http
from . import redis
from . import memcache
from . import mongo
from . import thrift
from . import auth
from . import grpc
from . import nshead
from . import legacy_pbrpc
from . import nova
from . import public_pbrpc
from . import esp
from . import ubrpc
from . import amf
from . import rtmp
