"""policy — wire protocols.  Importing this package registers tpu_std,
http and grpc, in the reference's order (global.cpp)."""
from . import tpu_std
from . import http
from . import auth
from . import grpc
