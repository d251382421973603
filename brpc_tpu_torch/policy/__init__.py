"""policy — wire protocols.  Importing this package registers tpu_std
(the reference does this in global.cpp)."""
from . import tpu_std
