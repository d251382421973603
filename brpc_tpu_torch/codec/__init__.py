"""Codec side-libraries (reference: src/json2pb/): JSON <-> protobuf for
the HTTP and h2 REST planes."""
from . import json2pb
from . import mcpack
