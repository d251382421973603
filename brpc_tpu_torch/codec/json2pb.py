"""JSON <-> protobuf transcoding (reference: src/json2pb/ json_to_pb.h,
pb_to_json.h): the HTTP and h2 REST planes' bodies.  Built on
google.protobuf.json_format with the JAX package's settings (field names
as in the .proto, no default-valued fields, enums by name), so both
packages print the same JSON."""
from __future__ import annotations

from typing import Any, Tuple, Type

from google.protobuf import json_format


def pb_to_json(message: Any) -> Tuple[bool, str]:
    """Returns (ok, json or the error)."""
    try:
        return True, json_format.MessageToJson(
            message, preserving_proto_field_name=True,
            always_print_fields_with_no_presence=False,
            use_integers_for_enums=False, indent=None)
    except Exception as e:
        return False, str(e)


def json_to_pb(json_str: str, message_cls: Type) -> Tuple[bool, Any, str]:
    """Returns (ok, message, error); unknown fields are ignored."""
    msg = message_cls()
    try:
        json_format.Parse(json_str, msg, ignore_unknown_fields=True)
        return True, msg, ""
    except Exception as e:
        return False, None, str(e)
