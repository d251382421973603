"""JSON <-> protobuf transcoding (reference: src/json2pb/ json_to_pb.h,
pb_to_json.h): the HTTP and h2 REST planes' bodies.  Built on
google.protobuf.json_format with the JAX package's settings (field names
as in the .proto, no default-valued fields, enums by name), so both
packages print the same JSON."""
from __future__ import annotations

from typing import Any, Optional, Tuple, Type

from google.protobuf import json_format


class Pb2JsonOptions:
    """The reference's pb-to-JSON options that json_format can honour.
    The JAX package's ``bytes_to_base64`` and ``jsonify_empty_array``
    reach nothing there (bytes are always base64, an empty repeated field
    prints only with ``always_print_primitive_fields``), so the port does
    not take them."""

    def __init__(self, always_print_primitive_fields: bool = False,
                 enum_option_as_number: bool = False):
        self.always_print_primitive_fields = always_print_primitive_fields
        self.enum_option_as_number = enum_option_as_number


def pb_to_json(message: Any, options: Optional[Pb2JsonOptions] = None
               ) -> Tuple[bool, str]:
    """Returns (ok, json or the error)."""
    options = options or Pb2JsonOptions()
    try:
        return True, json_format.MessageToJson(
            message, preserving_proto_field_name=True,
            always_print_fields_with_no_presence=(
                options.always_print_primitive_fields),
            use_integers_for_enums=options.enum_option_as_number,
            indent=None)
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


def pb_to_dict(message: Any) -> dict:
    return json_format.MessageToDict(message,
                                     preserving_proto_field_name=True)


def dict_to_pb(d: dict, message_cls: Type) -> Any:
    """A ``message_cls`` from a parsed JSON object (rpc_press's request
    body); unknown fields are ignored."""
    msg = message_cls()
    json_format.ParseDict(d, msg, ignore_unknown_fields=True)
    return msg
