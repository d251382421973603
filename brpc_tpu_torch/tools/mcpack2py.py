"""mcpack2py — the code-generator half of mcpack2pb (reference:
src/mcpack2pb/generator.cpp, which emits per-message C++ parse/serialize
from .proto).

This one emits per-message Python codecs from protobuf descriptors:
straight-line field access with names, presence checks and nesting
resolved at generation time, with no runtime descriptor walk.  The emitted
bytes are those of the runtime bridge (``brpc_tpu_torch/codec/mcpack.py``,
``pb_to_mcpack`` / ``mcpack_to_pb``) in both FORMAT_MCPACK and
FORMAT_COMPACK, and the generated module imports
``brpc_tpu_torch.codec.mcpack``.

Usage:
    python -m brpc_tpu_torch.tools.mcpack2py tests.echo_pb2:EchoRequest \
        tests.echo_pb2:TagBag -o echo_mcpack.py

Generated module surface (per message type X):
    encode_X(msg, compack=False) -> bytes
    decode_X(data, msg) -> msg        # fills and returns msg
"""
from __future__ import annotations

import argparse
import importlib
import sys
from typing import Any, List


def _is_map(fd) -> bool:
    mt = getattr(fd, "message_type", None)
    return mt is not None and mt.GetOptions().map_entry


def _is_repeated(fd) -> bool:
    rep = getattr(fd, "is_repeated", None)
    if isinstance(rep, bool):
        return rep
    from google.protobuf.descriptor import FieldDescriptor as FD
    return fd.label == FD.LABEL_REPEATED


def _has_presence(fd) -> bool:
    """Explicit field presence (proto3 `optional`, oneof member, proto2
    optional): these round-trip through HasField, not truthiness."""
    hp = getattr(fd, "has_presence", None)
    if isinstance(hp, bool):
        return hp
    return fd.containing_oneof is not None


def _collect_message_types(descs) -> List[Any]:
    """Transitive closure of message descriptors (skip map entries),
    dependency order not required — functions resolve lazily by name."""
    seen = {}
    stack = list(descs)
    while stack:
        d = stack.pop()
        if d.full_name in seen or d.GetOptions().map_entry:
            continue
        seen[d.full_name] = d
        for fd in d.fields:
            if _is_map(fd):
                vfd = fd.message_type.fields_by_name["value"]
                if vfd.message_type is not None:
                    stack.append(vfd.message_type)
            elif fd.message_type is not None:
                stack.append(fd.message_type)
    return list(seen.values())


def _fn(desc) -> str:
    return desc.full_name.replace(".", "_")


def _gen_dict_fn(desc, out: List[str]) -> None:
    from google.protobuf.descriptor import FieldDescriptor as FD
    out.append(f"def _dict_{_fn(desc)}(msg):")
    out.append("    d = {}")
    # ListFields() (the runtime bridge's walk) orders by field NUMBER —
    # matching insertion order is what makes the bytes identical
    for fd in sorted(desc.fields, key=lambda f: f.number):
        name = fd.name
        if _is_map(fd):
            vfd = fd.message_type.fields_by_name["value"]
            out.append(f"    v = msg.{name}")
            if vfd.type == FD.TYPE_MESSAGE:
                sub = _fn(vfd.message_type)
                out.append(f"    if v: d[{name!r}] = "
                           f"{{str(k): _dict_{sub}(x) "
                           f"for k, x in v.items()}}")
            else:
                out.append(f"    if v: d[{name!r}] = "
                           f"{{str(k): x for k, x in v.items()}}")
        elif _is_repeated(fd):
            out.append(f"    v = msg.{name}")
            if fd.type == FD.TYPE_MESSAGE:
                sub = _fn(fd.message_type)
                out.append(f"    if v: d[{name!r}] = "
                           f"[_dict_{sub}(x) for x in v]")
            else:
                out.append(f"    if v: d[{name!r}] = list(v)")
        elif fd.type == FD.TYPE_MESSAGE:
            sub = _fn(fd.message_type)
            out.append(f"    if msg.HasField({name!r}): "
                       f"d[{name!r}] = _dict_{sub}(msg.{name})")
        elif _has_presence(fd):
            # explicit presence (proto3 `optional`, oneof members,
            # proto2 optional): ListFields includes the field even at
            # its default value — truthiness would drop a set-to-0
            out.append(f"    if msg.HasField({name!r}): "
                       f"d[{name!r}] = msg.{name}")
        else:
            # proto3 implicit presence: emitted iff != default — exactly
            # ListFields' rule; Python truthiness matches for all scalar
            # defaults (0, 0.0, False, '', b'', enum 0)
            out.append(f"    v = msg.{name}")
            out.append(f"    if v: d[{name!r}] = v")
    out.append("    return d")
    out.append("")
    out.append("")


def _gen_fill_fn(desc, out: List[str]) -> None:
    from google.protobuf.descriptor import FieldDescriptor as FD
    out.append(f"def _fill_{_fn(desc)}(d, msg):")
    for fd in sorted(desc.fields, key=lambda f: f.number):
        name = fd.name
        out.append(f"    v = d.get({name!r})")
        out.append("    if v is not None:")
        if _is_map(fd):
            kfd = fd.message_type.fields_by_name["key"]
            vfd = fd.message_type.fields_by_name["value"]
            out.append(f"        t = msg.{name}")
            out.append("        for k, x in v.items():")
            if kfd.type != FD.TYPE_STRING:
                out.append("            k = int(k) "
                           "if isinstance(k, str) else k")
            if vfd.type == FD.TYPE_MESSAGE:
                sub = _fn(vfd.message_type)
                out.append(f"            _fill_{sub}(x, t[k])")
            else:
                out.append("            t[k] = x")
        elif _is_repeated(fd):
            out.append(f"        t = msg.{name}")
            if fd.type == FD.TYPE_MESSAGE:
                sub = _fn(fd.message_type)
                out.append("        for x in v:")
                out.append(f"            _fill_{sub}(x, t.add())")
            else:
                out.append("        t.extend(v)")
        elif fd.type == FD.TYPE_MESSAGE:
            sub = _fn(fd.message_type)
            out.append(f"        _fill_{sub}(v, msg.{name})")
        elif fd.type == FD.TYPE_BYTES:
            out.append(f"        msg.{name} = bytes(v)")
        else:
            out.append(f"        msg.{name} = v")
    out.append("    return msg")
    out.append("")
    out.append("")


def generate_module_source(message_classes) -> str:
    """Emit a self-contained module with encode_X/decode_X for every
    class (and _dict_/_fill_ helpers for every transitively reached
    message type)."""
    descs = [cls.DESCRIPTOR for cls in message_classes]
    closure = _collect_message_types(descs)
    out: List[str] = [
        '"""GENERATED by brpc_tpu_torch.tools.mcpack2py — per-message mcpack',
        'codecs (mcpack2pb generated-code analogue).  Do not edit."""',
        "from brpc_tpu_torch.codec.mcpack import mcpack_encode, "
        "mcpack_decode",
        "",
        "",
    ]
    for d in closure:
        _gen_dict_fn(d, out)
        _gen_fill_fn(d, out)
    shorts = {}
    for cls in message_classes:
        prev = shorts.setdefault(cls.DESCRIPTOR.name, cls.DESCRIPTOR)
        if prev is not cls.DESCRIPTOR:
            # encode_X names use the short name — two same-named messages
            # from different packages would silently shadow each other
            raise ValueError(
                f"duplicate short message name {cls.DESCRIPTOR.name!r}: "
                f"{prev.full_name} vs {cls.DESCRIPTOR.full_name}")
    for cls in message_classes:
        d = cls.DESCRIPTOR
        short = d.name
        out.append(f"def encode_{short}(msg, compack=False):")
        out.append(f"    return mcpack_encode(_dict_{_fn(d)}(msg), "
                   "compack=compack)")
        out.append("")
        out.append("")
        out.append(f"def decode_{short}(data, msg):")
        out.append(f"    return _fill_{_fn(d)}(mcpack_decode(data), msg)")
        out.append("")
        out.append("")
    return "\n".join(out)


def _load(spec: str):
    import os
    if os.getcwd() not in sys.path:      # the classes' modules resolve
        sys.path.insert(0, os.getcwd())  # from the invoking directory
    mod_name, _, cls_name = spec.partition(":")
    mod = importlib.import_module(mod_name)
    return getattr(mod, cls_name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("classes", nargs="+",
                    help="message classes as module:ClassName")
    ap.add_argument("-o", "--output", default="-",
                    help="output file (default stdout)")
    args = ap.parse_args(argv)
    src = generate_module_source([_load(s) for s in args.classes])
    if args.output == "-":
        sys.stdout.write(src)
    else:
        with open(args.output, "w") as f:
            f.write(src)
        print(f"wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
