"""FLV container reader/writer (port of :mod:`brpc_tpu.policy.flv`).

Reference: src/brpc/rtmp.h FlvWriter/FlvReader (rtmp.h:1050-1130) and the
FLV tag handling inside src/brpc/policy/rtmp_protocol.cpp.  FLV frames
the exact same audio/video/script payloads RTMP carries, so the two
modules share message-type constants; tags round-trip losslessly through
(type, timestamp, payload) triples.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, Optional, Tuple

from ..butil.iobuf import IOBuf
from ..butil.misc import p24 as _p24, u24 as _u24
from . import amf

FLV_TAG_AUDIO = 8
FLV_TAG_VIDEO = 9
FLV_TAG_SCRIPT_DATA = 18

_HEADER = b"FLV\x01"
_HAS_AUDIO = 0x04
_HAS_VIDEO = 0x01


class FlvWriter:
    """Serialize (type, timestamp, payload) tags into an FLV byte stream.
    Writes into an IOBuf (or any object with .append(bytes))."""

    def __init__(self, sink: Optional[IOBuf] = None, has_audio: bool = True,
                 has_video: bool = True):
        self.buf = sink if sink is not None else IOBuf()
        flags = (_HAS_AUDIO if has_audio else 0) | \
            (_HAS_VIDEO if has_video else 0)
        self.buf.append(_HEADER + bytes([flags]) + struct.pack(">I", 9))
        self.buf.append(struct.pack(">I", 0))       # PreviousTagSize0

    def write_tag(self, tag_type: int, timestamp: int,
                  payload: bytes) -> None:
        ts = timestamp & 0xFFFFFFFF
        head = bytes([tag_type]) + _p24(len(payload)) \
            + _p24(ts & 0xFFFFFF) + bytes([(ts >> 24) & 0xFF]) \
            + b"\x00\x00\x00"                       # stream id, always 0
        self.buf.append(head + payload)
        self.buf.append(struct.pack(">I", 11 + len(payload)))

    def write_audio(self, timestamp: int, data: bytes) -> None:
        self.write_tag(FLV_TAG_AUDIO, timestamp, data)

    def write_video(self, timestamp: int, data: bytes) -> None:
        self.write_tag(FLV_TAG_VIDEO, timestamp, data)

    def write_meta_data(self, meta: Dict[str, Any],
                        name: str = "onMetaData",
                        timestamp: int = 0) -> None:
        self.write_tag(FLV_TAG_SCRIPT_DATA, timestamp,
                       amf.encode(name, amf.EcmaArray(meta)))


class FlvReader:
    """Incremental FLV parser: feed bytes, iterate (type, ts, payload)."""

    def __init__(self, data: bytes = b""):
        self._buf = bytearray(data)
        self._header_done = False
        self.has_audio = False
        self.has_video = False

    def feed(self, data: bytes) -> None:
        self._buf += data

    def read_tag(self) -> Optional[Tuple[int, int, bytes]]:
        b = self._buf
        if not self._header_done:
            if len(b) < 13:
                return None
            if bytes(b[:3]) != b"FLV":
                raise ValueError("not an FLV stream")
            data_off = struct.unpack_from(">I", b, 5)[0]
            if len(b) < data_off + 4:       # extended header not yet here
                return None
            flags = b[4]
            self.has_audio = bool(flags & _HAS_AUDIO)
            self.has_video = bool(flags & _HAS_VIDEO)
            del b[:data_off + 4]                    # header + PrevTagSize0
            self._header_done = True
        if len(b) < 11:
            return None
        size = _u24(b, 1)
        if len(b) < 11 + size + 4:
            return None
        tag_type = b[0]
        ts = _u24(b, 4) | (b[7] << 24)
        payload = bytes(b[11:11 + size])
        del b[:11 + size + 4]
        return tag_type, ts, payload

    def __iter__(self) -> Iterator[Tuple[int, int, bytes]]:
        while True:
            tag = self.read_tag()
            if tag is None:
                return
            yield tag

    def read_meta_data(self, payload: bytes) -> Tuple[str, Dict[str, Any]]:
        vals = amf.decode_all(payload)
        name = vals[0] if vals and isinstance(vals[0], str) else ""
        meta = next((v for v in vals[1:] if isinstance(v, dict)), {})
        return name, dict(meta)
