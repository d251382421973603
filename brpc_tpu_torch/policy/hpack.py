"""HPACK (RFC 7541) — header compression for HTTP/2.

Reference: src/brpc/details/hpack.{h,cpp}.  Full decoder (indexed fields,
all literal forms, dynamic-table size updates, static + dynamic tables)
and a full encoder: ``Encoder()`` defaults to incremental indexing with
its own dynamic table (the RFC's example encoder, golden-pinned against
Appendix C.3-C.6 in tests/test_torch_grpc.py), with optional huffman coding
both directions.

INVARIANT the connection depends on: the default encoder is STATEFUL —
its dynamic table must evolve in the same order the peer's decoder sees
the blocks, so every header block must reach the wire in encode order
(grpc.py holds the h2 conn lock across encode AND write for this reason).
``Encoder(index=False)`` restores the stateless literal-only form.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

STATIC_TABLE: List[Tuple[bytes, bytes]] = [
    (b":authority", b""), (b":method", b"GET"), (b":method", b"POST"),
    (b":path", b"/"), (b":path", b"/index.html"), (b":scheme", b"http"),
    (b":scheme", b"https"), (b":status", b"200"), (b":status", b"204"),
    (b":status", b"206"), (b":status", b"304"), (b":status", b"400"),
    (b":status", b"404"), (b":status", b"500"), (b"accept-charset", b""),
    (b"accept-encoding", b"gzip, deflate"), (b"accept-language", b""),
    (b"accept-ranges", b""), (b"accept", b""), (b"access-control-allow-origin", b""),
    (b"age", b""), (b"allow", b""), (b"authorization", b""),
    (b"cache-control", b""), (b"content-disposition", b""),
    (b"content-encoding", b""), (b"content-language", b""),
    (b"content-length", b""), (b"content-location", b""),
    (b"content-range", b""), (b"content-type", b""), (b"cookie", b""),
    (b"date", b""), (b"etag", b""), (b"expect", b""), (b"expires", b""),
    (b"from", b""), (b"host", b""), (b"if-match", b""),
    (b"if-modified-since", b""), (b"if-none-match", b""), (b"if-range", b""),
    (b"if-unmodified-since", b""), (b"last-modified", b""), (b"link", b""),
    (b"location", b""), (b"max-forwards", b""), (b"proxy-authenticate", b""),
    (b"proxy-authorization", b""), (b"range", b""), (b"referer", b""),
    (b"refresh", b""), (b"retry-after", b""), (b"server", b""),
    (b"set-cookie", b""), (b"strict-transport-security", b""),
    (b"transfer-encoding", b""), (b"user-agent", b""), (b"vary", b""),
    (b"via", b""), (b"www-authenticate", b""),
]

_STATIC_LOOKUP: Dict[Tuple[bytes, bytes], int] = {
    kv: i + 1 for i, kv in enumerate(STATIC_TABLE)}
_STATIC_NAME_LOOKUP: Dict[bytes, int] = {}
for i, (k, _) in enumerate(STATIC_TABLE):
    _STATIC_NAME_LOOKUP.setdefault(k, i + 1)

# RFC 7541 Appendix B huffman code table: (code, bits) per symbol 0..256
_HUFF = [
    (0x1ff8, 13), (0x7fffd8, 23), (0xfffffe2, 28), (0xfffffe3, 28),
    (0xfffffe4, 28), (0xfffffe5, 28), (0xfffffe6, 28), (0xfffffe7, 28),
    (0xfffffe8, 28), (0xffffea, 24), (0x3ffffffc, 30), (0xfffffe9, 28),
    (0xfffffea, 28), (0x3ffffffd, 30), (0xfffffeb, 28), (0xfffffec, 28),
    (0xfffffed, 28), (0xfffffee, 28), (0xfffffef, 28), (0xffffff0, 28),
    (0xffffff1, 28), (0xffffff2, 28), (0x3ffffffe, 30), (0xffffff3, 28),
    (0xffffff4, 28), (0xffffff5, 28), (0xffffff6, 28), (0xffffff7, 28),
    (0xffffff8, 28), (0xffffff9, 28), (0xffffffa, 28), (0xffffffb, 28),
    (0x14, 6), (0x3f8, 10), (0x3f9, 10), (0xffa, 12), (0x1ff9, 13),
    (0x15, 6), (0xf8, 8), (0x7fa, 11), (0x3fa, 10), (0x3fb, 10),
    (0xf9, 8), (0x7fb, 11), (0xfa, 8), (0x16, 6), (0x17, 6), (0x18, 6),
    (0x0, 5), (0x1, 5), (0x2, 5), (0x19, 6), (0x1a, 6), (0x1b, 6),
    (0x1c, 6), (0x1d, 6), (0x1e, 6), (0x1f, 6), (0x5c, 7), (0xfb, 8),
    (0x7ffc, 15), (0x20, 6), (0xffb, 12), (0x3fc, 10), (0x1ffa, 13),
    (0x21, 6), (0x5d, 7), (0x5e, 7), (0x5f, 7), (0x60, 7), (0x61, 7),
    (0x62, 7), (0x63, 7), (0x64, 7), (0x65, 7), (0x66, 7), (0x67, 7),
    (0x68, 7), (0x69, 7), (0x6a, 7), (0x6b, 7), (0x6c, 7), (0x6d, 7),
    (0x6e, 7), (0x6f, 7), (0x70, 7), (0x71, 7), (0x72, 7), (0xfc, 8),
    (0x73, 7), (0xfd, 8), (0x1ffb, 13), (0x7fff0, 19), (0x1ffc, 13),
    (0x3ffc, 14), (0x22, 6), (0x7ffd, 15), (0x3, 5), (0x23, 6), (0x4, 5),
    (0x24, 6), (0x5, 5), (0x25, 6), (0x26, 6), (0x27, 6), (0x6, 5),
    (0x74, 7), (0x75, 7), (0x28, 6), (0x29, 6), (0x2a, 6), (0x7, 5),
    (0x2b, 6), (0x76, 7), (0x2c, 6), (0x8, 5), (0x9, 5), (0x2d, 6),
    (0x77, 7), (0x78, 7), (0x79, 7), (0x7a, 7), (0x7b, 7), (0x7ffe, 15),
    (0x7fc, 11), (0x3ffd, 14), (0x1ffd, 13), (0xffffffc, 28), (0xfffe6, 20),
    (0x3fffd2, 22), (0xfffe7, 20), (0xfffe8, 20), (0x3fffd3, 22),
    (0x3fffd4, 22), (0x3fffd5, 22), (0x7fffd9, 23), (0x3fffd6, 22),
    (0x7fffda, 23), (0x7fffdb, 23), (0x7fffdc, 23), (0x7fffdd, 23),
    (0x7fffde, 23), (0xffffeb, 24), (0x7fffdf, 23), (0xffffec, 24),
    (0xffffed, 24), (0x3fffd7, 22), (0x7fffe0, 23), (0xffffee, 24),
    (0x7fffe1, 23), (0x7fffe2, 23), (0x7fffe3, 23), (0x7fffe4, 23),
    (0x1fffdc, 21), (0x3fffd8, 22), (0x7fffe5, 23), (0x3fffd9, 22),
    (0x7fffe6, 23), (0x7fffe7, 23), (0xffffef, 24), (0x3fffda, 22),
    (0x1fffdd, 21), (0xfffe9, 20), (0x3fffdb, 22), (0x3fffdc, 22),
    (0x7fffe8, 23), (0x7fffe9, 23), (0x1fffde, 21), (0x7fffea, 23),
    (0x3fffdd, 22), (0x3fffde, 22), (0xfffff0, 24), (0x1fffdf, 21),
    (0x3fffdf, 22), (0x7fffeb, 23), (0x7fffec, 23), (0x1fffe0, 21),
    (0x1fffe1, 21), (0x3fffe0, 22), (0x1fffe2, 21), (0x7fffed, 23),
    (0x3fffe1, 22), (0x7fffee, 23), (0x7fffef, 23), (0xfffea, 20),
    (0x3fffe2, 22), (0x3fffe3, 22), (0x3fffe4, 22), (0x7ffff0, 23),
    (0x3fffe5, 22), (0x3fffe6, 22), (0x7ffff1, 23), (0x3ffffe0, 26),
    (0x3ffffe1, 26), (0xfffeb, 20), (0x7fff1, 19), (0x3fffe7, 22),
    (0x7ffff2, 23), (0x3fffe8, 22), (0x1ffffec, 25), (0x3ffffe2, 26),
    (0x3ffffe3, 26), (0x3ffffe4, 26), (0x7ffffde, 27), (0x7ffffdf, 27),
    (0x3ffffe5, 26), (0xfffff1, 24), (0x1ffffed, 25), (0x7fff2, 19),
    (0x1fffe3, 21), (0x3ffffe6, 26), (0x7ffffe0, 27), (0x7ffffe1, 27),
    (0x3ffffe7, 26), (0x7ffffe2, 27), (0xfffff2, 24), (0x1fffe4, 21),
    (0x1fffe5, 21), (0x3ffffe8, 26), (0x3ffffe9, 26), (0xffffffd, 28),
    (0x7ffffe3, 27), (0x7ffffe4, 27), (0x7ffffe5, 27), (0xfffec, 20),
    (0xfffff3, 24), (0xfffed, 20), (0x1fffe6, 21), (0x3fffe9, 22),
    (0x1fffe7, 21), (0x1fffe8, 21), (0x7ffff3, 23), (0x3fffea, 22),
    (0x3fffeb, 22), (0x1ffffee, 25), (0x1ffffef, 25), (0xfffff4, 24),
    (0xfffff5, 24), (0x3ffffea, 26), (0x7ffff4, 23), (0x3ffffeb, 26),
    (0x7ffffe6, 27), (0x3ffffec, 26), (0x3ffffed, 26), (0x7ffffe7, 27),
    (0x7ffffe8, 27), (0x7ffffe9, 27), (0x7ffffea, 27), (0x7ffffeb, 27),
    (0xffffffe, 28), (0x7ffffec, 27), (0x7ffffed, 27), (0x7ffffee, 27),
    (0x7ffffef, 27), (0x7fffff0, 27), (0x3ffffee, 26), (0x3fffffff, 30),
]

_huff_decode_tree: Optional[dict] = None


def _build_huff_tree() -> dict:
    global _huff_decode_tree
    if _huff_decode_tree is None:
        root: dict = {}
        for sym, (code, bits) in enumerate(_HUFF):
            node = root
            for i in range(bits - 1, -1, -1):
                bit = (code >> i) & 1
                if i == 0:
                    node[bit] = sym
                else:
                    node = node.setdefault(bit, {})
        _huff_decode_tree = root
    return _huff_decode_tree


def huffman_decode(data: bytes) -> bytes:
    tree = _build_huff_tree()
    out = bytearray()
    node = tree
    for byte in data:
        for i in range(7, -1, -1):
            bit = (byte >> i) & 1
            nxt = node[bit]
            if isinstance(nxt, int):
                if nxt == 256:
                    raise ValueError("EOS in huffman stream")
                out.append(nxt)
                node = tree
            else:
                node = nxt
    return bytes(out)


def _encode_int(value: int, prefix_bits: int, first_byte_flags: int) -> bytes:
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([first_byte_flags | value])
    out = [first_byte_flags | limit]
    value -= limit
    while value >= 128:
        out.append((value % 128) + 128)
        value //= 128
    out.append(value)
    return bytes(out)


def _decode_int(data: bytes, pos: int, prefix_bits: int) -> Tuple[int, int]:
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not (b & 0x80):
            return value, pos


def huffman_encode(data: bytes) -> bytes:
    """RFC 7541 §5.2: huffman string, EOS-padded with 1-bits."""
    bits = 0
    nbits = 0
    out = bytearray()
    for b in data:
        code, n = _HUFF[b]
        bits = (bits << n) | code
        nbits += n
        while nbits >= 8:
            nbits -= 8
            out.append((bits >> nbits) & 0xFF)
    if nbits:
        pad = 8 - nbits
        out.append(((bits << pad) | ((1 << pad) - 1)) & 0xFF)
    return bytes(out)


class Encoder:
    """RFC 7541 encoder with its own dynamic table.

    ``index=True`` (default) emits literal-with-incremental-indexing for
    non-static headers, so repeats on a connection compress to 1-2 bytes —
    this is the RFC's own example encoder (Appendix C.3-C.6), and the
    golden-vector tests pin its output byte-for-byte.  ``index=False``
    restores the stateless literal-without-indexing form (never requires
    peer state).  ``use_huffman`` huffman-codes every literal string (the
    C.4/C.6 examples)."""

    def __init__(self, index: bool = True, use_huffman: bool = False,
                 max_table_size: int = 4096):
        self.index = index
        self.use_huffman = use_huffman
        self.dynamic: List[Tuple[bytes, bytes]] = []
        self.max_table_size = max_table_size
        self._size = 0

    # dynamic-table bookkeeping mirrors the Decoder exactly: both ends
    # evolve the same table from the same header stream (RFC 7541 §2.3.2)
    def _add(self, name: bytes, value: bytes) -> None:
        self.dynamic.insert(0, (name, value))
        self._size += len(name) + len(value) + 32
        while self._size > self.max_table_size and self.dynamic:
            n, v = self.dynamic.pop()
            self._size -= len(n) + len(v) + 32

    def table_size(self) -> int:
        return self._size

    def _find(self, name: bytes, value: bytes) -> Tuple[int, bool]:
        """(index, full_match); index 0 = no name match anywhere."""
        idx = _STATIC_LOOKUP.get((name, value))
        if idx is not None:
            return idx, True
        for i, (n, v) in enumerate(self.dynamic):
            if n == name and v == value:
                return len(STATIC_TABLE) + 1 + i, True
        name_idx = _STATIC_NAME_LOOKUP.get(name, 0)
        if name_idx == 0:
            for i, (n, _v) in enumerate(self.dynamic):
                if n == name:
                    name_idx = len(STATIC_TABLE) + 1 + i
                    break
        return name_idx, False

    def _string(self, s: bytes) -> bytes:
        if self.use_huffman:
            enc = huffman_encode(s)
            return _encode_int(len(enc), 7, 0x80) + enc
        return _encode_int(len(s), 7, 0x00) + s

    def encode(self, headers: List[Tuple[bytes, bytes]]) -> bytes:
        out = bytearray()
        for name, value in headers:
            name = name.lower()
            idx, full = self._find(name, value)
            if full:
                out += _encode_int(idx, 7, 0x80)       # indexed field
                continue
            if self.index:
                out += _encode_int(idx, 6, 0x40)       # incremental indexing
                if idx == 0:
                    out += self._string(name)
                out += self._string(value)
                self._add(name, value)
            else:
                out += _encode_int(idx, 4, 0x00)       # literal, no indexing
                if idx == 0:
                    out += self._string(name)
                out += self._string(value)
        return bytes(out)


class Decoder:
    def __init__(self, max_table_size: int = 4096):
        self.dynamic: List[Tuple[bytes, bytes]] = []
        self.max_table_size = max_table_size
        self._size = 0

    def _entry(self, index: int) -> Tuple[bytes, bytes]:
        if 1 <= index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        d = index - len(STATIC_TABLE) - 1
        if 0 <= d < len(self.dynamic):
            return self.dynamic[d]
        raise ValueError(f"bad hpack index {index}")

    def _add(self, name: bytes, value: bytes) -> None:
        self.dynamic.insert(0, (name, value))
        self._size += len(name) + len(value) + 32
        while self._size > self.max_table_size and self.dynamic:
            n, v = self.dynamic.pop()
            self._size -= len(n) + len(v) + 32

    def _read_string(self, data: bytes, pos: int) -> Tuple[bytes, int]:
        huff = bool(data[pos] & 0x80)
        length, pos = _decode_int(data, pos, 7)
        raw = data[pos:pos + length]
        pos += length
        return (huffman_decode(raw) if huff else raw), pos

    def decode(self, data: bytes) -> List[Tuple[bytes, bytes]]:
        out: List[Tuple[bytes, bytes]] = []
        pos = 0
        while pos < len(data):
            b = data[pos]
            if b & 0x80:                    # indexed
                index, pos = _decode_int(data, pos, 7)
                out.append(self._entry(index))
            elif b & 0x40:                  # literal with incremental indexing
                index, pos = _decode_int(data, pos, 6)
                if index:
                    name = self._entry(index)[0]
                else:
                    name, pos = self._read_string(data, pos)
                value, pos = self._read_string(data, pos)
                self._add(name, value)
                out.append((name, value))
            elif b & 0x20:                  # dynamic table size update
                size, pos = _decode_int(data, pos, 5)
                self.max_table_size = size
                while self._size > size and self.dynamic:
                    n, v = self.dynamic.pop()
                    self._size -= len(n) + len(v) + 32
            else:                           # literal w/o indexing (or never)
                index, pos = _decode_int(data, pos, 4)
                if index:
                    name = self._entry(index)[0]
                else:
                    name, pos = self._read_string(data, pos)
                value, pos = self._read_string(data, pos)
                out.append((name, value))
        return out
