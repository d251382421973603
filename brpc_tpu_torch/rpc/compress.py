"""Compression registry (reference: src/brpc/compress.{h,cpp} + policy
gzip/snappy).  Types: 0=none, 1=gzip, 2=zlib (the snappy slot — snappy
itself isn't in the image, zlib-raw fills the fast-codec role)."""
from __future__ import annotations

import gzip as _gzip
import zlib as _zlib
from typing import Callable, Dict, Tuple

COMPRESS_TYPE_NONE = 0
COMPRESS_TYPE_GZIP = 1
COMPRESS_TYPE_ZLIB = 2

_codecs: Dict[int, Tuple[Callable[[bytes], bytes], Callable[[bytes], bytes]]] = {
    COMPRESS_TYPE_GZIP: (_gzip.compress, _gzip.decompress),
    COMPRESS_TYPE_ZLIB: (_zlib.compress, _zlib.decompress),
}


def register_compression(ctype: int, compressor, decompressor) -> None:
    """Add (or replace) the codec of compress type ``ctype``."""
    _codecs[ctype] = (compressor, decompressor)


def compress(ctype: int, data: bytes) -> bytes:
    if ctype == COMPRESS_TYPE_NONE:
        return data
    try:
        return _codecs[ctype][0](data)
    except KeyError:
        raise ValueError(f"unknown compress_type {ctype}")


def decompress(ctype: int, data: bytes) -> bytes:
    if ctype == COMPRESS_TYPE_NONE:
        return data
    try:
        return _codecs[ctype][1](data)
    except KeyError:
        raise ValueError(f"unknown compress_type {ctype}")
