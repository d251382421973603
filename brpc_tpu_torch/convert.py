"""Carry IOBuf contents across from the JAX package.

The JAX package's IOBuf holds host bytes and DEVICE blocks resident on mesh
devices.  Exported as numpy — host segments as ``bytes``, device segments
as ``(uint8 ndarray, mesh_index)`` — the same buffer is rebuilt here with
each device segment owned by the same logical rank of the port's mesh.
"""
from __future__ import annotations

from typing import Iterable, Tuple, Union

import numpy as np
import torch

from .butil.iobuf import IOBuf
from .ici.mesh import IciMesh

Segment = Union[bytes, Tuple[np.ndarray, int]]


def iobuf_from_segments(segments: Iterable[Segment], mesh: IciMesh) -> IOBuf:
    """An IOBuf of ``segments`` in order: ``bytes`` become host blocks,
    ``(array, rank)`` a DEVICE block owned by ``rank`` of ``mesh``."""
    buf = IOBuf()
    for seg in segments:
        if isinstance(seg, (bytes, bytearray)):
            buf.append(bytes(seg))
            continue
        arr, rank = seg
        arr = np.asarray(arr)
        if arr.dtype != np.uint8 or arr.ndim != 1:
            raise TypeError("device segment must be a flat uint8 array")
        host = torch.from_numpy(arr.copy())
        buf.append_device_array(mesh.device_put(host, int(rank)))
    return buf
