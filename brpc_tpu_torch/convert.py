"""Carry state across from the JAX package.

The JAX package's IOBuf holds host bytes and DEVICE blocks resident on mesh
devices.  Exported as numpy — host segments as ``bytes``, device segments
as ``(uint8 ndarray, mesh_index)`` — the same buffer is rebuilt here with
each device segment owned by the same logical rank of the port's mesh.

A JAX array sharded one row per device, exported as an ``(n, *chunk)``
numpy array, becomes a :class:`~.ici.mesh.ShardedTensor` with row r owned
by rank r.

A JAX prefill's quantized KV (the flat uint8 array of
``examples/disagg_serving/model.py``), exported as numpy, becomes a flat
uint8 tensor owned by a rank (:func:`kv_from_numpy`), ready to ride a
LoadKv attachment.
"""
from __future__ import annotations

from typing import Iterable, Tuple, Union

import numpy as np
import torch

from .butil.iobuf import IOBuf
from .ici.mesh import IciMesh, ShardedTensor

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


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A tensor of its own holding ``arr``; numpy's bfloat16 extension
    type (what a JAX bfloat16 array exports to) crosses as its bits."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.uint16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def sharded_from_numpy(rows: np.ndarray, mesh: IciMesh) -> ShardedTensor:
    """An ``(n, *chunk)`` array as a ShardedTensor of ``mesh``: row r
    owned by rank r, on rank r's device."""
    rows = np.asarray(rows)
    if rows.ndim == 0 or rows.shape[0] != mesh.size:
        raise ValueError(f"expected ({mesh.size}, ...) rows, got "
                         f"{rows.shape}")
    return ShardedTensor.adopt(
        [_tensor(rows[r]).to(mesh.device(r)) for r in range(mesh.size)],
        mesh)


def kv_from_numpy(arr: np.ndarray, mesh: IciMesh, rank: int) -> torch.Tensor:
    """A flat uint8 KV array as a tensor of its own owned by ``rank`` of
    ``mesh``, on that rank's device."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise TypeError(f"KV bytes must be uint8, got {arr.dtype}")
    return mesh.device_put(torch.from_numpy(arr.reshape(-1).copy()),
                           int(rank))
