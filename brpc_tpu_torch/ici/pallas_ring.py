"""Ring collectives on hand-written Hopper kernels (the port of the JAX
package's ``ici/pallas_ring.py``, whose name this module keeps).

  * ``ring_all_gather(x)`` — every rank ends with every rank's chunk
  * ``ring_all_reduce(x)`` — every rank ends with the sum of all chunks,
    folded in the ring's order: rank d holds
    ``x[d+1] + x[d+2] + ... + x[d]`` (indices mod n), rounded to the dtype
    after every add, so the rows differ from rank to rank in their last
    bits, as on the TPU

``x`` is a :class:`~.mesh.ShardedTensor` ``(n, *chunk)``; the results are
sharded too: ``(n, n, *chunk)`` and ``(n, *chunk)``.  On a mesh of one
rank neither launches anything: they return ``x[:, None]`` and ``x``.
The JAX functions' ``interpret`` flag has no meaning here (a CPU tensor
runs the plain version, a CUDA tensor the kernel) and is gone.

The kernels replace the TPU kernels ``_build_all_reduce.kernel``
(brpc_tpu/ici/pallas_ring.py:107-132, ``pl.pallas_call`` at :135) and
``_build_all_gather.kernel`` (:50-73, call at :76).  On one card the ranks
share HBM, so there are no hops: one launch reads every rank's row once
and writes every output row.  The sources, ``csrc/ring_all_reduce.cu`` and
``csrc/ring_all_gather.cu``, state their bounds (bytes) and design.

:data:`ring_all_reduce_kernel` and :data:`ring_all_gather_kernel` are the
wrappers: each takes the list of n input rows and the list of n output
rows.  For CPU tensors it runs its plain version
(:func:`ring_all_reduce_plain`, :func:`ring_all_gather_plain`); for CUDA
tensors it launches the kernel on the current stream or raises — there is
no fallback.  Its ``launches`` counter grows by one per kernel launch and
nowhere else.  Rows on two cards are refused: that leg waits for the
multi-card plane, like ``p2p_copy``'s.
"""
from __future__ import annotations

import ctypes
from typing import Callable, List, Optional, Sequence

import torch

from .cuda_kernel import CSRC, CudaKernel
from .mesh import IciMesh, ShardedTensor

MAX_RANKS = 128            # kMaxRanks of both sources: the pointer tables
# dtype codes of csrc/ring_all_reduce.cu
_REDUCE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                  torch.int32: 3}


# ---- plain versions ------------------------------------------------------
def ring_all_reduce_plain(rows: Sequence[torch.Tensor],
                          outs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """outs[d] = x[d+1] + x[d+2] + ... + x[d] (mod n), one add per hop in
    the dtype: the same function as the kernel."""
    n = len(rows)
    x = torch.stack(list(rows))
    acc = x.roll(-1, 0)                  # acc[d] = x[(d + 1) % n]
    for j in range(2, n + 1):
        acc = acc + x.roll(-j, 0)        # + x[(d + j) % n]
    for d in range(n):
        outs[d].copy_(acc[d])
    return list(outs)


def ring_all_gather_plain(rows: Sequence[torch.Tensor],
                          outs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """outs[d][r] = rows[r] for every d and r: the same function as the
    kernel."""
    for out in outs:
        torch.stack(list(rows), out=out)
    return list(outs)


# ---- wrappers ------------------------------------------------------------
def _check(name: str, rows, outs, out_shape: Callable[[int, tuple], tuple],
           dtypes=None) -> torch.device:
    """The device of the rows, after checking what the kernel takes;
    ``out_shape(n, chunk)`` is the shape of every output."""
    if not isinstance(rows, (list, tuple)) or not isinstance(outs,
                                                             (list, tuple)):
        raise TypeError(f"{name}: rows and outs must be lists of tensors")
    n = len(rows)
    if not 1 <= n <= MAX_RANKS:
        raise ValueError(f"{name}: {n} rows; the kernel takes 1 to "
                         f"{MAX_RANKS}")
    if len(outs) != n:
        raise ValueError(f"{name}: {n} rows but {len(outs)} outputs")
    for t in list(rows) + list(outs):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: every row and output must be a tensor")
    first = rows[0]
    if dtypes is not None and first.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {first.dtype} is not one of "
                        f"{sorted(str(d) for d in dtypes)}")
    device = first.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    for kind, group, shape in (("row", rows, tuple(first.shape)),
                               ("output", outs,
                                out_shape(n, tuple(first.shape)))):
        for r, t in enumerate(group):
            if t.dtype != first.dtype or tuple(t.shape) != shape:
                raise ValueError(f"{name}: {kind} {r} is {t.dtype}"
                                 f"{tuple(t.shape)}, expected {first.dtype}"
                                 f"{shape}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {kind} {r} is not contiguous")
            if t.device != device:
                raise ValueError(
                    f"{name}: {kind} {r} on {t.device}, row 0 on {device}; "
                    "rows on two cards need the multi-card leg, not built")
    if device.type == "cuda":
        ins = {t.data_ptr() for t in rows if t.numel()}
        if any(t.data_ptr() in ins for t in outs if t.numel()):
            raise ValueError(f"{name}: an output is an input row")
    return device


def _pointers(ts: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


class RingAllReduce(CudaKernel):
    """``csrc/ring_all_reduce.cu`` and its launch counter."""

    def __init__(self):
        super().__init__(CSRC / "ring_all_reduce.cu", "ring_all_reduce_launch",
                         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int])

    def __call__(self, rows: Sequence[torch.Tensor],
                 outs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """outs[d] = the ring fold for rank d, on the current stream."""
        device = _check("ring_all_reduce", rows, outs,
                        lambda n, chunk: chunk, _REDUCE_DTYPES)
        if device.type == "cpu":
            return ring_all_reduce_plain(rows, outs)
        numel = rows[0].numel()
        if numel:
            rec = self.record(device.index)
            self.launch(rec, _pointers(rows), _pointers(outs), len(rows),
                        numel, _REDUCE_DTYPES[rows[0].dtype], rec.blocks_cap)
        return list(outs)


class RingAllGather(CudaKernel):
    """``csrc/ring_all_gather.cu`` and its launch counter."""

    def __init__(self):
        super().__init__(CSRC / "ring_all_gather.cu", "ring_all_gather_launch",
                         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_ulonglong, ctypes.c_int])

    def __call__(self, rows: Sequence[torch.Tensor],
                 outs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """outs[d][r] = rows[r] for every d, on the current stream."""
        device = _check("ring_all_gather", rows, outs,
                        lambda n, chunk: (n,) + chunk)
        if device.type == "cpu":
            return ring_all_gather_plain(rows, outs)
        nbytes = rows[0].numel() * rows[0].element_size()
        if nbytes:
            rec = self.record(device.index)
            self.launch(rec, _pointers(rows), _pointers(outs), len(rows),
                        nbytes, rec.blocks_cap)
        return list(outs)


ring_all_reduce_kernel = RingAllReduce()
ring_all_gather_kernel = RingAllGather()


# ---- entry points (the JAX names and argument order) ---------------------
def _layout(x, mesh: Optional[IciMesh], what: str) -> IciMesh:
    if not isinstance(x, ShardedTensor):
        raise TypeError(f"{what}: expected a ShardedTensor, got "
                        f"{type(x).__name__}")
    mesh = mesh or x.mesh
    if x.mesh is not mesh:
        raise ValueError(f"{what}: x is sharded over another mesh")
    return mesh


def ring_all_gather(x: ShardedTensor,
                    mesh: Optional[IciMesh] = None) -> ShardedTensor:
    """x: (n, *chunk) sharded one row per rank → (n, n, *chunk) sharded:
    rank d's row holds every rank's chunk.  ``mesh`` defaults to x's."""
    mesh = _layout(x, mesh, "ring_all_gather")
    if mesh.size == 1:
        return ShardedTensor([x.row(0)[None]], mesh)
    n = mesh.size
    outs = [mesh.register(torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                      device=t.device), r)
            for r, t in enumerate(x.rows)]
    ring_all_gather_kernel(x.rows, outs)
    return ShardedTensor(outs, mesh)


def ring_all_reduce(x: ShardedTensor,
                    mesh: Optional[IciMesh] = None) -> ShardedTensor:
    """x: (n, *chunk) sharded → (n, *chunk) sharded where every row is the
    elementwise sum over all rows, in the ring's order for its rank.
    ``mesh`` defaults to x's."""
    mesh = _layout(x, mesh, "ring_all_reduce")
    if mesh.size == 1:
        return x
    outs = [mesh.register(torch.empty(t.shape, dtype=t.dtype,
                                      device=t.device), r)
            for r, t in enumerate(x.rows)]
    ring_all_reduce_kernel(x.rows, outs)
    return ShardedTensor(outs, mesh)
