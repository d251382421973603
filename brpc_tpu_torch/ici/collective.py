"""Mesh collectives: the lowering target for combo channels.

The JAX package lowers each of these to one XLA collective over the mesh
(``psum``, ``all_gather``, ``psum_scatter``, ``ppermute``, ``all_to_all``)
inside a ``shard_map``, outside any Pallas kernel.  Here the ranks of a
mesh share the card, so each collective is plain PyTorch over the rows of a
:class:`~.mesh.ShardedTensor`: copies, stacks and sums, run eagerly.
There is no compile step, so nothing is cached.

Layouts follow the JAX functions: a sharded input or output is a
``ShardedTensor`` (row r owned by rank r); a replicated output is one
plain tensor on the mesh's card, ``mesh.device(0)``.  Sums are left folds
in rank order, ``x[0] + x[1] + ... + x[n-1]``, so a replicated sum has one
value for every rank (the ring kernels' per-rank orders are in
:mod:`.pallas_ring`).
"""
from __future__ import annotations

import threading
from typing import List, Optional

import torch

from .mesh import IciMesh, ShardedTensor


def fold(parts: List[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The left fold ``parts[0] + parts[1] + ...`` in list order, into a
    fresh tensor on ``device`` (psum's counterpart)."""
    acc = parts[0].to(device, copy=True)
    for p in parts[1:]:
        acc.add_(p.to(device))
    return acc


def gather(parts: List[torch.Tensor], device: torch.device) -> torch.Tensor:
    """``parts`` stacked in list order on ``device`` (all_gather's
    counterpart)."""
    return torch.stack([t.to(device) for t in parts])


class Collectives:
    def __init__(self, mesh: Optional[IciMesh] = None):
        self.mesh = mesh or IciMesh.default()

    def _sharded(self, x: ShardedTensor, what: str,
                 square: bool = False) -> int:
        if not isinstance(x, ShardedTensor):
            raise TypeError(f"{what}: expected a ShardedTensor, got "
                            f"{type(x).__name__}")
        if x.mesh is not self.mesh:
            raise ValueError(f"{what}: the input is sharded over another mesh")
        n = self.mesh.size
        if square and (len(x.shape) < 2 or x.shape[1] != n):
            raise ValueError(f"{what}: expected ({n}, {n}, ...), got "
                             f"{tuple(x.shape)}")
        return n

    def shard(self, x) -> ShardedTensor:
        """Place a (mesh_size, ...) array with one row per rank."""
        x = torch.as_tensor(x)
        n = self.mesh.size
        if x.dim() == 0 or x.shape[0] != n:
            raise ValueError(f"shard: expected ({n}, ...), got "
                             f"{tuple(x.shape)}")
        return ShardedTensor([self.mesh.device_put(x[r], r)
                              for r in range(n)], self.mesh)

    def replicate(self, x) -> torch.Tensor:
        """One copy on the mesh's card, owned by no rank."""
        return torch.as_tensor(x).to(self.mesh.device(0))

    # -- collectives -----------------------------------------------------
    def all_reduce(self, x: ShardedTensor) -> torch.Tensor:
        """Sum over the mesh axis; in: (n, ...) sharded, out: (...) summed,
        replicated (ParallelChannel response-merge as a reduction)."""
        self._sharded(x, "all_reduce")
        return fold(x.rows, self.mesh.device(0))

    def all_gather(self, x: ShardedTensor) -> torch.Tensor:
        """in: (n, ...) sharded → out: (n, ...) fully replicated (every
        rank sees every response)."""
        self._sharded(x, "all_gather")
        return gather(x.rows, self.mesh.device(0))

    def reduce_scatter(self, x: ShardedTensor) -> ShardedTensor:
        """in: (n, n, ...) sharded on dim0 → out: (n, 1, ...) sharded: rank
        d gets sum_s x[s, d:d+1] (the JAX ``psum_scatter(tiled=True)``
        shape; gradient-bucket exchange)."""
        n = self._sharded(x, "reduce_scatter", square=True)
        return ShardedTensor.adopt(
            [fold([t[d:d + 1] for t in x.rows], self.mesh.device(d))
             for d in range(n)], self.mesh)

    def ppermute(self, x: ShardedTensor, shift: int = 1) -> ShardedTensor:
        """Rotate rows around the ring by ``shift`` hops: rank
        (i + shift) % n receives rank i's row (the chained Send/Recv
        primitive; streaming/sequence pipelines build on this)."""
        self._sharded(x, "ppermute")
        rows = {dst: self.mesh.device_put(x.rows[src], dst)
                for src, dst in self.mesh.ring_perm(shift)}
        return ShardedTensor([rows[d] for d in sorted(rows)], self.mesh)

    def broadcast(self, x: ShardedTensor, root: int = 0) -> torch.Tensor:
        """Replicate rank ``root``'s row to every rank (ParallelChannel
        request replication)."""
        self._sharded(x, "broadcast")
        return x.rows[root].to(self.mesh.device(0), copy=True)

    def all_to_all(self, x: ShardedTensor) -> ShardedTensor:
        """in: (n, n, ...) sharded dim0 — row s holds what s sends to every
        d → out: (n, n, ...) sharded: row d holds what every s sent to d
        (PartitionChannel resharding)."""
        n = self._sharded(x, "all_to_all", square=True)
        return ShardedTensor.adopt(
            [torch.stack([t[d].to(self.mesh.device(d)) for t in x.rows])
             for d in range(n)], self.mesh)


_default_collectives: Optional[Collectives] = None
_default_lock = threading.Lock()


def default_collectives() -> Collectives:
    global _default_collectives
    with _default_lock:
        if _default_collectives is None:
            _default_collectives = Collectives()
        return _default_collectives
