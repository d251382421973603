"""Combo-channel fan-out lowered to mesh collectives.

Where a ParallelChannel sends N socket RPCs and merges N responses on the
host, a CollectiveChannel runs the same semantics

    CallMapper(replicate|shard)  →  replicated operand | sharded operand
    per-server handler           →  the rank-local method body
    ResponseMerger(sum|gather|concat) → Collectives.all_reduce | all_gather

over the mesh with no RPC in between.  The JAX package compiles a call into
one SPMD program; here a call is n eager handler calls, one per rank on its
own row (in rank order), followed by the merge through
:class:`~brpc_tpu_torch.ici.collective.Collectives`.  Eager PyTorch has no
compile step, so nothing is cached per shape.

Operands: a :class:`~brpc_tpu_torch.ici.mesh.ShardedTensor` is a sharded
request (rank r gets its row r); anything else is replicated (every rank
gets it whole).

    ch = CollectiveChannel(mesh)
    ch.register("Shard.MatVec", lambda w, x: w @ x, merge=MERGE_SUM)
    y = ch.call("Shard.MatVec", ch.shard(w), ch.replicate(x))
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..ici.collective import Collectives
from ..ici.mesh import IciMesh, ShardedTensor

MERGE_SUM = "sum"           # ResponseMerger that adds (reduction)
MERGE_GATHER = "gather"     # ResponseMerger that stacks all responses
MERGE_CONCAT = "concat"     # stack along existing axis 0
MERGE_NONE = "none"         # keep responses sharded (each rank keeps its own)

MAP_REPLICATE = "replicate"  # CallMapper: same request to every server
MAP_SHARD = "shard"          # CallMapper: row i of the request to server i


class _Method:
    __slots__ = ("name", "handler", "merge", "mapping", "takes_index")

    def __init__(self, name, handler, merge, mapping, takes_index):
        self.name = name
        self.handler = handler
        self.merge = merge
        self.mapping = mapping
        self.takes_index = takes_index


class CollectiveChannel:
    def __init__(self, mesh: Optional[IciMesh] = None):
        self.mesh = mesh or IciMesh.default()
        self.coll = Collectives(self.mesh)
        self._methods: Dict[str, _Method] = {}

    def register(self, name: str, handler: Callable, merge: str = MERGE_GATHER,
                 mapping: str = MAP_SHARD, takes_index: bool = False) -> None:
        """handler(*operands) -> result, operating on rank-local rows.
        With takes_index=True the handler receives the rank first (the
        CallMapper's channel_index)."""
        self._methods[name] = _Method(name, handler, merge, mapping,
                                      takes_index)

    def shard(self, x) -> ShardedTensor:
        """Lay a (n, ...) operand out one row per rank (MAP_SHARD input)."""
        return self.coll.shard(x)

    def replicate(self, x) -> torch.Tensor:
        return self.coll.replicate(x)

    def call(self, name: str, *operands):
        """One fan-out+merge: the handler on every rank, then the merge."""
        md = self._methods[name]
        sharded = [isinstance(o, ShardedTensor) for o in operands]
        # storages the caller holds: a result that is one of them is copied,
        # not claimed for a rank
        held = {o.untyped_storage().data_ptr() for o, s in
                zip(operands, sharded) if not s and isinstance(o, torch.Tensor)}
        results = []
        for r in range(self.mesh.size):
            args = [o.row(r) if s else o for o, s in zip(operands, sharded)]
            out = md.handler(r, *args) if md.takes_index else md.handler(*args)
            out = torch.as_tensor(out, device=self.mesh.device(r))
            if out.untyped_storage().data_ptr() in held:
                out = self.mesh.device_put(out, r)
            results.append(self.mesh.own(out, r))
        y = ShardedTensor(results, self.mesh)
        if md.merge == MERGE_SUM:
            return self.coll.all_reduce(y)
        if md.merge == MERGE_GATHER:
            return self.coll.all_gather(y)
        if md.merge == MERGE_CONCAT:
            return self.coll.all_gather(y).flatten(0, 1)
        return y                    # MERGE_NONE: keep sharded rows
