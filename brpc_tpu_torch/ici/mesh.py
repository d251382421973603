"""IciMesh: the logical ranks underlying the ici:// transport.

The JAX package's mesh is a list of devices: ``ici://k`` is device k and
an array's device names its endpoint.  Here the mesh is ``ranks`` logical
ranks placed on the visible devices — rank k lives on
``cuda:(k % torch.cuda.device_count())``, or on ``cpu`` for a host mesh.
On one card all ranks report ``cuda:0``, so a tensor's ``device`` does not
name its rank.  The mesh therefore keeps an explicit **residency
registry**: ``device_put(t, k)`` (the ``jax.device_put(arr,
mesh.device(k))`` counterpart) returns a tensor owned by rank k, and
``rank_of(t)`` reads it back.

The registry is keyed on the tensor's underlying storage, so a view or a
slice of a registered tensor resolves to the same rank (the transport
slices IOBuf refs at any offset), and an entry is dropped when its storage
dies — a later allocation at the same address is never mistaken for it.

Sharded and replicated values (the collectives' layouts).  Because
ownership is per storage, the rows of one ``(n, *chunk)`` tensor cannot
belong to n ranks.  A JAX array sharded one row per device
(``PartitionSpec(axis)``) is therefore a :class:`ShardedTensor`: n row
tensors, row r a tensor of its own owned by rank r, so a row sent as an
RPC attachment leaves from the right rank.  A replicated JAX array
(``PartitionSpec()``) is one plain tensor on the mesh's card,
``mesh.device(0)``, owned by no rank.
"""
from __future__ import annotations

import threading
import weakref
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch

from ..butil.endpoint import EndPoint, SCHEME_ICI


class IciMesh:
    _default: Optional["IciMesh"] = None
    _lock = threading.Lock()
    # bumped whenever the default mesh is (re)bound: consumers caching
    # mesh-relative facts key their entries on this and recompute after
    # a swap
    generation: int = 0

    def __init__(self, ranks: int = 8, device: Optional[str] = None):
        kind = torch.device(device if device is not None else "cuda").type
        if kind == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "IciMesh: CUDA is not available; pass device='cpu' to "
                    "build a host mesh explicitly")
            n = torch.cuda.device_count()
            self.devices: List[torch.device] = [
                torch.device("cuda", k % n) for k in range(ranks)]
        elif kind == "cpu":
            self.devices = [torch.device("cpu")] * ranks
        else:
            raise ValueError(f"IciMesh: unsupported device type {kind!r}")
        self.device_type = kind
        self.size = ranks
        # (device, storage address) -> (rank, storage weakref)
        self._residency: Dict[Tuple[str, int], Tuple[int, weakref.ref]] = {}
        self._res_lock = threading.Lock()

    @classmethod
    def default(cls) -> "IciMesh":
        with cls._lock:
            if cls._default is None:
                cls._default = IciMesh()
            return cls._default

    @classmethod
    def set_default(cls, mesh: Optional["IciMesh"]) -> None:
        with cls._lock:
            cls._default = mesh
            cls.generation += 1

    # ---- endpoints -----------------------------------------------------
    def endpoint(self, rank: int) -> EndPoint:
        return EndPoint(scheme=SCHEME_ICI, coords=(rank,))

    def endpoints(self) -> List[EndPoint]:
        return [self.endpoint(i) for i in range(self.size)]

    def device(self, rank: int) -> torch.device:
        return self.devices[rank % self.size]

    def process_block(self, process_id: int, num_processes: int) -> range:
        """The ranks process ``process_id`` of ``num_processes`` owns in a
        multi-process fabric by default: a contiguous block, the same
        answer in every process (the JAX package's ``devices[k].
        process_index``).  The fabric publishes the block it serves."""
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process {process_id} outside "
                             f"{num_processes}")
        per = -(-self.size // num_processes)
        return range(min(process_id * per, self.size),
                     min((process_id + 1) * per, self.size))

    # ---- topology ------------------------------------------------------
    def ring_perm(self, shift: int = 1) -> List[Tuple[int, int]]:
        """Source→dest pairs rotating the ring by ``shift`` hops."""
        n = self.size
        return [(i, (i + shift) % n) for i in range(n)]

    def neighbors(self, rank: int) -> List[int]:
        n = self.size
        if n == 1:
            return [0]
        return sorted({(rank - 1) % n, (rank + 1) % n})

    # ---- residency -----------------------------------------------------
    @staticmethod
    def _key(t: torch.Tensor) -> Tuple[str, int]:
        return (str(t.device), t.untyped_storage().data_ptr())

    def register(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """Record that ``t`` (and every view of its storage) is owned by
        ``rank``; returns ``t``."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        if t.device != self.device(rank):
            raise ValueError(f"rank {rank} lives on {self.device(rank)}, "
                             f"not {t.device}")
        storage = t.untyped_storage()
        key = self._key(t)
        ref = weakref.ref(storage)
        with self._res_lock:
            self._residency[key] = (rank, ref)
        weakref.finalize(storage, self._forget, key, ref)
        return t

    def _forget(self, key: Tuple[str, int], ref: weakref.ref) -> None:
        with self._res_lock:
            entry = self._residency.get(key)
            if entry is not None and entry[1] is ref:
                del self._residency[key]

    def rank_of(self, t: torch.Tensor) -> int:
        """Logical rank owning ``t``'s storage; -1 when off-mesh."""
        with self._res_lock:
            entry = self._residency.get(self._key(t))
        if entry is None or entry[1]() is None:
            return -1
        return entry[0]

    def device_put(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """A tensor owned by ``rank`` holding ``t``'s values: ``t`` itself
        when that rank already owns it, else a fresh copy.  The copy never
        aliases ``t`` — the detach rule for host buffers that other code
        may free or reuse."""
        if self.rank_of(t) == rank:
            return t
        out = torch.empty(t.shape, dtype=t.dtype, device=self.device(rank))
        out.copy_(t)
        return self.register(out, rank)

    def own(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """``t`` owned by ``rank``, copied only where it must be: ``t``
        itself when ``rank`` owns it already, ``t`` registered to ``rank``
        when no rank owns it and it lies on ``rank``'s device, else a copy
        (:meth:`device_put`).  For results that nobody else holds — a
        fresh tensor or a view of one: registering claims the storage."""
        owner = self.rank_of(t)
        if owner == rank:
            return t
        if owner == -1 and t.device == self.device(rank):
            return self.register(t, rank)
        return self.device_put(t, rank)

    def live_registrations(self) -> int:
        with self._res_lock:
            return len(self._residency)


class ShardedTensor:
    """An ``(n, *chunk)`` value held one row per rank of ``mesh``: row r is
    a tensor of its own, owned by rank r (the JAX ``PartitionSpec(axis)``
    layout).  Iterating yields the rows, as iterating the stacked tensor
    would."""

    __slots__ = ("rows", "mesh")

    def __init__(self, rows: Sequence[torch.Tensor], mesh: IciMesh):
        rows = list(rows)
        if len(rows) != mesh.size:
            raise ValueError(f"ShardedTensor: {len(rows)} rows for a mesh "
                             f"of {mesh.size}")
        first = rows[0]
        for r, row in enumerate(rows):
            if not isinstance(row, torch.Tensor):
                raise TypeError(f"ShardedTensor: row {r} is not a tensor")
            if row.shape != first.shape or row.dtype != first.dtype:
                raise ValueError(
                    f"ShardedTensor: row {r} is {row.dtype}{tuple(row.shape)}"
                    f", row 0 {first.dtype}{tuple(first.shape)}")
            if mesh.rank_of(row) != r:
                raise ValueError(f"ShardedTensor: row {r} is owned by rank "
                                 f"{mesh.rank_of(row)}")
        self.rows: List[torch.Tensor] = rows
        self.mesh = mesh

    @classmethod
    def adopt(cls, rows: Sequence[torch.Tensor],
              mesh: IciMesh) -> "ShardedTensor":
        """Rows that nobody else holds (fresh results, or views of a row
        of the same rank), each made owned by its rank (:meth:`IciMesh.own`)."""
        return cls([mesh.own(t, r) for r, t in enumerate(rows)], mesh)

    @property
    def shape(self) -> torch.Size:
        return torch.Size((len(self.rows),) + tuple(self.rows[0].shape))

    @property
    def dtype(self) -> torch.dtype:
        return self.rows[0].dtype

    @property
    def device(self) -> torch.device:
        """Row 0's device: every row's on a mesh of one card."""
        return self.rows[0].device

    def row(self, r: int) -> torch.Tensor:
        return self.rows[r]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "ShardedTensor":
        """``fn`` applied to every row; each result must be new or a view
        of its row (see :meth:`adopt`)."""
        return ShardedTensor.adopt([fn(t) for t in self.rows], self.mesh)

    def stack(self) -> torch.Tensor:
        """One ``(n, *chunk)`` tensor on row 0's device (for tests and
        ``.cpu().numpy()``)."""
        return torch.stack([t.to(self.device) for t in self.rows])

    def __iter__(self) -> Iterator[torch.Tensor]:
        return iter(self.rows)
