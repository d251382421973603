"""The KV handoff's last leg: the prefill attachment's bytes land DIRECTLY
in :class:`~.kv_pool.PagedKvPool` blocks.

Port of :mod:`brpc_tpu.serving.kv_source` (``wire_source`` and
``load_wire_attachment``) for DEVICE and HOST blocks.  The wire segments
are wrapped as views and scattered straight into the blocks
``PagedKvPool.load_into`` reserves — every payload byte is copied once:

  * **adopted** — host-byte segments (HOST/USER blocks) read in place;
  * **scattered** — DEVICE segments: the tensor the device plane's
    ``p2p_copy`` wrote at the decode rank.  The fill is one strided copy
    per extent of reserved blocks, layer-major wire ``(layers, seq,
    dmodel)`` to token-major rows, on the device.  It is ordered after the
    plane's copy by a stream wait (:meth:`DevicePlane.order_after_copies`),
    never by a host sync.

Segment boundaries need not align with pool block, token or layer
boundaries: the general path walks (extent × layer) destination slices
through the segment list.  Per-route truth rides
``serving_kv_load_{adopted,scattered,materialized}`` Adders plus
``serving_kv_load_copy_bytes`` (copy passes × payload bytes).
:func:`load_token_major_attachment` is the same path for a live
migration's token-major payload.  The shared-memory ring claims and
native attachment handles of the reference are not ported yet.
"""
from __future__ import annotations

import bisect
import threading
import warnings
from typing import Dict, List, Optional

import torch

from .. import bvar
from ..butil.iobuf import DEVICE, IOBuf

ADOPTED = "adopted"
SCATTERED = "scattered"
MATERIALIZED = "materialized"


class _KvLoadStats:
    """Which path carried each session's bytes and how many copy passes
    they paid, for every KV load in the process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._route_bytes: Dict[str, int] = {}
        self.adopted = bvar.Adder("serving_kv_load_adopted")
        self.scattered = bvar.Adder("serving_kv_load_scattered")
        self.materialized = bvar.Adder("serving_kv_load_materialized")
        self.copy_bytes = bvar.Adder("serving_kv_load_copy_bytes")

    def record(self, route: str, payload_bytes: int,
               copy_passes: int) -> None:
        {ADOPTED: self.adopted, SCATTERED: self.scattered,
         MATERIALIZED: self.materialized}[route] << 1
        self.copy_bytes << payload_bytes * copy_passes
        with self._lock:
            self._route_bytes[route] = \
                self._route_bytes.get(route, 0) + payload_bytes

    def snapshot(self) -> dict:
        with self._lock:
            by_route = dict(self._route_bytes)
        return {
            "adopted": self.adopted.get_value(),
            "scattered": self.scattered.get_value(),
            "materialized": self.materialized.get_value(),
            "copy_bytes": self.copy_bytes.get_value(),
            "payload_bytes_by_route": by_route,
        }


stats = _KvLoadStats()


def kv_load_stats() -> dict:
    """{route: loads, copy_bytes, payload_bytes_by_route}."""
    return stats.snapshot()


def _write_flat(dest: torch.Tensor, off: int, chunk: torch.Tensor) -> None:
    """Write a contiguous 1-D ``chunk`` into the strided 2-D ``dest``
    starting at row-major flat offset ``off``: head partial row, the
    middle as whole rows, tail partial row."""
    ncols = dest.shape[1]
    n = chunk.shape[0]
    i = 0
    r, c = divmod(off, ncols)
    if c:
        take = min(ncols - c, n)
        dest[r, c:c + take].copy_(chunk[:take])
        i = take
        r += 1
    full = (n - i) // ncols
    if full:
        dest[r:r + full].copy_(chunk[i:i + full * ncols].view(full, ncols))
        i += full * ncols
        r += full
    if i < n:
        dest[r, :n - i].copy_(chunk[i:])


class WireKvSource:
    """One LoadKv payload as ordered uint8 views over the wire segments,
    plus the ``fill`` that scatters the layer-major wire layout ``(layers,
    seq_len, dmodel)`` into the pool's token-major block views.
    Single-use: ``fill`` once, then :meth:`release`; a ``fill`` after
    release raises."""

    __slots__ = ("route", "layers", "seq_len", "dmodel", "_segs",
                 "_starts")

    def __init__(self, segments: List[torch.Tensor], route: str,
                 layers: int, seq_len: int, dmodel: int):
        self.route = route
        self.layers = layers
        self.seq_len = seq_len
        self.dmodel = dmodel
        self._segs = segments
        starts = [0]
        for s in segments:
            starts.append(starts[-1] + s.shape[0])
        self._starts = starts

    @property
    def total(self) -> int:
        return self._starts[-1]

    def fill(self, views: List[torch.Tensor]) -> None:
        """The ``PagedKvPool.load_into`` fill callback (runs outside the
        pool lock; it only writes the reserved views)."""
        if not self._segs:
            raise RuntimeError(
                "WireKvSource.fill after release(): sources are "
                "single-use — build a fresh source per load")
        dev = views[0].device
        if dev.type == "cuda":
            from ..ici.device_plane import plane
            plane().order_after_copies(dev)
            cur = torch.cuda.current_stream(dev)
            for seg in self._segs:
                if seg.is_cuda:
                    # the segment's memory must outlive this stream's use
                    seg.record_stream(cur)
        L, D = self.layers, self.dmodel
        if len(self._segs) == 1:
            wire = self._segs[0].view(L, self.seq_len, D)
            t0 = 0
            for v in views:
                n = v.shape[0]
                # one strided copy per extent: wire (L, n, D) slab →
                # token-major (n, L, D) rows
                v.view(n, L, D).copy_(wire[:, t0:t0 + n, :].permute(1, 0, 2))
                t0 += n
            return
        t0 = 0
        for v in views:
            n = v.shape[0]
            for layer in range(L):
                self._copy_rows(layer, t0, n,
                                v[:, layer * D:(layer + 1) * D])
            t0 += n

    def _copy_rows(self, layer: int, t0: int, n: int,
                   dest: torch.Tensor) -> None:
        """Copy layer ``layer``'s bytes for tokens [t0, t0+n) into the
        strided (n, dmodel) dest, walking the segment list."""
        D = self.dmodel
        pos = (layer * self.seq_len + t0) * D
        need = n * D
        i = bisect.bisect_right(self._starts, pos) - 1
        off = 0
        while need > 0:
            seg = self._segs[i]
            a = pos + off - self._starts[i]
            take = min(seg.shape[0] - a, need)
            _write_flat(dest, off, seg[a:a + take])
            off += take
            need -= take
            i += 1

    def release(self) -> None:
        """Drop the segment views NOW, so the device tensors free at a
        deterministic point instead of a later GC."""
        self._segs = []
        self._starts = [0]


def wire_source(att: IOBuf, layers: int, seq_len: int,
                dmodel: int) -> WireKvSource:
    """Build the scatter source for one LoadKv attachment: one view per
    backing block — DEVICE blocks as slices of their tensors (route
    SCATTERED), HOST/USER blocks as tensors over their bytes (route
    ADOPTED)."""
    segs = []
    dev = False
    for i in range(att.backing_block_num()):
        r = att.backing_block(i)
        b = r.block
        if b.kind == DEVICE:
            # DEVICE blocks are flat uint8, so ref offset/length index
            # bytes; a slice is a view
            dev = True
            seg = b.data[r.offset:r.offset + r.length]
        else:
            with warnings.catch_warnings():
                # a USER block may wrap immutable bytes: the view is
                # only read
                warnings.simplefilter("ignore", UserWarning)
                seg = torch.frombuffer(b.data, dtype=torch.uint8,
                                       offset=r.offset, count=r.length)
        segs.append(seg)
    return WireKvSource(segs, SCATTERED if dev else ADOPTED,
                        layers, seq_len, dmodel)


def load_wire_attachment(pool, att: IOBuf, session: str, seq_len: int,
                         layers: int, dmodel: int, *, last_token: int,
                         tenant: str = "",
                         priority: Optional[int] = None):
    """The whole handoff in one call: build the source, let the pool
    reserve-and-fill (the fill outside the pool lock), record the route,
    and release the segment views whether the load committed or aborted.
    Pool refusals (PoolSaturated / SessionBusy) propagate for the RPC
    layer's shed mapping."""
    src = wire_source(att, layers, seq_len, dmodel)
    try:
        want = seq_len * layers * dmodel
        if src.total != want:
            raise ValueError(
                f"kv wire segments hold {src.total} bytes, "
                f"descriptor said {want}")
        s = pool.load_into(session, seq_len, src.fill,
                           last_token=last_token, tenant=tenant,
                           priority=priority)
    finally:
        src.release()
    stats.record(src.route, seq_len * layers * dmodel, 1)
    return s


def load_token_major_attachment(pool, att: IOBuf, session: str,
                                seq_len: int, *, last_token: int,
                                tenant: str = "",
                                priority: Optional[int] = None):
    """The KV migration ingest: the payload is already token-major
    ``(seq_len, bytes_per_token)``, the source pool's row layout, so there
    is no layer transpose to undo.  Declaring ``layers=1`` with
    ``dmodel=bytes_per_token`` makes the wire layout the pool's block rows
    and the fill one strided copy per extent (after a stream wait on the
    plane); everything else is :func:`load_wire_attachment`."""
    return load_wire_attachment(
        pool, att, session, seq_len, 1, pool.options.bytes_per_token,
        last_token=last_token, tenant=tenant, priority=priority)
