"""``tests/test_serving.py``'s KV pool classes on both packages
(``tests/torch_mirror.py``): ``TestPagedKvPool``, ``TestKvZeroCopyHandoff``,
``TestKvPrefixSharing``, ``TestKvTiers`` and ``TestCustodyRegressions``.
The scheduler, migration and service classes are in
``tests/test_torch_twin_serving_step.py``; the swaps are listed in
``tests/torch_serving_swaps.py``.

Left out of the port's copy, each because the JAX pool's host store is
a numpy array that the case reads or writes with numpy's own API, where
the port's store is a torch tensor on the pool's device (the card, or
the CPU here):
- ``TestKvZeroCopyHandoff::test_snapshot_view_and_straddle_copy`` and
  ``TestKvPrefixSharing::test_readonly_view_over_shared_blocks``: a view's
  ``rows.flags.writeable`` and ``np.shares_memory(rows, pool._store)``
  (a tensor has no write flag);
- ``TestKvPrefixSharing::test_cow_divergence_mid_block_and_write_split``:
  ``materialize(...).sum(dtype=np.int64)``, numpy's reduction spelling;
- ``TestKvPrefixSharing::test_load_and_load_into_parity_both_disciplines``,
  ``test_concurrent_fill_no_longer_serializes``,
  ``test_commit_race_last_commit_wins_and_pinned_abort`` and
  ``test_pin_during_reload_fill_window_aborts_commit``: the fill callback
  assigns a numpy array into the pool's fill views (``v[:] = rows``),
  which torch refuses for a tensor.  ``tests/test_torch_kv_flags.py``
  holds the first two contracts on the port with tensor fills; the
  last two are held below on both packages, the fill copying the rows
  in each package's own way (``test_commit_race_on_both_packages``,
  ``test_pin_during_reload_on_both_packages``).

The snapshot view's and the CoW split's contracts are held below on both
packages too, with each package's spelling of "shares the store's
memory" and "the sum as int64" (``test_snapshot_view_on_both_packages``,
``test_cow_divergence_on_both_packages``); only the JAX view carries a
write flag to assert (the port's docstring says a caller must not write
through a view).
"""
from __future__ import annotations

import sys
import threading

import numpy as np
import pytest
import torch

from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)
from tests.torch_serving_swaps import SWAPS

torch_mirror.mirror(
    "tests/test_serving.py", globals(), swaps=SWAPS, cpu_mesh=True,
    names=["TestPagedKvPool", "TestKvZeroCopyHandoff", "TestKvPrefixSharing",
           "TestKvTiers", "TestCustodyRegressions"])

# the numpy host store's API (above)
for _cls, _case in (
        (TestKvZeroCopyHandoffPort,  # noqa: F821
         "test_snapshot_view_and_straddle_copy"),
        (TestKvPrefixSharingPort,  # noqa: F821
         "test_readonly_view_over_shared_blocks"),
        (TestKvPrefixSharingPort,  # noqa: F821
         "test_cow_divergence_mid_block_and_write_split"),
        (TestKvPrefixSharingPort,  # noqa: F821
         "test_load_and_load_into_parity_both_disciplines"),
        (TestKvPrefixSharingPort,  # noqa: F821
         "test_concurrent_fill_no_longer_serializes"),
        (TestKvPrefixSharingPort,  # noqa: F821
         "test_commit_race_last_commit_wins_and_pinned_abort"),
        (TestKvPrefixSharingPort,  # noqa: F821
         "test_pin_during_reload_fill_window_aborts_commit")):
    setattr(_cls, _case, None)


@pytest.fixture(params=["jax", "port"])
def copy(request):
    """The left-out fill cases' copy: the JAX package's copy, its pool
    helpers and its ``SessionBusy``, and a fill that copies numpy rows
    into that package's views."""
    mod = sys.modules[f"tests._mirror_{request.param}_test_serving"]
    busy = __import__(mod._mirror_package + ".serving",
                      fromlist=["SessionBusy"]).SessionBusy

    def put(view, rows):
        if isinstance(view, torch.Tensor):
            view.copy_(torch.from_numpy(np.ascontiguousarray(rows)))
        else:
            view[:] = rows
    return mod, busy, put


def _slow_fill(mod, put, tokens, in_fill, unblock):
    def fill(views):
        rows = mod._rows(tokens)
        off = 0
        for v in views:
            put(v, rows[off:off + v.shape[0]])
            off += v.shape[0]
        in_fill.set()
        assert unblock.wait(10)
    return fill


def test_commit_race_on_both_packages(copy):
    """``test_commit_race_last_commit_wins_and_pinned_abort``'s contract:
    two loaders race one session id across the fill window; the later
    commit wins over an unpinned incumbent, a pinned incumbent aborts the
    late fill with SessionBusy, the loser's blocks come back either
    way."""
    mod, busy, put = copy
    pool = mod._mk_pool(num_blocks=32, block_tokens=8)
    toks_slow = [(3 * j + 2) % 499 for j in range(12)]
    toks_fast = [(9 * j + 4) % 499 for j in range(12)]
    try:
        for pinned in (False, True):
            in_fill, unblock, result = threading.Event(), threading.Event(), {}

            def racer():
                try:
                    pool.load_into("s", len(toks_slow), _slow_fill(
                        mod, put, toks_slow, in_fill, unblock),
                        last_token=toks_slow[-1])
                    result["ok"] = True
                except busy:
                    result["busy"] = True

            races0 = pool.commit_races.get_value()
            t = threading.Thread(target=racer)
            t.start()
            assert in_fill.wait(10)
            pool.load("s", mod._rows(toks_fast), last_token=toks_fast[-1])
            if pinned:
                assert pool.pin("s")
            free_before = len(pool._free)
            unblock.set()
            t.join(10)
            assert pool.commit_races.get_value() == races0 + 1
            want = toks_fast if pinned else toks_slow
            assert result == ({"busy": True} if pinned else {"ok": True})
            assert np.array_equal(np.asarray(pool.materialize("s")),
                                  mod._rows(want))
            if pinned:
                pool.unpin("s")
            assert len(pool._free) == free_before + 2
            pool.release("s")
        assert len(pool._free) == 32 and not pool._refs
    finally:
        pool.close()


def test_pin_during_reload_on_both_packages(copy):
    """``test_pin_during_reload_fill_window_aborts_commit``'s contract: a
    reload whose old entry is pinned during the fill window aborts at
    commit with SessionBusy, the old bytes stay, the reservation returns
    clean, and no two-loader race is counted."""
    mod, busy, put = copy
    pool = mod._mk_pool(num_blocks=32, block_tokens=8)
    toks_old = [(3 * j + 2) % 499 for j in range(12)]
    toks_new = [(9 * j + 4) % 499 for j in range(12)]
    in_fill, unblock, result = threading.Event(), threading.Event(), {}
    try:
        pool.load("s", mod._rows(toks_old), last_token=toks_old[-1])

        def reloader():
            try:
                pool.load_into("s", len(toks_new), _slow_fill(
                    mod, put, toks_new, in_fill, unblock),
                    last_token=toks_new[-1])
                result["ok"] = True
            except busy:
                result["busy"] = True

        t = threading.Thread(target=reloader)
        t.start()
        assert in_fill.wait(10)
        assert pool.pin("s")
        races0 = pool.commit_races.get_value()
        free_before = len(pool._free)
        unblock.set()
        t.join(10)
        assert result == {"busy": True}
        assert pool.commit_races.get_value() == races0
        assert np.array_equal(np.asarray(pool.materialize("s")),
                              mod._rows(toks_old))
        assert len(pool._free) == free_before + 2
        pool.unpin("s")
        pool.release("s")
        assert len(pool._free) == 32 and not pool._refs
    finally:
        unblock.set()
        pool.close()


def _shares_store(rows, pool) -> bool:
    if isinstance(rows, torch.Tensor):
        base = pool._store.untyped_storage().data_ptr()
        ptr = rows.untyped_storage().data_ptr()
        return base == ptr
    return np.shares_memory(rows, pool._store)


def test_snapshot_view_on_both_packages(copy):
    """``test_snapshot_view_and_straddle_copy``'s contract: a contiguous
    session snapshots as a zero-copy view, pinned until unpin (a release
    meanwhile is deferred to the last unpin); a non-contiguous one is a
    copy and owes no pin; the 3-tuple surface and materialize copy."""
    mod, _busy, _put = copy
    pool = mod._mk_pool(num_blocks=4, block_tokens=8)
    try:
        t = [3] * 16
        pool.load("v", mod._rows(t), last_token=3)
        rows, _seq, _last, is_view = pool.snapshot("v", view=True)
        assert is_view and _shares_store(rows, pool)
        if isinstance(rows, np.ndarray):
            assert not rows.flags.writeable
        assert np.array_equal(np.asarray(rows), mod._rows(t))
        assert pool.expire_idle(now=pool._now() + 1e9) == 0
        assert pool.release("v") is True
        assert pool.get("v") is not None
        pool.unpin("v")
        assert pool.get("v") is None
        assert pool.release("v") is False
        for k in (1, 2, 3):
            pool.load(f"f{k}", mod._rows([k] * 8), last_token=k)
        pool.release("f2")
        pool.release("f1")
        pool.load("nc", mod._rows([4] * 24), last_token=4)
        rows, _seq, _last, is_view = pool.snapshot("nc", view=True)
        assert not is_view and not _shares_store(rows, pool)
        assert np.array_equal(np.asarray(rows), mod._rows([4] * 24))
        assert pool.release("nc") is True
        pool.load("old", mod._rows(t), last_token=3)
        assert len(pool.snapshot("old")) == 3
        assert not _shares_store(pool.materialize("old"), pool)
    finally:
        pool.close()


def test_cow_divergence_on_both_packages(copy):
    """``test_cow_divergence_mid_block_and_write_split``'s contract:
    sessions diverging mid-block share the full prefix block only; an
    in-place write into a shared block splits it, the co-owners' bytes
    stay, and the reduction arena follows the write."""
    mod, _busy, _put = copy
    pool = mod._mk_pool(num_blocks=16, block_tokens=8)
    try:
        pre = [(5 * j) % 499 for j in range(8)]
        ta, tb = pre + [7, 8, 9, 10], pre + [7, 8, 99, 10]
        a = pool.load("a", mod._rows(ta), last_token=ta[-1])
        b = pool.load("b", mod._rows(tb), last_token=tb[-1])
        assert int(a.blocks[0]) == int(b.blocks[0])
        assert int(a.blocks[1]) != int(b.blocks[1])
        c = pool.load("c", mod._rows(pre), last_token=pre[-1])
        assert int(c.blocks[0]) == int(a.blocks[0])
        splits0 = pool.cow_splits.get_value()
        new_row = np.full((1, pool.options.bytes_per_token), 7, np.uint8)
        if mod._mirror_package == "brpc_tpu_torch":
            new_row = torch.from_numpy(new_row)
        assert pool.write_rows("b", 0, new_row) == 1
        assert pool.cow_splits.get_value() == splits0 + 1
        assert int(pool.get("b").blocks[0]) != int(a.blocks[0])
        assert np.array_equal(np.asarray(pool.materialize("a")),
                              mod._rows(ta))
        assert np.array_equal(np.asarray(pool.materialize("c")),
                              mod._rows(pre))
        got = np.asarray(pool.materialize("b"))
        assert np.array_equal(got[0], np.asarray(new_row)[0])
        assert np.array_equal(got[1:], mod._rows(tb)[1:])
        assert pool.get("b").acc == int(got.sum(dtype=np.int64))
    finally:
        pool.close()
