"""bthread_id: lockable, versioned correlation handles.

Reference: src/bthread/id.{h,cpp} (bthread_id_create_ranged id.h:56,
bthread_id_lock_and_reset_range id.h:106).  A correlation id represents one
in-flight RPC across retries: the id covers a *range* of versions, one per
try; locking serializes everyone touching the RPC state (response arrival,
timeout, backup trigger); a response carrying a stale try's version fails to
lock and is ignored — that single mechanism resolves every
timeout/retry/late-response race in the client (SURVEY.md §3.3).

Semantics kept: create_ranged / lock (blocking, version-checked) / unlock /
unlock_and_destroy / error (lock + on_error callback) / reset_version
(start try k, staling older versions).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional, Tuple

from ..butil.resource_pool import ResourcePool

EINVAL = 22
EPERM = 1

# on_error(data, cid, error_code) -> None; MUST unlock or destroy cid.
OnError = Callable[[Any, int, int], None]

_pool: ResourcePool = ResourcePool()


class _IdState:
    __slots__ = ("data", "on_error", "range", "cur_version", "locked",
                 "destroyed", "cond", "pending_errors")

    def __init__(self, data: Any, on_error: Optional[OnError], version_range: int):
        self.data = data
        self.on_error = on_error
        self.range = version_range
        self.cur_version = 0          # smallest still-valid try number
        self.locked = False
        self.destroyed = False
        self.cond = threading.Condition()
        self.pending_errors = []


def _split(cid: int) -> Tuple[int, int]:
    """cid = (rid, try_version) packed as rid in low 48, version in high 16."""
    return cid & 0xFFFFFFFFFFFF, (cid >> 48) & 0xFFFF


def _make_cid(rid: int, version: int) -> int:
    return (version << 48) | rid


def create(data: Any = None, on_error: Optional[OnError] = None) -> int:
    return create_ranged(data, on_error, 1)


def create_ranged(data: Any, on_error: Optional[OnError],
                  version_range: int) -> int:
    if version_range < 1 or version_range > 0xFFFF:
        raise ValueError("bad version range")
    st = _IdState(data, on_error, version_range)
    rid = _pool.get_resource(st)
    if rid > 0xFFFFFFFFFFFF:
        raise OverflowError("id space exhausted")
    return _make_cid(rid, 0)


def get_version(cid: int) -> int:
    return _split(cid)[1]


def with_version(cid: int, version: int) -> int:
    rid, _ = _split(cid)
    return _make_cid(rid, version)


def _state(cid: int) -> Optional[_IdState]:
    rid, _ = _split(cid)
    return _pool.address(rid)


def lock(cid: int, timeout: Optional[float] = None) -> Tuple[int, Any]:
    """Returns (0, data) on success; (EINVAL, None) if destroyed or the cid's
    try-version went stale."""
    st = _state(cid)
    if st is None:
        return EINVAL, None
    _, ver = _split(cid)
    with st.cond:
        while True:
            if st.destroyed or ver < st.cur_version or ver >= st.range:
                return EINVAL, None
            if not st.locked:
                st.locked = True
                return 0, st.data
            if not st.cond.wait(timeout):
                return EINVAL, None


def unlock(cid: int) -> int:
    st = _state(cid)
    if st is None:
        return EINVAL
    with st.cond:
        if not st.locked:
            return EPERM
        st.locked = False
        # deliver one queued error to its waiter, if any
        st.cond.notify_all()
    _drain_pending(st)
    return 0


def unlock_and_destroy(cid: int) -> int:
    rid, _ = _split(cid)
    st = _pool.address(rid)
    if st is None:
        return EINVAL
    with st.cond:
        st.destroyed = True
        st.locked = False
        st.cond.notify_all()
    _pool.return_resource(rid)
    return 0


def reset_version(cid: int, new_version: int) -> int:
    """Start try ``new_version``: older versions' responses become stale
    (reference bthread_id_lock_and_reset_range — caller holds the lock)."""
    st = _state(cid)
    if st is None:
        return EINVAL
    with st.cond:
        st.cur_version = new_version
    return 0


def is_live(cid: int) -> bool:
    """True while this exact cid version could still receive an event
    (used to prune completed ids from per-socket in-flight sets)."""
    st = _state(cid)
    if st is None:
        return False
    _, ver = _split(cid)
    with st.cond:
        return not st.destroyed and st.cur_version <= ver < st.range


def error(cid: int, error_code: int) -> int:
    """Lock the id and run on_error (the RPC completion/timeout entry point).
    If the id is currently locked, queue the error; the unlocker drains it."""
    st = _state(cid)
    if st is None:
        return EINVAL
    _, ver = _split(cid)
    with st.cond:
        if st.destroyed or ver < st.cur_version or ver >= st.range:
            return EINVAL
        if st.locked:
            st.pending_errors.append((cid, error_code))
            return 0
        st.locked = True
    _invoke_on_error(st, cid, error_code)
    return 0


def _invoke_on_error(st: _IdState, cid: int, error_code: int) -> None:
    if st.on_error is not None:
        st.on_error(st.data, cid, error_code)   # callee unlocks/destroys
    else:
        unlock_and_destroy(cid)


def _drain_pending(st: _IdState) -> None:
    while True:
        with st.cond:
            if st.destroyed or st.locked or not st.pending_errors:
                return
            cid, code = st.pending_errors.pop(0)
            _, ver = _split(cid)
            if ver < st.cur_version:
                continue            # stale try's error — drop
            st.locked = True
        _invoke_on_error(st, cid, code)


def join(cid: int, timeout: Optional[float] = None) -> int:
    """Wait until the id is destroyed (bthread_id_join): 0, or ETIMEDOUT
    (110)."""
    st = _state(cid)
    if st is None:
        return 0                    # already destroyed
    from . import scheduler
    scheduler.note_worker_blocked()
    try:
        with st.cond:
            done = st.cond.wait_for(lambda: st.destroyed, timeout)
    finally:
        scheduler.note_worker_unblocked()
    return 0 if done else 110
