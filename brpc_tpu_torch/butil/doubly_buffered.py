"""DoublyBufferedData: read-mostly hot data with uncontended reads.

Reference: src/butil/containers/doubly_buffered_data.h:37-56.  Readers grab a
*thread-local* mutex (never contended in steady state) and read the
foreground copy; writers modify the background copy, flip the index, then
acquire every thread-local mutex once to make sure no reader still sees the
old foreground, and apply the change again.  Load-balancer server lists and
SocketMap use this so the RPC hot path never blocks on membership changes.

The Python GIL would let us cheat, but we keep the real algorithm: it is what
makes ``read()`` safe against torn in-place mutation and it documents the
concurrency contract of the reference.  Port of
:mod:`brpc_tpu.butil.doubly_buffered`.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Generic, List, TypeVar

T = TypeVar("T")


class DoublyBufferedData(Generic[T]):
    def __init__(self, factory: Callable[[], T]):
        self._data = [factory(), factory()]
        self._index = 0                      # foreground index
        self._modify_lock = threading.Lock()  # serialize writers
        self._wrappers_lock = threading.Lock()
        self._wrappers: List["_Wrapper"] = []
        self._tls = threading.local()

    def _wrapper(self) -> "_Wrapper":
        w = getattr(self._tls, "w", None)
        if w is None:
            w = _Wrapper()
            self._tls.w = w
            with self._wrappers_lock:
                self._wrappers.append(w)
        return w

    def read(self) -> "ScopedPtr[T]":
        w = self._wrapper()
        w.lock.acquire()
        return ScopedPtr(self._data[self._index], w)

    def modify(self, fn: Callable[[T], Any]) -> Any:
        """fn is applied to the background copy, the buffers are flipped, and
        fn is applied to the (old-foreground) copy after all readers left."""
        with self._modify_lock:
            bg = 1 - self._index
            ret = fn(self._data[bg])
            self._index = bg
            with self._wrappers_lock:
                wrappers = list(self._wrappers)
            for w in wrappers:      # wait out readers of the old foreground
                w.lock.acquire()
                w.lock.release()
            fn(self._data[1 - self._index])
            return ret


class _Wrapper:
    __slots__ = ("lock",)

    def __init__(self):
        self.lock = threading.Lock()


class ScopedPtr(Generic[T]):
    """Context manager holding the per-thread read lock."""
    __slots__ = ("_value", "_w")

    def __init__(self, value: T, w: _Wrapper):
        self._value = value
        self._w = w

    def __enter__(self) -> T:
        return self._value

    def __exit__(self, *exc) -> None:
        self._w.lock.release()

    def get(self) -> T:
        return self._value

    def done(self) -> None:
        self._w.lock.release()
