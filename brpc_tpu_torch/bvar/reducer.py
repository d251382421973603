"""Reducers: write-local, read-combine variables.

Reference: src/bvar/reducer.h, detail/agent_group.h and detail/combiner.h,
ported from :mod:`brpc_tpu.bvar.reducer`.  Each writing thread gets a
private *agent*, so writes are uncontended; a read combines every agent's
value with the reducer's operator.  Python threads writing one shared int
would race on the read-modify-write despite the GIL, so each agent keeps
its own lock.
"""
from __future__ import annotations

import threading
from typing import Callable, Generic, List, Optional, TypeVar

from .variable import Variable

T = TypeVar("T")


class _Agent:
    __slots__ = ("value", "lock")

    def __init__(self, identity):
        self.value = identity
        self.lock = threading.Lock()


class Reducer(Variable, Generic[T]):
    def __init__(self, identity: T, op: Callable[[T, T], T],
                 inv_op: Optional[Callable[[T, T], T]] = None,
                 name: Optional[str] = None):
        self._identity = identity
        self._op = op
        self._inv_op = inv_op           # lets a Window sample by subtraction
        self._agents: List[_Agent] = []
        self._agents_lock = threading.Lock()
        self._tls = threading.local()
        super().__init__(name)

    def _agent(self, lock=None) -> _Agent:
        """This thread's agent, created on first use.  ``lock``, when
        given, becomes the new agent's lock before the agent is published
        to readers: LatencyRecorder's five per-thread agents share one
        lock, so a record is one acquisition.  An agent that already
        exists keeps its own lock (the caller sees the mismatch)."""
        a = getattr(self._tls, "agent", None)
        if a is None:
            a = _Agent(self._identity)
            if lock is not None:
                a.lock = lock
            self._tls.agent = a
            with self._agents_lock:
                self._agents.append(a)
        return a

    def __lshift__(self, value: T) -> "Reducer[T]":
        a = self._agent()
        with a.lock:
            a.value = self._op(a.value, value)
        return self

    def add(self, value: T) -> None:
        self.__lshift__(value)

    def get_value(self) -> T:
        result = self._identity
        with self._agents_lock:
            agents = list(self._agents)
        for a in agents:
            with a.lock:
                result = self._op(result, a.value)
        return result

    def reset(self) -> T:
        """Combine and clear; returns the combined value."""
        result = self._identity
        with self._agents_lock:
            agents = list(self._agents)
        for a in agents:
            with a.lock:
                result = self._op(result, a.value)
                a.value = self._identity
        return result

    @property
    def op(self):
        return self._op

    @property
    def inv_op(self):
        return self._inv_op


class Adder(Reducer):
    """A sum: ``a << v`` adds ``v``."""

    def __init__(self, name: Optional[str] = None, identity=0):
        super().__init__(identity, lambda a, b: a + b, lambda a, b: a - b,
                         name)

    def __lshift__(self, value) -> "Adder":
        # the op and this thread's agent inlined: counters sit on every
        # request's path
        try:
            a = self._tls.agent
        except AttributeError:
            a = self._agent()
        with a.lock:
            a.value += value
        return self

    def increment(self) -> None:
        self << 1

    def decrement(self) -> None:
        self << -1


class Maxer(Reducer):
    def __init__(self, name: Optional[str] = None):
        super().__init__(float("-inf"), max, None, name)

    def get_value(self):
        v = super().get_value()
        return 0 if v == float("-inf") else v


class Miner(Reducer):
    def __init__(self, name: Optional[str] = None):
        super().__init__(float("inf"), min, None, name)

    def get_value(self):
        v = super().get_value()
        return 0 if v == float("inf") else v
