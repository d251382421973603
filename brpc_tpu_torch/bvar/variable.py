"""bvar Variable base and the expose registry (reference:
src/bvar/variable.h:102-206), ported from :mod:`brpc_tpu.bvar.variable`.

A Variable is a named observable value, written often and read rarely.
``expose``/``hide`` manage its registration; ``dump_exposed`` renders every
(or a wildcard-filtered set of) variable for the /vars and /brpc_metrics
builtin pages.  The duplicate-name rule is the reference's: a second
variable exposed under a taken name is refused (``expose`` returns False)
and keeps counting unexposed, so two pools or servers of one process never
fight over a name.
"""
from __future__ import annotations

import fnmatch
import threading
from typing import Callable, Dict, List, Optional, Tuple

_registry: Dict[str, "Variable"] = {}
_registry_lock = threading.Lock()


class Variable:
    def __init__(self, name: Optional[str] = None):
        self._name: Optional[str] = None
        if name:
            self.expose(name)

    # value access -----------------------------------------------------
    def get_value(self):
        raise NotImplementedError

    def describe(self) -> str:
        v = self.get_value()
        if isinstance(v, float):
            return f"{v:.6g}"
        return str(v)

    # registry ---------------------------------------------------------
    @property
    def name(self) -> Optional[str]:
        return self._name

    def expose(self, name: str, prefix: str = "") -> bool:
        name = to_underscored_name((prefix + "_" if prefix else "") + name)
        with _registry_lock:
            if name in _registry and _registry[name] is not self:
                return False
            if self._name and self._name != name:
                _registry.pop(self._name, None)
            _registry[name] = self
            self._name = name
            return True

    def hide(self) -> bool:
        with _registry_lock:
            if self._name and _registry.get(self._name) is self:
                del _registry[self._name]
                self._name = None
                return True
            return False

    def __del__(self):
        try:
            self.hide()
        except Exception:
            pass


def to_underscored_name(name: str) -> str:
    """``"EchoService.Echo"`` → ``"echoservice_echo"``: alphanumerics
    lowered, every other run of characters one underscore, none at the
    ends (the reference's variable-name rule)."""
    out = []
    prev_underscore = False
    for ch in name:
        if ch.isalnum():
            out.append(ch.lower())
            prev_underscore = False
        elif not prev_underscore and out:
            out.append("_")
            prev_underscore = True
    return "".join(out).strip("_")


def find_exposed(name: str) -> Optional[Variable]:
    with _registry_lock:
        return _registry.get(name)


def list_exposed(wildcards: str = "") -> List[str]:
    with _registry_lock:
        names = sorted(_registry.keys())
    if not wildcards:
        return names
    pats = [w for w in wildcards.replace(";", ",").split(",") if w]
    return [n for n in names if any(fnmatch.fnmatch(n, p) for p in pats)]


def dump_exposed(wildcards: str = "") -> List[Tuple[str, str]]:
    out = []
    for n in list_exposed(wildcards):
        v = find_exposed(n)
        if v is not None:
            out.append((n, v.describe()))
    return out


def count_exposed() -> int:
    with _registry_lock:
        return len(_registry)


class Status(Variable):
    """A mutable single value (reference bvar::Status)."""

    def __init__(self, name: Optional[str] = None, value=0):
        self._value = value
        super().__init__(name)

    def set_value(self, v) -> None:
        self._value = v

    def get_value(self):
        return self._value


class PassiveStatus(Variable):
    """A value computed by a callback at read time (reference
    src/bvar/passive_status.h)."""

    def __init__(self, getter: Callable[[], object],
                 name: Optional[str] = None):
        self._getter = getter
        super().__init__(name)

    def get_value(self):
        return self._getter()


class GFlag(Variable):
    """A runtime flag exposed as a variable (reference bvar/gflag.h)."""

    def __init__(self, flag_name: str, name: Optional[str] = None):
        from ..butil import flags as _flags
        self._flag = _flags.flag_object(flag_name)
        super().__init__(name or flag_name)

    def get_value(self):
        return self._flag.get()
