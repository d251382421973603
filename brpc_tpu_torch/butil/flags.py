"""gflags-equivalent runtime flag registry with live reload.

The reference configures everything through gflags ``DEFINE_*`` macros with
``BRPC_VALIDATE_GFLAG`` validators and allows editing flags at runtime through
the ``/flags`` builtin service (reference: src/brpc/reloadable_flags.{h,cpp},
src/brpc/builtin/flags_service.cpp).  This module provides the same contract:
module-level flag definitions, optional validators that gate reloads, env-var
overrides (``BRPC_TPU_<NAME>``), and a registry the admin service renders.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional


class Flag:
    __slots__ = ("name", "value", "default", "help", "type", "validator",
                 "_reloadable", "_lock")

    def __init__(self, name: str, default: Any, help: str,
                 validator: Optional[Callable[[Any], bool]] = None,
                 reloadable: bool = True):
        self.name = name
        self.default = default
        self.help = help
        self.type = type(default)
        self.validator = validator
        self._reloadable = reloadable
        self._lock = threading.Lock()
        env = os.environ.get("BRPC_TPU_" + name.upper())
        if env is not None:
            default = _coerce(env, self.type)
            if validator is not None and not validator(default):
                raise ValueError(f"env override for flag {name} rejected by validator: {env!r}")
        self.value = default

    @property
    def reloadable(self) -> bool:
        return self._reloadable

    def get(self) -> Any:
        return self.value

    def set(self, value: Any) -> None:
        value = _coerce(value, self.type)
        if not self._reloadable:
            raise PermissionError(f"flag {self.name} is not reloadable")
        if self.validator is not None and not self.validator(value):
            raise ValueError(f"value {value!r} rejected by validator of flag {self.name}")
        with self._lock:
            self.value = value


def _coerce(value: Any, typ: type) -> Any:
    if isinstance(value, typ):
        return value
    if typ is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    return typ(value)


_registry: Dict[str, Flag] = {}
_registry_lock = threading.Lock()


def define_flag(name: str, default: Any, help: str = "",
                validator: Optional[Callable[[Any], bool]] = None,
                reloadable: bool = True) -> Flag:
    with _registry_lock:
        if name in _registry:
            return _registry[name]
        f = Flag(name, default, help, validator, reloadable)
        _registry[name] = f
        return f


def get_flag(name: str) -> Any:
    return _registry[name].get()


def set_flag(name: str, value: Any) -> None:
    _registry[name].set(value)


def flag_object(name: str) -> Flag:
    """The Flag itself: a hot path reads ``flag.value`` (one attribute
    load) instead of a registry lookup per call."""
    return _registry[name]


def list_flags() -> list:
    """Every defined flag, sorted by name (the /flags page)."""
    with _registry_lock:
        return [_registry[k] for k in sorted(_registry)]


def positive_integer(v: Any) -> bool:
    return isinstance(v, int) and v > 0


def non_negative_integer(v: Any) -> bool:
    return isinstance(v, int) and v >= 0
