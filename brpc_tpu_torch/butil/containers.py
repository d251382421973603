"""Container utilities (reference: src/butil/containers/): the
case-insensitive map HTTP headers live in (the port's copy of the JAX
package's ``CaseIgnoredFlatMap``)."""
from __future__ import annotations

from typing import Dict, Generic, Iterator, Optional, Tuple, TypeVar

V = TypeVar("V")


class CaseIgnoredFlatMap(Generic[V]):
    """Case-insensitive string map preserving original key case
    (reference: case_ignored_flat_map.h; used for HTTP headers)."""

    def __init__(self):
        self._d: Dict[str, Tuple[str, V]] = {}

    def __setitem__(self, key: str, value: V) -> None:
        self._d[key.lower()] = (key, value)

    def __getitem__(self, key: str) -> V:
        return self._d[key.lower()][1]

    def __contains__(self, key: str) -> bool:
        return key.lower() in self._d

    def __delitem__(self, key: str) -> None:
        del self._d[key.lower()]

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key: str, default: Optional[V] = None) -> Optional[V]:
        e = self._d.get(key.lower())
        return e[1] if e is not None else default

    def items(self) -> Iterator[Tuple[str, V]]:
        return iter(self._d.values())

    def keys(self):
        return (orig for orig, _ in self._d.values())
