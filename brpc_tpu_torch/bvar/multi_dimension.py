"""MultiDimension (mbvar): labelled metric families for Prometheus export.

Reference: src/bvar/multi_dimension.h, ported from
:mod:`brpc_tpu.bvar.multi_dimension`.  A family is keyed by an ordered
label list; ``get_stats(label_values)`` creates the per-combination
variable on first use.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Sequence, Tuple

from .variable import Variable


class MultiDimension(Variable):
    def __init__(self, name: str, labels: Sequence[str],
                 factory: Callable[[], Variable]):
        self._labels = tuple(labels)
        self._factory = factory
        self._stats: Dict[Tuple[str, ...], Variable] = {}
        self._lock = threading.Lock()
        super().__init__(name)

    @property
    def labels(self) -> Tuple[str, ...]:
        return self._labels

    def get_stats(self, label_values: Sequence[str]) -> Variable:
        key = tuple(str(v) for v in label_values)
        if len(key) != len(self._labels):
            raise ValueError(
                f"expected {len(self._labels)} label values, got {len(key)}")
        with self._lock:
            v = self._stats.get(key)
            if v is None:
                v = self._factory()
                self._stats[key] = v
            return v

    def has_stats(self, label_values: Sequence[str]) -> bool:
        return tuple(str(v) for v in label_values) in self._stats

    def delete_stats(self, label_values: Sequence[str]) -> None:
        with self._lock:
            self._stats.pop(tuple(str(v) for v in label_values), None)

    def count_stats(self) -> int:
        with self._lock:
            return len(self._stats)

    def list_stats(self) -> List[Tuple[Tuple[str, ...], Variable]]:
        with self._lock:
            return list(self._stats.items())

    def get_value(self):
        return self.count_stats()

    def describe(self) -> str:
        parts = []
        for key, v in self.list_stats():
            lbl = ",".join(f'{k}="{val}"' for k, val in zip(self._labels, key))
            parts.append(f"{{{lbl}}} {v.describe()}")
        return "; ".join(parts)
