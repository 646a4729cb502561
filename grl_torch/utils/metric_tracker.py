"""Metric accumulators (reference: gnn/utils/metric_tracker.py:6-55).

A copy of ``grl_tpu/utils/metric_tracker.py`` (pure Python).

``Dictlist`` keeps per-key lists and averages them; ``MetricTracker``
keeps running totals/averages — stdlib-only (no pandas).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable


class Dictlist(dict):
    """Accumulate values per key; ``result()`` averages each list."""

    def __setitem__(self, key: str, value: Any) -> None:
        if key not in self:
            super().__setitem__(key, [])
        self[key].append(value)

    def update_metrics(self, items: Dict[str, Any]) -> None:
        for key, value in items.items():
            self[key] = value

    # Reference-compatible aliases.
    _update = update_metrics

    def avg(self, key: str) -> float:
        values = self[key]
        return round(sum(values) / len(values), 6)

    def result(self) -> Dict[str, float]:
        return {key: self.avg(key) for key in self.keys()}

    _result = result


class MetricTracker:
    """Running total/count/average per metric key."""

    def __init__(self, *keys: str, writer: Any = None):
        self.writer = writer
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self.reset(keys)

    def reset(self, keys: Iterable[str] = ()) -> None:
        for key in keys:
            self._totals[key] = 0.0
            self._counts[key] = 0

    def update(self, key: str, value: float, n: int = 1) -> None:
        if self.writer is not None:
            self.writer.add_scalar(key, value, n)
        self._totals[key] = self._totals.get(key, 0.0) + value * n
        self._counts[key] = self._counts.get(key, 0) + n

    def avg(self, key: str) -> float:
        count = self._counts.get(key, 0)
        return self._totals.get(key, 0.0) / count if count else 0.0

    def result(self) -> Dict[str, float]:
        return {key: self.avg(key) for key in self._totals}
