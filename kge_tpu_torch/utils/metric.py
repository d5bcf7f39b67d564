"""Metric comparison helper (kge_tpu/utils/metric.py; reference
kge/util/metric.py:12-40)."""

from __future__ import annotations


class Metric:
    """Compares metric values under the job's ``valid.metric_max`` setting."""

    def __init__(self, config_or_max) -> None:
        if hasattr(config_or_max, "get"):
            self._max = bool(config_or_max.get("valid.metric_max"))
        else:
            self._max = bool(config_or_max)

    @property
    def maximize(self) -> bool:
        return self._max

    def better(self, a: float, b: float) -> bool:
        """True iff metric value ``a`` is better than ``b``."""
        return a > b if self._max else a < b

    def best(self, values) -> float:
        return max(values) if self._max else min(values)

    def best_index(self, values) -> int:
        values = list(values)
        return values.index(self.best(values))

    def worst(self) -> float:
        return float("-inf") if self._max else float("inf")
