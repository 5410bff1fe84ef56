"""Running metric averages, overall and per log window.

Counterpart of ``dlmc_quant_tpu/utils/metric_tracker.py`` (ref:
utils/util.py:49-76), on plain dicts: the card's machine has no pandas.
"""

from __future__ import annotations

from typing import Dict


class MetricTracker:
    def __init__(self, *keys, writer=None):
        self.writer = writer
        self._keys = keys
        self.reset()

    def reset(self):
        self._total = dict.fromkeys(self._keys, 0.0)
        self._count = dict.fromkeys(self._keys, 0.0)
        self.reset_batch()

    def reset_batch(self):
        self._cur_total = dict.fromkeys(self._keys, 0.0)
        self._cur_count = dict.fromkeys(self._keys, 0.0)

    def update(self, key, value, n: int = 1):
        value = float(value)
        if self.writer is not None:
            self.writer.add_scalar(key, value)
        self._total[key] += value * n
        self._count[key] += n
        self._cur_total[key] += value * n
        self._cur_count[key] += n

    def avg(self, key) -> float:
        return self._total[key] / self._count[key] if self._count[key] \
            else 0.0

    def avg_batch(self, key) -> float:
        return self._cur_total[key] / self._cur_count[key] \
            if self._cur_count[key] else 0.0

    def result(self) -> Dict[str, float]:
        return {k: self.avg(k) for k in self._keys}

    def result_batch(self) -> Dict[str, float]:
        return {k: self.avg_batch(k) for k in self._keys}
