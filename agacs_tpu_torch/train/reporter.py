"""Metric aggregation + timing (counterpart of `agacs_tpu/train/reporter.py`,
line for line) — the reference Reporter's role (`espnet2/train/reporter.py`:
weighted-average stats keyed (phase, metric), epoch history, timing
contexts). Non-finite stats are not averaged in; `measure_time` keys
(`iter_time`, `step_time`) are per-epoch sums in seconds.
Sinks: python logging; history dict feeds CheckpointManager's best/n-best
logic and can be dumped as JSON for plotting.
"""

from __future__ import annotations

import json
import logging
import time
from collections import defaultdict
from typing import Any

import numpy as np


class SubReporter:
    """Accumulates weighted means for one (phase, epoch)."""

    def __init__(self, phase: str, epoch: int):
        self.phase = phase
        self.epoch = epoch
        self._sums: dict[str, float] = defaultdict(float)
        self._weights: dict[str, float] = defaultdict(float)
        self._timings: dict[str, float] = defaultdict(float)
        self.n_batches = 0

    def register(self, stats: dict[str, Any], weight: float = 1.0) -> None:
        self.n_batches += 1
        for k, v in stats.items():
            if v is None:
                continue
            v = float(np.asarray(v))
            if not np.isfinite(v):
                continue
            self._sums[k] += v * weight
            self._weights[k] += weight

    def add_time(self, key: str, seconds: float) -> None:
        self._timings[key] += seconds

    def mean(self) -> dict[str, float]:
        out = {
            k: self._sums[k] / max(self._weights[k], 1e-12) for k in self._sums
        }
        out.update({k: v for k, v in self._timings.items()})
        return out

    class _Timer:
        def __init__(self, sub: "SubReporter", key: str):
            self.sub, self.key = sub, key

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.sub.add_time(self.key, time.perf_counter() - self.t0)
            return False

    def measure_time(self, key: str) -> "SubReporter._Timer":
        return SubReporter._Timer(self, key)


class Reporter:
    def __init__(self):
        self.history: dict[int, dict[str, dict[str, float]]] = {}

    def start_epoch(self, phase: str, epoch: int) -> SubReporter:
        return SubReporter(phase, epoch)

    def finish_epoch(self, sub: SubReporter) -> dict[str, float]:
        means = sub.mean()
        self.history.setdefault(sub.epoch, {})[sub.phase] = means
        logging.info(
            "%s epoch %d: %s",
            sub.phase,
            sub.epoch,
            ", ".join(f"{k}={v:.4g}" for k, v in sorted(means.items())),
        )
        return means

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({str(k): v for k, v in self.history.items()}, f, indent=1)
