"""Per-stage timing of the ingestion pipeline.

Every pipeline stage (decode / preprocess / encode / store / db) accumulates
into a StageTimer that reports totals and throughput.

``StageTimer`` is copied from ``wise_tpu/utils/profiling.py``; that module's
profiler-trace helpers belong to the JAX package and are not part of the port.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add(self, name: str, seconds: float, count: int = 1):
        self.totals[name] += seconds
        self.counts[name] += count

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(
                    1000 * self.totals[name] / max(1, self.counts[name]), 3
                ),
            }
            for name in sorted(self.totals)
        }

    def summary(self) -> str:
        parts = [
            f"{name}={self.totals[name]:.2f}s/{self.counts[name]}x"
            for name in sorted(self.totals)
        ]
        return " ".join(parts)
