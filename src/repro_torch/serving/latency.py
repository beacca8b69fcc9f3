"""Latency percentile + queue-depth tracking for SLA-driven serving.

The paper's deployment metric is the P99 batch latency under an SLA bound
(§IV-A); this tracker maintains a sliding window of per-batch latencies and
exposes the percentile/throughput trade-off the evaluation plots.  The
serving runtime (DESIGN.md §8) additionally records the admission-queue
depth observed at each batch release: under overload, a no-admission
configuration's latency grows linearly with this depth, which is exactly
the signal the bounded-queue policies are there to cap — ``servebench``
plots both columns side by side."""
from __future__ import annotations

import collections

import numpy as np


class LatencyTracker:
    def __init__(self, window: int = 2048):
        self.samples: collections.deque[float] = collections.deque(maxlen=window)
        self.depths: collections.deque[int] = collections.deque(maxlen=window)
        self.queries = 0
        self.t_total = 0.0

    def record(self, seconds: float, queries: int = 1) -> None:
        self.samples.append(seconds)
        self.queries += queries
        self.t_total += seconds

    def record_depth(self, depth: int) -> None:
        """Admission-queue depth at a batch release (post-release)."""
        self.depths.append(int(depth))

    def percentile(self, q: float) -> float | None:
        """Percentile over the sliding window; ``None`` (not NaN) with no
        samples yet — an idle server has *no* latency, and ``None`` survives
        JSON round-trips and ``is None`` guards where NaN silently poisons
        comparisons and formatting."""
        if not self.samples:
            return None
        return float(np.percentile(np.array(self.samples), q))

    @property
    def p50(self) -> float | None:
        return self.percentile(50)

    @property
    def p99(self) -> float | None:
        return self.percentile(99)

    @property
    def throughput(self) -> float:
        return self.queries / self.t_total if self.t_total else 0.0

    def summary(self) -> dict:
        p50, p99 = self.p50, self.p99
        out = {
            "p50_us": None if p50 is None else p50 * 1e6,
            "p99_us": None if p99 is None else p99 * 1e6,
            "tps": self.throughput,
            "n": len(self.samples),
        }
        if self.depths:
            depths = np.array(self.depths)
            out["queue_depth_mean"] = float(depths.mean())
            out["queue_depth_max"] = int(depths.max())
        return out
