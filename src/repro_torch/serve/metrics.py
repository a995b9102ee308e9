"""Serving metrics: per-request latency distribution, throughput, occupancy.

Every engine (sync adapter and async tier) funnels its observations through
one :class:`ServeMetrics` instance per model plus one engine-wide aggregate:
``record_batch`` after each batched forward (batch size, bucket, device
seconds) and ``record_request`` at each request completion (enqueue→complete
latency, SLO verdict).  ``snapshot()`` reduces them to the numbers the
benchmarks gate on — p50/p99 latency, requests/sec, mean batch occupancy —
plus the compile-artifact cache hit/miss counters the cold-start story is
measured by.

Latencies are kept in a bounded reservoir (default 8192): old observations
are dropped FIFO, so long-running engines report *recent* percentiles at
O(1) memory.
"""

from __future__ import annotations

import collections
from typing import Iterable

import numpy as np

__all__ = ["ServeMetrics", "percentile"]


def percentile(values: Iterable[float], q: float) -> float:
    """Linear-interpolated percentile (numpy's default), 0 on no data."""
    arr = np.asarray(list(values), np.float64)
    return float(np.percentile(arr, q)) if arr.size else 0.0


class ServeMetrics:
    """Counters + reservoirs for one serving scope (a model, or an engine)."""

    def __init__(self, reservoir: int = 8192) -> None:
        self._latencies: collections.deque[float] = collections.deque(
            maxlen=reservoir)
        self._batch_sizes: collections.deque[int] = collections.deque(
            maxlen=reservoir)
        self.served = 0               # requests completed
        self.batches = 0              # batched forwards issued
        self.device_s = 0.0           # wall time inside batched forwards
        self.slo_misses = 0           # completions past their deadline
        self.rejected = 0             # admissions refused (queue full)
        self.cache_hits = 0           # program/artifact cache hits
        self.cache_misses = 0
        self.evictions = 0            # resident programs evicted (LRU)
        self.t_first: float | None = None   # first enqueue observed
        self.t_last: float | None = None    # last completion observed

    # ------------------------------------------------------------ recording
    def record_batch(self, n: int, device_s: float) -> None:
        self.batches += 1
        self.served += n
        self.device_s += device_s
        self._batch_sizes.append(n)

    def record_request(self, latency_s: float, *, t_submit: float,
                       t_done: float, missed_slo: bool = False) -> None:
        self._latencies.append(latency_s)
        if missed_slo:
            self.slo_misses += 1
        if self.t_first is None or t_submit < self.t_first:
            self.t_first = t_submit
        if self.t_last is None or t_done > self.t_last:
            self.t_last = t_done

    # ------------------------------------------------------------- reducing
    @property
    def wall_s(self) -> float:
        """First-enqueue → last-completion window."""
        if self.t_first is None or self.t_last is None:
            return 0.0
        return self.t_last - self.t_first

    def rps(self) -> float:
        """Requests/sec over the observed enqueue→complete window."""
        w = self.wall_s
        return self.served / w if w > 0 else 0.0

    def device_rps(self) -> float:
        """Requests/sec over device time only (the sync engines' historical
        ``throughput()`` figure — excludes queueing)."""
        return self.served / self.device_s if self.device_s > 0 else 0.0

    def batch_occupancy(self) -> float:
        """Mean requests per batched forward — continuous refill shows up
        here as occupancy > 1 under staggered arrivals."""
        sizes = self._batch_sizes
        return float(np.mean(sizes)) if sizes else 0.0

    def snapshot(self) -> dict:
        return {
            "served": self.served,
            "batches": self.batches,
            "p50_ms": percentile(self._latencies, 50) * 1e3,
            "p99_ms": percentile(self._latencies, 99) * 1e3,
            "rps": self.rps(),
            "device_rps": self.device_rps(),
            "device_s": self.device_s,
            "batch_occupancy": self.batch_occupancy(),
            "slo_misses": self.slo_misses,
            "rejected": self.rejected,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "evictions": self.evictions,
        }

    def reset(self) -> None:
        self.__init__(reservoir=self._latencies.maxlen or 8192)
