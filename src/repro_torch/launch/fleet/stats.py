"""Mirrors ``src/repro/launch/fleet/stats.py`` (verbatim).

Latency accounting for the fleet front-end.

A fixed-bucket log2 histogram: cheap to record under a lock (one
bisect + two adds), bounded memory, and good-enough percentiles for a
``/stats`` surface — the serving acceptance story wants p50/p99 per
stage (queue wait, compile, total), not exact order statistics.
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Dict, List

#: bucket upper bounds in seconds: 0.1ms · 2^i, topping out ~1.7e4 s —
#: everything a compile service can plausibly observe lands inside
_BOUNDS: List[float] = [0.0001 * (2 ** i) for i in range(28)]


class LatencyHistogram:
    """Thread-safe log2-bucketed latency histogram.

    ``record`` files one observation; ``percentile`` answers from the
    cumulative bucket counts (upper-bound biased, so a reported p99
    never understates the truth by more than one bucket width).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts = [0] * (len(_BOUNDS) + 1)
        self._count = 0
        self._sum_s = 0.0
        self._max_s = 0.0

    def record(self, seconds: float) -> None:
        if seconds < 0.0:
            seconds = 0.0          # clock skew must not corrupt buckets
        i = bisect_right(_BOUNDS, seconds)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum_s += seconds
            if seconds > self._max_s:
                self._max_s = seconds

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentile(self, p: float) -> float:
        """Upper bound of the bucket holding the ``p``-th percentile
        observation (0 when nothing was recorded)."""
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        with self._lock:
            if self._count == 0:
                return 0.0
            rank = max(1, int(round(p / 100.0 * self._count)))
            seen = 0
            for i, n in enumerate(self._counts):
                seen += n
                if seen >= rank:
                    # the overflow bucket has no upper bound; the exact
                    # max is the tightest true statement we can make
                    return _BOUNDS[i] if i < len(_BOUNDS) else self._max_s
            return self._max_s      # unreachable (seen == count >= rank)

    def to_dict(self) -> Dict[str, float]:
        """JSON-ready summary (the ``/stats`` payload shape)."""
        with self._lock:
            count, sum_s, max_s = self._count, self._sum_s, self._max_s
        return {
            "count": count,
            "mean_s": round(sum_s / count, 6) if count else 0.0,
            "p50_s": round(self.percentile(50), 6),
            "p90_s": round(self.percentile(90), 6),
            "p99_s": round(self.percentile(99), 6),
            "max_s": round(max_s, 6),
        }
