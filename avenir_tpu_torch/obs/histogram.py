"""Streaming latency histograms: fixed log-spaced buckets, exact merge.

The port's own copy of `avenir_tpu/obs/histogram.py`, unchanged in
behaviour. This accumulator is the RunningStats of latencies: counts and
per-bucket sums are additive, so ``merge`` is associative/commutative
and per-worker (or per-shard) histograms combine exactly.

Bucket layout is a module constant (quarter-octave geometric spacing:
~19% relative resolution over [1e-6, ~1.1e9)), so any two histograms
merge without negotiation. Quantiles return the MEAN of the selected
bucket's samples — an estimator bounded by the bucket's ~19% width, and
EXACT whenever the bucket holds one distinct value (which is how the
tests pin it on known inputs). ``min``/``max``/``mean`` are always
exact.

Units are the caller's; values <= the lowest edge clamp into bucket 0
and stay exact through its bucket sum.
"""

from __future__ import annotations

import math
from bisect import bisect_right
from typing import Dict, List

#: lowest bucket edge and geometric spacing factor (2**0.25 per bucket)
_LO = 1e-6
_FACTOR = 2.0 ** 0.25
_N_BUCKETS = 200
#: upper edges of buckets 0..N-2 (bucket i holds values in
#: [_EDGES[i-1], _EDGES[i]) — bisect_right places a value equal to an
#: edge in the NEXT bucket; the last bucket is open-ended)
_EDGES = tuple(_LO * _FACTOR ** (i + 1) for i in range(_N_BUCKETS - 1))


class LatencyHistogram:
    """Mergeable log-bucketed accumulator (module docstring)."""

    __slots__ = ("counts", "sums", "count", "total", "min_val", "max_val")

    def __init__(self):
        self.counts: List[int] = [0] * _N_BUCKETS
        self.sums: List[float] = [0.0] * _N_BUCKETS
        self.count = 0
        self.total = 0.0
        self.min_val = math.inf
        self.max_val = -math.inf

    def add(self, value: float) -> "LatencyHistogram":
        v = float(value)
        i = bisect_right(_EDGES, v) if v > _LO else 0
        self.counts[i] += 1
        self.sums[i] += v
        self.count += 1
        self.total += v
        if v < self.min_val:
            self.min_val = v
        if v > self.max_val:
            self.max_val = v
        return self

    def add_many(self, values) -> "LatencyHistogram":
        for v in values:
            self.add(v)
        return self

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold `other` into self (additive — associative and
        commutative, the shard-merge algebra)."""
        for i, c in enumerate(other.counts):
            if c:
                self.counts[i] += c
                self.sums[i] += other.sums[i]
        self.count += other.count
        self.total += other.total
        self.min_val = min(self.min_val, other.min_val)
        self.max_val = max(self.max_val, other.max_val)
        return self

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, p: float) -> float:
        """Value at percentile `p` in [0, 100]: the mean of the bucket
        containing the rank-``ceil(p/100 * count)`` sample (0.0 on an
        empty histogram; p=0 returns the exact min)."""
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        if self.count == 0:
            return 0.0
        if p == 0.0:
            return self.min_val
        rank = min(max(int(math.ceil(p / 100.0 * self.count)), 1),
                   self.count)
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return self.sums[i] / c
        return self.max_val          # unreachable; counts sum to count

    def summary(self) -> Dict[str, float]:
        """count/mean/min/max plus p50/p95/p99."""
        if self.count == 0:
            return {"count": 0, "mean": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {"count": self.count,
                "mean": round(self.mean, 6),
                "min": round(self.min_val, 6),
                "max": round(self.max_val, 6),
                "p50": round(self.quantile(50), 6),
                "p95": round(self.quantile(95), 6),
                "p99": round(self.quantile(99), 6)}

    def to_dict(self) -> Dict:
        """JSON-serializable sparse form (non-empty buckets only)."""
        return {"buckets": {str(i): [self.counts[i], self.sums[i]]
                            for i in range(_N_BUCKETS) if self.counts[i]},
                "count": self.count, "total": self.total,
                "min": None if self.count == 0 else self.min_val,
                "max": None if self.count == 0 else self.max_val}

    @classmethod
    def from_dict(cls, d: Dict) -> "LatencyHistogram":
        h = cls()
        for key, (c, s) in d.get("buckets", {}).items():
            h.counts[int(key)] = int(c)
            h.sums[int(key)] = float(s)
        h.count = int(d.get("count", 0))
        h.total = float(d.get("total", 0.0))
        if d.get("min") is not None:
            h.min_val = float(d["min"])
        if d.get("max") is not None:
            h.max_val = float(d["max"])
        return h
