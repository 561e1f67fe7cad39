"""Tracing, profiling and running stats, the port's own copy of
`avenir_tpu/utils/profiling.py`:

- PhaseTimer: named per-phase wall-clock accounting for multi-stage jobs
  (the timing analog of the reference's per-job Hadoop counter groups),
  thread-safe, with a merge that never holds two timers' locks at once.
- trace(): context manager around `torch.profiler` for a
  TensorBoard-readable device trace of a region, recorded as a
  ``torch.profiler.trace`` span in the port's span recorder.
- RunningStats: mergeable count/mean/variance/min/max accumulator (the
  chombo SimpleStat role) whose moments add, so shard results combine
  exactly.

The reference's `enable_persistent_compilation_cache` sets a JAX
compilation-cache option and has no counterpart here: the port compiles
its kernels once into `build/avenir_tpu_torch/<hash>/` (`ops/_build.py`),
and torch runs eagerly.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List


class PhaseTimer:
    """Accumulated wall clock per named phase.

    with timer.phase("ingest"): ...
    with timer.phase("train"): ...
    timer.report() -> {"ingest": seconds, ...}

    Thread-safe: phase exits mutate the accumulators under a lock, so
    one timer can be shared across server worker threads (phases that
    OVERLAP in time still sum their full durations — per-worker timers
    aggregated through :meth:`merge` are the per-thread view)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._order: List[str] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                if name not in self.totals:
                    self._order.append(name)
                    self.totals[name] = 0.0
                    self.counts[name] = 0
                self.totals[name] += dt
                self.counts[name] += 1

    def _snapshot(self) -> Dict[str, tuple]:
        with self._lock:
            return {name: (self.totals[name], self.counts[name])
                    for name in self._order}

    def merge(self, other: "PhaseTimer") -> "PhaseTimer":
        """Fold another timer's accumulators into this one (additive,
        like every fold-state merge in the repo) — how per-worker
        timers aggregate into one report. Snapshot-then-apply: the two
        locks are never held together, so ``a.merge(b)`` can never
        deadlock against a concurrent ``b.merge(a)``."""
        for name, (total, count) in other._snapshot().items():
            with self._lock:
                if name not in self.totals:
                    self._order.append(name)
                    self.totals[name] = 0.0
                    self.counts[name] = 0
                self.totals[name] += total
                self.counts[name] += count
        return self

    def report(self) -> Dict[str, float]:
        with self._lock:
            return {name: self.totals[name] for name in self._order}

    def summary(self) -> str:
        with self._lock:
            total = sum(self.totals.values()) or 1.0
            lines = []
            for name in self._order:
                t = self.totals[name]
                lines.append(
                    f"{name:>20s}  {t:9.3f}s  {100 * t / total:5.1f}%  "
                    f"x{self.counts[name]}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """torch.profiler trace of the enclosed region (the CPU, and the CUDA
    devices where there are any), written to `log_dir` for TensorBoard
    (`tensorboard_trace_handler`). No-ops cleanly if the profiler can't
    start, or if one is running already (a second one would end it).

    The region also records into the port's span recorder (a
    ``torch.profiler.trace`` span with the trace dir and whether the
    profiler actually started as attrs), so a host-side Chrome trace
    links each device-trace capture to the phase that took it."""
    import torch

    from avenir_tpu_torch import obs

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    # a second profiler would end the running one: start only alone
    if not torch._C._autograd._profiler_enabled():
        try:
            prof = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    log_dir))
            prof.start()
        except Exception:
            prof = None
    started = prof is not None
    t0 = obs.now()
    try:
        yield
    finally:
        if started:
            try:
                prof.stop()
            except Exception:
                pass
        obs.record("torch.profiler.trace", t0, log_dir=log_dir,
                   started=started)


@dataclass
class RunningStats:
    """Mergeable first/second-moment accumulator (chombo SimpleStat role)."""

    count: float = 0.0
    total: float = 0.0
    total_sq: float = 0.0
    min_val: float = math.inf
    max_val: float = -math.inf

    def add(self, *values: float) -> "RunningStats":
        for v in values:
            self.count += 1
            self.total += v
            self.total_sq += v * v
            self.min_val = min(self.min_val, v)
            self.max_val = max(self.max_val, v)
        return self

    def add_array(self, arr) -> "RunningStats":
        import numpy as np

        a = np.asarray(arr, np.float64).ravel()
        if a.size:
            self.count += a.size
            self.total += float(a.sum())
            self.total_sq += float((a * a).sum())
            self.min_val = min(self.min_val, float(a.min()))
            self.max_val = max(self.max_val, float(a.max()))
        return self

    def merge(self, other: "RunningStats") -> "RunningStats":
        """Moments are additive — the host-side analog of psum-merging
        per-shard stats."""
        self.count += other.count
        self.total += other.total
        self.total_sq += other.total_sq
        self.min_val = min(self.min_val, other.min_val)
        self.max_val = max(self.max_val, other.max_val)
        return self

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def variance(self) -> float:
        if self.count < 2:
            return 0.0
        m = self.mean
        return max((self.total_sq - self.count * m * m) / (self.count - 1), 0.0)

    @property
    def std(self) -> float:
        return math.sqrt(self.variance)

