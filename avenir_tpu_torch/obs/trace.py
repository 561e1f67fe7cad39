"""Span flight recorder: a bounded, thread-safe ring of timing events.

The port's own copy of `avenir_tpu/obs/trace.py`: the same span names,
ring capacity and ``AVENIR_TRACE`` switch. The recorder is
process-global and on by default. A span is a host-side wall-clock
interval: ``t0``/``dur`` are ``time.perf_counter`` seconds, ``tid`` the
recording thread, ``attrs`` a small dict of primitives. CUDA work is
launched asynchronously and no span synchronizes the device, so a span
around a kernel launch measures the launch and host time, not the
kernel.

Export is Chrome-trace JSON (the ``traceEvents`` complete-event form:
``ph:"X"`` with microsecond ``ts``/``dur``), loadable by Perfetto and
chrome://tracing.

Memory bound: the ring keeps the NEWEST ``capacity`` spans (overflow
drops the oldest and counts them in ``dropped``) — a resident server
can trace forever in O(capacity).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

from avenir_tpu_torch.obs.histogram import LatencyHistogram

#: default ring capacity (spans); ~100 bytes each -> a few MB bound
DEFAULT_CAPACITY = 65_536

#: shortest producer/consumer stall worth a span (seconds) — queue
#: handoffs complete in microseconds; recording every one would be
#: noise, not attribution
STALL_MIN_SECS = 1e-3


class Span(NamedTuple):
    name: str
    tid: int
    t0: float
    dur: float
    attrs: Optional[Dict]


class SpanRecorder:
    """Thread-safe ring buffer of :class:`Span` events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._buf: List[Span] = []
        self._n = 0                      # total spans ever recorded

    def record(self, name: str, t0: float, dur: float,
               tid: Optional[int] = None,
               attrs: Optional[Dict] = None) -> None:
        sp = Span(name, tid if tid is not None else threading.get_ident(),
                  t0, dur, attrs)
        with self._lock:
            if self._n < self.capacity:
                self._buf.append(sp)
            else:
                self._buf[self._n % self.capacity] = sp
            self._n += 1

    @property
    def dropped(self) -> int:
        """Spans the ring overwrote (oldest-first) since the last clear."""
        with self._lock:
            return max(self._n - self.capacity, 0)

    def __len__(self) -> int:
        with self._lock:
            return min(self._n, self.capacity)

    def spans(self) -> List[Span]:
        """Retained spans, oldest to newest."""
        with self._lock:
            if self._n <= self.capacity:
                return list(self._buf)
            head = self._n % self.capacity
            return self._buf[head:] + self._buf[:head]

    def clear(self) -> None:
        with self._lock:
            self._buf = []
            self._n = 0

    def chrome_events(self) -> List[Dict]:
        """The retained spans as Chrome-trace complete events (``ph:X``,
        microsecond ``ts``/``dur`` on the perf_counter timeline)."""
        pid = os.getpid()
        return [{"name": sp.name, "cat": "avenir", "ph": "X",
                 "ts": sp.t0 * 1e6, "dur": sp.dur * 1e6,
                 "pid": pid, "tid": sp.tid,
                 "args": sp.attrs or {}}
                for sp in self.spans()]

    def export_chrome(self, path: str) -> str:
        """Write the Chrome-trace JSON file (atomic tmp+rename; open it
        in Perfetto / chrome://tracing). Returns `path`."""
        doc = {"traceEvents": self.chrome_events(),
               "displayTimeUnit": "ms",
               "metadata": {"dropped_spans": self.dropped}}
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh)
        os.replace(tmp, path)
        return path


# --------------------------------------------------------------------------
# module-global surface (what the instrumentation points call)
# --------------------------------------------------------------------------
_ENABLED = os.environ.get("AVENIR_TRACE", "1") not in ("0", "false", "off")
_recorder = SpanRecorder()

now = time.perf_counter


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> bool:
    """Toggle recording; returns the previous state."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, bool(on)
    return prev


def recorder() -> SpanRecorder:
    return _recorder


def record(name: str, t0: float, **attrs) -> None:
    """Record a span that began at `t0` (from :func:`now`) and ends now.
    One flag load when disabled — cheap enough for per-chunk call sites."""
    if not _ENABLED:
        return
    _recorder.record(name, t0, time.perf_counter() - t0,
                     attrs=attrs or None)


def record_min(name: str, t0: float, min_dur: float = STALL_MIN_SECS,
               **attrs) -> None:
    """Record the span only when it lasted at least `min_dur` seconds, so
    instantaneous queue handoffs don't flood the ring."""
    if not _ENABLED:
        return
    dur = time.perf_counter() - t0
    if dur >= min_dur:
        _recorder.record(name, t0, dur, attrs=attrs or None)


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[None]:
    """Context-manager span around a region (exception-safe: the span
    records however the block exits)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record(name, t0, **attrs)


@contextlib.contextmanager
def capture(capacity: int = DEFAULT_CAPACITY) -> Iterator[SpanRecorder]:
    """Swap in a FRESH recorder (and force tracing on) for the duration
    — a caller captures one run's spans in isolation this way — then
    restore the previous recorder and flag."""
    global _recorder
    fresh = SpanRecorder(capacity)
    prev_rec, _recorder = _recorder, fresh
    prev_on = set_enabled(True)
    try:
        yield fresh
    finally:
        _recorder = prev_rec
        set_enabled(prev_on)


# --------------------------------------------------------------------------
# process-global streaming histograms
# --------------------------------------------------------------------------
_hist_lock = threading.Lock()
_hists: Dict[str, LatencyHistogram] = {}


def observe(name: str, value: float) -> None:
    """Fold one sample into the process-global histogram `name` (created
    on first use): the always-on aggregate view next to the span ring."""
    if not _ENABLED:
        return
    with _hist_lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = LatencyHistogram()
        h.add(value)


def hist(name: str):
    """A merged COPY of the process-global histogram `name` (None when
    nothing observed it yet) — a copy, so callers can merge/mutate
    without racing the live accumulator."""
    with _hist_lock:
        h = _hists.get(name)
        return None if h is None else LatencyHistogram().merge(h)


def hist_summaries() -> Dict[str, Dict[str, float]]:
    """{name: summary} of every process-global histogram."""
    with _hist_lock:
        return {name: h.summary() for name, h in sorted(_hists.items())}


def reset_hists() -> None:
    with _hist_lock:
        _hists.clear()
