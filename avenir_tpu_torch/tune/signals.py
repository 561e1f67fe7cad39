"""Signals: a window of captured spans rolled into the numbers a policy
moves on.

The port's copy of `RunSignals` and `extract_signals` of
`avenir_tpu/tune/signals.py`. Given the spans one run recorded
(:class:`avenir_tpu_torch.obs.trace.Span`: per-block ``stream.read``,
``stream.parse``, per-sink ``stream.fold``, the stall spans and
``job.checkpoint``), aggregate them into a JSON-serializable
:class:`RunSignals` row of totals, shares and per-sink fold means. The
sharded driver's straggler detector prices a block from it
(`dist/detect.py`).

Stall naming: a ``stream.stall.consumer`` span is recorded when the
consumer waited on an empty queue, so the producer (read, parse) was the
bottleneck: that time is ``producer_bound_s``. ``stream.stall.producer``
(the producer blocked on a full queue) becomes ``consumer_bound_s``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional


@dataclass
class RunSignals:
    """One run's aggregated telemetry (all times in seconds; the
    per-sink fold means in milliseconds per chunk)."""

    wall_s: float = 0.0
    read_s: float = 0.0
    parse_s: float = 0.0
    fold_s: float = 0.0
    producer_bound_s: float = 0.0      # consumer waited on producer
    consumer_bound_s: float = 0.0      # producer waited on consumer
    checkpoint_s: float = 0.0
    chunks: int = 0                    # ingest blocks (read or replayed)
    bytes_read: int = 0
    fold_ms_by_sink: Dict[str, float] = field(default_factory=dict)

    # ------------------------------------------------------------ shares
    @property
    def ingest_s(self) -> float:
        """Producer-side work: disk read + parse."""
        return self.read_s + self.parse_s

    def _share(self, x: float) -> float:
        return x / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def producer_bound_share(self) -> float:
        return self._share(self.producer_bound_s)

    @property
    def consumer_bound_share(self) -> float:
        return self._share(self.consumer_bound_s)

    @property
    def checkpoint_share(self) -> float:
        return self._share(self.checkpoint_s)

    def to_json(self) -> Dict:
        return {"wall_s": round(self.wall_s, 4),
                "read_s": round(self.read_s, 4),
                "parse_s": round(self.parse_s, 4),
                "fold_s": round(self.fold_s, 4),
                "producer_bound_s": round(self.producer_bound_s, 4),
                "consumer_bound_s": round(self.consumer_bound_s, 4),
                "checkpoint_s": round(self.checkpoint_s, 4),
                "chunks": int(self.chunks),
                "bytes_read": int(self.bytes_read),
                "fold_ms_by_sink": {k: round(v, 3) for k, v
                                    in sorted(self.fold_ms_by_sink.items())}}

    @classmethod
    def from_json(cls, d: Dict) -> "RunSignals":
        return cls(wall_s=float(d.get("wall_s", 0.0)),
                   read_s=float(d.get("read_s", 0.0)),
                   parse_s=float(d.get("parse_s", 0.0)),
                   fold_s=float(d.get("fold_s", 0.0)),
                   producer_bound_s=float(d.get("producer_bound_s", 0.0)),
                   consumer_bound_s=float(d.get("consumer_bound_s", 0.0)),
                   checkpoint_s=float(d.get("checkpoint_s", 0.0)),
                   chunks=int(d.get("chunks", 0)),
                   bytes_read=int(d.get("bytes_read", 0)),
                   fold_ms_by_sink={str(k): float(v) for k, v in
                                    dict(d.get("fold_ms_by_sink",
                                               {})).items()})


def extract_signals(spans: Iterable,
                    wall_s: Optional[float] = None) -> RunSignals:
    """Aggregate a window of :class:`~avenir_tpu_torch.obs.trace.Span` events
    into a :class:`RunSignals` row. `wall_s` is the run's wall clock as
    the caller measured it (the spans alone cannot give it — they may
    overlap across threads); when None it falls back to the span
    extent. Works on whatever subset of spans survived the ring — the
    signals are aggregates, so a truncated window degrades gracefully
    instead of failing."""
    sig = RunSignals()
    fold_n: Dict[str, int] = {}
    fold_t: Dict[str, float] = {}
    t_lo, t_hi = None, None
    for sp in spans:
        if t_lo is None or sp.t0 < t_lo:
            t_lo = sp.t0
        end = sp.t0 + sp.dur
        if t_hi is None or end > t_hi:
            t_hi = end
        if sp.name == "stream.read":
            sig.read_s += sp.dur
            sig.chunks += 1
            if sp.attrs:
                sig.bytes_read += int(sp.attrs.get("nbytes", 0))
        elif sp.name == "stream.sidecar.replay":
            # a sidecar replay is the run's ingest: without its chunks
            # and seconds a warm scan records no signal and the block
            # and prefetch rules go inert
            sig.read_s += sp.dur
            sig.chunks += 1
            if sp.attrs:
                sig.bytes_read += int(sp.attrs.get("nbytes", 0))
        elif sp.name == "stream.parse":
            sig.parse_s += sp.dur
        elif sp.name == "stream.fold":
            sig.fold_s += sp.dur
            sink = (sp.attrs or {}).get("sink", "sink")
            fold_n[sink] = fold_n.get(sink, 0) + 1
            fold_t[sink] = fold_t.get(sink, 0.0) + sp.dur
        elif sp.name == "stream.stall.consumer":
            sig.producer_bound_s += sp.dur     # consumer waited: producer slow
        elif sp.name == "stream.stall.producer":
            sig.consumer_bound_s += sp.dur     # producer waited: consumer slow
        elif sp.name == "job.checkpoint":
            sig.checkpoint_s += sp.dur
    sig.fold_ms_by_sink = {sink: 1e3 * fold_t[sink] / fold_n[sink]
                           for sink in fold_t}
    if wall_s is not None:
        sig.wall_s = float(wall_s)
    elif t_lo is not None and t_hi is not None:
        sig.wall_s = max(t_hi - t_lo, 0.0)
    return sig
