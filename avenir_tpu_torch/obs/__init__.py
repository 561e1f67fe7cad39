"""Host-side telemetry of the port: the span flight recorder and streaming
latency histograms, the port's own copies of `avenir_tpu/obs/trace.py` and
`obs/histogram.py` (stdlib only; nothing here imports torch).

- **Span flight recorder** (:mod:`avenir_tpu_torch.obs.trace`): a
  thread-safe ring of ``(name, tid, t0, dur, attrs)`` spans with bounded
  memory and Chrome-trace/Perfetto JSON export. The jobs record the
  reference's span names: ``job.run`` around a job in `runner.run_job`,
  ``stream.read`` for each byte block, ``stream.parse`` around each CSV
  parse (attributes ``nbytes`` and ``engine``), ``stream.fold`` around
  each chunk's fold or predict, and ``job.finish`` around each output.
  A span is host wall-clock time: it never synchronizes the device, so
  a span around device work measures its dispatch, not its run.
- **Streaming histograms** (:mod:`avenir_tpu_torch.obs.histogram`):
  log-spaced bucket accumulators whose merge is exact.

Tracing is on by default; ``AVENIR_TRACE=0`` or :func:`set_enabled`
turns it off, and every record call is then one flag load.
"""

# the submodule is named ``histogram`` (not ``hist``) on purpose: a
# submodule named ``hist`` would shadow the ``obs.hist(name)`` accessor
from avenir_tpu_torch.obs.histogram import LatencyHistogram
from avenir_tpu_torch.obs.trace import (Span, SpanRecorder, capture,
                                        enabled, hist, hist_summaries, now,
                                        observe, record, record_min,
                                        recorder, reset_hists, set_enabled,
                                        span)

__all__ = [
    "Span", "SpanRecorder", "LatencyHistogram",
    "capture", "enabled", "set_enabled", "recorder",
    "now", "record", "record_min", "span",
    "observe", "hist", "hist_summaries", "reset_hists",
]
