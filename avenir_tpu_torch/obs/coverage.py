"""The span-coverage auditor: instrumentation that cannot rot unseen.

The port of `avenir_tpu/obs/coverage.py`. A lost instrumentation point
fails no artifact test and blinds the profiling that reads the spans, so
every stream entry (`analysis.manifest.stream_entries`: the real jobs
over their corpora, the sidecar off) runs under a captured recorder, and
each must emit the mandatory spans at least once:

- ``stream.read``: a raw byte block left the disk (`core.stream`);
- ``stream.parse``: a block became typed data (the CSV parse, the native
  sequence and transaction encoders);
- ``stream.fold``: a sink or device fold consumed a chunk;
- ``job.finish``: the job sealed its fold and wrote the artifact.

`tools.bench_scaling.audit_tripwire` holds this at 8 of 8 beside the
invariance, footprint and merge audits; a fold stripped of its spans
(`tests/test_torch_audit.py`) fails it.
"""

from __future__ import annotations

import shutil
import tempfile
from collections import Counter
from typing import List, Optional, Sequence

from avenir_tpu_torch.obs import trace

#: the span names every stream entry must emit at least once
MANDATORY_SPANS = ("stream.read", "stream.parse", "stream.fold",
                   "job.finish")


class SpanCoverageError(RuntimeError):
    """A stream entry failed to run under the auditor (not the same as
    running and emitting no spans, which is a row that fails)."""


def audit_entry(spec, layout_mb: Optional[float] = None) -> dict:
    """One stream entry under a fresh captured recorder: its row of
    mandatory-span counts."""
    workdir = tempfile.mkdtemp(prefix=f"obs_coverage_{spec.name}_")
    try:
        ctx = spec.prepare(workdir)
        if layout_mb is None:
            # the middle layout: the audit corpus cuts into many chunks,
            # so the per-chunk spans must repeat
            layout_mb = (spec.layouts[1] if len(spec.layouts) > 1
                         else spec.layouts[0])
        with trace.capture() as rec:
            spec.run(ctx, layout_mb)
        spans = rec.spans()
    except Exception as e:
        raise SpanCoverageError(
            f"{spec.name}: stream entry failed to run under the span "
            f"auditor: {e!r}") from e
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    names = Counter(sp.name for sp in spans)
    missing = [n for n in MANDATORY_SPANS if names.get(n, 0) < 1]
    return {"kernel": spec.name,
            "layout_mb": float(layout_mb),
            "span_counts": {n: names.get(n, 0) for n in MANDATORY_SPANS},
            "total_spans": len(spans),
            "missing": missing,
            "span_coverage_validated": not missing}


def audit_span_coverage(entries: Optional[Sequence] = None,
                        device: str = "cuda") -> List[dict]:
    """Coverage rows of every stream entry on `device` (or of `entries`);
    a caller gates on each row's ``span_coverage_validated``."""
    if entries is None:
        from avenir_tpu_torch.analysis.manifest import stream_entries

        entries = stream_entries(device)
    return [audit_entry(spec) for spec in entries]
