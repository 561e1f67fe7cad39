"""The port's stream entries and their flow and coverage audits, held
against the JAX package's (`avenir_tpu/analysis/manifest.py`,
`analysis/flow.py`, `obs/coverage.py`), one test a stream entry and
audit on the CPU:

- at every layout, and under the adversarial scheduler, the port's
  entry writes the reference entry's artifact bytes;
- `audit_stream`'s rows agree field by field, but for the chunk counts:
  the reference's `_produce_hook` counts the items of every prefetch
  worker (a block counts once a stage it crosses), the port's counts the
  blocks read, so the reference's counts are the port's times one whole
  number an entry (its stages), at every layout;
- the coverage rows agree field by field, but for `total_spans`, which
  holds the stall spans: they are recorded when a queue wait passes 1
  ms, so their number changes from run to run in either package.
"""

import dataclasses

import pytest

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.analysis.flow import audit_stream as jax_audit_stream
from avenir_tpu.analysis.manifest import stream_entries as jax_entries
from avenir_tpu.obs.coverage import audit_entry as jax_coverage
from avenir_tpu_torch.analysis.flow import audit_stream
from avenir_tpu_torch.analysis.manifest import (stream_entries,
                                                stream_kernel_names)
from avenir_tpu_torch.obs.coverage import MANDATORY_SPANS, audit_entry

NAMES = ["nb_stream", "mi_stream", "discriminant_stream", "markov_stream",
         "apriori_stream", "gsp_stream", "shared_churn_stream",
         "shared_seq_stream"]


def _entry(entries, name):
    return next(s for s in entries if s.name == name)


def _recording(spec):
    """The spec with its runs' artifacts kept, in call order."""
    outs = []

    def run(ctx, block_mb):
        blob = spec.run(ctx, block_mb)
        outs.append(blob)
        return blob

    return dataclasses.replace(spec, run=run), outs


def test_the_port_has_the_reference_entries():
    assert stream_kernel_names() == NAMES
    assert [s.name for s in jax_entries()] == NAMES
    for port, ref in zip(stream_entries("cpu"), jax_entries()):
        assert port.layouts == ref.layouts and port.jobs == ref.jobs
        assert [(j, p) for j, p, _c in port.fold_specs] == \
            [(j, p) for j, p, _c in ref.fold_specs]
        assert port.path.startswith("avenir_tpu_torch/") and port.line > 1
        assert port.device == "cpu"
        for _job, prefix, conf in port.fold_specs:
            assert conf[f"{prefix}.stream.sidecar"] == "false"


@pytest.mark.parametrize("name", NAMES)
def test_flow_audit_and_artifacts_match_the_reference(name):
    port, port_outs = _recording(_entry(stream_entries("cpu"), name))
    ref, ref_outs = _recording(_entry(jax_entries(), name))
    row, finding = audit_stream(port)
    want, want_finding = jax_audit_stream(ref)
    assert finding is None and want_finding is None
    assert row["invariance_validated"] is True
    # three layouts and the adversarial run, each the reference's bytes
    assert len(port_outs) == len(ref_outs) == len(port.layouts) + 1
    assert port_outs == ref_outs
    counts, ref_counts = row.pop("chunk_counts"), want.pop("chunk_counts")
    assert row == want
    stages = ref_counts[0] // counts[0]
    assert stages >= 1
    assert ref_counts == [stages * n for n in counts], (counts, ref_counts)
    assert len(set(counts)) == len(counts)


@pytest.mark.parametrize("name", NAMES)
def test_span_coverage_matches_the_reference(name):
    row = audit_entry(_entry(stream_entries("cpu"), name))
    want = jax_coverage(_entry(jax_entries(), name))
    assert row["span_coverage_validated"] is True
    assert row["span_counts"]["stream.read"] > 1
    assert all(row["span_counts"][n] >= 1 for n in MANDATORY_SPANS)
    row.pop("total_spans")
    want.pop("total_spans")
    assert row == want
