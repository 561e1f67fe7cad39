"""The port's shard-merge and resume audit (`analysis/merge.py`) held
against the JAX package's on every stream entry on the CPU: shards of 2
and 4 merged, the mid-scan checkpoint, the overlap probe, the delta scan
killed and resumed (solo and fused) and the sharded steal give the
reference's row field for field, every verdict validated; and the
audit's negative cases."""

import dataclasses

import pytest

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.analysis.manifest import stream_entries as jax_entries
from avenir_tpu.analysis.merge import audit_merge as jax_audit_merge
from avenir_tpu_torch.analysis.manifest import stream_entries
from avenir_tpu_torch.analysis.merge import (MERGE_AUDIT_RULE,
                                             MergeAuditError, audit_merge)
from test_torch_audit_entries import NAMES, _entry


@pytest.mark.parametrize("name", NAMES)
def test_merge_audit_matches_the_reference(name):
    row, finding = audit_merge(_entry(stream_entries("cpu"), name))
    want, want_finding = jax_audit_merge(_entry(jax_entries(), name))
    assert finding is None and want_finding is None
    assert row["merge_validated"] and row["incremental_validated"] \
        and row["shard_dedup_validated"]
    assert row["overlap"]["contract"] == "non-idempotent"
    assert row["incremental"]["resume_interrupted"]
    assert row["sharded"]["dup_rejected"] and row["sharded"]["committed_once"]
    assert row == want


def _nb():
    return _entry(stream_entries("cpu"), "nb_stream")


def test_auditor_flags_a_corpus_too_small_to_shard():
    spec = _nb()

    def tiny_prepare(workdir):
        ctx = spec.prepare(workdir)
        with open(ctx["csv"], "w") as fh:       # one row: one block
            fh.write("c0,low,low,low,poor,12,open\n")
        return ctx

    row, finding = audit_merge(dataclasses.replace(
        spec, name="tiny_nb", prepare=tiny_prepare))
    assert row["merge_validated"] is False
    assert row["incremental_validated"] is False
    assert row["shard_dedup_validated"] is False
    assert row["shards"] == [] and row["checkpoint"] is None
    assert row["incremental"] is None and row["sharded"] is None
    assert finding is not None and finding.rule == MERGE_AUDIT_RULE
    assert "too small" in finding.message


def test_auditor_wraps_run_failures():
    def boom(ctx, block_mb):
        raise ValueError("synthetic fold failure")

    with pytest.raises(MergeAuditError, match="boom_kernel"):
        audit_merge(dataclasses.replace(_nb(), name="boom_kernel", run=boom))


def test_auditor_requires_fold_specs():
    with pytest.raises(MergeAuditError, match="fold_specs"):
        audit_merge(dataclasses.replace(_nb(), name="bare_kernel",
                                        fold_specs=()))
