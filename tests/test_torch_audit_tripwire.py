"""`tools/bench_scaling.py`'s audit tripwire on the CPU: it gates the
flow, mem and merge audits and span coverage at eight rows each and
writes the memory manifest under `build/avenir_tpu_torch/`, never over
the root's. Eight copies of the Markov entry stand for the eight stream
entries (their audits against the JAX package's are
`test_torch_audit_entries.py` and `test_torch_audit_merge.py`); a
ninth row that fails its audit fails the tripwire."""

import dataclasses
import json
import os

import pytest

from avenir_tpu_torch.analysis import manifest
from avenir_tpu_torch.tools.bench_scaling import ROOT, audit_tripwire


def _copies(n, broken=False):
    markov = next(s for s in manifest.stream_entries("cpu")
                  if s.name == "markov_stream")
    entries = [dataclasses.replace(markov, name=f"markov_{i}")
               for i in range(n)]
    if broken:
        entries.append(dataclasses.replace(
            markov, name="one_layout", layouts=(64.0, 64.0, 64.0)))
    return lambda device="cpu": entries


def test_audit_tripwire_on_the_cpu(monkeypatch):
    monkeypatch.setattr(manifest, "stream_entries", _copies(8))
    root_manifest = os.path.join(ROOT, "MEMORY_MANIFEST.json")
    before = open(root_manifest, "rb").read()
    out = audit_tripwire(device="cpu")
    for what in ("invariance", "footprint", "merge", "incremental",
                 "shard_dedup", "span_coverage"):
        assert out[f"{what}_validated"] == 8, what
    assert out["memory_manifest"] == os.path.join(
        "build", "avenir_tpu_torch", "MEMORY_MANIFEST.json")
    with open(os.path.join(ROOT, out["memory_manifest"])) as fh:
        written = json.load(fh)
    assert len(written["footprint_audit"]) == 8
    assert {r["source"] for r in written["kernels"]} == {"shapes"}
    assert open(root_manifest, "rb").read() == before
    assert len(out["rows"]["invariance"]) == 8


def test_audit_tripwire_fails_on_a_failed_row(monkeypatch):
    monkeypatch.setattr(manifest, "stream_entries", _copies(7, broken=True))
    with pytest.raises(RuntimeError, match="flow audit regression"):
        audit_tripwire(device="cpu", kernels=False)
