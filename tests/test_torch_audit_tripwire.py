"""`tools/bench_scaling.py`'s audit tripwire on the CPU: it gates the
AST rules over the package, the keys, proto and race audits, the IR
rules with the eight families' payloads (a gloo world of eight ranks),
then the flow, mem and merge audits and span coverage at eight rows
each, and writes the memory manifest under `build/avenir_tpu_torch/`,
never over the root's. Eight copies of the Markov entry stand for the
eight stream entries (their audits against the JAX package's are
`test_torch_audit_entries.py` and `test_torch_audit_merge.py`), and one
or two sites a host tier for its registered sites (every site:
`test_torch_audit_keys.py`, `_proto.py`, `_race.py`); a ninth row that
fails its audit, or a host site that fails its own, fails the
tripwire, as a family whose payload drifts from its model does."""

import dataclasses
import json
import os

import pytest

import functools

from avenir_tpu_torch.analysis import ir, keys, manifest, proto, race
from avenir_tpu_torch.tools.bench_scaling import ROOT, audit_tripwire


def _small_host_tiers(monkeypatch, key_sites=("sidecar.bytes",)):
    """A site or two a host tier (its registry cross-check off), the race
    at depth 1 and one seed."""
    for module, registry, check, names in (
            (keys, "KEY_SITES", "check_key_registry", key_sites),
            (proto, "COMMIT_SITES", "check_site_registry",
             ("checkpoint.save", "profile.save")),
            (race, "INTERLEAVE_SITES", "check_sched_registry",
             ("checkpoint.save",))):
        monkeypatch.setattr(module, registry,
                            [s for s in getattr(module, registry)
                             if s.name in names])
        monkeypatch.setattr(module, check, lambda root=None: {})
    monkeypatch.setattr(race, "run_race",
                        functools.partial(race.run_race, depth=1, seeds=1))


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
    _small_host_tiers(monkeypatch)
    out = audit_tripwire(device="cpu")
    for what in ("invariance", "footprint", "merge", "incremental",
                 "shard_dedup", "span_coverage"):
        assert out[f"{what}_validated"] == 8, what
    assert (out["keys_validated"], out["proto_validated"],
            out["race_validated"]) == (1, 2, 1)
    assert out["payload_validated"] == 8 and out["ir_allowlisted"] > 8
    assert [r["family"] for r in out["rows"]["payload"]] == \
        manifest.family_names()
    assert out["ast_files"] > 100 and out["ast_allowlisted"] > 40
    assert out["rows"]["race"][0]["schedules"] == {
        "exhaustive": 2, "seeded": 1, "replay": 0}
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
    _small_host_tiers(monkeypatch)
    with pytest.raises(RuntimeError, match="flow audit regression"):
        audit_tripwire(device="cpu", kernels=False)


def test_audit_tripwire_fails_on_a_host_site(monkeypatch):
    """A key site whose key cannot see a registered dimension fails the
    tripwire before any stream entry runs."""
    from test_torch_audit_keys import _bad_site

    _small_host_tiers(monkeypatch, key_sites=())
    monkeypatch.setattr(keys, "KEY_SITES", [_bad_site(keys)])
    with pytest.raises(RuntimeError, match="keys audit regression"):
        audit_tripwire(device="cpu", kernels=False)


def test_audit_tripwire_ir_leg_fails_on_a_drifted_family(monkeypatch):
    """The IR leg on the CPU: a family whose model is 4 bytes off fails
    the tripwire before any stream entry runs."""
    entries = manifest.manifest_entries("cpu")
    nb = next(s for s in entries if s.name == "nb_train")
    off = dataclasses.replace(
        nb, payload_model=lambda shape: nb.payload_model(shape) + 4)
    monkeypatch.setattr(ir, "manifest_entries", lambda device="cuda": [
        off if s.name == "nb_train" else s for s in entries])
    with pytest.raises(RuntimeError, match="IR audit regression.*nb_train"):
        audit_tripwire(device="cpu", host=False, kernels=False)
