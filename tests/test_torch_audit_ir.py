"""The port's IR tier (`avenir_tpu_torch/analysis/ir.py`) on the CPU, held
against the JAX package's (`avenir_tpu/analysis/ir.py`) in this process,
whose harness pins 8 virtual JAX devices.

- the gate: `run_ir(device="cpu")` clean under the port's allowlist, no
  stale entry, eight payload rows each with observed == recorded ==
  model bytes; the manifest's names are the reference's;
- each family's row against the reference's `audit_family` row on the
  same mesh: the model's bytes (twice the reference's for the int64 and
  float64 cells, equal for KNN, 0 for the bandit) and the collective
  kinds;
- each rule's bad twin fires and its good twin stays silent
  (`tests/torch_ir_fixtures.py`), a read inside a loop against the same
  read after it;
- drift two ways (a model 4 bytes off, a family that runs one collective
  it never records), each a `ir-collective-payload` finding scoped to
  the family; a failing build raises IRTraceError, in this process and
  in a rank;
- the CLI's `--ir --json` and its exit-2 cases; the SASS scanner on text.

The gate's world, the drift world, the failing rank's world and the
CLI's each spawn eight ranks; about a minute in all.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

import torch_ir_fixtures as fx
from avenir_tpu.analysis import engine as jengine
from avenir_tpu.analysis import ir as jir
from avenir_tpu.analysis import manifest as jmanifest
from avenir_tpu_torch.analysis import ir, manifest
from avenir_tpu_torch.analysis.engine import BaselineEntry, load_baseline
from avenir_tpu_torch.parallel.distributed import FAMILIES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the families whose cells are 8 bytes in the port and 4 in the
#: reference (tests/test_torch_dist_collective.py holds the model so)
_WIDE = ("nb_train", "tree_level", "lr_step", "markov_counts",
         "apriori_support", "crosscount")


@pytest.fixture(scope="module")
def gate():
    captures = {}
    report = ir.run_ir(baseline=load_baseline(), device="cpu",
                       captures=captures)
    return report, captures


def _spec(name="fixture"):
    return manifest.KernelSpec(name, "tests/torch_ir_fixtures.py", 1,
                               lambda _mesh: None)


def _findings(fn, *args, rules=None):
    cap = ir.record(fn, args, "cpu")
    return ir.check_capture(_spec(), cap, rules)


def _ids(findings):
    return {f.rule for f in findings}


# ------------------------------------------------------------------- gate
def test_gate_is_clean_with_eight_validated_families(gate):
    report, captures = gate
    assert report.clean, [f.render() for f in report.findings] + [
        e.key for e in report.stale]
    assert report.suppressed and not report.errors
    rows = report.payload_audit
    assert [r["family"] for r in rows] == manifest.family_names()
    for r in rows:
        assert r["payload_model_validated"] is True, r
        assert (r["observed_payload_bytes"] == r["recorded_payload_bytes"]
                == r["analytic_payload_bytes"]), r
    assert set(captures) == {s.name for s in manifest.manifest_entries(
        "cpu")}


def test_manifest_names_are_the_references():
    assert [s.name for s in manifest.manifest_entries("cpu")] == \
        [s.name for s in jmanifest.manifest_entries()]
    assert manifest.family_names() == list(FAMILIES)
    assert manifest.AUDIT_DEVICES == jmanifest.AUDIT_DEVICES
    for s in manifest.manifest_entries("cpu"):
        assert s.path.startswith("avenir_tpu_torch/") and s.line > 1
        assert s.is_family == (s.name in FAMILIES)
        assert s.model_parallel == (2 if s.name == "knn_topk" else 1)


def test_entries_default_to_the_card(monkeypatch):
    import inspect

    for fn in (ir.run_ir, manifest.manifest_entries, manifest._op_entries):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = manifest._op_entries("cpu")[0]
    with pytest.raises(ir.IRTraceError, match="CUDA device"):
        ir.run_ir(entries=[spec], baseline=[])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_row_against_the_reference(gate, family):
    report, _captures = gate
    row = next(r for r in report.payload_audit if r["family"] == family)
    jspec = next(s for s in jmanifest.manifest_entries()
                 if s.name == family)
    jrow, jfinding = jir.audit_family(jspec, jax.devices())
    assert jfinding is None and row["mesh"] == jrow["mesh"]
    want = jrow["analytic_payload_bytes"]
    if family in _WIDE:
        want *= 2
    assert row["analytic_payload_bytes"] == want
    if family == "bandit_select":
        assert want == 0
    assert {c["op"] for c in row["collectives"]} == \
        {c["op"] for c in jrow["collectives"]}


def test_the_ir_findings_are_the_allowlisted_ones(gate):
    """The gate absorbed exactly the allowlist's IR keys that hold on
    the CPU, and the families' int64 and float64 are found where the
    allowlist says they are."""
    report, captures = gate
    keys = {f.key for f in report.suppressed}
    ir_keys = {e.key for e in ir.for_device(load_baseline(), "cpu")
               if e.key.split("::")[1].startswith("ir-")}
    assert keys == ir_keys
    lr = {d for e in captures["lr_step"].events for d in e.wide}
    assert lr == {"float64"}
    counts = {e.op for e in captures["nb_train"].events
              if e.op.startswith("c10d.")}
    assert counts == {"c10d.allreduce_"}


# -------------------------------------------------------------- rule twins
@pytest.mark.parametrize("bad,good,rule", [
    (fx.read_in_loop, fx.read_after_loop, "ir-callback-in-loop"),
    (fx.read_in_helper_in_loop, fx.read_in_helper_once,
     "ir-callback-in-loop"),
    (fx.size_read_in_loop, fx.size_read_once, "ir-callback-in-loop"),
    (fx.mask_index_in_loop, fx.mask_index_once, "ir-callback-in-loop"),
    (fx.lift_in_loop, fx.lift_once, "ir-host-transfer-in-loop"),
    (fx.place_in_loop, fx.place_once, "ir-host-transfer-in-loop"),
    (fx.widen, fx.stay_narrow, "ir-widen-64bit"),
])
def test_rule_twins(bad, good, rule):
    """The rule under test alone (an index op's int64 output is the
    widening rule's)."""
    x = torch.arange(6, dtype=torch.float32)
    if bad is fx.mask_index_in_loop:
        x = x.reshape(2, 3)
    only = [r() for r in ir.ALL_IR_RULES if r.rule_id == rule]
    assert _ids(_findings(bad, x, rules=only)) == {rule}, bad.__name__
    assert _findings(good, x, rules=only) == [], good.__name__


def test_widen_counts_the_int64_a_count_makes():
    x = torch.tensor([0, 1, 3, 3], dtype=torch.int32)
    got = _findings(fx.count_int64, x)
    assert _ids(got) == {"ir-widen-64bit"}
    assert {f.message.split("through ")[1].split("`")[1] for f in got} == {
        "aten._to_copy", "aten.bincount"}
    assert _findings(fx.count_int32, x) == []


def test_a_loop_site_names_the_loop_line():
    cap = ir.record(fx.read_in_helper_in_loop,
                    (torch.ones(3, 2),), "cpu")
    reads = [e for e in cap.events if e.op == "aten._local_scalar_dense"]
    assert len(reads) == 3
    assert {e.loop_site.split(":")[0] for e in reads} == {
        "tests/torch_ir_fixtures.py"}
    assert {e.site for e in reads} != {e.loop_site for e in reads}


def test_a_sync_is_explained_only_by_a_host_read_at_its_line():
    """The card's sync warnings name the line their call returned to;
    one is explained when the capture recorded a device-to-host read
    whose frames pass that line."""
    def ev(op, chain, src="cuda", dst="cuda"):
        return ir.OpEvent(op, (), src, dst, chain[0], None, chain)

    cap = ir.Capture("k", "cuda", events=[
        ev("aten._local_scalar_dense", ("a.py:3", "b.py:7")),
        ev("aten._to_copy", ("c.py:5",), dst="cpu"),
        ev("aten.add", ("d.py:1",))],
        syncs=["b.py:7", "c.py:5", "d.py:1", "e.py:2"])
    assert cap.unexplained_syncs() == ["d.py:1", "e.py:2"]


def test_rule_ids_are_the_references():
    assert ir.ir_rule_ids() == jir.ir_rule_ids()
    assert ir.PAYLOAD_RULE == jir.PAYLOAD_RULE


def test_device_tagged_allowlist_entries():
    base = [BaselineEntry("a.py::ir-widen-64bit::x", "[cpu] plain", 1),
            BaselineEntry("a.py::ir-widen-64bit::y", "[cuda] kernel", 2),
            BaselineEntry("a.py::ir-widen-64bit::z", "both", 3),
            BaselineEntry("a.py::flow-x::w", "[cuda] not ir", 4)]
    assert [e.lineno for e in ir.for_device(base, "cpu")] == [1, 3, 4]
    assert [e.lineno for e in ir.for_device(base, "cuda")] == [2, 3, 4]
    assert ir.for_device(None, "cpu") is None


# ------------------------------------------------------------------ drift
def test_drift_fails_validation_two_ways():
    by = {s.name: s for s in manifest.manifest_entries("cpu")}
    nb, cross = by["nb_train"], by["crosscount"]
    off = dataclasses.replace(
        nb, payload_model=lambda shape: nb.payload_model(shape) + 4)
    extra = dataclasses.replace(cross, build=fx.cross_extra_build)
    report = ir.run_ir(entries=[off, extra], baseline=load_baseline(),
                       device="cpu", rules=[])
    rows = {r["family"]: r for r in report.payload_audit}
    assert rows["nb_train"]["payload_model_validated"] is False
    assert rows["nb_train"]["analytic_payload_bytes"] == 1296 + 4
    assert rows["nb_train"]["observed_payload_bytes"] == 1296
    c = rows["crosscount"]
    assert c["payload_model_validated"] is False
    assert (c["observed_payload_bytes"], c["recorded_payload_bytes"],
            c["analytic_payload_bytes"]) == (168, 160, 160)
    assert [x["op"] for x in c["collectives"]] == ["all-reduce"] * 2
    found = {(f.rule, f.scope) for f in report.findings}
    assert found == {(ir.PAYLOAD_RULE, "nb_train"),
                     (ir.PAYLOAD_RULE, "crosscount")}


def test_a_failing_build_is_a_trace_error():
    bad = dataclasses.replace(_spec("broken"), build=fx.failing_build)
    with pytest.raises(ir.IRTraceError, match="could not build"):
        ir.run_ir(entries=[bad], baseline=[], device="cpu")
    fam = dataclasses.replace(manifest.manifest_entries("cpu")[-1],
                              build=fx.failing_build)
    with pytest.raises(ir.IRTraceError, match="no such family"):
        ir.run_ir(entries=[fam], baseline=[], device="cpu")


# -------------------------------------------------------------------- CLI
def _cli(args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "avenir_tpu_torch.analysis", *args],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env={**os.environ, "PYTHONPATH": REPO, **(env or {})})


def test_cli_ir_json_is_clean_in_the_references_schema():
    proc = _cli(["--ir", "--device", "cpu", "--json"])
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    rep = json.loads(proc.stdout)
    assert set(rep) == set(jengine.Report().to_json())
    assert rep["clean"] is True and rep["findings"] == []
    assert len(rep["payload_audit"]) == 8
    for r in rep["payload_audit"]:
        assert r["payload_model_validated"]
        assert (r["observed_payload_bytes"] == r["recorded_payload_bytes"]
                == r["analytic_payload_bytes"])


@pytest.mark.parametrize("args,env", [
    (["--ir", "avenir_tpu_torch/"], None),
    (["--ir", "--rules", "nope"], None),
    (["--ir", "--device", "cpu"], {ir.DEVICES_ENV: "1"}),
    (["--ir", "--device", "nodevice"], None),
])
def test_cli_ir_usage_and_trace_errors_exit_2(args, env):
    proc = _cli(args, env)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    if args[-1] in ("cpu", "nodevice"):
        assert "trace error" in proc.stderr


# ------------------------------------------------------------------- SASS
_SASS_FP64 = """
        code for sm_90a
                Function : _Z9kernel_f64Pdi
        /*0040*/                   LDG.E.64 R2, desc[UR4][R2.64] ;
        /*0050*/                   DFMA R4, R2, R2, R4 ;
        /*0060*/                   F2F.F32.F64 R6, R4 ;
        /*0070*/                   EXIT ;
                Function : _Z9kernel_f32Pfi
        /*0040*/                   FFMA R4, R2, R2, R4 ;
        /*0050*/                   F2F.F16.F32 R6, R4 ;
"""

_SASS_FP32 = """
                Function : _Z6kernelPfi
        /*0040*/                   FFMA R4, R2, R2, R4 ;
        /*0050*/                   FADD R5, R4, R4 ;
        /*0060*/                   I2F.U32 R6, R4 ;
        /*0070*/                   F2I.S64.TRUNC R6, R4 ;
"""


def test_sass_scanner():
    assert ir.scan_sass(_SASS_FP64) == {
        "_Z9kernel_f64Pdi": {"DFMA": 1, "F2F.F32.F64": 1}}
    assert ir.scan_sass(_SASS_FP32) == {}
    cap = ir.Capture("k", "cuda", libraries=("knn_topk",),
                     sass={"knn_topk": ir.scan_sass(_SASS_FP64)})
    got = ir.check_capture(_spec("knn_topk_pallas"), cap)
    assert [(f.rule, f.scope) for f in got] == [
        ("ir-widen-64bit", "knn_topk_pallas.libknn_topk")]
