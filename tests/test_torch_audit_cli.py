"""`python -m avenir_tpu_torch.analysis` on the CPU: its exit codes (0
clean, 1 findings, 2 a usage error or an audit that failed to run), its
JSON for one tier and for several, its usage errors (the audits' own
runs are held in `test_torch_audit_*.py` and the audit tripwire);
and the miner and shared-scan tripwires of `tools/bench_scaling.py` at
small row counts."""

import json
import os
import subprocess
import sys

import pytest
import torch

from test_graftlint_flow import _THREAD_BAD, _THREAD_GOOD
from test_graftlint_mem import _CARRY_BAD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "avenir_tpu_torch.analysis", *args],
        capture_output=True, text=True, cwd=cwd, timeout=600,
        env={**os.environ, "PYTHONPATH": REPO})


def test_cli_exit_codes_and_json(tmp_path):
    (tmp_path / "bad.py").write_text(_THREAD_BAD)
    (tmp_path / "good.py").write_text(_THREAD_GOOD)
    # findings, an audit left out by the rule subset: 1
    proc = _cli(["--flow", "bad.py", "--rules", "flow-unjoined-thread",
                 "--no-baseline", "--json"], cwd=str(tmp_path))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    rep = json.loads(proc.stdout)
    assert rep["counts"] == {"flow-unjoined-thread": 2}
    assert rep["invariance_audit"] == [] and rep["clean"] is False
    # clean: 0, text output
    proc = _cli(["--flow", "good.py", "--rules", "flow-unjoined-thread",
                 "--no-baseline"], cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout


def test_cli_combines_tiers_with_the_worst_exit(tmp_path):
    (tmp_path / "bad.py").write_text(_CARRY_BAD)
    proc = _cli(["--flow", "--mem", "bad.py", "--rules",
                 "flow-unjoined-thread,mem-unbounded-carry", "--no-baseline",
                 "--json"], cwd=str(tmp_path))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    rep = json.loads(proc.stdout)
    assert set(rep["modes"]) == {"flow", "mem"} and rep["clean"] is False
    assert rep["modes"]["flow"]["findings"] == []
    assert set(rep["modes"]["mem"]["counts"]) == {"mem-unbounded-carry"}


def test_the_audits_default_to_the_card():
    """As every entry point of the port, the CLI and the audit functions
    run on cuda unless the caller asks for the CPU."""
    import inspect

    from avenir_tpu_torch.analysis import (cli, flow, keys, manifest, mem,
                                           merge, proto, race)
    from avenir_tpu_torch.obs import coverage

    assert cli.build_parser().parse_args(["--flow"]).device == "cuda"
    assert cli.build_parser().parse_args(["--ir"]).device == "cuda"
    assert {s.device for s in manifest.stream_entries()} == {"cuda"}
    for fn in (manifest.stream_entries, flow.run_flow, mem.run_mem,
               merge.run_merge, mem.memory_manifest,
               mem.kernel_device_entries, coverage.audit_span_coverage,
               keys.run_keys, keys.audit_keys, proto.run_proto,
               race.run_race):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("args,text", [
    (["--flow", "--rules", "nope"], "unknown rule"),
    (["--ir", "avenir_tpu_torch/"], "do not pass paths"),
    (["--schedule", "ledger.claim:01"], "needs --race"),
    (["--race", "--schedule", "ledger.claim"], "bad schedule"),
    (["--keys", "--proto", "--rules", "nope"], "unknown rule"),
    ([], "pass paths"),
    (["--flow", "--rules", "flow-chunk-invariance", "--device", "nodevice"],
     "failed to run"),
    pytest.param(["--flow", "--rules", "flow-chunk-invariance"],
                 "runs on a CUDA device by default",
                 marks=pytest.mark.skipif(
                     torch.cuda.is_available(),
                     reason="the default device is present")),
])
def test_cli_usage_and_audit_errors_exit_2(args, text):
    proc = _cli(args)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert text in proc.stderr


#: (reference fixture module, fixture stem, tier flag, rule id)
_EXIT_CASES = [
    ("test_graftlint", "_INT64", None, "default-int64"),
    ("test_graftlint", "_SYNC", None, "host-sync-in-fold"),
    ("test_graftlint_keys", "_MTIME", "--keys", "keys-mtime-validity"),
    ("test_graftlint_proto", "_NONATOMIC", "--proto",
     "proto-nonatomic-publish"),
    ("test_graftlint_race", "_CTA", "--race", "race-check-then-act"),
]


@pytest.mark.parametrize("module,stem,tier,rule", _EXIT_CASES,
                         ids=[c[3] for c in _EXIT_CASES])
def test_cli_exit_codes_match_the_reference(tmp_path, monkeypatch, capsys,
                                            module, stem, tier, rule):
    """The AST tier and the keys, proto and race tiers exit as the
    reference's command line does on its fixtures: 1 on the bad one, 0
    on the good one (a rule subset, so no audit runs), 2 on an unknown
    rule; the port's JSON holds the same counts."""
    import importlib

    from avenir_tpu.analysis import cli as jax_cli
    from avenir_tpu_torch.analysis import cli

    fx = importlib.import_module(module)
    (tmp_path / "bad.py").write_text(getattr(fx, stem + "_BAD"))
    (tmp_path / "good.py").write_text(getattr(fx, stem + "_GOOD"))
    monkeypatch.chdir(tmp_path)
    flag = [tier] if tier else []
    for argv in (flag + ["bad.py", "--rules", rule, "--no-baseline"],
                 flag + ["good.py", "--rules", rule, "--no-baseline"],
                 flag + ["good.py", "--rules", "nope"]):
        got = cli.main(argv + ["--device", "cpu"])
        capsys.readouterr()
        assert got == jax_cli.main(argv), argv
        capsys.readouterr()
    assert cli.main(flag + ["bad.py", "--rules", rule, "--no-baseline",
                            "--json", "--device", "cpu"]) == 1
    rep = json.loads(capsys.readouterr().out)
    jax_cli.main(flag + ["bad.py", "--rules", rule, "--no-baseline",
                         "--json"])
    assert rep["counts"] == json.loads(capsys.readouterr().out)["counts"]
    assert rep["proto_audit"] == rep["race_audit"] == rep["key_audit"] == []


def test_cli_ast_tier_passes_the_package():
    proc = _cli(["avenir_tpu_torch", "--json"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = json.loads(proc.stdout)
    assert rep["clean"] and rep["findings"] == []
    assert rep["files_scanned"] > 100 and rep["suppressed"] > 40


def test_cli_runs_the_new_tiers_together_on_the_cpu(tmp_path):
    (tmp_path / "clean.py").write_text("x = 1\n")
    proc = _cli(["--keys", "--race", "clean.py", "--rules",
                 "keys-mtime-validity,race-check-then-act", "--json",
                 "--device", "cpu"], cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = json.loads(proc.stdout)
    assert set(rep["modes"]) == {"keys", "race"} and rep["clean"]


def test_cli_bad_allowlist_exits_2(tmp_path):
    bad = tmp_path / "allow.txt"
    bad.write_text("x.py::flow-unjoined-thread::f\n")
    proc = _cli(["--flow", "--rules", "flow-unjoined-thread", "--baseline",
                 str(bad)])
    assert proc.returncode == 2 and "justification" in proc.stderr


# ------------------------------------------------------------ tripwires
def test_miner_tripwire_on_the_cpu():
    from avenir_tpu_torch.tools.bench_scaling import miner_tripwire

    out = miner_tripwire(rows=3_000, device="cpu")
    for job in ("frequentItemsApriori", "candidateGenerationWithSelfJoin"):
        assert out[job]["rows"] == 3_000 and out[job]["rows_per_sec"] > 0
    # the CPU builds and binds no kernel library and launches no kernel
    assert out["gsp_build_counts"] == [
        {"builds": 0, "binds": 0, "libraries": []}] * 2
    assert out["gsp_subseq_support_launches"] == 0
    cache = out["miner_cache"]
    assert cache["replays"] >= 1
    assert 0 < cache["cache_bytes"] < cache["csv_bytes"]


class _FakeLibrary:
    """A library whose every C entry is a plain object, for `bind`."""

    def __getattr__(self, entry):
        return type(entry, (), {})()


def test_miner_tripwire_catches_a_rebind_per_run(monkeypatch):
    """A GSP run that binds its library again, as a re-bind a block
    would, adds to `ops._build.counts` on the rerun and fails the gate."""
    from avenir_tpu_torch import runner
    from avenir_tpu_torch.ops import _build
    from avenir_tpu_torch.tools.bench_scaling import miner_tripwire

    real = runner.run_job

    def rebinding(job, *args, **kw):
        res = real(job, *args, **kw)
        if job == "candidateGenerationWithSelfJoin":
            _build.bind(_FakeLibrary(), "subseq_support")
        return res

    monkeypatch.setattr(runner, "run_job", rebinding)
    monkeypatch.setattr(_build, "counts", {"builds": 0, "binds": 0})
    with pytest.raises(RuntimeError, match="re-bound a block"):
        miner_tripwire(rows=1_000, device="cpu")


def test_shared_scan_tripwire_on_the_cpu():
    from avenir_tpu_torch.tools.bench_scaling import shared_scan_tripwire

    out = shared_scan_tripwire(rows=3_000, floor=0.0, device="cpu")
    assert out["outputs_byte_identical"] is True
    assert out["fused_build_counts"] == {"builds": 0, "binds": 0,
                                         "libraries": []}
    assert len(out["t_sequential_runs_s"]) == len(out["t_fused_runs_s"]) == 3
    assert out["speedup"] > 0


def test_tripwire_command_line_takes_the_new_names():
    from avenir_tpu_torch.tools.bench_scaling import TRIPWIRES, main

    assert {"miner", "shared_scan", "audit"} <= set(TRIPWIRES)
    with pytest.raises(SystemExit):
        main(["--tripwire", "audit", "--rows", "10", "--device", "cpu"])
