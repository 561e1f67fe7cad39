"""The port stands alone: importing `avenir_tpu_torch` and every one of its
modules (and `chip_smoke.py`) loads neither `jax` nor any module of the
JAX package `avenir_tpu`. Checked in a fresh interpreter, since this test
process has both loaded already."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "avenir_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py"))
FORBIDDEN_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|avenir_tpu)(\.|\s|$)",
                              re.M)

_PROBE = """
import importlib, json, sys
sys.path.insert(0, sys.argv[1])
for name in sys.argv[2:]:
    importlib.import_module(name)
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(*modules):
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT), *modules],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _forbidden(names):
    # `avenir_tpu_torch` starts with `avenir_tpu`: match the JAX package
    # exactly or by its `avenir_tpu.` prefix
    return [n for n in names if n in ("jax", "avenir_tpu")
            or n.startswith(("jax.", "avenir_tpu.", "jaxlib"))]


def test_modules_list_covers_the_package():
    assert "avenir_tpu_torch" in MODULES
    assert "avenir_tpu_torch.ops.knn_kernels" in MODULES
    assert "avenir_tpu_torch.models.convert" in MODULES
    assert "avenir_tpu_torch.tools.kernel_check" in MODULES
    assert "avenir_tpu_torch.tools.knn_sweep" in MODULES
    assert "avenir_tpu_torch.models.naive_bayes" in MODULES
    assert "avenir_tpu_torch.models.artifact" in MODULES
    assert "avenir_tpu_torch.ops.matmul_ceiling" in MODULES
    assert "avenir_tpu_torch.tools.bench" in MODULES
    for sub in ("obs", "obs.trace", "obs.histogram", "native",
                "native.ingest", "ops.reduce", "ops.infotheory",
                "models.explore", "models.discriminant", "models.tree",
                "models.text", "models.sequence", "models.bandits",
                "ops.sequence_kernels", "ops.prng", "tools.bandit_check",
                "models.markov", "core.keys", "server", "server.score",
                "models.reinforce", "streaming", "utils.tabular",
                "utils.mcmc", "utils.profiling", "utils.sampling",
                "models.svm", "models.neural", "ops.sampling_kernels",
                "tools.sampling_check", "dist", "dist.driver", "dist.worker",
                "dist.plan", "dist.ledger", "dist.detect", "dist.collective",
                "tune", "tune.signals", "tune.knobs", "tune.policy",
                "tune.store", "tune.report", "parallel.scaling",
                "tools.bench_scaling", "core.incremental", "native.sidecar",
                "server.jobserver", "server.spool", "net", "net.router",
                "net.listener", "net.fault", "net.fleet", "obs.report",
                "analysis", "analysis.mem", "tools.fleet_load",
                "analysis.engine", "analysis.manifest", "analysis.flow",
                "analysis.merge", "analysis.cli", "analysis.__main__",
                "obs.coverage", "analysis.rules", "analysis.keys",
                "analysis.proto", "analysis.race", "utils.metrics"):
        assert f"avenir_tpu_torch.{sub}" in MODULES


def test_native_source_is_the_ports_own():
    """The native parser builds from the port's own copy of the C++
    source, in the port's build directory."""
    from avenir_tpu_torch.native import ingest

    assert ingest.SRC == PORT / "native" / "csv_ingest.cpp"
    assert ingest.SRC.exists()
    assert ingest.BUILD_ROOT == ROOT / "build" / "avenir_tpu_torch" / "native"


@pytest.mark.parametrize("entry", ["avenir_tpu_torch", "all", "chip_smoke",
                                   "obs", "native", "mutualInformation",
                                   "fisherDiscriminant", "tree", "text",
                                   "sequence", "bandits", "markov",
                                   "score", "reinforce", "library",
                                   "dist", "serve", "audit",
                                   "host_services"])
def test_import_loads_no_jax(entry):
    modules = {"avenir_tpu_torch": ["avenir_tpu_torch"], "all": MODULES,
               "chip_smoke": ["chip_smoke"],
               "obs": ["avenir_tpu_torch.obs"],
               "native": ["avenir_tpu_torch.native.ingest"],
               "mutualInformation": ["avenir_tpu_torch.runner",
                                     "avenir_tpu_torch.models.explore",
                                     "avenir_tpu_torch.ops.infotheory",
                                     "avenir_tpu_torch.ops.reduce"],
               "fisherDiscriminant": ["avenir_tpu_torch.runner",
                                      "avenir_tpu_torch.models.discriminant",
                                      "avenir_tpu_torch.pipelines"],
               "tree": ["avenir_tpu_torch.models.tree",
                        "avenir_tpu_torch.data.generators",
                        "avenir_tpu_torch.tools.bench"],
               "text": ["avenir_tpu_torch.models.text",
                        "avenir_tpu_torch.models.convert"],
               "sequence": ["avenir_tpu_torch.models.sequence",
                            "avenir_tpu_torch.ops.sequence_kernels"],
               "bandits": ["avenir_tpu_torch.models.bandits",
                           "avenir_tpu_torch.ops.prng",
                           "avenir_tpu_torch.tools.bandit_check",
                           "avenir_tpu_torch.pipelines"],
               "markov": ["avenir_tpu_torch.models.markov",
                          "avenir_tpu_torch.models.convert",
                          "avenir_tpu_torch.runner",
                          "avenir_tpu_torch.data.generators"],
               "serve": ["avenir_tpu_torch.server.jobserver",
                         "avenir_tpu_torch.server.spool",
                         "avenir_tpu_torch.net",
                         "avenir_tpu_torch.obs.report",
                         "avenir_tpu_torch.analysis.mem",
                         "avenir_tpu_torch.tools.fleet_load"],
               "score": ["avenir_tpu_torch.server",
                         "avenir_tpu_torch.server.score",
                         "avenir_tpu_torch.core.keys",
                         "avenir_tpu_torch.models.artifact"],
               "reinforce": ["avenir_tpu_torch.models.reinforce",
                             "avenir_tpu_torch.streaming"],
               "library": ["avenir_tpu_torch.utils.tabular",
                           "avenir_tpu_torch.utils.mcmc",
                           "avenir_tpu_torch.utils.profiling",
                           "avenir_tpu_torch.utils.sampling",
                           "avenir_tpu_torch.models.svm",
                           "avenir_tpu_torch.models.neural",
                           "avenir_tpu_torch.ops.sampling_kernels",
                           "avenir_tpu_torch.tools.sampling_check",
                           "avenir_tpu_torch.models.convert"],
               "dist": ["avenir_tpu_torch.dist",
                        "avenir_tpu_torch.dist.worker",
                        "avenir_tpu_torch.dist.collective",
                        "avenir_tpu_torch.tune",
                        "avenir_tpu_torch.parallel.scaling",
                        "avenir_tpu_torch.tools.bench_scaling"],
               "audit": ["avenir_tpu_torch.analysis.engine",
                         "avenir_tpu_torch.analysis.manifest",
                         "avenir_tpu_torch.analysis.flow",
                         "avenir_tpu_torch.analysis.mem",
                         "avenir_tpu_torch.analysis.merge",
                         "avenir_tpu_torch.analysis.cli",
                         "avenir_tpu_torch.obs.coverage"],
               "host_services": ["avenir_tpu_torch.analysis",
                                 "avenir_tpu_torch.analysis.rules",
                                 "avenir_tpu_torch.analysis.keys",
                                 "avenir_tpu_torch.analysis.proto",
                                 "avenir_tpu_torch.analysis.race",
                                 "avenir_tpu_torch.utils.metrics"]}[entry]
    loaded = _loaded(*modules)
    assert set(modules) <= set(loaded)
    assert _forbidden(loaded) == []


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_no_import_statement_names_jax(path):
    text = (ROOT / path).read_text()
    assert FORBIDDEN_IMPORT.findall(text) == []


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """With no CUDA device the smoke script exits non-zero and prints no
    result line."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import runpy, torch; torch.cuda.is_available = lambda: False; "
         "runpy.run_path('chip_smoke.py', run_name='__main__')"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the package, the script fails rather than passing."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run(
        [sys.executable, "-c",
         "import runpy, torch; torch.cuda.is_available = lambda: True; "
         "runpy.run_path('chip_smoke.py', run_name='__main__')"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_association_path_loads_no_jax():
    """The association path (its model, the bit-packed count, the jobs,
    the pipeline and the bench) loads neither `jax` nor the JAX
    package."""
    modules = ["avenir_tpu_torch.models.association",
               "avenir_tpu_torch.ops.bitset", "avenir_tpu_torch.runner",
               "avenir_tpu_torch.pipelines", "avenir_tpu_torch.tools.bench"]
    assert set(modules) <= set(MODULES)
    loaded = _loaded(*modules)
    assert set(modules) <= set(loaded)
    assert _forbidden(loaded) == []


_BLOCKED_WORKER = """
import importlib.abc, runpy, sys


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "jaxlib", "avenir_tpu") or name.startswith(
                ("jax.", "jaxlib.", "avenir_tpu.")):
            raise ImportError(f"{name} is blocked in this worker")
        return None


sys.meta_path.insert(0, Blocker())
sys.argv = ["worker", *sys.argv[1:]]
runpy.run_module("avenir_tpu_torch.dist.worker", run_name="__main__",
                 alter_sys=True)
"""


def test_shard_worker_runs_with_jax_unimportable(tmp_path):
    """One sharded worker process, with `jax` and the JAX package made
    unimportable, folds every block of a plan and commits them."""
    from avenir_tpu_torch.data import churn_schema, generate_churn
    from avenir_tpu_torch.dist import (BlockLedger, merge_block_states,
                                       plan_shards, write_plan)
    from avenir_tpu_torch.runner import (_finish_fold, _job_cfg, _schema,
                                         run_job, stream_fold_ops)

    csv = tmp_path / "churn.csv"
    csv.write_text(generate_churn(1500, seed=5, as_csv=True))
    schema = str(tmp_path / "churn.json")
    churn_schema().save(schema)
    conf = {"mut.feature.schema.file.path": schema}
    root = tmp_path / "root"
    root.mkdir()
    plan = plan_shards([str(csv)], procs=1, factor=3)
    plan.job, plan.prefix, plan.device = "mutualInformation", "mut", "cpu"
    plan.props = dict(conf)
    write_plan(plan, str(root / "plan.json"))
    (root / "go").write_text("go")
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_WORKER, str(root), "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    ledger = BlockLedger(str(root))
    assert ledger.committed() == [0, 1, 2]
    stats = json.loads((root / "stats" / "w0.json").read_text())
    assert stats["folded"] == 3 and stats["device"] == "cpu"
    canonical, cfg = _job_cfg("mutualInformation", conf)
    merged = merge_block_states(
        canonical, cfg, stream_fold_ops(canonical), plan,
        {b: ledger.load_state(b) for b in range(3)}, [str(csv)], str(root),
        schema=_schema(cfg), device="cpu")
    _finish_fold(merged, str(tmp_path / "sharded.txt"), canonical)
    run_job("mutualInformation", conf, [str(csv)], str(tmp_path / "solo.txt"),
            device="cpu")
    assert (tmp_path / "sharded.txt").read_bytes() == \
        (tmp_path / "solo.txt").read_bytes()


_BLOCKED_AUDIT = """
import importlib.abc, json, sys


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "jaxlib", "avenir_tpu") or name.startswith(
                ("jax.", "jaxlib.", "avenir_tpu.")):
            raise ImportError(f"{name} is blocked here")
        return None


sys.meta_path.insert(0, Blocker())
from avenir_tpu_torch.analysis.flow import audit_stream
from avenir_tpu_torch.analysis.manifest import stream_entries
from avenir_tpu_torch.analysis.mem import audit_footprint
from avenir_tpu_torch.analysis.merge import audit_merge
from avenir_tpu_torch.obs.coverage import audit_entry

spec = next(s for s in stream_entries("cpu") if s.name == "mi_stream")
print(json.dumps([audit_stream(spec)[0]["invariance_validated"],
                  audit_merge(spec)[0]["merge_validated"],
                  audit_footprint(spec)[0]["footprint_model_validated"],
                  audit_entry(spec)["span_coverage_validated"]]))
"""


def test_auditors_run_with_jax_unimportable():
    """The flow, merge, mem and coverage audits of one stream entry run
    to validated rows in an interpreter where `jax` and the JAX package
    cannot be imported."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_AUDIT], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [True] * 4
