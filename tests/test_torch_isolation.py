"""The port stands alone: importing `avenir_tpu_torch` and every one of its
modules (and `chip_smoke.py`) loads neither `jax` nor any module of the
JAX package `avenir_tpu`. Checked in a fresh interpreter, since this test
process has both loaded already."""

import json
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
                "tools.sampling_check"):
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
                                   "score", "reinforce", "library"])
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
                           "avenir_tpu_torch.models.convert"]}[entry]
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
