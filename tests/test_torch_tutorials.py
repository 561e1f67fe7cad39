"""The docs/ tutorials, run on the port and held against the reference.

Each runnable tutorial's ```python fences run twice, in sibling temporary
directories: verbatim on the JAX package, and through
`torch_tutorial_harness.port_source` on the port with `device="cpu"`.
The port's run must pass the tutorial's own asserts, and every file it
writes under `workdir` must equal the reference's byte for byte (a
config that names its own directory is compared with that path
replaced). No file needs a float tolerance: at these sizes XLA's `log`,
MI and impurity values print the same digits as the port's.

The reference also writes its columnar sidecar and autotune records
under `workdir` (`.avenir_sidecar/`, `.avenir_tune/`); the port has
neither module yet, so those two caches are the only files the port's
run may lack.
"""

import os

import pytest

from torch_tutorial_harness import (RUNNABLE, TUTORIALS, WAITING, _device_slot,
                                    _port_call, fences, port_source,
                                    run_tutorial, written_files)

#: the reference's caches under `workdir`, which the port does not write
REFERENCE_ONLY = (".avenir_sidecar" + os.sep, ".avenir_tune" + os.sep)


def test_excluded_set_is_exactly_the_two_waiting_tutorials():
    assert sorted(set(TUTORIALS) - set(RUNNABLE)) == [
        "tutorial_job_server.md", "tutorial_scale_streaming.md"]
    assert set(WAITING) <= set(TUTORIALS)


@pytest.mark.parametrize("name", RUNNABLE)
def test_tutorial_runs_on_port(name, tmp_path):
    ref, port = tmp_path / "ref", tmp_path / "port"
    ref.mkdir()
    port.mkdir()
    run_tutorial(name, str(ref), port=False)
    run_tutorial(name, str(port), port=True)
    want = {k: v for k, v in written_files(str(ref)).items()
            if not k.startswith(REFERENCE_ONLY)}
    got = written_files(str(port))
    assert sorted(got) == sorted(want)
    differ = [k for k in sorted(want) if got[k] != want[k]]
    assert not differ, f"{name}: files differ from the reference's: {differ}"


def test_rewrite_maps_imports_names_and_module_strings():
    ns = {"__port_call__": _port_call}
    exec(port_source(
        "import avenir_tpu.core.config\n"
        "from avenir_tpu.core.config import load_hocon\n"
        "mod = avenir_tpu.core.config\n"
        "name = 'avenir_tpu.core.dataset'\n"
        "other = 'avenir_tpu_x'\n", "<test>"), ns)
    import avenir_tpu_torch.core.config as cfg
    assert ns["mod"] is cfg and ns["load_hocon"] is cfg.load_hocon
    assert ns["name"] == "avenir_tpu_torch.core.dataset"
    assert ns["other"] == "avenir_tpu_x"


def test_device_is_read_off_the_port_signatures():
    from avenir_tpu_torch.models.cluster import KMeans
    from avenir_tpu_torch.models.tree import RandomForestBuilder
    from avenir_tpu_torch.runner import run_job
    from avenir_tpu_torch.utils.sampling import MetropolisSampler
    assert _device_slot(run_job) == 4
    assert _device_slot(KMeans) is not None
    assert _device_slot(MetropolisSampler) is not None
    # `device: bool` is a route flag, not a DeviceLike: left alone
    assert _device_slot(RandomForestBuilder.predict) is None
    assert _device_slot(len) is None and _device_slot(os.path.join) is None


def test_port_call_adds_cpu_only_where_no_device_is_given():
    def record(*args, **kwargs):
        return args, kwargs
    record.__module__ = "avenir_tpu_torch.fake"

    def probe(a, device: "DeviceLike" = None):
        return a, device
    probe.__module__ = "avenir_tpu_torch.fake"
    assert _port_call(probe)(1) == (1, "cpu")
    assert _port_call(probe)(1, "cuda") == (1, "cuda")
    assert _port_call(probe)(1, device="cuda") == (1, "cuda")
    assert _port_call(record) is record


def test_run_from_cli_gets_a_cpu_device(tmp_path):
    from avenir_tpu_torch.runner import run_from_cli
    data = tmp_path / "f.csv"
    data.write_text("P0,0,F\nP0,604800000,L\nP0,1209600000,F\n")
    conf = tmp_path / "j.properties"
    conf.write_text("str.key.field.ordinals=0\nstr.time.field.ordinal=1\n"
                    "str.state.field.ordinal=2\nstr.state.values=F,L\n"
                    "str.rate.time.unit=week\nstr.input.time.unit=ms\n")
    res = _port_call(run_from_cli)(["stateTransitionRate", "--conf",
                                    str(conf), str(data),
                                    str(tmp_path / "out.txt")])
    assert res.outputs == [str(tmp_path / "out.txt")]


def test_every_runnable_tutorial_has_fences():
    for name in RUNNABLE:
        assert fences(name), name
