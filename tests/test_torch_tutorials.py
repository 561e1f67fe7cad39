"""The docs/ tutorials, run on the port and held against the reference.

Each runnable tutorial's ```python fences run twice, one after the other
in the same temporary directory (the first run's files moved aside):
verbatim on the JAX package, and through
`torch_tutorial_harness.port_source` on the port with `device="cpu"`.
The port's run must pass the tutorial's own asserts, and every file it
writes under `workdir` must equal the reference's byte for byte (a
config that names its own directory is compared with that path
replaced; the one path also gives the sidecar directories named from a
hash of their corpus' path the same names). No file needs a float
tolerance: the streaming tutorial's mutual-information files are
compared byte for byte too (their one value on a 6th-decimal rounding
edge, `tests/test_torch_explore.py::test_tutorial_mi_value_one_float32_ulp_from_jax`,
is summed in XLA's CPU order).

Both packages write the columnar sidecar (`.avenir_sidecar/`, and the
directory a tutorial names in `stream.sidecar.dir`) in one format, so
its files are compared like any other. The job server's tutorial
writes metrics snapshots, host logs and result rows that hold times;
TIMING_FILES leaves them out by name, each with its reason, and its
served artifacts are compared. Both packages write autotune profiles
(`.avenir_tune/<job>_<digest>.json`): each is compared by the fields that
do not hold timings or memory readings (`format`, `format_version`,
`job`, `corpus_digest`) and by the presence of its `runs` and
`residuals`. A streamed run records its residual only when it raises the
process's lifetime peak RSS, which hangs on what the process ran before
(both packages run in one process here), so the test opens that gate for
every streamed run of both packages (`_every_run_records_its_residual`).
An incremental checkpoint (a directory holding `MANIFEST.json` beside its
`carry_<seq>_<hash8>.npz`) is compared by its manifest's fields: the
port's carry holds its own dtypes (int64 and float64 counts), so its npz
bytes, and the carry's name, size and hash built from them, are its own.
"""

import json

import os

import pytest
import torch_reference_native  # noqa: F401  (settles the reference's native route)
from torch_tutorial_harness import (RUNNABLE, TUTORIALS, WAITING, _device_slot,
                                    _port_call, fences, port_source,
                                    run_tutorial, written_files)

#: a tutorial's files that hold times, left out of the comparison by name
#: (fnmatch patterns under `workdir`), each with its reason; the artifacts
#: they describe are compared
TIMING_FILES = {"tutorial_job_server.md": {
    "chaos_fleet/metrics.json":
        "the fleet's merged snapshot: time stamps, uptime, latency "
        "histograms",
    "chaos_fleet/host*/metrics.json":
        "a host's snapshot: time stamps, uptime, latency histograms",
    "chaos_fleet/host*/server.log":
        "a host's stderr: its closing stats line holds latencies and RSS",
    "chaos_fleet/host*/out/*.json":
        "a host's result row: the request's queue wait and throughput "
        "counters (the chaos_out artifact it names is compared)",
}}

#: the autotune profile store's directory name (tune/store.py)
TUNE_DIR = ".avenir_tune"
#: a profile's fields that hold no timing and no memory reading
PROFILE_FIELDS = ("format", "format_version", "job", "corpus_digest")

#: the checkpoint manifest's fields both packages write alike (the carry's
#: `carry_file`, `carry_bytes` and `carry_hash` are each package's own)
CHECKPOINT_FIELDS = ("format", "format_version", "job", "seq", "conf_digest",
                     "inputs", "block_bytes", "watermarks", "fingerprints",
                     "complete", "predicted_peak_bytes")


def _untimed(name, files):
    """`files` without the tutorial's TIMING_FILES."""
    import fnmatch

    pats = TIMING_FILES.get(name, {})
    return {k: v for k, v in files.items()
            if not any(fnmatch.fnmatch(k, p) for p in pats)}


def _profiles(files):
    """Split the autotune profiles out of `files`: (the other files,
    {profile path: its PROFILE_FIELDS and whether it holds runs and
    residuals}). A publish's tmp file beside them (a host SIGKILLed while
    it wrote) is left out: the protocol leaves the last whole profile."""
    from avenir_tpu_torch.core.atomic import is_tmp_name

    rest, profs = {}, {}
    for k, v in files.items():
        if TUNE_DIR not in k.split(os.sep)[:-1]:
            rest[k] = v
        elif not is_tmp_name(k):
            prof = json.loads(v)
            profs[k] = {**{f: prof.get(f) for f in PROFILE_FIELDS},
                        "runs": "runs" in prof,
                        "residuals": "residuals" in prof}
    return rest, profs


def _every_run_records_its_residual(monkeypatch):
    """Open the residual gate of both runners for every streamed run in
    this process: the peak it compares with is reset before each result,
    and the starting RSS reads 0, so each result records (predicted, the
    process peak). Without it, whether a run records hangs on the
    process's earlier runs, not on the package."""
    import avenir_tpu.runner as jax_runner
    import avenir_tpu_torch.runner as port_runner

    for mod in (jax_runner, port_runner):
        def gate_open(*args, _orig=mod._add_mem_counters, _mod=mod,
                      **kwargs):
            _mod._residual_peak_seen = 0
            return _orig(*args, **kwargs)

        monkeypatch.setattr(mod, "_add_mem_counters", gate_open)
        monkeypatch.setattr(mod, "_rss_now", lambda: 0)


def _checkpoints(files):
    """Split the incremental checkpoints out of `files`: (the other files,
    {checkpoint dir: its manifest's CHECKPOINT_FIELDS and carry count})."""
    dirs = {os.path.dirname(k) for k in files
            if os.path.basename(k).startswith("carry_")
            and k.endswith(".npz")}
    rest, ckpt = {}, {}
    for k, v in files.items():
        d = os.path.dirname(k)
        if d not in dirs:
            rest[k] = v
        elif os.path.basename(k) == "MANIFEST.json":
            man = json.loads(v)
            ckpt.setdefault(d, {}).update(
                {f: man[f] for f in CHECKPOINT_FIELDS})
        else:
            ckpt.setdefault(d, {})["carries"] = \
                ckpt.get(d, {}).get("carries", 0) + 1
    return rest, ckpt


def test_excluded_set_is_exactly_the_two_waiting_tutorials():
    """Of the two tutorials that waited, none still does: every tutorial
    runs on the port."""
    assert sorted(set(TUTORIALS) - set(RUNNABLE)) == []
    assert WAITING == {}
    assert len(RUNNABLE) == len(TUTORIALS) == 20


def _quiet_shards(monkeypatch):
    """The sharded runs of a tutorial mirror no straggler on a loaded box:
    their default policy (both packages') waits 60 s, not 5, before it
    folds a peer's claimed block again, so the fences' `Shard:DedupBlocks
    == 0` holds however slowly a worker boots. Mirroring is timing, not
    the bytes the test compares."""
    import functools

    import avenir_tpu.dist.driver as jax_driver
    import avenir_tpu_torch.dist.driver as port_driver

    for mod in (jax_driver, port_driver):
        monkeypatch.setattr(mod, "StragglerPolicy", functools.partial(
            mod.StragglerPolicy, mirror_floor_s=60.0))


@pytest.mark.parametrize("name", RUNNABLE)
def test_tutorial_runs_on_port(name, tmp_path, monkeypatch):
    _quiet_shards(monkeypatch)
    _every_run_records_its_residual(monkeypatch)
    work = tmp_path / "work"
    work.mkdir()
    run_tutorial(name, str(work), port=False)
    want, want_prof = _profiles(_untimed(name, written_files(str(work))))
    want, want_ckpt = _checkpoints(want)
    work.rename(tmp_path / "ref")
    work.mkdir()
    run_tutorial(name, str(work), port=True)
    got, got_prof = _profiles(_untimed(name, written_files(str(work))))
    got, got_ckpt = _checkpoints(got)
    assert got_prof == want_prof
    assert sorted(got) == sorted(want)
    differ = [k for k in sorted(want) if got[k] != want[k]]
    assert not differ, f"{name}: files differ from the reference's: {differ}"
    assert got_ckpt == want_ckpt


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
