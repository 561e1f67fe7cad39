"""The port's autotune loop held against the JAX package on the CPU.

The counterparts of `tests/test_tune.py`: the knob registry (keys, kinds,
defaults, ranges, `KnobError` texts), every policy rule on a grid of
`RunSignals` and counters that reaches each clamp edge (the same move and
the same reason text), the residual factor and the batch-balance
predicate, the profile store (a profile either package writes loads in
the other, byte for byte; the window caps; a profile of another format
version goes cold), the session (the knob overlay, the commit, `close()`
on a failed run, contamination by a concurrent session and by an untuned
fold, explicit conf never persisted), autotuned `run_job`, `run_shared`
and `run_incremental` writing the JAX package's bytes and choosing its
knobs from its signals, `Mem:PredictedPeakBytes` equal to the
reference's on every streamed job, and the CLI (`--autotune`, its two
refusals, `tune <dir>`). The two tripwires run at a small size with no
speed bound, since a small corpus on a shared CPU measures start-up
costs. Inputs are made from seeds."""

import io
import json
import os
import subprocess
import sys
from collections import namedtuple
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch_reference_native  # noqa: F401  (settles the reference's native route)
from test_torch_explore import assert_within_one_unit

from avenir_tpu_torch import tune
from avenir_tpu_torch.runner import (run_from_cli, run_incremental,
                                     run_job, run_shared)
from avenir_tpu_torch.tune import policy as port_policy
from avenir_tpu_torch.tune.knobs import KNOBS, KnobError, validate_knobs
from avenir_tpu_torch.tune.signals import RunSignals, extract_signals
from avenir_tpu_torch.tune.store import ProfileStore, corpus_digest

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120
TRIO = (("bayesianDistr", "bad"), ("mutualInformation", "mut"),
        ("fisherDiscriminant", "fid"))


def _churn(tmp_path, rows=1500, seed=7):
    from avenir_tpu.data import churn_schema, generate_churn

    csv = tmp_path / "churn.csv"
    csv.write_text(generate_churn(rows, seed=seed, as_csv=True))
    schema = tmp_path / "churn.json"
    churn_schema().save(str(schema))
    return str(csv), str(schema)


def _seq(tmp_path, rows=400, name="seq.csv"):
    """Labelled chains of six states from a seeded walk (test_tune.py's
    corpus)."""
    rng = np.random.default_rng(5)
    states = ["L", "M", "H"]
    csv = tmp_path / name
    with open(csv, "w") as fh:
        for i in range(rows):
            up = i % 2 == 0
            s, toks = 1, []
            for _ in range(6):
                p = [0.1, 0.3, 0.6] if up else [0.6, 0.3, 0.1]
                s = int(np.clip(s + rng.choice([-1, 0, 1], p=p), 0, 2))
                toks.append(states[s])
            fh.write(f"c{i},{'T' if up else 'F'}," + ",".join(toks) + "\n")
    return str(csv)


def _mi(schema, **extra):
    return {"mut.feature.schema.file.path": schema,
            "mut.mutual.info.score.algorithms": "mutual.info.maximization",
            **{f"mut.{k}": v for k, v in extra.items()}}


def _bytes_of(res):
    return [open(p, "rb").read() for p in sorted(res.outputs)]


def _same_as_reference(got, ref):
    """A port result's files against the reference's: byte for byte, but
    a mutual-information file, whose printed values are held within one
    unit in the 6th decimal (`test_torch_explore.py`'s rule)."""
    got_b, ref_b = _bytes_of(got), _bytes_of(ref)
    assert len(got_b) == len(ref_b)
    for g, r in zip(got_b, ref_b):
        if got.name == "mutualInformation":
            assert_within_one_unit(g.decode(), r.decode())
        else:
            assert g == r


def _jax_run_job(*args, **kwargs):
    from avenir_tpu.runner import run_job as jax_run_job

    return jax_run_job(*args, **kwargs)


# ========================================================== knob registry
def test_registry_matches_reference():
    from avenir_tpu.tune import knobs as ref

    assert list(KNOBS) == list(ref.KNOBS)
    for key, knob in KNOBS.items():
        want = ref.KNOBS[key]
        assert (knob.key, knob.kind, knob.default, knob.lo, knob.hi,
                knob.signal, knob.description) == \
            (want.key, want.kind, want.default, want.lo, want.hi,
             want.signal, want.description)
        assert knob.lo <= knob.default <= knob.hi
    assert tune.CONTROL_KEYS == ref.CONTROL_KEYS
    assert tune.knob_keys() == ref.knob_keys()
    assert tune.knob_defaults() == ref.knob_defaults()


@pytest.mark.parametrize("mapping", [
    {"stream.block.size.mb": 8, "stream.prefetch.depth": 4.0},
    {"stream.checkpoint.interval.mb": "32", "stream.encoded.cache.budget.mb":
     8192},
    {"stream.block.size.mb": 1.0}, {"stream.block.size.mb": 256},
    {"stream.blokc.size.mb": 8}, {"stream.prefetch.depth": 99},
    {"stream.prefetch.depth": 0}, {"stream.block.size.mb": "eight"},
    {"stream.block.size.mb": None}, {"stream.checkpoint.interval.mb": 4097},
], ids=lambda m: ",".join(f"{k}={v}" for k, v in m.items()))
def test_validate_knobs_matches_reference(mapping):
    """The same coerced mapping, or a KnobError of the same text."""
    from avenir_tpu.tune.knobs import KnobError as RefError
    from avenir_tpu.tune.knobs import validate_knobs as ref_validate

    try:
        want = ref_validate(mapping, source="p.json")
    except RefError as e:
        with pytest.raises(KnobError) as got:
            validate_knobs(mapping, source="p.json")
        assert str(got.value) == str(e)
        return
    got = validate_knobs(mapping, source="p.json")
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]


@pytest.mark.parametrize("key,value", [
    ("stream.block.size.mb", 0.5), ("stream.block.size.mb", 64.0),
    ("stream.block.size.mb", 1.0 / 3), ("stream.prefetch.depth", 8),
    ("stream.prefetch.depth", 3.0), ("stream.checkpoint.interval.mb", 512.0),
    ("stream.encoded.cache.budget.mb", 1536.0)])
def test_format_value_and_clamp_match_reference(key, value):
    from avenir_tpu.tune import knobs as ref

    assert tune.format_value(key, value) == ref.format_value(key, value)
    for v in (value, -1e9, 1e9):
        got, want = KNOBS[key].clamp(v), ref.KNOBS[key].clamp(v)
        assert got == want and type(got) is type(want)


# ========================================================== policy rules
def _signal_grid():
    """RunSignals rows reaching every rule's branches and clamp edges: no
    signal, tiny and huge corpora, producer- and consumer-bound and
    balanced scans, stall shares on both sides of 10%, checkpoint shares
    on both sides of 5%, plus seeded random rows."""
    rows = [
        dict(),
        dict(wall_s=10, read_s=1, parse_s=1, fold_s=6, chunks=6,
             bytes_read=384 << 20),
        dict(wall_s=10, read_s=4, parse_s=4, fold_s=2, chunks=96,
             bytes_read=384 << 20),
        dict(wall_s=1, fold_s=0.6, read_s=0.1, parse_s=0.1, chunks=3,
             bytes_read=1 << 17),
        dict(wall_s=1, read_s=0.6, fold_s=0.1, chunks=1000,
             bytes_read=1 << 40),
        dict(wall_s=10, read_s=2, parse_s=1, fold_s=2, chunks=8,
             bytes_read=512 << 20),
        dict(wall_s=0.05, read_s=0.01, parse_s=0.01, fold_s=0.01, chunks=1,
             bytes_read=4096),
        dict(wall_s=10, producer_bound_s=2.0),
        dict(wall_s=10, producer_bound_s=0.99),
        dict(wall_s=10, producer_bound_s=9.0),
        dict(wall_s=10, consumer_bound_s=5.0),
        dict(wall_s=10, consumer_bound_s=1.0, producer_bound_s=1.0),
        dict(wall_s=10, checkpoint_s=1.0),
        dict(wall_s=10, checkpoint_s=0.5),
        dict(wall_s=10, checkpoint_s=0.1),
        dict(wall_s=0.0, checkpoint_s=0.1, producer_bound_s=0.1),
    ]
    rng = np.random.default_rng(25)
    for _ in range(12):
        wall = float(rng.uniform(0.1, 40))
        rows.append(dict(
            wall_s=wall, read_s=float(rng.uniform(0, wall / 2)),
            parse_s=float(rng.uniform(0, wall / 2)),
            fold_s=float(rng.uniform(0, wall)),
            producer_bound_s=float(rng.uniform(0, wall / 4)),
            consumer_bound_s=float(rng.uniform(0, wall / 4)),
            checkpoint_s=float(rng.uniform(0, wall / 8)),
            chunks=int(rng.integers(0, 2000)),
            bytes_read=int(rng.integers(0, 1 << 38))))
    return rows


SIGNALS = _signal_grid()
COUNTERS = [{}, {"Cache:EvictedBytes": 200 << 20, "Cache:SpillBytes": 600 << 20},
            {"Cache:EvictedBytes": 1, "Cache:SpillBytes": 10 << 40},
            {"Cache:EvictedBytes": 5 << 20, "Cache:SpillBytes": 0},
            {"Cache:EvictedBytes": 3 << 20, "Cache:SpillBytes": 7 << 20}]
CURRENT = {"stream.block.size.mb": (1.0, 4.0, 64.0, 256.0, 0.01, 512.0),
           "stream.prefetch.depth": (1, 2, 4, 8, 16),
           "stream.checkpoint.interval.mb": (0.001, 32.0, 256.0, 4096.0),
           "stream.encoded.cache.budget.mb": (0.5, 64.0, 512.0, 8192.0)}


def _both_signals(row):
    from avenir_tpu.tune.signals import RunSignals as RefSignals

    return RunSignals(**row), RefSignals(**row)


@pytest.mark.parametrize("i", range(len(SIGNALS)))
def test_signal_rules_match_reference(i):
    """Block, prefetch and checkpoint: the same (value, reason) at every
    current value of the grid, every value inside the knob's range."""
    from avenir_tpu.tune import policy as ref

    sig, rsig = _both_signals(SIGNALS[i])
    for name, key in (("choose_block_mb", "stream.block.size.mb"),
                      ("choose_prefetch_depth", "stream.prefetch.depth"),
                      ("choose_checkpoint_interval_mb",
                       "stream.checkpoint.interval.mb")):
        for cur in CURRENT[key]:
            got = getattr(port_policy, name)(sig, cur)
            assert got == getattr(ref, name)(rsig, cur), (name, cur)
            if got[0] is not None:
                assert KNOBS[key].lo <= got[0] <= KNOBS[key].hi


@pytest.mark.parametrize("i", range(len(COUNTERS)))
def test_cache_rule_and_choose_knobs_match_reference(i):
    from avenir_tpu.tune import policy as ref

    counters = COUNTERS[i]
    for cur in CURRENT["stream.encoded.cache.budget.mb"]:
        assert port_policy.choose_cache_budget_mb(counters, cur) == \
            ref.choose_cache_budget_mb(counters, cur)
    for row in SIGNALS[::3]:
        sig, rsig = _both_signals(row)
        for block, depth in ((64.0, 2), (0.01, 8), (256.0, 1)):
            current = {"stream.block.size.mb": block,
                       "stream.prefetch.depth": depth}
            assert port_policy.choose_knobs(sig, counters, current) == \
                ref.choose_knobs(rsig, counters, current)


@pytest.mark.parametrize("residuals", [
    [], [{"predicted": 100, "measured": 10}],
    [{"predicted": 100, "measured": 250}],
    [{"predicted": 1, "measured": 10 ** 9}],
    [{"predicted": 0, "measured": 5}, {"predicted": 5, "measured": 0}],
    [{"predicted": "x"}, {"measured": 3}, {"predicted": 10, "measured": 30}],
    [{"predicted": 10, "measured": 10 * (i + 1)} for i in range(12)],
], ids=lambda r: f"n{len(r)}")
def test_residual_factor_matches_reference(residuals):
    from avenir_tpu.tune import policy as ref

    for cap in (8.0, 2.0, 100.0):
        got = port_policy.residual_factor(residuals, cap=cap)
        assert got == ref.residual_factor(residuals, cap=cap)
        assert 1.0 <= got <= cap
    assert port_policy.RESIDUAL_WINDOW == ref.RESIDUAL_WINDOW
    assert tune.RESIDUAL_FACTOR_CAP == ref.RESIDUAL_FACTOR_CAP


@pytest.mark.parametrize("costs,cand,ratio", [
    ([], 100.0, 4.0), ([None, None], 100.0, 4.0), ([50.0], None, 4.0),
    ([50.0], 150.0, 4.0), ([50.0], 250.0, 4.0), ([250.0], 50.0, 4.0),
    ([50.0], 200.0, 4.0), ([0.0, -1.0], 3.0, 4.0), ([1.0, 3.9], 0.0, 4.0),
    ([1.0, 2.0], 8.0, 8.0), ([1.0, 2.0], 8.1, 8.0)])
def test_batch_balanced_matches_reference(costs, cand, ratio):
    from avenir_tpu.tune import policy as ref

    assert port_policy.batch_balanced(costs, cand, ratio=ratio) == \
        ref.batch_balanced(costs, cand, ratio=ratio)
    assert tune.BATCH_BALANCE_RATIO == ref.BATCH_BALANCE_RATIO


def test_policy_constants_match_reference():
    from avenir_tpu.tune import policy as ref

    for name in ("TARGET_CHUNKS", "MIN_CHUNK_WORK_SECS", "BALANCE_RATIO",
                 "STALL_SHARE", "CHECKPOINT_BUDGET_SHARE", "CACHE_HEADROOM",
                 "RESIDUAL_FACTOR_CAP", "RESIDUAL_WINDOW",
                 "BATCH_BALANCE_RATIO"):
        assert getattr(port_policy, name) == getattr(ref, name), name


# ======================================================= signal extraction
def test_extract_signals_matches_reference_with_sidecar_replay():
    """Synthetic spans of every kind (a sidecar replay among them, the
    ingest of a warm scan) give the same row in both packages."""
    from avenir_tpu.tune.signals import extract_signals as ref_extract

    Span = namedtuple("Span", "name tid t0 dur attrs")
    spans = [Span("stream.read", 1, 0.0, 0.2, {"nbytes": 1000}),
             Span("stream.parse", 2, 0.1, 0.3, {"nbytes": 1000}),
             Span("stream.sidecar.replay", 2, 0.5, 0.05, {"nbytes": 700}),
             Span("stream.sidecar.replay", 2, 0.6, 0.05, None),
             Span("stream.fold", 3, 0.4, 0.5, {"sink": "mutualInformation"}),
             Span("stream.fold", 3, 0.9, 0.25, {"sink": "bayesianDistr"}),
             Span("stream.fold", 3, 1.2, 0.1, None),
             Span("stream.stall.consumer", 3, 1.3, 0.2, None),
             Span("stream.stall.producer", 1, 1.4, 0.1, None),
             Span("job.checkpoint", 3, 1.5, 0.4, None),
             Span("job.finish", 3, 1.9, 0.1, None)]
    for wall in (None, 3.0):
        got = extract_signals(spans, wall_s=wall).to_json()
        assert got == ref_extract(spans, wall_s=wall).to_json()
    assert got["chunks"] == 3 and got["bytes_read"] == 1700


def test_extract_from_captured_spans(tmp_path):
    from avenir_tpu_torch import obs

    csv, schema = _churn(tmp_path)
    with obs.capture() as rec:
        run_job("mutualInformation", _mi(schema, **{
            "stream.block.size.mb": "0.01", "stream.sidecar": "false"}),
            [csv], str(tmp_path / "out.txt"), device=CPU)
    sig = extract_signals(rec.spans())
    assert sig.chunks > 1 and sig.bytes_read == os.path.getsize(csv)
    assert sig.read_s > 0 and sig.parse_s > 0 and sig.fold_s > 0
    assert "mutualInformation" in sig.fold_ms_by_sink
    back = RunSignals.from_json(sig.to_json())
    assert back.chunks == sig.chunks
    assert back.fold_ms_by_sink.keys() == sig.fold_ms_by_sink.keys()


# ================================================================ store
def _fill(store, job="mutualInformation", digest="beef", n=40):
    sig = RunSignals(wall_s=1.25, chunks=2, read_s=0.5,
                     fold_ms_by_sink={"a": 1.5, "b": 2.25}).to_json()
    for i in range(n):
        store.record_run(job, digest, sig, {"stream.prefetch.depth": 2},
                         1.0 + i / 8)
        store.record_residual(job, digest, 100, 150 + i)
    store.set_knobs(job, digest, {"stream.block.size.mb": 8.0,
                                  "stream.prefetch.depth": 4},
                    ["block 64->8MB (test)"])
    store.note_fold_cost(job, digest, 3.0)


def test_profiles_cross_load_byte_for_byte(tmp_path):
    """The same calls write the same bytes in both packages; each loads
    the other's profile to the same dict; `profiles()` agree."""
    from avenir_tpu.tune.store import ProfileStore as RefStore

    _fill(ProfileStore(str(tmp_path / "port")))
    _fill(RefStore(str(tmp_path / "ref")))
    name = ProfileStore(str(tmp_path / "port")).path("mutualInformation",
                                                     "beef")
    ref_name = RefStore(str(tmp_path / "ref")).path("mutualInformation",
                                                    "beef")
    assert os.path.basename(name) == os.path.basename(ref_name)
    assert open(name, "rb").read() == open(ref_name, "rb").read()
    for a, b in (("port", "ref"), ("ref", "port")):
        theirs = RefStore(str(tmp_path / a)).load("mutualInformation",
                                                  "beef")
        ours = ProfileStore(str(tmp_path / b)).load("mutualInformation",
                                                    "beef")
        assert theirs == ours
    assert ProfileStore(str(tmp_path / "ref")).profiles() == \
        RefStore(str(tmp_path / "port")).profiles()


def test_store_windows_and_constants_match_reference(tmp_path):
    from avenir_tpu.tune import store as ref
    from avenir_tpu_torch.tune import store as port

    for name in ("FORMAT_VERSION", "MAX_RUNS", "MAX_RESIDUALS",
                 "FOLD_COST_BLEND", "DEFAULT_DIR_NAME"):
        assert getattr(port, name) == getattr(ref, name), name
    store = ProfileStore(str(tmp_path / "t"))
    _fill(store)
    prof = store.load("mutualInformation", "beef")
    assert len(prof["runs"]) == port.MAX_RUNS
    assert len(prof["residuals"]) == port.MAX_RESIDUALS
    assert prof["residuals"][-1]["measured"] == 189
    assert prof["fold_cost_ms"] == ref.ProfileStore(
        str(tmp_path / "t")).fold_cost_ms("mutualInformation", "beef")


@pytest.mark.parametrize("version", [2, 0, None])
def test_other_format_version_goes_cold_in_both(tmp_path, version):
    """A profile stamped with another layout version loads as None (a
    missing stamp is a profile from before the stamp, and loads)."""
    from avenir_tpu.tune.store import ProfileStore as RefStore

    store = ProfileStore(str(tmp_path))
    prof = {"format": 1, "job": "j", "corpus_digest": "d",
            "knobs": {"stream.block.size.mb": 8}}
    if version is not None:
        prof["format_version"] = version
    os.makedirs(str(tmp_path), exist_ok=True)
    with open(store.path("j", "d"), "w") as fh:
        json.dump(prof, fh)
    got = store.load("j", "d")
    assert got == RefStore(str(tmp_path)).load("j", "d")
    assert (got is None) == (version is not None)


def test_typoed_profile_is_loud_in_both(tmp_path):
    from avenir_tpu.tune.knobs import KnobError as RefError
    from avenir_tpu.tune.store import ProfileStore as RefStore

    store = ProfileStore(str(tmp_path))
    with open(store.path("mutualInformation", "cafe"), "w") as fh:
        json.dump({"format": 1, "job": "mutualInformation",
                   "corpus_digest": "cafe",
                   "knobs": {"stream.blokc.size.mb": 8}}, fh)
    with pytest.raises(RefError) as want:
        RefStore(str(tmp_path)).load("mutualInformation", "cafe")
    with pytest.raises(KnobError) as got:
        store.load("mutualInformation", "cafe")
    assert str(got.value) == str(want.value)
    with pytest.raises(KnobError):
        store.set_knobs("j", "d", {"nope": 1}, [])
    assert store.fold_cost_ms("mutualInformation", "cafe") is None


def test_resolve_dir_and_digest_match_reference(tmp_path):
    from avenir_tpu.core.config import JobConfig as RefConfig
    from avenir_tpu.tune import store as ref
    from avenir_tpu_torch.core.config import JobConfig

    inputs = [str(tmp_path / "a" / "x.csv"), "rel/y.csv"]
    assert corpus_digest(inputs) == ref.corpus_digest(inputs)
    for props in ({}, {"mut.stream.autotune.dir": "/elsewhere/t"},
                  {"stream.autotune.dir": "d2"}):
        assert tune.resolve_dir(JobConfig(props, "mut"), inputs) == \
            ref.resolve_dir(RefConfig(props, "mut"), inputs)


# ============================================================== session
def _cfg(tmp_path, prefix="mut", **props):
    from avenir_tpu_torch.core.config import JobConfig

    return JobConfig({"stream.autotune.dir": str(tmp_path / "t"), **props},
                     prefix)


def test_session_overlays_and_keeps_earlier_profile_moves(tmp_path):
    csv, _schema = _churn(tmp_path, rows=50)
    store = ProfileStore(str(tmp_path / "t"))
    digest = corpus_digest([csv])
    store.set_knobs("mutualInformation", digest,
                    {"stream.block.size.mb": 8.0, "stream.prefetch.depth": 4},
                    ["earlier round"])
    cfg = _cfg(tmp_path)
    session = tune.begin_run(["mutualInformation"], [cfg], [csv])
    assert cfg.props["mut.stream.block.size.mb"] == "8"
    assert cfg.props["mut.stream.prefetch.depth"] == "4"
    assert session.knobs_used["stream.block.size.mb"] == 8.0
    chosen = session.finish({})
    assert chosen == {"stream.block.size.mb": 8.0, "stream.prefetch.depth": 4}
    prof = store.load("mutualInformation", digest)
    assert prof["knobs"] == chosen and prof["runs"]


def test_user_conf_never_persists_as_tuned_knob(tmp_path):
    """An explicit conf value the tuner did not choose, even one below the
    registry's range, never lands in the profile, and the recording goes
    on (a refused set_knobs would stop it)."""
    csv, schema = _churn(tmp_path)
    conf = _mi(schema, **{"stream.block.size.mb": "0.01",
                          "stream.checkpoint.interval.mb": "0.001",
                          "stream.autotune": "true",
                          "stream.autotune.dir": str(tmp_path / "t")})
    run_job("mutualInformation", conf, [csv], str(tmp_path / "out.txt"),
            device=CPU)
    prof = ProfileStore(str(tmp_path / "t")).load("mutualInformation",
                                                  corpus_digest([csv]))
    assert prof is not None and prof["runs"]
    assert "stream.checkpoint.interval.mb" not in prof["knobs"]
    assert 0.01 not in prof["knobs"].values()


def test_failed_run_closes_its_session(tmp_path):
    """A run that raises closes its session, so the next run in the
    process records."""
    csv, schema = _churn(tmp_path, rows=100)
    bad = _mi(str(tmp_path / "missing.json"), **{
        "stream.autotune": "true",
        "stream.autotune.dir": str(tmp_path / "t")})
    with pytest.raises(Exception):
        run_job("mutualInformation", bad, [csv], str(tmp_path / "boom.txt"),
                device=CPU)
    assert not tune._active_sessions
    good = dict(bad, **{"mut.feature.schema.file.path": schema})
    run_job("mutualInformation", good, [csv], str(tmp_path / "ok.txt"),
            device=CPU)
    prof = ProfileStore(str(tmp_path / "t")).load("mutualInformation",
                                                  corpus_digest([csv]))
    assert prof is not None and prof["runs"]


def test_untuned_concurrent_fold_contaminates_window(tmp_path):
    from avenir_tpu_torch import obs

    csv, _schema = _churn(tmp_path, rows=50)
    s = tune.begin_run(["mutualInformation"], [_cfg(tmp_path)], [csv])
    obs.recorder().record("stream.fold", obs.now(), 0.001,
                          attrs={"sink": "bayesianDistr"})
    assert s.finish({}) is None
    s2 = tune.begin_run(["mutualInformation"], [_cfg(tmp_path)], [csv])
    obs.recorder().record("stream.fold", obs.now(), 0.001,
                          attrs={"sink": "mutualInformation"})
    assert s2.finish({}) is not None


def test_concurrent_sessions_skip_recording(tmp_path):
    csv, _schema = _churn(tmp_path, rows=50)
    a = tune.begin_run(["mutualInformation"], [_cfg(tmp_path)], [csv])
    b = tune.begin_run(["bayesianDistr"], [_cfg(tmp_path, "bad")], [csv])
    assert a.contaminated and b.contaminated
    assert a.finish({}) is None and b.finish({}) is None
    assert ProfileStore(str(tmp_path / "t")).load(
        "mutualInformation", corpus_digest([csv])) is None
    c = tune.begin_run(["mutualInformation"], [_cfg(tmp_path)], [csv])
    assert c.finish({}) is not None


def test_autotuned_run_fails_loud_on_bad_profile(tmp_path):
    """The same KnobError as the reference's, from both packages' run_job."""
    from avenir_tpu.tune.knobs import KnobError as RefError

    csv, schema = _churn(tmp_path)
    tune_dir = tmp_path / "tune"
    tune_dir.mkdir()
    path = ProfileStore(str(tune_dir)).path("mutualInformation",
                                            corpus_digest([csv]))
    with open(path, "w") as fh:
        json.dump({"format": 1, "job": "mutualInformation",
                   "corpus_digest": corpus_digest([csv]),
                   "knobs": {"stream.block.size.mb": 99999}}, fh)
    conf = _mi(schema, **{"stream.autotune": "true",
                          "stream.autotune.dir": str(tune_dir)})
    with pytest.raises(RefError) as want:
        _jax_run_job("mutualInformation", conf, [csv],
                     str(tmp_path / "ref.txt"))
    with pytest.raises(KnobError) as got:
        run_job("mutualInformation", conf, [csv], str(tmp_path / "out.txt"),
                device=CPU)
    assert str(got.value) == str(want.value)
    assert "safe range" in str(got.value)


# ======================================================== autotuned runs
def _two_passes(tmp_path, job, conf, inputs, out_name, runner=None,
                **kwargs):
    """Pass 1 (records and chooses) and pass 2 (applies) of an autotuned
    job in each package, each with its own profile store; returns
    {pkg: (pass1, pass2, profile after pass 1, profile after pass 2)}."""
    from avenir_tpu import runner as jax_runner
    from avenir_tpu.tune.store import ProfileStore as RefStore

    runner = runner or "run_job"
    out = {}
    for pkg, fn, store_cls, extra in (
            ("ref", getattr(jax_runner, runner), RefStore, {}),
            ("port", {"run_job": run_job,
                      "run_incremental": run_incremental}[runner],
             ProfileStore, {"device": CPU})):
        tdir = str(tmp_path / f"t_{pkg}")
        prefix = next(iter(conf)).split(".")[0]
        c = dict(conf, **{f"{prefix}.stream.autotune": "true",
                          f"{prefix}.stream.autotune.dir": tdir})
        passes, profs = [], []
        for i in (1, 2):
            kw = dict(kwargs)
            if "state_dir" in kw:
                kw["state_dir"] = f"{kw['state_dir']}_{pkg}"
            passes.append(fn(job, c, inputs,
                             str(tmp_path / f"{out_name}_{pkg}{i}"),
                             **kw, **extra))
            profs.append(store_cls(tdir).load(job, corpus_digest(inputs)))
        out[pkg] = (*passes, *profs)
    return out


#: the knobs a tiny corpus decides without a timing: its measured work
#: is under MIN_CHUNK_WORK_SECS x 2, so the block target is the whole
#: corpus, and the cache rule reads counters; the prefetch rule reads
#: stall shares, which vary run to run
UNTIMED_KNOBS = ("stream.block.size.mb", "stream.encoded.cache.budget.mb")


def _assert_same_tuning(runs, same_knobs=True):
    ref1, ref2, ref_p1, ref_p2 = runs["ref"]
    got1, got2, got_p1, _got_p2 = runs["port"]
    assert _bytes_of(got1) == _bytes_of(got2)
    assert _bytes_of(ref1) == _bytes_of(ref2)
    _same_as_reference(got1, ref1)
    # the reference's recorded signal row through both policies: the same
    # knobs and reasons (the row is rounded to 4 decimals when stored, so
    # a share on a rule's edge may read apart from the run's own, and the
    # comparison is on the stored row); the knobs no timing decides are
    # the ones the reference stored
    from avenir_tpu.tune import policy as ref_policy
    from avenir_tpu.tune.signals import RunSignals as RefSignals

    row = ref_p1["runs"][-1]
    counters = {k: v for k, v in ref1.counters.items()
                if k.startswith("Cache:")}
    knobs, reasons = port_policy.choose_knobs(
        RunSignals.from_json(row["signals"]), counters, row["knobs_used"])
    assert (knobs, reasons) == ref_policy.choose_knobs(
        RefSignals.from_json(row["signals"]), counters, row["knobs_used"])
    for key in UNTIMED_KNOBS:
        assert knobs.get(key) == ref_p1["knobs"].get(key), key
    assert got_p1["runs"][-1]["knobs_used"] == row["knobs_used"]
    if same_knobs:
        for key in UNTIMED_KNOBS:
            assert got_p1["knobs"].get(key) == ref_p1["knobs"].get(key), key
    assert {k: v for k, v in got_p1.items() if k not in ("runs", "knobs",
                                                         "reasons",
                                                         "residuals",
                                                         "fold_cost_ms")} \
        == {k: v for k, v in ref_p1.items() if k not in ("runs", "knobs",
                                                         "reasons",
                                                         "residuals",
                                                         "fold_cost_ms")}


def test_autotuned_run_job_writes_reference_bytes(tmp_path):
    csv, schema = _churn(tmp_path)
    runs = _two_passes(tmp_path, "mutualInformation",
                       _mi(schema, **{"stream.block.size.mb": "0.01"}),
                       [csv], "mi")
    _assert_same_tuning(runs)
    # the tiny corpus' work converges to one whole-corpus block
    assert runs["port"][2]["knobs"]["stream.block.size.mb"] == 1.0
    assert runs["port"][0].counters["Mem:PredictedPeakBytes"] == \
        runs["ref"][0].counters["Mem:PredictedPeakBytes"]


def test_autotuned_bytes_fold_apriori(tmp_path):
    csv = _seq(tmp_path)
    conf = {"fia.support.threshold": "0.3", "fia.item.set.length": "2",
            "fia.skip.field.count": "2", "fia.stream.block.size.mb": "0.003"}
    runs = _two_passes(tmp_path, "frequentItemsApriori", conf, [csv], "fia")
    _assert_same_tuning(runs)


def test_autotuned_gsp_cache_rule_matches_reference(tmp_path):
    """GSP over two sources under an explicit budget below the registry's
    range, room for one source's encoded blocks: pass 1 evicts the other
    (an eviction takes a whole source, so one source would leave no spill
    to size from). The cache rule clamps the current budget into the
    range, so it reads 64 MB, and prices the small spill at the same 64
    MB floor: in both packages the budget does not move, pass 2 (at the
    moved block size) evicts again, and both passes write the reference's
    bytes. A spill past 60.34 MiB
    rounds up to 128 MB, which moves (chip_smoke's phase 24 sizes its
    corpus for it)."""
    from avenir_tpu.tune import policy as ref

    inputs = [_seq(tmp_path, rows=600, name="a.csv"),
              _seq(tmp_path, rows=700, name="b.csv")]
    conf = {"cgs.support.threshold": "0.2", "cgs.item.set.length": "3",
            "cgs.skip.field.count": "2", "cgs.stream.block.size.mb": "0.003",
            "cgs.stream.encoded.cache.budget.mb": "0.006"}
    runs = _two_passes(tmp_path, "candidateGenerationWithSelfJoin", conf,
                       inputs, "gsp")
    _assert_same_tuning(runs)
    for pkg in ("ref", "port"):
        first, second, p1, _p2 = runs[pkg]
        assert first.counters["Cache:EvictedBytes"] > 0
        assert first.counters["Cache:SpillBytes"] > 0
        assert "stream.encoded.cache.budget.mb" not in p1["knobs"]
        assert second.counters["Cache:EvictedBytes"] > 0
    spill = 65_270_548                      # phase 24's source, 62.25 MiB
    for counters, current, want in (
            ({"Cache:EvictedBytes": spill, "Cache:SpillBytes": spill},
             64.0, 128.0),
            ({"Cache:EvictedBytes": spill, "Cache:SpillBytes": spill},
             0.006, 128.0),
            ({"Cache:EvictedBytes": 1, "Cache:SpillBytes": 63_270_000},
             64.0, None),
            ({"Cache:EvictedBytes": 1, "Cache:SpillBytes": 63_272_000},
             64.0, 128.0)):
        got = port_policy.choose_cache_budget_mb(counters, current)
        assert got == ref.choose_cache_budget_mb(counters, current)
        assert got[0] == want


def test_autotuned_run_shared_writes_reference_bytes(tmp_path):
    """The fused trio autotuned in both packages: every file equal, the
    fused profile ("+"-joined) with the reference's knobs from its own
    signals, and each member's fold cost noted."""
    from avenir_tpu import runner as jax_runner
    from avenir_tpu.tune.store import ProfileStore as RefStore

    csv, schema = _churn(tmp_path, rows=3000)
    group = "+".join(sorted(j for j, _p in TRIO))
    got = {}
    for pkg, fn, store_cls, extra in (
            ("ref", jax_runner.run_shared, RefStore, {}),
            ("port", run_shared, ProfileStore, {"device": CPU})):
        tdir = str(tmp_path / f"t_{pkg}")
        res = []
        for i in (1, 2):
            specs = [(job, {f"{p}.feature.schema.file.path": schema,
                            f"{p}.stream.block.size.mb": "0.02",
                            f"{p}.stream.autotune": "true",
                            f"{p}.stream.autotune.dir": tdir,
                            **({"mut.mutual.info.score.algorithms":
                                "mutual.info.maximization"}
                               if p == "mut" else {})},
                      str(tmp_path / f"{pkg}{i}_{p}"))
                     for job, p in TRIO]
            res.append(fn(specs, [csv], **extra))
        store = store_cls(tdir)
        got[pkg] = (res, store.load(group, corpus_digest([csv])),
                    {j: store.fold_cost_ms(j, corpus_digest([csv]))
                     for j, _p in TRIO})
    (ref1, ref2), ref_prof, _ref_costs = got["ref"]
    (port1, port2), port_prof, port_costs = got["port"]
    for job, _p in TRIO:
        assert _bytes_of(ref2[job]) == _bytes_of(ref1[job])
        assert _bytes_of(port1[job]) == _bytes_of(port2[job])
        _same_as_reference(port1[job], ref1[job])
        assert port1[job].counters["Mem:PredictedPeakBytes"] == \
            ref1[job].counters["Mem:PredictedPeakBytes"]
        assert port_costs[job] is not None and port_costs[job] > 0
    # the reference's pass-1 signal row through the port's policy gives
    # the moves its pass 2 ran under
    row = ref_prof["runs"][0]
    moves, _reasons = port_policy.choose_knobs(
        RunSignals.from_json(row["signals"]), {}, row["knobs_used"])
    assert moves
    for key, value in moves.items():
        assert ref_prof["runs"][1]["knobs_used"][key] == value
    assert port_prof["job"] == ref_prof["job"] == group
    assert len(port_prof["runs"]) == len(ref_prof["runs"]) == 2


def test_autotuned_incremental_moves_the_checkpoint_interval(tmp_path):
    """run_incremental records job.checkpoint spans: an autotuned refresh
    whose checkpoints pass their wall budget doubles the interval; its
    bytes equal the reference's and a cold run's."""
    csv, schema = _churn(tmp_path, rows=2500)
    conf = _mi(schema, **{"stream.block.size.mb": "0.01",
                          "stream.checkpoint.interval.mb": "0.005"})
    cold = run_job("mutualInformation", conf, [csv],
                   str(tmp_path / "cold.txt"), device=CPU)
    runs = _two_passes(tmp_path, "mutualInformation", conf, [csv], "incr",
                       runner="run_incremental",
                       state_dir=str(tmp_path / "state"))
    assert _bytes_of(runs["port"][0]) == _bytes_of(cold)
    _assert_same_tuning(runs, same_knobs=False)
    sig = runs["port"][2]["runs"][-1]["signals"]
    assert sig["checkpoint_s"] > 0
    knob = runs["port"][2]["knobs"].get("stream.checkpoint.interval.mb")
    if sig["checkpoint_s"] / max(sig["wall_s"], 1e-9) > 0.05:
        assert knob is not None and knob >= 32.0


# ========================================================== memory model
STREAMED = {
    "bayesianDistr": ("bad", "churn", {}),
    "mutualInformation": ("mut", "churn", {
        "mutual.info.score.algorithms": "mutual.info.maximization"}),
    "fisherDiscriminant": ("fid", "churn", {}),
    "markovStateTransitionModel": ("mst", "seq", {
        "model.states": "L,M,H", "class.label.field.ord": "1",
        "skip.field.count": "2", "class.labels": "T,F"}),
    "frequentItemsApriori": ("fia", "seq", {
        "support.threshold": "0.3", "item.set.length": "2",
        "skip.field.count": "2"}),
    "candidateGenerationWithSelfJoin": ("cgs", "seq", {
        "support.threshold": "0.3", "item.set.length": "2",
        "skip.field.count": "2"}),
}


@pytest.mark.parametrize("job", sorted(STREAMED))
@pytest.mark.parametrize("depth", ["2", "5"])
def test_mem_counters_match_reference(tmp_path, job, depth):
    """Mem:PredictedPeakBytes equals the JAX package's at two prefetch
    depths; Mem:PeakRSS, the process's, is there; every other counter but
    the throughput ones equal."""
    prefix, data, extra = STREAMED[job]
    if data == "churn":
        inp, schema = _churn(tmp_path, rows=800)
        extra = dict(extra, **{"feature.schema.file.path": schema})
    else:
        inp = _seq(tmp_path)
    conf = {f"{prefix}.{k}": v for k, v in dict(
        extra, **{"stream.block.size.mb": "0.004",
                  "stream.prefetch.depth": depth}).items()}
    tail = os.sep if prefix in ("fia", "cgs") else ".txt"
    ref = _jax_run_job(job, conf, [inp], str(tmp_path / "ref") + tail)
    got = run_job(job, conf, [inp], str(tmp_path / "out") + tail,
                  device=CPU)
    assert got.counters["Mem:PredictedPeakBytes"] == \
        ref.counters["Mem:PredictedPeakBytes"] > 0
    assert got.counters["Mem:PeakRSS"] > 0
    timing = ("Mem:PeakRSS", "Basic:RowsPerSec", "Basic:Seconds")
    assert {k for k in got.counters if k not in timing} == \
        {k for k in ref.counters if k not in timing}


def test_residual_recorded_only_when_the_run_raises_the_peak(tmp_path,
                                                            monkeypatch):
    """A residual lands in `.avenir_tune/` beside the input when the run
    raised the process peak (autotune off), and a second run under the
    same peak records none."""
    import resource

    from avenir_tpu_torch import runner

    csv, schema = _churn(tmp_path)

    class _Rusage:
        ru_maxrss = 1 << 20            # KB: a flat 1 GiB peak
    monkeypatch.setattr(resource, "getrusage", lambda who: _Rusage())
    monkeypatch.setattr(runner, "_rss_now", lambda: 0)
    monkeypatch.setattr(runner, "_residual_peak_seen", 0)
    conf = _mi(schema, **{"stream.block.size.mb": "0.01"})
    res = run_job("mutualInformation", conf, [csv], str(tmp_path / "o.txt"),
                  device=CPU)
    store = ProfileStore(str(tmp_path / ".avenir_tune"))
    prof = store.load("mutualInformation", corpus_digest([csv]))
    assert prof["residuals"] == [{
        "predicted": int(res.counters["Mem:PredictedPeakBytes"]),
        "measured": 1 << 30}]
    assert prof["runs"] == [] and prof["knobs"] == {}
    run_job("mutualInformation", conf, [csv], str(tmp_path / "o2.txt"),
            device=CPU)
    assert len(store.load("mutualInformation",
                          corpus_digest([csv]))["residuals"]) == 1


# ================================================================== CLI
def _cli_error(fn, argv):
    """The text after "error: " of an argparse refusal, and its code."""
    err = io.StringIO()
    with redirect_stderr(err), pytest.raises(SystemExit) as exit_:
        fn(argv)
    return exit_.value.code, err.getvalue().strip().splitlines()[-1] \
        .split("error: ", 1)[1]


@pytest.mark.parametrize("case", ["hocon", "shard"])
def test_autotune_refusals_match_reference(tmp_path, case):
    from avenir_tpu.runner import run_from_cli as jax_cli

    csv, schema = _churn(tmp_path, rows=50)
    if case == "hocon":
        conf = tmp_path / "j.conf"
        conf.write_text("mutualInformation {\n}\n")
        argv = ["mutualInformation", "--conf", str(conf), "--autotune",
                csv, str(tmp_path / "o.txt")]
    else:
        props = tmp_path / "j.properties"
        props.write_text(f"mut.feature.schema.file.path={schema}\n")
        argv = ["mutualInformation", "--conf", str(props), "--autotune",
                "--shard", "2", csv, str(tmp_path / "o.txt")]
    assert _cli_error(run_from_cli, argv + ["--device", "cpu"]) == \
        _cli_error(jax_cli, argv)


def test_cli_autotune_tunes_like_the_reference(tmp_path):
    """`--autotune` from a properties file: the run records its profile
    beside the input and writes the reference's bytes; the second run
    applies the knobs the reference chose."""
    from avenir_tpu.runner import run_from_cli as jax_cli
    from avenir_tpu.tune.store import ProfileStore as RefStore

    csv, schema = _churn(tmp_path)
    got = {}
    for pkg, fn, store_cls, tail in (("ref", jax_cli, RefStore, []),
                                     ("port", run_from_cli, ProfileStore,
                                      ["--device", "cpu"])):
        props = tmp_path / f"{pkg}.properties"
        props.write_text(
            f"mut.feature.schema.file.path={schema}\n"
            "mut.mutual.info.score.algorithms=mutual.info.maximization\n"
            "mut.stream.block.size.mb=0.01\n"
            f"mut.stream.autotune.dir={tmp_path / ('t_' + pkg)}\n")
        with redirect_stdout(io.StringIO()):
            res = [fn(["mutualInformation", "--conf", str(props),
                       "--autotune", csv, str(tmp_path / f"{pkg}{i}.txt"),
                       *tail]) for i in (1, 2)]
        got[pkg] = (res, store_cls(str(tmp_path / f"t_{pkg}")).load(
            "mutualInformation", corpus_digest([csv])))
    (r1, r2), ref_prof = got["ref"]
    (p1, p2), port_prof = got["port"]
    assert _bytes_of(p1) == _bytes_of(p2)
    assert _bytes_of(r1) == _bytes_of(r2)
    _same_as_reference(p1, r1)
    assert port_prof["runs"][0]["knobs_used"] == \
        ref_prof["runs"][0]["knobs_used"]
    assert len(port_prof["runs"]) == len(ref_prof["runs"]) == 2
    for key in UNTIMED_KNOBS:
        assert port_prof["knobs"].get(key) == ref_prof["knobs"].get(key)


@pytest.mark.parametrize("as_json", [False, True])
def test_tune_renders_the_reference_text(tmp_path, as_json):
    from avenir_tpu.tune.report import tune_main as jax_tune
    from avenir_tpu_torch.tune.report import tune_main

    store = ProfileStore(str(tmp_path / "t"))
    store.record_run("mutualInformation", "beef",
                     RunSignals(wall_s=2.0, chunks=4, read_s=0.5).to_json(),
                     {"stream.prefetch.depth": 2}, 2.0)
    store.set_knobs("mutualInformation", "beef",
                    {"stream.block.size.mb": 8.0}, ["block 64->8MB (test)"])
    store.record_residual("mutualInformation", "beef", 100, 220)
    _fill(store, job="bayesianDistr", digest="cafe", n=3)
    texts = []
    for fn in (jax_tune, tune_main):
        out = io.StringIO()
        with redirect_stdout(out):
            assert fn([str(tmp_path / "t")] + (["--json"] if as_json
                                               else [])) == 0
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    if not as_json:
        assert "stream.block.size.mb=8" in texts[1]
        assert "residual_factor=2.2" in texts[1]


@pytest.mark.parametrize("case", ["missing", "bad_profile"])
def test_tune_missing_dir_and_bad_profile_answer_alike(tmp_path, case):
    from avenir_tpu.tune.report import tune_main as jax_tune
    from avenir_tpu_torch.tune.report import tune_main

    path = tmp_path / "nope"
    if case == "bad_profile":
        path.mkdir()
        (path / "mutualInformation_cafe.json").write_text(json.dumps(
            {"format": 1, "knobs": {"stream.prefetch.depth": 99}}))
    answers = []
    for fn in (jax_tune, tune_main):
        out = io.StringIO()
        with redirect_stdout(out):
            rc = fn([str(path)])
        answers.append((rc, out.getvalue()))
    assert answers[0] == answers[1]
    assert answers[1][0] == (0 if case == "missing" else 2)


def test_tune_subcommand_lists_profiles(tmp_path):
    """`python -m avenir_tpu_torch tune <dir>` in a fresh interpreter."""
    _fill(ProfileStore(str(tmp_path / "t")), job="mutualInformation")
    _fill(ProfileStore(str(tmp_path / "t")), job="bayesianDistr")
    proc = subprocess.run(
        [sys.executable, "-m", "avenir_tpu_torch", "tune", str(tmp_path / "t")],
        cwd=REPO, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr
    assert "bayesianDistr  corpus=beef" in proc.stdout
    assert "mutualInformation  corpus=beef" in proc.stdout


# ============================================================= tripwires
def test_autotune_tripwire_on_the_cpu():
    from avenir_tpu_torch.tools.bench_scaling import autotune_tripwire

    out = autotune_tripwire(rows=20_000, floor=0.0, device="cpu")
    assert out["outputs_byte_identical"] is True
    assert out["chosen_knobs"] and out["reasons"]
    assert out["signals"]["chunks"] >= 1
    assert min(out["t_static_runs_s"] + out["t_tuned_runs_s"]) > 0
    assert all(m["Mem:PredictedPeakBytes"] > 0 for m in out["mem"].values())


def test_obs_tripwire_on_the_cpu():
    from avenir_tpu_torch.tools.bench_scaling import obs_tripwire

    out = obs_tripwire(rows=20_000, ceiling=1000.0, device="cpu")
    assert out["outputs_byte_identical"] is True
    assert out["chunks"] >= 1 and out["spans"] >= 5 * out["chunks"]
    assert out["spans_dropped"] == 0
