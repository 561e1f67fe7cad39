"""The port's delta-scan layer held against the JAX package on the CPU:
`core/incremental.py` (fingerprints, the verified prefix, the checkpoint
store), `runner.run_incremental` and `run_incremental_shared`, the CLI's
`--incremental`, `run_warm_miner`, and the encoded-block cache's
appended-source replay.

Every stream fold family runs cold, takes an append and refreshes; the
refreshed artifact equals the JAX package's `run_incremental` twin and a
cold `run_job` byte for byte. Every cold-fallback gate (a torn, truncated
or unloadable carry, a version skew, an in-place edit, a changed conf, a
reordered input list, a last line without a newline) falls back with
`Cache:HitBlocks == 0` to the cold bytes. A child interpreter killed at
the first mid-scan checkpoint leaves a checkpoint the next run resumes
from. The checkpoint manifests equal the reference's field by field but
the carry: the port's carry holds its own dtypes, so its npz bytes and
the `carry_file` name built from their hash differ. Inputs are made from
seeds at 0.005 MB blocks; every child interpreter has its own timeout."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch_reference_native  # noqa: F401  (settles the reference's native route)

from avenir_tpu_torch.core.incremental import (CheckpointStore,
                                               block_fingerprint,
                                               ends_at_newline,
                                               verified_prefix)
from avenir_tpu_torch.runner import (run_incremental, run_incremental_shared,
                                     run_job)

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 300
BLOCK = "0.005"


def _churn(tmp_path, rows=600, seed=11):
    from avenir_tpu.data import churn_schema, generate_churn

    csv = tmp_path / "churn.csv"
    csv.write_text(generate_churn(rows, seed=seed, as_csv=True))
    schema = tmp_path / "churn.json"
    churn_schema().save(str(schema))
    return str(csv), str(schema)


def _append_churn(csv, rows, seed):
    from avenir_tpu.data import generate_churn

    with open(csv, "a") as fh:
        fh.write(generate_churn(rows, seed=seed, as_csv=True))


def _seq(path, rows, start=0, mode="w"):
    """Chains of 2-8 states with skewed weights, labelled T or F."""
    rng = np.random.default_rng(31 + start)
    with open(path, mode) as fh:
        for i in range(start, start + rows):
            toks = rng.choice(3, size=int(rng.integers(2, 9)),
                              p=[0.5, 0.3, 0.2])
            label = "T" if rng.random() < 0.4 else "F"
            fh.write(f"c{i},{label}," + ",".join("LMH"[t] for t in toks)
                     + "\n")
    return str(path)


def _conf(job, schema=None, **extra):
    prefix = {"bayesianDistr": "bad", "mutualInformation": "mut",
              "fisherDiscriminant": "fid",
              "markovStateTransitionModel": "mst",
              "frequentItemsApriori": "fia",
              "candidateGenerationWithSelfJoin": "cgs"}[job]
    body = {"stream.block.size.mb": BLOCK}
    if schema is not None:
        body["feature.schema.file.path"] = schema
    body.update({
        "mutualInformation": {"mutual.info.score.algorithms":
                              "mutual.info.maximization"},
        "markovStateTransitionModel": {
            "model.states": "L,M,H", "class.label.field.ord": "1",
            "skip.field.count": "2", "class.labels": "T,F"},
        "frequentItemsApriori": {"support.threshold": "0.2",
                                 "item.set.length": "3",
                                 "skip.field.count": "2"},
        "candidateGenerationWithSelfJoin": {"support.threshold": "0.15",
                                            "item.set.length": "3",
                                            "skip.field.count": "2"},
    }.get(job, {}))
    body.update(extra)
    return {f"{prefix}.{k}": v for k, v in body.items()}


def _files(res):
    return [open(p, "rb").read() for p in sorted(res.outputs)]


def _out(tmp_path, name, job):
    miner = job in ("frequentItemsApriori", "candidateGenerationWithSelfJoin")
    return str(tmp_path / name) + (os.sep if miner else ".txt")


def _manifest(state):
    with open(os.path.join(state, CheckpointStore.MANIFEST)) as fh:
        return json.load(fh)


#: the manifest fields both packages must agree on; the carry's name,
#: size and hash follow the port's own carry bytes
SHARED_FIELDS = ("format", "format_version", "job", "seq", "conf_digest",
                 "inputs", "block_bytes", "watermarks", "fingerprints",
                 "complete", "predicted_peak_bytes")


# ------------------------------------------------------------ mechanics
@pytest.mark.parametrize("change", ["none", "append", "edit", "shrink"])
def test_verified_prefix_matches_reference(tmp_path, change):
    from avenir_tpu.core import incremental as jincr
    from avenir_tpu_torch.core.stream import iter_byte_blocks

    p = tmp_path / "f.csv"
    p.write_text("".join(f"row{i},a,b\n" for i in range(300)))
    fps = [block_fingerprint(o, b)
           for o, b in iter_byte_blocks(str(p), 331, with_offsets=True)]
    assert fps == [jincr.block_fingerprint(o, b) for o, b in
                   iter_byte_blocks(str(p), 331, with_offsets=True)]
    data = bytearray(p.read_bytes())
    if change == "append":
        p.write_bytes(bytes(data) + b"tail,x,y\n")
    elif change == "edit":
        data[len(data) // 2] = ord("X")
        p.write_bytes(bytes(data))
    elif change == "shrink":
        p.write_bytes(bytes(data[: len(data) // 3]))
    got = verified_prefix(str(p), fps)
    assert got == jincr.verified_prefix(str(p), fps)
    if change in ("none", "append"):
        assert got == (len(fps), len(data))
    else:
        assert got[0] < len(fps)
    assert ends_at_newline(str(p), got[1]) == \
        jincr.ends_at_newline(str(p), got[1])


def test_checkpoint_store_roundtrip_torn_writes_and_reference_load(tmp_path):
    from avenir_tpu.core.incremental import CheckpointStore as JaxStore

    store = CheckpointStore(str(tmp_path / "state"))
    assert store.load() is None
    meta = store.save({"seq": 1, "job": "j", "complete": True}, b"carry-1")
    assert store.load()[1] == b"carry-1"
    # the same manifest and carry the reference's store writes and reads
    jmeta = JaxStore(str(tmp_path / "jstate")).save(
        {"seq": 1, "job": "j", "complete": True}, b"carry-1")
    assert jmeta == meta
    assert JaxStore(store.dir).load() == store.load()
    meta2 = store.save({"seq": 2, "job": "j", "complete": True}, b"carry-22")
    assert store.load()[1] == b"carry-22"
    assert not os.path.exists(os.path.join(store.dir, meta["carry_file"]))
    with open(os.path.join(store.dir, meta2["carry_file"]), "wb") as fh:
        fh.write(b"carry")                    # truncated carry
    assert store.load() is None
    store.save({"seq": 3, "job": "j", "complete": True}, b"carry-3")
    with open(os.path.join(store.dir, store.MANIFEST), "w") as fh:
        fh.write("{not json")
    assert store.load() is None
    store.save({"seq": 4, "job": "j", "format_version": 2}, b"carry-4")
    assert store.load() is None               # a version skew refuses
    store.clear()
    assert os.listdir(store.dir) == []


# ---------------------------------------------------------- equivalence
FAMILIES = ["bayesianDistr", "mutualInformation", "fisherDiscriminant",
            "markovStateTransitionModel", "frequentItemsApriori",
            "candidateGenerationWithSelfJoin"]


@pytest.mark.parametrize("job", FAMILIES)
def test_append_refresh_equals_reference_and_cold(tmp_path, job):
    from avenir_tpu.runner import run_incremental as jax_incremental

    if job in ("bayesianDistr", "mutualInformation", "fisherDiscriminant"):
        csv, schema = _churn(tmp_path)
        conf = _conf(job, schema)
    else:
        csv = _seq(tmp_path / "seq.csv", 500)
        conf = _conf(job)
    state, jstate = str(tmp_path / "state"), str(tmp_path / "jstate")
    first = run_incremental(job, conf, [csv], _out(tmp_path, "p0", job),
                            state_dir=state, device=CPU)
    jax_incremental(job, conf, [csv], _out(tmp_path, "j0", job),
                    state_dir=jstate)
    assert first.counters["Cache:HitBlocks"] == 0
    assert first.counters["Cache:DeltaBlocks"] > 0
    if job in ("bayesianDistr", "mutualInformation", "fisherDiscriminant"):
        _append_churn(csv, 60, seed=12)
    else:
        _seq(csv, 40, start=500, mode="a")
    got = run_incremental(job, conf, [csv], _out(tmp_path, "p1", job),
                          state_dir=state, device=CPU)
    want = jax_incremental(job, conf, [csv], _out(tmp_path, "j1", job),
                           state_dir=jstate)
    cold = run_job(job, conf, [csv], _out(tmp_path, "cold", job),
                   device=CPU)
    assert _files(got) == _files(want) == _files(cold)
    assert got.counters["Cache:HitBlocks"] > 0
    assert 0 < got.counters["Resume:SkippedBytes"] < os.path.getsize(csv)
    assert got.counters["Cache:DeltaBlocks"] \
        < first.counters["Cache:DeltaBlocks"]
    for key in ("Cache:HitBlocks", "Cache:DeltaBlocks",
                "Resume:SkippedBytes"):
        assert got.counters[key] == want.counters[key], key
    mine, theirs = _manifest(state), _manifest(jstate)
    mine["inputs"] = theirs["inputs"]      # the same path either way
    assert {k: mine[k] for k in SHARED_FIELDS} == \
        {k: theirs[k] for k in SHARED_FIELDS}


def test_unchanged_corpus_refresh_folds_nothing(tmp_path):
    csv, schema = _churn(tmp_path, rows=300)
    conf = _conf("mutualInformation", schema)
    state = str(tmp_path / "state")
    first = run_incremental("mutualInformation", conf, [csv],
                            str(tmp_path / "a.txt"), state_dir=state,
                            device=CPU)
    again = run_incremental("mutualInformation", conf, [csv],
                            str(tmp_path / "b.txt"), state_dir=state,
                            device=CPU)
    assert _files(first) == _files(again)
    assert again.counters["Cache:DeltaBlocks"] == 0
    assert again.counters["Resume:SkippedBytes"] == os.path.getsize(csv)
    assert _manifest(state)["seq"] == 2


# ------------------------------------------------------ cold fallbacks
def _corrupt(case, tmp_path, csv, schema, state, conf):
    """Break one restore gate; returns the (conf, inputs) of the rerun."""
    meta = _manifest(state)
    carry = os.path.join(state, meta["carry_file"])
    if case == "torn_carry":
        with open(carry, "r+b") as fh:
            fh.seek(10)
            fh.write(b"\x00\x01torn")
    elif case == "truncated_carry":
        with open(carry, "r+b") as fh:
            fh.truncate(16)
    elif case == "unloadable_carry":
        # a carry whose length and hash verify but whose npz does not load
        CheckpointStore(state).save(
            {k: v for k, v in meta.items()
             if not k.startswith("carry_")}, b"not an npz")
    elif case == "version_skew":
        meta["format_version"] = 2
        with open(os.path.join(state, CheckpointStore.MANIFEST), "w") as fh:
            json.dump(meta, fh)
    elif case == "inplace_edit":
        data = open(csv, "rb").read()
        cut = data.index(b",")
        open(csv, "wb").write(b"Z" * cut + data[cut:])
    elif case == "changed_conf":
        conf = dict(conf, **{"mut.stream.block.size.mb": "0.01"})
    elif case == "changed_schema_bytes":
        with open(schema, "a") as fh:
            fh.write("\n")
    elif case == "reordered_inputs":
        other = str(tmp_path / "other.csv")
        _append_churn(other, 50, seed=5)
        return conf, [other, csv]
    _append_churn(csv, 40, seed=13)
    return conf, [csv]


@pytest.mark.parametrize("case", [
    "torn_carry", "truncated_carry", "unloadable_carry", "version_skew",
    "inplace_edit", "changed_conf", "changed_schema_bytes",
    "reordered_inputs"])
def test_cold_fallback(tmp_path, case):
    from avenir_tpu.runner import run_job as jax_run_job

    csv, schema = _churn(tmp_path, rows=400)
    conf = _conf("mutualInformation", schema)
    state = str(tmp_path / "state")
    run_incremental("mutualInformation", conf, [csv],
                    str(tmp_path / "a.txt"), state_dir=state, device=CPU)
    conf, inputs = _corrupt(case, tmp_path, csv, schema, state, conf)
    got = run_incremental("mutualInformation", conf, inputs,
                          str(tmp_path / "b.txt"), state_dir=state,
                          device=CPU)
    cold = jax_run_job("mutualInformation", conf, inputs,
                       str(tmp_path / "cold.txt"))
    assert _files(got) == _files(cold)
    assert got.counters["Cache:HitBlocks"] == 0
    assert got.counters["Resume:SkippedBytes"] == 0
    # the fallback seeded a good checkpoint: the next refresh is warm
    again = run_incremental("mutualInformation", conf, inputs,
                            str(tmp_path / "c.txt"), state_dir=state,
                            device=CPU)
    assert again.counters["Cache:HitBlocks"] > 0
    assert _files(again) == _files(cold)


def test_unterminated_last_line_append_falls_back_cold(tmp_path):
    """A watermark that ends mid-line: the appended bytes extend the row
    already folded, so a resume would skip its continuation."""
    csv, schema = _churn(tmp_path, rows=300)
    with open(csv, "rb+") as fh:
        fh.seek(-1, 2)
        fh.truncate()                       # no trailing newline
    conf = _conf("mutualInformation", schema)
    state = str(tmp_path / "state")
    run_incremental("mutualInformation", conf, [csv],
                    str(tmp_path / "a.txt"), state_dir=state, device=CPU)
    with open(csv, "a") as fh:
        fh.write("\n")
    _append_churn(csv, 60, seed=14)
    got = run_incremental("mutualInformation", conf, [csv],
                          str(tmp_path / "b.txt"), state_dir=state,
                          device=CPU)
    cold = run_job("mutualInformation", conf, [csv],
                   str(tmp_path / "cold.txt"), device=CPU)
    assert _files(got) == _files(cold)
    assert got.counters["Cache:HitBlocks"] == 0


def test_appended_input_file_folds_whole(tmp_path):
    """An input list that extends the checkpoint's (a prefix) restores,
    and the new file folds whole."""
    csv, schema = _churn(tmp_path, rows=300)
    more = str(tmp_path / "more.csv")
    _append_churn(more, 80, seed=21)
    conf = _conf("mutualInformation", schema)
    state = str(tmp_path / "state")
    run_incremental("mutualInformation", conf, [csv],
                    str(tmp_path / "a.txt"), state_dir=state, device=CPU)
    got = run_incremental("mutualInformation", conf, [csv, more],
                          str(tmp_path / "b.txt"), state_dir=state,
                          device=CPU)
    cold = run_job("mutualInformation", conf, [csv, more],
                   str(tmp_path / "cold.txt"), device=CPU)
    assert _files(got) == _files(cold)
    assert got.counters["Resume:SkippedBytes"] == os.path.getsize(csv)


def test_default_state_dir_equals_reference(tmp_path):
    from avenir_tpu.runner import _incremental_state_dir as jax_dir
    from avenir_tpu.runner import _job_cfg as jax_job_cfg
    from avenir_tpu_torch.runner import _incremental_state_dir, _job_cfg

    csv, schema = _churn(tmp_path, rows=50)
    conf = _conf("mutualInformation", schema)
    _c, cfg = _job_cfg("mutualInformation", conf)
    _c, _p, jcfg = jax_job_cfg("mutualInformation", conf)
    d1 = _incremental_state_dir(cfg, "mutualInformation", [csv])
    assert d1 == jax_dir(jcfg, "mutualInformation", [csv])
    assert d1 != _incremental_state_dir(cfg, "bayesianDistr", [csv])
    assert d1.startswith(os.path.join(str(tmp_path), ".avenir_incremental"))
    res = run_incremental("mutualInformation", conf, [csv],
                          str(tmp_path / "a.txt"), device=CPU)
    assert res.counters["Cache:DeltaBlocks"] > 0
    assert os.path.exists(os.path.join(d1, CheckpointStore.MANIFEST))


# ------------------------------------------------------ fused refresh
def test_incremental_shared_mixed_groups_equal_solo(tmp_path):
    """MI and NB seeded at the first size, Fisher seeded after the
    append: two watermark groups, each scanned once, every artifact equal
    to its solo refresh and to the reference's fused refresh."""
    from avenir_tpu.runner import run_incremental_shared as jax_shared
    from avenir_tpu_torch import obs

    jobs = ["bayesianDistr", "mutualInformation", "fisherDiscriminant"]
    csv, schema = _churn(tmp_path, rows=500)
    confs = {j: _conf(j, schema) for j in jobs}
    dirs = {j: {w: str(tmp_path / f"{w}_{j}") for w in ("f", "s", "j")}
            for j in jobs}
    for j in jobs[:2]:
        for w in ("f", "s"):
            run_incremental(j, confs[j], [csv], str(tmp_path / f"seed{w}{j}"),
                            state_dir=dirs[j][w], device=CPU)
        from avenir_tpu.runner import run_incremental as jax_incremental
        jax_incremental(j, confs[j], [csv], str(tmp_path / f"seedj{j}"),
                        state_dir=dirs[j]["j"])
    _append_churn(csv, 50, seed=17)
    with obs.capture() as rec:
        fused = run_incremental_shared(
            [(j, confs[j], str(tmp_path / f"fused_{j}")) for j in jobs],
            [csv], state_dirs={j: dirs[j]["f"] for j in jobs}, device=CPU)
    groups = [sp.attrs["jobs"] for sp in rec.spans()
              if sp.name == "job.dispatch"
              and sp.attrs.get("mode") == "incremental_shared"]
    assert sorted(groups) == ["bayesianDistr,mutualInformation",
                              "fisherDiscriminant"]
    theirs = jax_shared(
        [(j, confs[j], str(tmp_path / f"jfused_{j}")) for j in jobs],
        [csv], state_dirs={j: dirs[j]["j"] for j in jobs})
    for j in jobs:
        solo = run_incremental(j, confs[j], [csv], str(tmp_path / f"solo_{j}"),
                               state_dir=dirs[j]["s"], device=CPU)
        assert _files(fused[j]) == _files(solo) == _files(theirs[j]), j
        for key in ("Cache:HitBlocks", "Cache:DeltaBlocks",
                    "Resume:SkippedBytes"):
            assert fused[j].counters[key] == solo.counters[key] \
                == theirs[j].counters[key], (j, key)
    with pytest.raises(ValueError, match="mixed scan kinds"):
        run_incremental_shared(
            [("mutualInformation", confs["mutualInformation"], "a"),
             ("markovStateTransitionModel",
              _conf("markovStateTransitionModel"), "b")], [csv], device=CPU)


# ------------------------------------------------- warm miners, prefix
@pytest.mark.parametrize("job", ["frequentItemsApriori",
                                 "candidateGenerationWithSelfJoin"])
def test_warm_miner_equals_cold_and_reference(tmp_path, job):
    from avenir_tpu.runner import _build_miner_source as jax_source
    from avenir_tpu.runner import _job_cfg as jax_job_cfg
    from avenir_tpu.runner import run_warm_miner as jax_warm
    from avenir_tpu_torch.runner import (_build_miner_source, _job_cfg,
                                         run_warm_miner)

    csv = _seq(tmp_path / "seq.csv", 600)
    conf = _conf(job)
    canonical, cfg = _job_cfg(job, conf)
    src = _build_miner_source(canonical, cfg, [csv], True)
    (src.scan_items if job == "frequentItemsApriori" else src.scan)()
    assert src.cache_ready()
    got = run_warm_miner(job, conf, [csv], _out(tmp_path, "warm", job), src,
                         device=CPU)
    assert src.cache_replays >= 1
    src.close()
    _c, _p, jcfg = jax_job_cfg(job, conf)
    jsrc = jax_source(canonical, jcfg, [csv], True)
    (jsrc.scan_items if job == "frequentItemsApriori" else jsrc.scan)()
    want = jax_warm(job, conf, [csv], _out(tmp_path, "jwarm", job), jsrc)
    jsrc.close()
    cold = run_job(job, conf, [csv], _out(tmp_path, "cold", job),
                   device=CPU)
    assert _files(got) == _files(want) == _files(cold)
    with pytest.raises(ValueError, match="no warm-source path"):
        run_warm_miner("mutualInformation", {}, [csv], "x", src, device=CPU)


def test_cache_prefix_replay_equals_reference(tmp_path):
    """An appended source replays its committed prefix and re-parses only
    the tail; an in-place edit and a mid-line watermark refuse."""
    from avenir_tpu.native.ingest import EncodedBlockCache as JaxCache
    from avenir_tpu_torch.core.stream import iter_byte_blocks
    from avenir_tpu_torch.native.ingest import EncodedBlockCache

    csv = _seq(tmp_path / "seq.csv", 300)
    caches = [EncodedBlockCache([csv], byte_budget=1 << 20),
              JaxCache([csv], byte_budget=1 << 20)]
    for cache in caches:
        cache.begin()
        cache.set_source(0)
        for off, data in iter_byte_blocks(csv, 2000, with_offsets=True):
            cache.note_block(off, data)
            n = data.count(b"\n")
            cache.add_block(np.full(n, 2, np.int32),
                            np.arange(2 * n, dtype=np.int32) % 7)
        assert cache.commit()
    size = os.path.getsize(csv)
    _seq(csv, 20, start=300, mode="a")
    for cache in caches:
        assert not cache.source_valid(0)
        assert cache.source_delta(0) == size
    got = [(c.tolist(), k.tolist()) for c, k in caches[0].blocks(0, prefix=True)]
    want = [(c.tolist(), k.tolist()) for c, k in caches[1].blocks(0, prefix=True)]
    assert got == want and got
    with pytest.raises(RuntimeError, match="stale"):
        list(caches[0].blocks(0))
    data = bytearray(open(csv, "rb").read())
    data[5] = ord("Q")
    open(csv, "wb").write(bytes(data))
    assert caches[0].source_delta(0) is None \
        and caches[1].source_delta(0) is None
    for cache in caches:
        cache.close()


@pytest.mark.parametrize("job", ["frequentItemsApriori",
                                 "candidateGenerationWithSelfJoin"])
def test_miner_rounds_replay_prefix_after_append(tmp_path, job):
    """Pass 1 scanned, then the corpus grew: the per-k rounds replay the
    committed prefix and parse the tail, as the reference's miners do."""
    import torch

    from avenir_tpu import runner as jax_runner
    from avenir_tpu_torch import runner

    conf = _conf(job)
    out = {}
    for who in ("port", "jax"):
        csv = _seq(tmp_path / f"{who}.csv", 400)
        if who == "port":
            canonical, cfg = runner._job_cfg(job, conf)
            src = runner._build_miner_source(canonical, cfg, [csv], True)
            miner = runner._build_miner(canonical, cfg, torch.device(CPU))
            finish = runner.finish_miner_levels
        else:
            canonical, _p, cfg = jax_runner._job_cfg(job, conf)
            src = jax_runner._build_miner_source(canonical, cfg, [csv], True)
            miner = jax_runner._build_miner(canonical, cfg)
            finish = jax_runner.finish_miner_levels
        (src.scan_items if job == "frequentItemsApriori" else src.scan)()
        _seq(csv, 30, start=400, mode="a")
        assert src._cache.source_delta(0) is not None
        levels = miner.mine_stream(src)
        src.close()
        out[who] = _files(finish(canonical, cfg, levels, 0, 1.0,
                                 _out(tmp_path, who, job)))
    assert out["port"] == out["jax"]


# --------------------------------------------------------- crash resume
_KILL_CHILD = r'''
import json, os, sys
sys.path.insert(0, %(repo)r)
from avenir_tpu_torch.core import incremental

seen = {"n": 0}
def bomb(meta):
    if not meta.get("complete"):
        seen["n"] += 1
        if seen["n"] >= %(kills)d:
            os._exit(137)        # a hard kill mid-scan, no cleanup
incremental._checkpoint_hook = bomb

from avenir_tpu_torch.runner import run_incremental
run_incremental(%(job)r, json.loads(%(conf)r), [%(csv)r], %(out)r,
                state_dir=%(state)r, device="cpu")
print("COMPLETED")               # unreachable on the kill run
'''


@pytest.mark.parametrize("job", ["markovStateTransitionModel",
                                 "mutualInformation"])
def test_mid_scan_kill_then_rerun_reproduces_cold_bytes(tmp_path, job):
    if job == "mutualInformation":
        csv, schema = _churn(tmp_path, rows=800)
        conf = _conf(job, schema, **{"stream.checkpoint.interval.mb":
                                     "0.004"})
    else:
        csv = _seq(tmp_path / "seq.csv", 800)
        conf = _conf(job, **{"stream.block.size.mb": "0.002",
                             "stream.checkpoint.interval.mb": "0.001"})
    state = str(tmp_path / "state")
    child = _KILL_CHILD % {"repo": REPO, "kills": 2, "job": job,
                           "conf": json.dumps(conf), "csv": csv,
                           "out": str(tmp_path / "killed"), "state": state}
    proc = subprocess.run([sys.executable, "-c", child],
                          capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT_S, cwd=REPO)
    assert proc.returncode == 137, proc.stderr[-800:]
    assert "COMPLETED" not in proc.stdout
    loaded = CheckpointStore(state).load()
    assert loaded is not None and loaded[0]["complete"] is False
    covered = sum(loaded[0]["watermarks"])
    assert 0 < covered < os.path.getsize(csv)
    cold = run_job(job, conf, [csv], str(tmp_path / "cold.txt"), device=CPU)
    got = run_incremental(job, conf, [csv], str(tmp_path / "resumed.txt"),
                          state_dir=state, device=CPU)
    assert _files(got) == _files(cold)
    assert got.counters["Resume:SkippedBytes"] == covered
    assert got.counters["Cache:DeltaBlocks"] > 0


# ------------------------------------------------------ CLI and spans
def test_cli_incremental_flag(tmp_path, capsys):
    from avenir_tpu.runner import run_job as jax_run_job
    from avenir_tpu_torch import obs
    from avenir_tpu_torch.runner import run_from_cli

    csv, schema = _churn(tmp_path, rows=300)
    props = tmp_path / "job.properties"
    props.write_text(
        f"mut.feature.schema.file.path={schema}\n"
        "mut.mutual.info.score.algorithms=mutual.info.maximization\n"
        f"mut.stream.block.size.mb={BLOCK}\n"
        f"mut.stream.incremental.state.dir={tmp_path / 'state'}\n")
    out1, out2 = str(tmp_path / "o1.txt"), str(tmp_path / "o2.txt")
    res = run_from_cli(["mutualInformation", "--incremental", "--conf",
                        str(props), csv, out1, "--device", CPU])
    assert res.counters["Cache:DeltaBlocks"] > 0
    _append_churn(csv, 50, seed=13)
    with obs.capture() as rec:
        res2 = run_from_cli(["mutualInformation", "--incremental", "--conf",
                             str(props), csv, out2, "--device", CPU])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["counters"]["Resume:SkippedBytes"] == \
        res2.counters["Resume:SkippedBytes"] > 0
    names = {sp.name for sp in rec.spans()}
    assert {"job.restore", "job.checkpoint", "job.finish"} <= names
    cold = jax_run_job("mutualInformation", {
        "mut.feature.schema.file.path": schema,
        "mut.mutual.info.score.algorithms": "mutual.info.maximization"},
        [csv], str(tmp_path / "cold.txt"))
    assert open(out2, "rb").read() == open(cold.outputs[0], "rb").read()
