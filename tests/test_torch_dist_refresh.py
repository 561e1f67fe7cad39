"""`dist.run_sharded_refresh` (`--shard N --incremental`) and the sharded
driver's sidecar route on the CPU (`device="cpu"`, two worker processes),
held against the solo refresh, a cold `run_job` and the JAX package.

A seeded churn corpus is cut at two thirds: the first part seeds an
incremental checkpoint, the rest is appended, and the sharded refresh
folds only the appended tail across the workers. Its artifact equals the
solo refresh's and the cold run's; the workers' fingerprints extend the
checkpoint so the next solo refresh restores the whole file warm; a block
whose fingerprints the coordinator cannot read keeps the previous
checkpoint; nothing appended starts no worker; the miners are refused,
and so is the CLI's `--shard --incremental` for them. Every sharded call
has its own `timeout_s`, every child interpreter its own timeout."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch_reference_native  # noqa: F401  (settles the reference's native route)

from avenir_tpu_torch.dist import (BlockLedger, ShardError, StragglerPolicy,
                                   run_sharded, run_sharded_refresh)
from avenir_tpu_torch.runner import run_incremental, run_job

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = dict(mirror_floor_s=60.0)
TIMEOUT_S = 150.0
CHILD_TIMEOUT_S = 300


def _corpus(tmp_path, rows=2000, seed=23, frac=2 / 3):
    """(csv holding the first part, the appended rest, schema path)."""
    from avenir_tpu.data import churn_schema, generate_churn

    text = generate_churn(rows, seed=seed, as_csv=True)
    cut = text.rindex("\n", 0, int(len(text) * frac)) + 1
    csv = str(tmp_path / "churn.csv")
    with open(csv, "w") as fh:
        fh.write(text[:cut])
    schema = str(tmp_path / "churn.json")
    churn_schema().save(schema)
    return csv, text[cut:], schema


def _conf(schema, tmp_path, job="mutualInformation", prefix="mut"):
    conf = {f"{prefix}.feature.schema.file.path": schema,
            f"{prefix}.stream.block.size.mb": "0.01",
            f"{prefix}.stream.sidecar.dir": str(tmp_path / "sc")}
    if job == "mutualInformation":
        conf["mut.mutual.info.score.algorithms"] = "mutual.info.maximization"
    return conf


def _refresh(job, conf, csv, out, state, **kw):
    return run_sharded_refresh(job, conf, [csv], out, procs=2, factor=2,
                               policy=StragglerPolicy(**QUIET),
                               timeout_s=TIMEOUT_S, state_dir=state,
                               device=CPU, **kw)


def _bytes(path):
    return open(path, "rb").read()


@pytest.mark.parametrize("job,prefix", [("mutualInformation", "mut"),
                                        ("bayesianDistr", "bad")])
def test_sharded_refresh_equals_solo_refresh_and_cold(tmp_path, job, prefix):
    from avenir_tpu.runner import run_job as jax_run_job

    csv, tail, schema = _corpus(tmp_path)
    conf = _conf(schema, tmp_path, job, prefix)
    sd = str(tmp_path / "state")
    run_incremental(job, conf, [csv], str(tmp_path / "seed.txt"),
                    state_dir=sd, device=CPU)
    sd_solo = str(tmp_path / "state_solo")
    shutil.copytree(sd, sd_solo)
    with open(csv, "a") as fh:
        fh.write(tail)
    solo = run_incremental(job, conf, [csv], str(tmp_path / "solo.txt"),
                           state_dir=sd_solo, device=CPU)
    res = _refresh(job, conf, csv, str(tmp_path / "shard.txt"), sd)
    cold = jax_run_job(job, conf, [csv], str(tmp_path / "cold.txt"))
    assert _bytes(str(tmp_path / "shard.txt")) == _bytes(solo.outputs[0]) \
        == _bytes(cold.outputs[0])
    assert res.counters["Shard:Workers"] == 2.0
    assert res.counters["Shard:Blocks"] >= 2
    assert res.counters["Cache:HitBlocks"] == solo.counters["Cache:HitBlocks"]
    assert res.counters["Resume:SkippedBytes"] \
        == solo.counters["Resume:SkippedBytes"] > 0
    assert res.counters["Cache:DeltaBlocks"] >= 1
    assert [w["device"] for w in res.payload["workers"]] == [CPU, CPU]
    # the workers' fingerprints extended the checkpoint: the next solo
    # refresh restores the whole file
    again = run_incremental(job, conf, [csv], str(tmp_path / "again.txt"),
                            state_dir=sd, device=CPU)
    assert again.counters["Cache:DeltaBlocks"] == 0
    assert again.counters["Resume:SkippedBytes"] == os.path.getsize(csv)
    assert _bytes(again.outputs[0]) == _bytes(solo.outputs[0])


def test_missing_worker_fingerprints_keep_the_previous_checkpoint(
        tmp_path, monkeypatch):
    csv, tail, schema = _corpus(tmp_path, rows=1200, seed=29, frac=0.5)
    conf = _conf(schema, tmp_path)
    sd = str(tmp_path / "state")
    run_incremental("mutualInformation", conf, [csv],
                    str(tmp_path / "seed.txt"), state_dir=sd, device=CPU)
    with open(os.path.join(sd, "MANIFEST.json")) as fh:
        seq0 = json.load(fh)["seq"]
    with open(csv, "a") as fh:
        fh.write(tail)
    cold = run_job("mutualInformation", conf, [csv],
                   str(tmp_path / "cold.txt"), device=CPU)
    # the coordinator reads no fingerprints (the workers commit as ever)
    monkeypatch.setattr(BlockLedger, "load_fps", lambda self, bid: None)
    res = _refresh("mutualInformation", conf, csv,
                   str(tmp_path / "shard.txt"), sd)
    assert _bytes(str(tmp_path / "shard.txt")) == _bytes(cold.outputs[0])
    assert res.counters["Cache:DeltaBlocks"] >= 1
    with open(os.path.join(sd, "MANIFEST.json")) as fh:
        assert json.load(fh)["seq"] == seq0     # not rewritten
    monkeypatch.undo()
    again = run_incremental("mutualInformation", conf, [csv],
                            str(tmp_path / "again.txt"), state_dir=sd,
                            device=CPU)
    assert again.counters["Cache:DeltaBlocks"] >= 1
    assert _bytes(again.outputs[0]) == _bytes(cold.outputs[0])


def test_nothing_appended_starts_no_worker(tmp_path):
    csv, _tail, schema = _corpus(tmp_path, rows=600)
    conf = _conf(schema, tmp_path)
    sd = str(tmp_path / "state")
    seed = run_incremental("mutualInformation", conf, [csv],
                           str(tmp_path / "seed.txt"), state_dir=sd,
                           device=CPU)

    def no_workers(pids, root):
        raise AssertionError("a refresh with nothing appended spawned "
                             "workers")

    res = _refresh("mutualInformation", conf, csv,
                   str(tmp_path / "again.txt"), sd, worker_hook=no_workers)
    assert res.counters["Shard:Workers"] == 0.0
    assert res.counters["Shard:Blocks"] == 0.0
    assert res.counters["Cache:DeltaBlocks"] == 0.0
    assert _bytes(str(tmp_path / "again.txt")) == _bytes(seed.outputs[0])


@pytest.mark.parametrize("job", ["frequentItemsApriori",
                                 "candidateGenerationWithSelfJoin"])
def test_miners_are_refused(tmp_path, job):
    with pytest.raises(ShardError, match="cannot refresh incrementally"):
        run_sharded_refresh(job, {}, [str(tmp_path / "x.csv")],
                            str(tmp_path / "o"), device=CPU,
                            timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("job", ["frequentItemsApriori",
                                 "candidateGenerationWithSelfJoin"])
def test_cli_refuses_the_miners_refresh(tmp_path, job):
    proc = subprocess.run(
        [sys.executable, "-m", "avenir_tpu_torch", job, "--shard", "2",
         "--incremental", "in.csv", "out.txt", "--device", CPU],
        capture_output=True, text=True, timeout=CHILD_TIMEOUT_S, cwd=REPO)
    assert proc.returncode != 0
    assert "cannot compose for the miners" in proc.stderr


def test_cli_shard_incremental(tmp_path):
    csv, tail, schema = _corpus(tmp_path, rows=1200)
    props = tmp_path / "mi.properties"
    props.write_text("".join(f"{k}={v}\n" for k, v in {
        **_conf(schema, tmp_path),
        "mut.stream.incremental.state.dir": str(tmp_path / "state")}.items()))
    argv = [sys.executable, "-m", "avenir_tpu_torch", "mutualInformation",
            "--shard", "2", "--incremental", "--conf", str(props), csv,
            str(tmp_path / "out.txt"), "--device", CPU]
    first = subprocess.run(argv, capture_output=True, text=True,
                           timeout=CHILD_TIMEOUT_S, cwd=REPO)
    assert first.returncode == 0, first.stderr[-2000:]
    with open(csv, "a") as fh:
        fh.write(tail)
    second = subprocess.run(argv, capture_output=True, text=True,
                            timeout=CHILD_TIMEOUT_S, cwd=REPO)
    assert second.returncode == 0, second.stderr[-2000:]
    row = json.loads(second.stdout.strip().splitlines()[-1])
    assert row["counters"]["Resume:SkippedBytes"] > 0
    assert row["counters"]["Shard:Workers"] == 2.0
    assert len(row["workers"]) == 2
    cold = run_job("mutualInformation", _conf(schema, tmp_path), [csv],
                   str(tmp_path / "cold.txt"), device=CPU)
    assert _bytes(str(tmp_path / "out.txt")) == _bytes(cold.outputs[0])


def test_fold_block_fingerprints_the_folded_bytes(tmp_path):
    """fps_out describes the exact bytes the fold consumed, tiling the
    range without a gap, whatever the file holds after it."""
    from avenir_tpu_torch.core import incremental as incr
    from avenir_tpu_torch.dist.worker import fold_block
    from avenir_tpu_torch.runner import _job_cfg, _schema, stream_fold_ops

    csv, _tail, schema = _corpus(tmp_path, rows=900)
    canonical, cfg = _job_cfg("mutualInformation",
                              {**_conf(schema, tmp_path),
                               "mut.stream.block.size.mb": "0.005"})
    size = os.path.getsize(csv)
    before = _bytes(csv)
    fps = []
    fold_block(canonical, cfg, stream_fold_ops(canonical), _schema(cfg),
               [csv], csv, 0, size, __import__("torch").device(CPU),
               fps_out=fps)
    with open(csv, "a") as fh:
        fh.write("zz,77,1,2,3\n")
    assert len(fps) >= 2
    expect = 0
    for fp in fps:
        assert fp["offset"] == expect
        assert fp["hash"] == incr.block_hash(
            before[expect:expect + fp["length"]])
        expect += fp["length"]
    assert expect == size


def test_ledger_publishes_the_winners_fingerprints(tmp_path):
    ledger = BlockLedger(str(tmp_path))
    fps = [{"offset": 0, "length": 4, "hash": "aa"},
           {"offset": 4, "length": 3, "hash": "bb"}]
    assert ledger.commit(5, worker=0, blob=b"s0", fps=fps)
    assert not ledger.commit(5, worker=1, blob=b"s1",
                             fps=[{"offset": 0, "length": 7, "hash": "cc"}])
    assert ledger.load_fps(5) == fps
    assert ledger.commit(6, worker=0, blob=b"s6")
    assert ledger.load_fps(6) is None
    assert ledger.committed() == [5, 6]


def test_sharded_scan_over_a_warm_sidecar_parses_nothing(tmp_path):
    """A plan snapped to the sidecar's verified block starts: each worker
    replays its claimed range read-only, Shard:ParseSpans == 0, and the
    artifact equals the solo run's."""
    from avenir_tpu.data import churn_schema, generate_churn

    csv = str(tmp_path / "churn.csv")
    with open(csv, "w") as fh:
        fh.write(generate_churn(3000, seed=41, as_csv=True))
    schema = str(tmp_path / "churn.json")
    churn_schema().save(schema)
    conf = {**_conf(schema, tmp_path), "mut.stream.block.size.mb": "0.005"}
    solo = run_job("mutualInformation", conf, [csv],
                   str(tmp_path / "solo.txt"), device=CPU)
    assert solo.counters["Sidecar:DeltaBlocks"] >= 4     # packed
    res = run_sharded("mutualInformation", conf, [csv],
                      str(tmp_path / "shard.txt"), procs=2, factor=2,
                      policy=StragglerPolicy(**QUIET), timeout_s=TIMEOUT_S,
                      device=CPU)
    assert _bytes(str(tmp_path / "shard.txt")) == _bytes(solo.outputs[0])
    assert res.counters["Shard:ParseSpans"] == 0
    assert res.counters["Shard:ReplaySpans"] \
        == res.counters["Sidecar:HitBlocks"] \
        == solo.counters["Sidecar:DeltaBlocks"]
    assert res.counters["Sidecar:DeltaBlocks"] == 0
