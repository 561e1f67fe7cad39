"""Stragglers in the port's `run_sharded` on the CPU (`device="cpu"`):
a held pass-1 block stolen, mirrored and deduped; a held per-k block
mirrored from the per-k wall; a worker wedged past the run that cannot hold
the finished scan; and the SIGSTOP leg of `tools.bench_scaling`. Every
artifact equals the solo run's. Each run has its own `timeout_s`."""

import os

import pytest

from avenir_tpu_torch.dist import StragglerPolicy, run_sharded
from avenir_tpu_torch.runner import run_job

CPU = "cpu"
TIMEOUT_S = 150.0
HOLD = "AVENIR_SHARD_TEST_HOLD"
FAST = dict(mirror_floor_s=0.3, mirror_multiple=2.0, poll_s=0.02)
MARKOV = {"mst.model.states": "L,M,H", "mst.class.label.field.ord": "1",
          "mst.skip.field.count": "2", "mst.class.labels": "T,F"}


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("chaos") / "seq.csv")
    with open(p, "w") as fh:
        for i in range(1500):
            fh.write(f"c{i},{'T' if i % 2 else 'F'},L,M,H,M,L\n")
    return p


def _files(res):
    return [open(p, "rb").read() for p in sorted(res.outputs)]


def test_held_straggler_block_is_stolen_and_deduped(seq, tmp_path,
                                                    monkeypatch):
    solo = run_job("markovStateTransitionModel", MARKOV, [seq],
                   str(tmp_path / "solo.txt"), device=CPU)
    monkeypatch.setenv(HOLD, "0:0:12")
    res = run_sharded("markovStateTransitionModel", MARKOV, [seq],
                      str(tmp_path / "sharded.txt"), procs=2, factor=2,
                      policy=StragglerPolicy(**FAST), device=CPU,
                      timeout_s=TIMEOUT_S)
    c = res.counters
    assert c["Shard:DedupBlocks"] >= 1.0
    assert c["Shard:StolenBlocks"] >= 1.0
    assert c["Shard:MirroredBlocks"] >= 1.0
    assert _files(res) == _files(solo)


@pytest.mark.parametrize("job,conf", [
    ("frequentItemsApriori",
     {"fia.support.threshold": "0.3", "fia.item.set.length": "2",
      "fia.skip.field.count": "2", "fia.stream.block.size.mb": "0.005"}),
    ("candidateGenerationWithSelfJoin",
     {"cgs.support.threshold": "0.3", "cgs.item.set.length": "3",
      "cgs.skip.field.count": "2", "cgs.stream.block.size.mb": "0.005"})],
    ids=["apriori", "gsp"])
def test_per_k_straggler_is_mirrored_and_deduped(seq, tmp_path, monkeypatch,
                                                 job, conf):
    """Worker 0 holds its k=2 count of block 0; worker 1 prices the stale
    claim off its own per-k wall and counts the block itself: it never
    folded that block in pass 1, so it folds the range once and replays
    that cache at every later level."""
    solo = run_job(job, conf, [seq], str(tmp_path / "solo"), device=CPU)
    monkeypatch.setenv(HOLD, "0:k2:0:8")
    res = run_sharded(job, conf, [seq], str(tmp_path / "sharded"), procs=2,
                      factor=2, policy=StragglerPolicy(**FAST), device=CPU,
                      timeout_s=TIMEOUT_S)
    c = res.counters
    assert c["Shard:DedupBlocks"] >= 1.0
    assert c["Shard:MirroredBlocks"] >= 1.0
    assert c["Shard:PerKRounds"] >= 1.0
    assert sum(s["perk_mirrored"] for s in res.payload["workers"]) >= 1
    assert _files(res) == _files(solo)


def test_wedged_worker_cannot_hold_a_finished_scan(seq, tmp_path,
                                                   monkeypatch):
    solo = run_job("markovStateTransitionModel", MARKOV, [seq],
                   str(tmp_path / "solo.txt"), device=CPU)
    monkeypatch.setenv(HOLD, "0:0:600")
    res = run_sharded("markovStateTransitionModel", MARKOV, [seq],
                      str(tmp_path / "sharded.txt"), procs=2, factor=2,
                      policy=StragglerPolicy(**FAST, exit_grace_s=2.0),
                      device=CPU, timeout_s=120.0)
    assert res.counters["Shard:MirroredBlocks"] >= 1.0
    # the held worker was killed at the grace's end: it wrote no stats
    assert [s["worker"] for s in res.payload["workers"]] == [1]
    assert _files(res) == _files(solo)


def test_sigstop_chaos_leg(seq, tmp_path):
    from avenir_tpu_torch.tools.bench_scaling import chaos_leg, same_files

    solo = str(tmp_path / "solo.txt")
    run_job("markovStateTransitionModel", MARKOV, [seq], solo, device=CPU)
    res, caught = chaos_leg("markovStateTransitionModel",
                            {**MARKOV, "mst.stream.block.size.mb": "0.002"},
                            seq, str(tmp_path / "chaos.txt"), CPU,
                            timeout_s=TIMEOUT_S)
    assert caught["victim"] in (0, 1) and caught["resumed"]
    assert res.counters["Shard:DedupBlocks"] >= 1.0
    assert res.counters["Shard:Blocks"] == 8.0
    assert same_files(solo, res.outputs)
    assert os.path.getsize(res.outputs[0]) > 0
