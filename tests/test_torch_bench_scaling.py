"""`tools/bench_scaling.py` on the CPU at a small size: the shard
tripwire's three legs (byte identity of two fold families and the miner's
per-k rounds against solo runs in child processes, and the SIGSTOP chaos
leg), and the incremental and sidecar tripwires' byte identity and parse
accounting, each with its speedup floor at 0, since a small corpus on a
shared CPU measures start-up costs and not the scan."""

from avenir_tpu_torch.tools.bench_scaling import (host_parallel_capacity,
                                                  shard_tripwire)


def test_host_parallel_capacity_is_positive():
    # a ratio of busy-loop counts: on a loaded host it can fall anywhere
    # above zero
    assert host_parallel_capacity(2, secs=0.3) > 0


def test_shard_tripwire_legs_on_the_cpu():
    out = shard_tripwire(rows=100_000, floor=0.0, device="cpu")
    assert out["effective_floor"] == 0.0 and out["device"] == "cpu"
    assert set(out["families"]) == {"mutualInformation",
                                    "markovStateTransitionModel"}
    for row in [*out["families"].values(), out["miner"]]:
        assert row["solo_seconds"] > 0 and row["sharded_seconds"] > 0
        assert row["counters"]["Shard:Workers"] == 2.0
    assert out["miner"]["counters"]["Shard:PerKRounds"] >= 1
    assert out["chaos"]["counters"]["Shard:DedupBlocks"] >= 1
    assert out["chaos"]["resumed"] is True


def test_incremental_tripwire_on_the_cpu():
    from avenir_tpu_torch.tools.bench_scaling import incremental_tripwire

    out = incremental_tripwire(rows=100_000, floor=0.0, device="cpu")
    assert out["outputs_byte_identical"] is True
    assert out["skipped_bytes"] > 0 and out["delta_blocks"] >= 1
    assert out["appended_rows"] == 1_000


def test_sidecar_tripwire_on_the_cpu():
    from avenir_tpu_torch.tools.bench_scaling import sidecar_tripwire

    out = sidecar_tripwire(rows=100_000, floor=0.0, device="cpu")
    assert out["outputs_byte_identical"] is True
    assert out["warm_parse_spans"] == 0 and out["warm_replay_spans"] >= 3
    assert out["shard_parse_spans"] == 0 and out["shard_replay_spans"] >= 1
    assert out["incremental_parse_spans"] == 0
    assert min(out["hit_blocks"].values()) >= 1
    assert 0 < out["sidecar_bytes"]
