"""`tools/bench_scaling.py` on the CPU at a small size: the shard
tripwire's three legs (byte identity of two fold families and the miner's
per-k rounds against solo runs in child processes, and the SIGSTOP chaos
leg), the incremental and sidecar tripwires' byte identity and parse
accounting (the sidecar's with its job-server leg: a served batch
replays and pins the sidecar), and the server, fleet, fleet-fault and score tripwires' byte
identity, batching, affinity, requeue, hedge and coalescing checks, each
with its speedup floor at 0, since a small corpus on a shared CPU
measures start-up costs and not the scan."""

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
    assert out["server_parse_spans"] == 0
    assert out["server_pinned_sidecars"] >= 1
    assert min(out["hit_blocks"].values()) >= 1
    assert 0 < out["sidecar_bytes"]


def test_server_tripwire_on_the_cpu():
    """The job server against one job at a time: every served artifact
    equals its sequential twin's, the churn trio batched, the duplicate
    Apriori request coalesced, admission under its budget."""
    from avenir_tpu_torch.tools.bench_scaling import server_tripwire

    out = server_tripwire(rows=20_000, floor=0.0, device="cpu")
    assert out["outputs_byte_identical"] is True
    assert out["max_batch_size"] >= 3 and out["coalesced"] >= 1
    assert 0 < out["peak_rss_mb"] <= out["budget_mb"] + 512
    assert out["t_served_s"] > 0 and out["t_sequential_s"] > 0


def test_fleet_tripwire_on_the_cpu():
    """Two CPU hosts against one: equal artifacts, repeat corpora back on
    their warm host, the budget vector never passed."""
    from avenir_tpu_torch.tools.bench_scaling import fleet_tripwire

    out = fleet_tripwire(rows=20_000, floor=0.0, device="cpu")
    assert out["outputs_byte_identical"] is True
    assert out["requests"] == 12 and out["affinity_hit_rate"] >= 0.6
    assert out["router"]["placed"] == 12 + 3 * 2     # load + warm-ups
    assert {h["host"] for h in out["per_host"]} == {0, 1}


def test_fleet_fault_tripwire_on_the_cpu():
    """A SIGKILLed host's leases requeue (nothing lost, nothing
    conflicting) and a SIGSTOPped host's request is hedged."""
    from avenir_tpu_torch.tools.bench_scaling import fleet_fault_tripwire

    out = fleet_fault_tripwire(rows=100_000, device="cpu")
    assert out["zero_lost"] and out["zero_conflicting"]
    assert out["chaos_kill_skipped"] or (
        out["stranded_at_kill"] >= 1 and out["chaos_requeues"] >= 1)
    assert out["hedges"] >= 1


def test_score_tripwire_on_the_cpu():
    """The coalescing plane and the two-host score fleet: every row its
    solo twin's, one model load, fewer predicts than requests."""
    from avenir_tpu_torch.tools.bench_scaling import score_tripwire

    out = score_tripwire(queries=64, floor=0.0, fleet_scores_per_model=10,
                         device="cpu")
    assert out["rows_byte_identical"] is True
    assert out["model_loads"] == 1
    assert out["vectorized_dispatches"] < out["queries"]
    assert out["fleet_scores"] == 20
    assert out["fleet_affinity_hit_rate"] >= 0.9
