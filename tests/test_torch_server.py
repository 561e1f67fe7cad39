"""The port's resident job server (`avenir_tpu_torch/server/jobserver.py`,
`server/spool.py`) on the CPU, one counterpart of each of the 25 tests of
`tests/test_server.py`.

The same contracts: batching (compatible requests dispatch as one shared
scan, identical ones coalesce), fairness (priorities and FIFO aging),
admission (the footprint oracle prices before a dispatch runs; a dispatch
over budget is held, one that can never fit fails), warm state (a repeat
mining request replays the pinned spill cache; refresh requests restore
the managed checkpoint store), lifecycle and the spool/stdin transports.
The server runs on device="cpu". Every served artifact is compared with
the port's solo `run_job` and with the JAX package's `run_job` on the same
seeded corpus (`_twin`; the JAX twin parses its input, with the sidecar
off, so it never replays a sidecar the port packed), and
`price_request_bytes` with the reference's on one corpus. Then the warm
store as the sidecar's landlord: an evicted sidecar repacks cold, a scan
racing an eviction finishes (cold before the segment opened, from the
open segment after), and the two `cache_evict_to` methods.
"""

import io
import json
import os
import threading

import numpy as np
import pytest

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.runner import run_job as jax_run_job
from avenir_tpu_torch.runner import run_incremental, run_job
from avenir_tpu_torch.server import (AdmissionError, JobRequest, JobServer,
                                     ServerClosed, Ticket, compat_key,
                                     price_request_bytes, serve_spool,
                                     serve_stream)

CPU = "cpu"


def _twin(job, conf, inputs, out):
    """The port's solo run_job on the CPU, after holding each of its files
    to the JAX package's run_job of the same request (written beside it
    under `<out>.jax`)."""
    port = run_job(job, conf, inputs, out, device=CPU)
    jax_conf = dict(conf, **{"stream.sidecar": "false"})
    ref = jax_run_job(job, jax_conf, inputs, out + ".jax")
    assert len(port.outputs) == len(ref.outputs)
    for a, b in zip(sorted(port.outputs), sorted(ref.outputs)):
        assert _read(a) == _read(b), (job, a)
    return port


# ---------------------------------------------------------------- fixtures
def _churn(tmp_path, rows=1200, seed=11):
    from avenir_tpu_torch.data import churn_schema, generate_churn

    csv = tmp_path / "churn.csv"
    csv.write_text(generate_churn(rows, seed=seed, as_csv=True))
    schema = tmp_path / "churn.json"
    churn_schema().save(str(schema))
    return str(csv), str(schema)


def _seq(tmp_path, rows=800):
    rng = np.random.default_rng(12)
    states = ["L", "M", "H"]
    csv = tmp_path / "seq.csv"
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


def _conf(prefix, schema, block="0.01"):
    return {f"{prefix}.feature.schema.file.path": schema,
            f"{prefix}.stream.block.size.mb": block}


def _mi_conf(schema, block="0.01"):
    return {**_conf("mut", schema, block),
            "mut.mutual.info.score.algorithms": "mutual.info.maximization"}


def _fia_conf(block="0.01"):
    return {"fia.support.threshold": "0.3", "fia.item.set.length": "2",
            "fia.skip.field.count": "2",
            "fia.stream.block.size.mb": block}


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _server(tmp_path, **kw):
    kw.setdefault("state_root", str(tmp_path / "srv_state"))
    kw.setdefault("device", CPU)
    return JobServer(**kw)


# --------------------------------------------------- compatibility matrix
def test_compat_key_matrix(tmp_path):
    csv, schema = _churn(tmp_path)
    seq = _seq(tmp_path)
    base = JobRequest("mutualInformation", _mi_conf(schema), [csv], "o1")
    same = JobRequest("bayesianDistr", _conf("bad", schema), [csv], "o2")
    assert compat_key(base) == compat_key(same)       # fusable pair
    cases = {
        "other corpus": JobRequest("bayesianDistr",
                                   _conf("bad", schema), [seq], "o"),
        "other block": JobRequest("bayesianDistr",
                                  _conf("bad", schema, "0.02"),
                                  [csv], "o"),
        "other kind": JobRequest("markovStateTransitionModel",
                                 {"mst.model.states": "L,M,H",
                                  "mst.skip.field.count": "2",
                                  "mst.stream.block.size.mb": "0.01"},
                                 [seq], "o"),
        "other mode": JobRequest("bayesianDistr", _conf("bad", schema),
                                 [csv], "o", mode="refresh"),
    }
    for why, req in cases.items():
        assert compat_key(req) != compat_key(base), why
    # a second schema file differs even with equal contents
    schema2 = str(tmp_path / "churn2.json")
    from avenir_tpu_torch.data import churn_schema

    churn_schema().save(schema2)
    assert compat_key(JobRequest("bayesianDistr", _conf("bad", schema2),
                                 [csv], "o")) != compat_key(base)
    # jobs with no stream fold never batch
    assert compat_key(JobRequest(
        "greedyRandomBandit", {"grb.current.round.num": "1"},
        [csv], "o")) is None


def test_batched_requests_byte_identical_to_solo(tmp_path):
    csv, schema = _churn(tmp_path)
    seq = _seq(tmp_path)
    mst_conf = {"mst.model.states": "L,M,H",
                "mst.class.label.field.ord": "1",
                "mst.skip.field.count": "2", "mst.class.labels": "T,F",
                "mst.stream.block.size.mb": "0.01"}
    srv = _server(tmp_path, workers=1)
    # submit BEFORE start: the full queue makes batch formation
    # deterministic — three churn profilers fuse, markov rides alone
    t_nb = srv.submit(JobRequest("bayesianDistr", _conf("bad", schema),
                                 [csv], str(tmp_path / "s_nb.csv"),
                                 tenant="a"))
    t_mi = srv.submit(JobRequest("mutualInformation", _mi_conf(schema),
                                 [csv], str(tmp_path / "s_mi.txt"),
                                 tenant="b"))
    t_fd = srv.submit(JobRequest("fisherDiscriminant", _conf("fid", schema),
                                 [csv], str(tmp_path / "s_fd.txt"),
                                 tenant="c"))
    t_mk = srv.submit(JobRequest("markovStateTransitionModel", mst_conf,
                                 [seq], str(tmp_path / "s_mk.txt"),
                                 tenant="a"))
    with srv:
        res = {n: t.result(180) for n, t in
               [("nb", t_nb), ("mi", t_mi), ("fd", t_fd), ("mk", t_mk)]}
    for name in ("nb", "mi", "fd"):
        assert res[name].counters["Server:BatchSize"] == 3.0, name
    assert res["mk"].counters["Server:BatchSize"] == 1.0
    for name, c in res.items():
        assert c.counters["Server:QueueWaitMs"] >= 0.0
        assert "Server:AdmissionHeldMs" in c.counters
        assert "Server:CompileHits" in c.counters
    twins = {
        "nb": _twin("bayesianDistr", _conf("bad", schema), [csv],
                      str(tmp_path / "r_nb.csv")),
        "mi": _twin("mutualInformation", _mi_conf(schema), [csv],
                      str(tmp_path / "r_mi.txt")),
        "fd": _twin("fisherDiscriminant", _conf("fid", schema), [csv],
                      str(tmp_path / "r_fd.txt")),
        "mk": _twin("markovStateTransitionModel", mst_conf, [seq],
                      str(tmp_path / "r_mk.txt")),
    }
    for name in res:
        for a, b in zip(sorted(res[name].outputs),
                        sorted(twins[name].outputs)):
            assert _read(a) == _read(b), name


def test_identical_requests_coalesce_into_one_execution(tmp_path):
    csv, schema = _churn(tmp_path, rows=800)
    srv = _server(tmp_path, workers=1)
    t1 = srv.submit(JobRequest("mutualInformation", _mi_conf(schema),
                               [csv], str(tmp_path / "c1.txt"),
                               tenant="a"))
    t2 = srv.submit(JobRequest("mutualInformation", _mi_conf(schema),
                               [csv], str(tmp_path / "c2.txt"),
                               tenant="b"))
    with srv:
        r1, r2 = t1.result(120), t2.result(120)
        stats = srv.stats()
    assert stats["coalesced"] == 1
    assert r1.counters["Server:BatchSize"] == 2.0
    assert r2.counters["Server:BatchSize"] == 2.0
    assert _read(str(tmp_path / "c1.txt")) == _read(str(tmp_path / "c2.txt"))
    twin = _twin("mutualInformation", _mi_conf(schema), [csv],
                   str(tmp_path / "c_ref.txt"))
    assert _read(str(tmp_path / "c2.txt")) == _read(twin.outputs[0])


# ------------------------------------------------------------- fairness
def _flood_tickets(srv, tmp_path, csv, schema):
    """Tenant A floods two high-priority requests around tenant B's one
    low-priority request (distinct block sizes: never batched, never
    coalesced). Returns the tickets in submission order."""
    return [
        srv.submit(JobRequest("mutualInformation",
                              _mi_conf(schema, "0.01"), [csv],
                              str(tmp_path / "f_a1.txt"), tenant="a",
                              priority=10)),
        srv.submit(JobRequest("mutualInformation",
                              _mi_conf(schema, "0.011"), [csv],
                              str(tmp_path / "f_b.txt"), tenant="b",
                              priority=0)),
        srv.submit(JobRequest("mutualInformation",
                              _mi_conf(schema, "0.012"), [csv],
                              str(tmp_path / "f_a2.txt"), tenant="a",
                              priority=10)),
    ]


def test_priority_orders_fresh_requests(tmp_path):
    csv, schema = _churn(tmp_path, rows=600)
    # starvation bound far away: pure priority scheduling — tenant B's
    # low-priority request goes last
    srv = _server(tmp_path, workers=1, starvation_ms=3_600_000)
    a1, b, a2 = _flood_tickets(srv, tmp_path, csv, schema)
    with srv:
        for t in (a1, b, a2):
            t.result(120)
    assert b._dispatched_at > a1._dispatched_at
    assert b._dispatched_at > a2._dispatched_at


def test_starving_tenant_still_progresses(tmp_path):
    csv, schema = _churn(tmp_path, rows=600)
    # starvation bound 0: every queued head is aged, so dispatch is
    # global FIFO — tenant B's low-priority request cannot be pushed
    # behind tenant A's later high-priority one
    srv = _server(tmp_path, workers=1, starvation_ms=0.0)
    a1, b, a2 = _flood_tickets(srv, tmp_path, csv, schema)
    with srv:
        for t in (a1, b, a2):
            t.result(120)
    assert a1._dispatched_at < b._dispatched_at < a2._dispatched_at


# ------------------------------------------------------------- admission
def test_admission_price_consumes_footprint_model(tmp_path):
    csv, schema = _churn(tmp_path)
    from avenir_tpu_torch.analysis.mem import (combined_footprint,
                                               corpus_stats, footprint_model)
    from avenir_tpu_torch.core.schema import FeatureSchema

    stats = corpus_stats([csv])
    sch = FeatureSchema.from_file(schema)
    block = int(0.01 * (1 << 20))
    solo = JobRequest("mutualInformation", _mi_conf(schema), [csv], "o")
    assert price_request_bytes([solo]) == footprint_model(
        "mutualInformation", block, sch, stats).total_bytes
    pair = [solo, JobRequest("bayesianDistr", _conf("bad", schema),
                             [csv], "o2")]
    assert price_request_bytes(pair) == combined_footprint(
        ["mutualInformation", "bayesianDistr"], block, sch,
        stats).total_bytes
    # unmodeled jobs price at the flat reserve
    assert price_request_bytes(
        [JobRequest("greedyRandomBandit", {}, [csv], "o")],
        reserve_bytes=123) == 123
    # both packages price one request alike: the reference's terms
    from avenir_tpu.server import JobRequest as JaxRequest
    from avenir_tpu.server import price_request_bytes as jax_price

    for group in ([solo], pair, [pair[1]]):
        assert price_request_bytes(group) == jax_price(
            [JaxRequest(r.job, r.conf, r.inputs, r.output)
             for r in group])


def test_admission_holds_until_inflight_releases(tmp_path):
    csv, schema = _churn(tmp_path, rows=600)
    price = 100 << 20
    srv = _server(tmp_path, workers=2, budget_bytes=150 << 20,
                  pricer=lambda reqs, reserve: price * len(reqs),
                  rss_probe=lambda: 0)
    # two same-job requests under different confs: never batched, never
    # coalesced — but only ONE 100MB prediction fits a 150MB budget
    t1 = srv.submit(JobRequest("mutualInformation",
                               _mi_conf(schema, "0.01"), [csv],
                               str(tmp_path / "h1.txt"), tenant="a"))
    t2 = srv.submit(JobRequest("mutualInformation",
                               _mi_conf(schema, "0.011"), [csv],
                               str(tmp_path / "h2.txt"), tenant="b"))
    with srv:
        r1, r2 = t1.result(120), t2.result(120)
        stats = srv.stats()
    assert stats["admission_holds"] >= 1
    held = max(r1.counters["Server:AdmissionHeldMs"],
               r2.counters["Server:AdmissionHeldMs"])
    assert held > 0.0
    assert stats["peak_priced_bytes"] <= 150 << 20


def test_admission_gates_on_model_not_ambient_rss(tmp_path):
    """The admission gate is the priced prediction, NOT live process
    RSS: a resident CPython process's RSS is sticky (freed arenas stay
    resident), so an RSS-gated server would reject everything once the
    host process ever grew past the budget — exactly what happened when
    these tests ran late in the full suite. A probe reading far above
    the budget must not block a cheaply-priced request."""
    csv, schema = _churn(tmp_path, rows=400)
    srv = _server(tmp_path, workers=1, budget_bytes=150 << 20,
                  pricer=lambda reqs, reserve: 1 << 20,
                  rss_probe=lambda: 10 << 30)
    ticket = srv.submit(JobRequest("mutualInformation", _mi_conf(schema),
                                   [csv], str(tmp_path / "amb.txt")))
    with srv:
        res = ticket.result(120)
        stats = srv.stats()
    assert res.counters["Server:BatchSize"] >= 1.0
    assert stats["rss_bytes"] == float(10 << 30)   # advisory, reported
    assert stats["peak_priced_bytes"] <= 150 << 20


def test_admission_rejects_request_that_can_never_fit(tmp_path):
    csv, schema = _churn(tmp_path, rows=600)
    srv = _server(tmp_path, workers=1, budget_bytes=150 << 20,
                  pricer=lambda reqs, reserve: 200 << 20,
                  rss_probe=lambda: 0)
    ticket = srv.submit(JobRequest("mutualInformation", _mi_conf(schema),
                                   [csv], str(tmp_path / "n.txt")))
    with srv:
        with pytest.raises(AdmissionError):
            ticket.result(60)


# ------------------------------------------------------------ warm state
def test_warm_cache_hit_on_second_miner_request(tmp_path):
    seq = _seq(tmp_path)
    srv = _server(tmp_path, workers=1)
    with srv:
        r1 = srv.submit(JobRequest("frequentItemsApriori", _fia_conf(),
                                   [seq], str(tmp_path / "w1"),
                                   tenant="a")).result(120)
        r2 = srv.submit(JobRequest("frequentItemsApriori", _fia_conf(),
                                   [seq], str(tmp_path / "w2"),
                                   tenant="b")).result(120)
        stats = srv.stats()
    assert r1.counters["Server:WarmHit"] == 0.0
    assert r2.counters["Server:WarmHit"] == 1.0
    assert stats["warm_hits"] == 1.0
    assert stats["warm_pinned_sources"] >= 1.0
    assert stats["warm_pinned_bytes"] > 0.0
    twin = _twin("frequentItemsApriori", _fia_conf(), [seq],
                   str(tmp_path / "w_ref"))
    for a, b in zip(sorted(r2.outputs), sorted(twin.outputs)):
        assert _read(a) == _read(b)


def test_warm_source_invalidated_by_corpus_change(tmp_path):
    seq = _seq(tmp_path, rows=400)
    srv = _server(tmp_path, workers=1)
    with srv:
        srv.submit(JobRequest("frequentItemsApriori", _fia_conf(), [seq],
                              str(tmp_path / "i1"))).result(120)
        # in-place edit: the pinned cache's content gate must refuse
        data = _read(seq)
        with open(seq, "wb") as fh:
            fh.write(data.replace(b"L,", b"M,", 5))
        r2 = srv.submit(JobRequest("frequentItemsApriori", _fia_conf(),
                                   [seq],
                                   str(tmp_path / "i2"))).result(120)
    assert r2.counters["Server:WarmHit"] == 0.0
    twin = _twin("frequentItemsApriori", _fia_conf(), [seq],
                   str(tmp_path / "i_ref"))
    for a, b in zip(sorted(r2.outputs), sorted(twin.outputs)):
        assert _read(a) == _read(b)


def test_warm_source_missed_on_different_trans_id_ord(tmp_path):
    """A pinned apriori source bakes in the trans-id column; a request
    emitting transaction ids from a DIFFERENT column must miss the warm
    store (and stay byte-identical to its solo twin), never silently
    serve ids read from the pinned source's column."""
    seq = _seq(tmp_path, rows=400)
    ord1 = {**_fia_conf(), "fia.emit.trans.id": "true",
            "fia.tans.id.ord": "1"}
    srv = _server(tmp_path, workers=1)
    with srv:
        srv.submit(JobRequest("frequentItemsApriori", _fia_conf(), [seq],
                              str(tmp_path / "t0"))).result(120)
        r2 = srv.submit(JobRequest("frequentItemsApriori", ord1, [seq],
                                   str(tmp_path / "t1"))).result(120)
    assert r2.counters["Server:WarmHit"] == 0.0
    twin = _twin("frequentItemsApriori", ord1, [seq],
                   str(tmp_path / "t_ref"))
    for a, b in zip(sorted(r2.outputs), sorted(twin.outputs)):
        assert _read(a) == _read(b)


def test_failed_batch_returns_sidecars_to_warm_store(tmp_path, monkeypatch):
    """A streamed batch checks sidecar entries OUT of the warm store so
    a concurrent budget squeeze cannot delete a directory mid-replay.
    If the batch then fails, the entries must be re-pinned anyway —
    otherwise the resident server permanently loses byte accounting for
    those directories and the budget landlord can never evict them."""
    import avenir_tpu_torch.runner as runner

    csv, schema = _churn(tmp_path)
    srv = _server(tmp_path, workers=1)
    with srv:
        srv.submit(JobRequest("mutualInformation", _mi_conf(schema),
                              [csv], str(tmp_path / "p1.txt"))).result(120)
        pinned = srv.stats()["warm_pinned_sources"]
        assert pinned >= 1.0
        real = runner.run_shared

        def boom(*_a, **_kw):
            raise RuntimeError("injected batch failure")

        monkeypatch.setattr(runner, "run_shared", boom)
        t = srv.submit(JobRequest("mutualInformation", _mi_conf(schema),
                                  [csv], str(tmp_path / "p2.txt")))
        with pytest.raises(RuntimeError, match="injected batch failure"):
            t.result(120)
        monkeypatch.setattr(runner, "run_shared", real)
        assert srv.stats()["warm_pinned_sources"] == pinned


def test_refresh_served_from_managed_checkpoint_store(tmp_path):
    from avenir_tpu_torch.data import generate_churn

    csv, schema = _churn(tmp_path, rows=1000)
    srv = _server(tmp_path, workers=1)
    with srv:
        seed = srv.submit(JobRequest(
            "mutualInformation", _mi_conf(schema), [csv],
            str(tmp_path / "rf0.txt"), mode="refresh")).result(120)
        with open(csv, "a") as fh:
            fh.write(generate_churn(120, seed=12, as_csv=True))
        refreshed = srv.submit(JobRequest(
            "mutualInformation", _mi_conf(schema), [csv],
            str(tmp_path / "rf1.txt"), mode="refresh")).result(120)
    assert seed.counters["Resume:SkippedBytes"] == 0.0
    assert refreshed.counters["Resume:SkippedBytes"] > 0.0
    assert refreshed.counters["Cache:HitBlocks"] > 0.0
    cold = _twin("mutualInformation", _mi_conf(schema), [csv],
                   str(tmp_path / "rf_cold.txt"))
    assert _read(str(tmp_path / "rf1.txt")) == _read(cold.outputs[0])


def test_refresh_batch_fuses_delta_scan(tmp_path):
    from avenir_tpu_torch.data import generate_churn

    csv, schema = _churn(tmp_path, rows=1000)
    state = str(tmp_path / "fused_state")
    # seed both jobs' checkpoints through the solo driver, then serve
    # both refreshes from ONE queued batch
    run_incremental("mutualInformation", _mi_conf(schema), [csv],
                    str(tmp_path / "fb_mi0.txt"),
                    state_dir=os.path.join(state, "mi"), device=CPU)
    run_incremental("bayesianDistr", _conf("bad", schema), [csv],
                    str(tmp_path / "fb_nb0.csv"),
                    state_dir=os.path.join(state, "nb"), device=CPU)
    with open(csv, "a") as fh:
        fh.write(generate_churn(120, seed=13, as_csv=True))
    srv = _server(tmp_path, workers=1)
    t_mi = srv.submit(JobRequest(
        "mutualInformation", _mi_conf(schema), [csv],
        str(tmp_path / "fb_mi1.txt"), tenant="a", mode="refresh",
        state_dir=os.path.join(state, "mi")))
    t_nb = srv.submit(JobRequest(
        "bayesianDistr", _conf("bad", schema), [csv],
        str(tmp_path / "fb_nb1.csv"), tenant="b", mode="refresh",
        state_dir=os.path.join(state, "nb")))
    with srv:
        r_mi, r_nb = t_mi.result(120), t_nb.result(120)
    assert r_mi.counters["Server:BatchSize"] == 2.0
    assert r_nb.counters["Server:BatchSize"] == 2.0
    assert r_mi.counters["Resume:SkippedBytes"] > 0.0
    assert r_nb.counters["Resume:SkippedBytes"] > 0.0
    cold_mi = _twin("mutualInformation", _mi_conf(schema), [csv],
                      str(tmp_path / "fb_mi_cold.txt"))
    cold_nb = _twin("bayesianDistr", _conf("bad", schema), [csv],
                      str(tmp_path / "fb_nb_cold.csv"))
    assert _read(str(tmp_path / "fb_mi1.txt")) == _read(cold_mi.outputs[0])
    assert _read(str(tmp_path / "fb_nb1.csv")) == _read(cold_nb.outputs[0])


# -------------------------------------------------------------- lifecycle
def test_drain_shutdown_no_leaked_threads(tmp_path):
    csv, schema = _churn(tmp_path, rows=400)
    before = set(threading.enumerate())
    srv = _server(tmp_path, workers=2)
    srv.start()
    ticket = srv.submit(JobRequest("bayesianDistr", _conf("bad", schema),
                                   [csv], str(tmp_path / "d.csv")))
    srv.drain()
    assert ticket.done
    srv.shutdown()
    leaked = [t for t in set(threading.enumerate()) - before
              if t.name.startswith("avenir-server")]
    assert not leaked, leaked
    with pytest.raises(ServerClosed):
        srv.submit(JobRequest("bayesianDistr", _conf("bad", schema),
                              [csv], str(tmp_path / "late.csv")))
    srv.shutdown()                        # idempotent


def test_shutdown_without_drain_fails_queued_tickets(tmp_path):
    csv, schema = _churn(tmp_path, rows=400)
    srv = _server(tmp_path, workers=1)
    ticket = srv.submit(JobRequest("bayesianDistr", _conf("bad", schema),
                                   [csv], str(tmp_path / "q.csv")))
    # never started: the queued request must fail crisply, not hang
    srv.shutdown(drain=False)
    with pytest.raises(ServerClosed):
        ticket.result(10)


# -------------------------------------------------------------- transports
def test_serve_stream_round_trip(tmp_path):
    csv, schema = _churn(tmp_path, rows=400)
    req = {"job": "bayesianDistr", "conf": _conf("bad", schema),
           "inputs": [csv], "output": str(tmp_path / "st.csv"),
           "tenant": "a"}
    bad = {"job": "noSuchJob", "conf": {}, "inputs": [csv], "output": "x"}
    lines = io.StringIO(json.dumps(req) + "\n" + json.dumps(bad) + "\n")
    out = io.StringIO()
    with _server(tmp_path, workers=1) as srv:
        failures = serve_stream(srv, lines, out)
    assert failures == 1
    rows = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert rows[0]["ok"] and rows[0]["job"] == "bayesianDistr"
    assert rows[0]["counters"]["Server:BatchSize"] >= 1.0
    assert not rows[1]["ok"] and "KeyError" in rows[1]["error"]
    twin = _twin("bayesianDistr", _conf("bad", schema), [csv],
                   str(tmp_path / "st_ref.csv"))
    assert _read(str(tmp_path / "st.csv")) == _read(twin.outputs[0])


def test_serve_spool_once(tmp_path):
    csv, schema = _churn(tmp_path, rows=400)
    spool = str(tmp_path / "spool")
    os.makedirs(os.path.join(spool, "in"))
    req = {"job": "mutualInformation", "conf": _mi_conf(schema),
           "inputs": [csv], "output": str(tmp_path / "sp.txt")}
    tmp = os.path.join(spool, "req_1.json.tmp")
    with open(tmp, "w") as fh:
        json.dump(req, fh)
    os.replace(tmp, os.path.join(spool, "in", "req_1.json"))
    # a stray non-.json file in in/ (an abandoned stage, a dotfile) is
    # never claimed and must not keep --once polling forever
    with open(os.path.join(spool, "in", "stray.json.tmp"), "w") as fh:
        fh.write("{}")
    with _server(tmp_path, workers=1) as srv:
        failures = serve_spool(srv, spool, once=True)
    assert failures == 0
    with open(os.path.join(spool, "out", "req_1.json")) as fh:
        row = json.load(fh)
    assert row["ok"] and row["counters"]["Server:QueueWaitMs"] >= 0.0
    assert os.listdir(os.path.join(spool, "in")) == ["stray.json.tmp"]
    assert not os.listdir(os.path.join(spool, "work"))
    twin = _twin("mutualInformation", _mi_conf(schema), [csv],
                   str(tmp_path / "sp_ref.txt"))
    assert _read(str(tmp_path / "sp.txt")) == _read(twin.outputs[0])


def test_spool_nonce_namespaces_results(tmp_path):
    """Two clients reusing ONE filename stem used to overwrite each
    other in <spool>/out; with client nonces the results live side by
    side as <nonce>.<name>."""
    import time

    from avenir_tpu_torch.server.spool import result_name

    csv, schema = _churn(tmp_path, rows=400)
    spool = str(tmp_path / "spool")
    in_dir = os.path.join(spool, "in")
    os.makedirs(in_dir, exist_ok=True)
    stop = threading.Event()
    srv = _server(tmp_path, workers=1)
    failures = []
    with srv:
        t = threading.Thread(target=lambda: failures.append(
            serve_spool(srv, spool, should_stop=stop.is_set)))
        t.start()
        try:
            def drop(nonce, out):
                req = {"job": "bayesianDistr",
                       "conf": _conf("bad", schema), "inputs": [csv],
                       "output": out, "nonce": nonce}
                tmp = os.path.join(spool, f".{nonce}.tmp")
                with open(tmp, "w") as fh:
                    json.dump(req, fh)
                os.replace(tmp, os.path.join(in_dir, "req.json"))

            def wait_for(path, what, timeout=120):
                deadline = time.perf_counter() + timeout
                while not os.path.exists(path):
                    assert time.perf_counter() < deadline, what
                    time.sleep(0.05)

            out_a = os.path.join(spool, "out", "clientA.req.json")
            out_b = os.path.join(spool, "out", "clientB.req.json")
            drop("clientA", str(tmp_path / "na.csv"))
            wait_for(out_a, "client A result")
            drop("clientB", str(tmp_path / "nb.csv"))
            wait_for(out_b, "client B result")
        finally:
            stop.set()
            t.join(60)
        assert not t.is_alive()
    for path, nonce in ((out_a, "clientA"), (out_b, "clientB")):
        with open(path) as fh:
            row = json.load(fh)
        assert row["ok"] and row["nonce"] == nonce
    # both artifacts written — nothing overwrote anything
    assert _read(str(tmp_path / "na.csv")) == _read(str(tmp_path / "nb.csv"))
    # the namespacing recipe itself
    ticket = Ticket(JobRequest("j", {}, [], "", nonce="n1"))
    assert result_name("req.json", ticket) == "n1.req.json"
    assert result_name("req.json", Ticket(JobRequest("j", {}, [], ""))) \
        == "req.json"


def test_spool_concurrent_writers_same_stems(tmp_path):
    """Two writer threads submit through one spool with IDENTICAL
    filename stems (no-clobber drops: link-then-retry, the documented
    client discipline), distinct nonces: every request is served and
    every result is separately addressable."""
    import time

    csv, schema = _churn(tmp_path, rows=400)
    spool = str(tmp_path / "spool")
    in_dir = os.path.join(spool, "in")
    os.makedirs(in_dir, exist_ok=True)
    stop = threading.Event()
    srv = _server(tmp_path, workers=2)
    errors = []

    def writer(nonce):
        try:
            for i in range(3):
                req = {"job": "bayesianDistr",
                       "conf": _conf("bad", schema), "inputs": [csv],
                       "output": str(tmp_path / f"cw_{nonce}_{i}.csv"),
                       "nonce": nonce}
                tmp = os.path.join(spool, f".{nonce}_{i}.tmp")
                with open(tmp, "w") as fh:
                    json.dump(req, fh)
                dst = os.path.join(in_dir, f"r{i}.json")   # shared stem
                deadline = time.perf_counter() + 120
                while True:                  # atomic no-clobber drop
                    try:
                        os.link(tmp, dst)
                        os.remove(tmp)
                        break
                    except FileExistsError:
                        assert time.perf_counter() < deadline
                        time.sleep(0.02)
                out = os.path.join(spool, "out", f"{nonce}.r{i}.json")
                deadline = time.perf_counter() + 120
                while not os.path.exists(out):
                    assert time.perf_counter() < deadline
                    time.sleep(0.02)
        except BaseException as exc:  # noqa: BLE001 — reported to main
            errors.append((nonce, exc))

    with srv:
        t = threading.Thread(target=lambda: serve_spool(
            srv, spool, should_stop=stop.is_set))
        t.start()
        writers = [threading.Thread(target=writer, args=(n,))
                   for n in ("wa", "wb")]
        try:
            for w in writers:
                w.start()
            for w in writers:
                w.join(240)
                assert not w.is_alive(), "writer wedged"
        finally:
            stop.set()
            t.join(60)
        assert not t.is_alive()
    assert not errors, errors
    for nonce in ("wa", "wb"):
        for i in range(3):
            with open(os.path.join(spool, "out",
                                   f"{nonce}.r{i}.json")) as fh:
                row = json.load(fh)
            assert row["ok"] and row["nonce"] == nonce


def test_request_from_json_rejects_bad_nonce(tmp_path):
    from avenir_tpu_torch.server.spool import request_from_json

    base = {"job": "j", "conf": {}, "inputs": [], "output": ""}
    assert request_from_json({**base, "nonce": "ok-1.a_B"}).nonce \
        == "ok-1.a_B"
    for bad in ("", ".hidden", "a/b", "../up", "x" * 65):
        with pytest.raises(ValueError):
            request_from_json({**base, "nonce": bad})


def test_metrics_snapshot_written_and_rendered(tmp_path):
    """The live metrics surface: a serving JobServer atomic-renames a
    metrics.json snapshot; the queue-wait/admission-hold histograms
    carry nonzero counts after serving, the per-result scalar keys are
    unchanged and the new P50/P99 keys ride along, and `python -m
    avenir_tpu_torch stats` renders the file."""
    from avenir_tpu_torch.obs.report import load_metrics, render_metrics

    csv, schema = _churn(tmp_path, rows=400)
    mp = str(tmp_path / "metrics.json")
    with _server(tmp_path, workers=1, metrics_path=mp,
                 metrics_interval_s=0.0) as srv:
        t1 = srv.submit(JobRequest("bayesianDistr", _conf("bad", schema),
                                   [csv], str(tmp_path / "m1.csv"),
                                   tenant="a"))
        t2 = srv.submit(JobRequest("fisherDiscriminant",
                                   _conf("fid", schema), [csv],
                                   str(tmp_path / "m2.txt"), tenant="b"))
        srv.drain(timeout=240)
        r1, r2 = t1.result(timeout=10), t2.result(timeout=10)
        stats = srv.stats()
    # both results: old scalar keys unchanged, histogram keys new
    for res in (r1, r2):
        assert res.counters["Server:QueueWaitMs"] >= 0.0
        assert res.counters["Server:AdmissionHeldMs"] >= 0.0
        assert res.counters["Server:QueueWaitP50Ms"] >= 0.0
        assert res.counters["Server:QueueWaitP99Ms"] >= \
            res.counters["Server:QueueWaitP50Ms"]
        assert "Server:AdmissionHeldP99Ms" in res.counters
    # stats() surfaces the full summaries
    assert stats["hists"]["queue_wait_ms"]["count"] == 2
    assert stats["hists"]["admission_held_ms"]["count"] == 2
    assert stats["hists"]["dispatch_ms"]["count"] >= 1
    # the snapshot on disk (shutdown wrote a final one) is valid and
    # renders; histograms show the served requests
    snap = load_metrics(str(tmp_path))
    assert snap["stats"]["served"] == 2
    assert snap["inflight"]["budget_bytes"] > 0
    assert snap["hists"]["queue_wait_ms"]["count"] == 2
    assert snap["hists"]["admission_held_ms"]["count"] == 2
    assert "chunk_latency_ms" in snap["hists"]
    text = render_metrics(snap)
    assert "served: 2" in text
    assert "queue_wait_ms" in text


def test_metrics_snapshot_refreshes_during_serving(tmp_path):
    """The scheduler tick (not only shutdown) refreshes the snapshot:
    with a zero interval, a snapshot must exist while the server is
    still up, and `python -m avenir_tpu_torch stats` exits 0 on it."""
    from avenir_tpu_torch.obs.report import stats_main

    csv, schema = _churn(tmp_path, rows=400)
    mp = str(tmp_path / "metrics.json")
    with _server(tmp_path, workers=1, metrics_path=mp,
                 metrics_interval_s=0.0) as srv:
        t = srv.submit(JobRequest("bayesianDistr", _conf("bad", schema),
                                  [csv], str(tmp_path / "m.csv"),
                                  tenant="a"))
        t.result(timeout=240)
        deadline = 100
        while not os.path.exists(mp) and deadline:
            import time

            time.sleep(0.05)
            deadline -= 1
        assert os.path.exists(mp), "no snapshot while serving"
        live = json.load(open(mp))
        assert live["stats"]["submitted"] >= 1
    assert stats_main([mp]) == 0
    assert stats_main([mp, "--json"]) == 0
    assert stats_main([str(tmp_path / "nope.json")]) == 2


def test_serve_cli_stdin(tmp_path):
    """`python -m avenir_tpu_torch serve --stdin --device cpu` — the
    hermetic CLI session: one request line in, one result line out, rc 0,
    the artifact its twins'."""
    import subprocess
    import sys

    seq = _seq(tmp_path, rows=300)
    req = {"job": "markovStateTransitionModel",
           "conf": {"mst.model.states": "L,M,H",
                    "mst.class.label.field.ord": "1",
                    "mst.skip.field.count": "2",
                    "mst.class.labels": "T,F"},
           "inputs": [seq], "output": str(tmp_path / "cli_mst.txt")}
    proc = subprocess.run(
        [sys.executable, "-m", "avenir_tpu_torch", "serve", "--stdin",
         "--workers", "1", "--device", "cpu"],
        input=json.dumps(req) + "\n", capture_output=True, text=True,
        timeout=240,
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 AVENIR_SKIP_DEVICE_PROBE="1"))
    assert proc.returncode == 0, proc.stderr[-800:]
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    assert row["ok"], row
    twin = _twin(req["job"], req["conf"], [seq],
                 str(tmp_path / "cli_ref.txt"))
    assert _read(str(tmp_path / "cli_mst.txt")) == _read(twin.outputs[0])


# ------------------------------------------------------ sidecar landlord
def _sidecar_dirs(root):
    return sorted(base for base, _d, files in os.walk(root)
                  if "MANIFEST.json" in files)


def test_warmstore_eviction_keeps_byte_identity(tmp_path):
    """Evicting a pinned SidecarHandle removes its directory; the next
    scan packs again from a cold parse, to the same bytes as the JAX
    package's run_job. A store too small for any sidecar holds none."""
    from avenir_tpu_torch.native import sidecar
    from avenir_tpu_torch.server.jobserver import WarmStore

    csv, schema = _churn(tmp_path)
    conf = {**_mi_conf(schema),
            "mut.stream.sidecar.dir": str(tmp_path / "sc")}
    run_job("mutualInformation", conf, [csv], str(tmp_path / "pack.txt"),
            device=CPU)
    (scdir,) = _sidecar_dirs(str(tmp_path / "sc"))
    handle = sidecar.SidecarHandle(csv, scdir)
    assert handle.cache_ready() and handle.cache_nbytes > 0
    store = WarmStore(byte_budget=1, state_root=str(tmp_path / "ws"))
    store.pin(("sidecar", csv, os.path.basename(scdir)), handle)
    assert store.stats()["pinned_sources"] == 0
    assert not os.path.exists(scdir)
    repack = run_job("mutualInformation", conf, [csv],
                     str(tmp_path / "repack.txt"), device=CPU)
    assert repack.counters["Sidecar:HitBlocks"] == 0
    assert repack.counters["Sidecar:DeltaBlocks"] >= 1
    twin = _twin("mutualInformation", _mi_conf(schema), [csv],
                 str(tmp_path / "twin.txt"))
    assert _read(repack.outputs[0]) == _read(twin.outputs[0])
    store.close()


@pytest.mark.parametrize("at", ["before_open", "after_first_block"])
def test_scan_racing_a_sidecar_eviction_finishes(tmp_path, monkeypatch, at):
    """The server pins the sidecar its first request packed. A scan of
    the same corpus outside the server (another process's run_job) has
    verified it when a budget squeeze evicts the pin and removes the
    directory: before the scan opened the segment, the scan finishes
    cold, parsing every block; after its first replayed block, it
    finishes from the segment it holds open. Either way it writes the
    JAX package's bytes."""
    from avenir_tpu_torch.native import sidecar

    csv, schema = _churn(tmp_path)
    srv = _server(tmp_path, workers=1)
    evicted = []

    def squeeze():
        with srv.warm._lock:
            srv.warm.byte_budget = 0
            srv.warm._enforce_budget()
        evicted.append(srv.stats()["warm_pinned_sources"])

    with srv:
        srv.submit(JobRequest("mutualInformation", _mi_conf(schema), [csv],
                              str(tmp_path / "s1.txt"))).result(120)
        assert srv.stats()["warm_pinned_sources"] >= 1.0
        real = sidecar.dataset_blocks

        def squeezed(*args, **kwargs):
            feed = real(*args, **kwargs)
            assert feed is not None
            if at == "before_open":
                squeeze()
                return feed

            def gen():
                for i, block in enumerate(feed):
                    yield block
                    if i == 0:
                        squeeze()
            return gen()

        monkeypatch.setattr(sidecar, "dataset_blocks", squeezed)
        raced = run_job("mutualInformation", _mi_conf(schema), [csv],
                        str(tmp_path / "raced.txt"), device=CPU)
        monkeypatch.setattr(sidecar, "dataset_blocks", real)
    assert evicted == [0.0]
    assert not _sidecar_dirs(os.path.join(str(tmp_path), ".avenir_sidecar"))
    if at == "before_open":
        assert raced.counters["Sidecar:HitBlocks"] == 0
        assert raced.counters["Sidecar:DeltaBlocks"] >= 2
    else:
        assert raced.counters["Sidecar:HitBlocks"] >= 2
        assert raced.counters["Sidecar:DeltaBlocks"] == 0
    twin = _twin("mutualInformation", _mi_conf(schema), [csv],
                 str(tmp_path / "twin.txt"))
    assert _read(raced.outputs[0]) == _read(twin.outputs[0])


def test_pinned_spill_cache_evict_to_forces_a_cold_mine(tmp_path):
    """`SpillScanMixin.cache_evict_to` on the warm store's pinned Apriori
    source trims its spill; the source then fails its warm gate, so the
    next request mines cold, to the JAX package's bytes."""
    seq = _seq(tmp_path, rows=400)
    srv = _server(tmp_path, workers=1)
    with srv:
        srv.submit(JobRequest("frequentItemsApriori", _fia_conf(), [seq],
                              str(tmp_path / "e1"))).result(120)
        (src,) = [s for s in srv.warm._sources.values()
                  if not getattr(s, "cache_durable", False)]
        nbytes = src.cache_nbytes
        assert nbytes > 0 and src.cache_ready()
        assert src.cache_evict_to(nbytes) == 0         # fits: nothing
        assert src.cache_evict_to(0) == nbytes
        assert src.cache_nbytes == 0 and not src.cache_ready()
        r2 = srv.submit(JobRequest("frequentItemsApriori", _fia_conf(),
                                   [seq], str(tmp_path / "e2"))).result(120)
    assert r2.counters["Server:WarmHit"] == 0.0
    twin = _twin("frequentItemsApriori", _fia_conf(), [seq],
                 str(tmp_path / "e_ref"))
    for a, b in zip(sorted(r2.outputs), sorted(twin.outputs)):
        assert _read(a) == _read(b)


def test_sidecar_handle_evict_to_is_whole_or_nothing(tmp_path):
    """A sidecar cannot be trimmed: a budget at its size keeps it, any
    budget below evicts the whole directory."""
    from avenir_tpu_torch.native import sidecar

    csv, schema = _churn(tmp_path, rows=400)
    conf = {**_mi_conf(schema),
            "mut.stream.sidecar.dir": str(tmp_path / "sc")}
    run_job("mutualInformation", conf, [csv], str(tmp_path / "p.txt"),
            device=CPU)
    (scdir,) = _sidecar_dirs(str(tmp_path / "sc"))
    handle = sidecar.SidecarHandle(csv, scdir)
    nbytes = handle.cache_nbytes
    assert handle.cache_durable and nbytes > 0
    assert handle.cache_evict_to(nbytes) == 0 and handle.cache_ready()
    assert handle.cache_evict_to(nbytes - 1) == nbytes
    assert not os.path.exists(scdir) and not handle.cache_ready()
