"""The port's network edge on the CPU: router, leases, listener, edge.

One counterpart of each of the 22 tests of `tests/test_net.py` that hold
the affinity router (sticky placement against the budget vector, spill,
failover, mirrors), the fault policy's pieces (restart backoff and
quarantine, the lease store, the hedge decision), the HTTP edge
(`POST /submit`, `/result`, `/metrics`, `/healthz`; 429 with Retry-After
against the admission model, hold mode, tenant depth, drain and the
supervision overlay) and the `serve --spool|--listen|--stdin` sessions'
signal handling, all on `avenir_tpu_torch` with device="cpu". The other
18 are in `tests/test_torch_fleet.py` (split so that xdist's
`--dist loadfile` runs them on two workers). Every served artifact is
compared with the port's solo run_job and with the JAX package's
(`_twin`).

Every network test binds port 0 and every subprocess test polls for
observable state.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from avenir_tpu_torch.net.fault import (FaultPolicy, Lease, LeaseStore,
                                  RestartTracker, hot_hosts)
from avenir_tpu_torch.net.fleet import Fleet, FleetError, affinity_key
from avenir_tpu_torch.net.listener import EdgePolicy, NetListener
from avenir_tpu_torch.net.router import AffinityRouter, RouterError
import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.runner import run_job as jax_run_job
from avenir_tpu_torch.runner import run_job
from avenir_tpu_torch.server import JobRequest, JobServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SUB_ENV = dict(os.environ,
                PYTHONPATH=os.pathsep.join(
                    p for p in (REPO, os.environ.get("PYTHONPATH"))
                    if p))
CPU = "cpu"

MST_CONF = {"mst.model.states": "L,M,H",
            "mst.class.label.field.ord": "1",
            "mst.skip.field.count": "2",
            "mst.class.labels": "T,F"}


# ---------------------------------------------------------------- fixtures
def _seq(tmp_path, rows=300, seed=12, name="seq.csv"):
    rng = np.random.default_rng(seed)
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


def _req_obj(csv, out, tenant="default", **extra):
    return {"job": "markovStateTransitionModel", "conf": MST_CONF,
            "inputs": [csv], "output": out, "tenant": tenant, **extra}


def _post(url, obj, expect_error=False):
    """(status, row) of one POST; 4xx/5xx surfaced as (code, body)."""
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=240) as resp:
            return resp.status, json.load(resp), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        if not expect_error:
            raise
        body = json.loads(exc.read() or b"{}")
        return exc.code, body, dict(exc.headers)


def _get(url, expect_error=False):
    try:
        with urllib.request.urlopen(url, timeout=240) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as exc:
        if not expect_error:
            raise
        return exc.code, json.loads(exc.read() or b"{}")


def _server(tmp_path, **kw):
    kw.setdefault("state_root", str(tmp_path / "srv_state"))
    kw.setdefault("workers", 1)
    kw.setdefault("device", CPU)
    return JobServer(**kw)


def _fleet(*args, **kwargs):
    """A Fleet whose hosts serve on the CPU (`serve --device cpu`)."""
    kwargs.setdefault("device", CPU)
    return Fleet(*args, **kwargs)


def _twin(job, conf, inputs, out):
    """The port's solo run_job on the CPU, after holding each of its files
    to the JAX package's run_job of the same request (written beside it
    under `<out>.jax`, its sidecar off so it parses its input)."""
    port = run_job(job, conf, inputs, out, device=CPU)
    ref = jax_run_job(job, dict(conf, **{"stream.sidecar": "false"}),
                      inputs, out + ".jax")
    assert len(port.outputs) == len(ref.outputs)
    for a, b in zip(sorted(port.outputs), sorted(ref.outputs)):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), (job, a)
    return port


# ------------------------------------------------------------------ router


def test_router_affinity_spill_and_budget_vector():
    r = AffinityRouter([100, 100])
    a = r.place(("a",), 60)
    b = r.place(("b",), 60)
    assert {a.host, b.host} == {0, 1}        # least-loaded spread
    assert a.kind == b.kind == "miss"
    # sticky: corpus a returns to its host while it fits
    hit = r.place(("a",), 30)
    assert (hit.host, hit.kind) == (a.host, "hit")
    # over the sticky host's vector entry: spill to the other host,
    # sticky mapping unmoved
    spill = r.place(("a",), 35)
    assert (spill.host, spill.kind) == (b.host, "spill")
    # nothing fits: held, never a breach — and a poller's RETRY of the
    # same arrival must not inflate the held stat (transition-only)
    assert r.place(("c",), 50) is None
    assert r.place(("c",), 50, count_held=False) is None
    snap = r.snapshot()
    for h in snap["hosts"]:
        assert h["assigned_bytes"] <= h["budget_bytes"]
        assert h["peak_assigned_bytes"] <= h["budget_bytes"]
    assert snap["stats"]["held"] == 1
    # release returns capacity; the corpus comes home to its warm host
    r.release(spill)
    r.release(hit)
    home = r.place(("a",), 30)
    assert (home.host, home.kind) == (a.host, "hit")
    # a request over EVERY vector entry can never place
    with pytest.raises(RouterError):
        r.place(("z",), 1000)


def test_router_fold_cost_breaks_byte_ties():
    r = AffinityRouter([1000, 1000])
    # equal bytes on both hosts, but host 0 carries measured-expensive
    # pending folds: the tie must break to host 1
    r.assign_to(0, ("w0",), 100, cost_ms=500.0)
    r.assign_to(1, ("w1",), 100, cost_ms=1.0)
    p = r.place(("new",), 100)
    assert p.host == 1
    # hit-rate counts only routed placements, not pinned warmups
    assert r.affinity_hit_rate() == 0.0
    r2 = AffinityRouter([1000])
    r2.place(("k",), 10)
    r2.place(("k",), 10)
    assert r2.affinity_hit_rate() == 0.5


def test_restart_tracker_backoff_and_quarantine():
    p = FaultPolicy(restart_backoff_base_s=0.5,
                    restart_backoff_cap_s=4.0, max_restarts=2,
                    quarantine_window_s=60.0)
    t = RestartTracker(p)
    assert t.record_death(0.0) == "restarting"
    assert t.backoff_s() == 0.5
    assert t.record_death(1.0) == "restarting"
    assert t.backoff_s() == 1.0          # capped exponential
    assert t.record_death(2.0) == "quarantined"
    # deaths OUTSIDE the window age out: a host that dies once an hour
    # is restarted every time, never quarantined
    t2 = RestartTracker(p)
    for now in (0.0, 100.0, 200.0, 300.0, 400.0):
        assert t2.record_death(now) == "restarting"
    # ... and the backoff caps
    t3 = RestartTracker(FaultPolicy(restart_backoff_base_s=1.0,
                                    restart_backoff_cap_s=4.0,
                                    max_restarts=100))
    for now in range(6):
        t3.record_death(float(now))
    assert t3.backoff_s() == 4.0


def test_lease_store_roundtrip_renew_expiry(tmp_path):
    store = LeaseStore(str(tmp_path))
    lease = Lease(name="r1.json", host=0, claimed_at=100.0, ttl_s=5.0,
                  hosts=[0], nonce="n1")
    store.write(lease)
    assert store.names() == ["r1.json"]
    back = store.load("r1.json")
    assert (back.host, back.nonce, back.hosts) == (0, "n1", [0])
    assert not back.expired(104.9) and back.expired(105.1)
    store.renew(back, 200.0)
    assert store.load("r1.json").claimed_at == 200.0
    store.remove("r1.json")
    assert store.names() == [] and store.load("r1.json") is None


def test_hot_hosts_hedge_decision():
    p = FaultPolicy(hedge_multiple=4.0, hedge_floor_ms=100.0)
    # symmetric load: nobody is hot
    assert hot_hosts({0: 500.0, 1: 520.0}, {}, p, [0, 1]) == []
    # one straggler past 4x the median (lower middle for 2 hosts)
    assert hot_hosts({0: 5000.0, 1: 200.0}, {}, p, [0, 1]) == [0]
    # the pending-age live lower bound counts with no served p99 yet
    assert hot_hosts({}, {0: 5000.0}, p, [0, 1]) == [0]
    # idle fleet: the floor keeps microscopic wobbles from hedging
    assert hot_hosts({0: 2.0, 1: 0.1}, {}, p, [0, 1]) == []
    # fewer than two healthy hosts: nowhere to mirror
    assert hot_hosts({0: 5000.0, 1: 1.0}, {}, p, [0]) == []
    off = FaultPolicy(hedge=False, hedge_floor_ms=100.0)
    assert hot_hosts({0: 5000.0, 1: 1.0}, {}, off, [0, 1]) == []


def test_router_failover_and_reintegration():
    r = AffinityRouter([100, 100])
    a = r.place(("a",), 10)
    assert a.kind == "miss"
    r.release(a)
    # warm host leaves serving: the sticky mapping DROPS (failover)
    # and the corpus re-places on a serving host
    r.set_host_state(a.host, "restarting")
    b = r.place(("a",), 10)
    assert b.host != a.host and b.kind == "miss"
    assert r.stats["failovers"] == 1
    # reintegration: the recovered host re-EARNS affinity through new
    # placements, never a map reset — corpus a stays with its new home
    r.set_host_state(a.host, "serving")
    c = r.place(("a",), 10)
    assert (c.host, c.kind) == (b.host, "hit")
    # ... and a new corpus lands on the recovered least-loaded host
    d = r.place(("new",), 10)
    assert (d.host, d.kind) == (a.host, "miss")
    # per-request exclusion (the requeue path): never back to a host
    # the request already failed on, sticky mapping unmoved
    e = r.place(("a",), 10, exclude=[b.host])
    assert e.host != b.host and e.kind == "spill"
    # mirrors: least-loaded serving host outside the exclusion set;
    # a quarantined fleet-mate can never take one
    r.set_host_state(a.host, "quarantined")
    assert r.place_mirror(("a",), 10, exclude=[b.host]) is None
    m = r.place_mirror(("a",), 10)
    assert (m.host, m.kind) == (b.host, "hedge")
    assert r.stats["hedges"] == 1
    assert r.snapshot()["hosts"][a.host]["state"] == "quarantined"


def test_listener_round_trip_byte_identical(tmp_path):
    csv = _seq(tmp_path)
    srv = _server(tmp_path).start()
    with NetListener(srv, port=0) as lis:
        url = f"http://127.0.0.1:{lis.port}"
        # blocking submit
        code, row, _ = _post(url + "/submit?wait=1",
                             _req_obj(csv, str(tmp_path / "net1.txt")))
        assert code == 200 and row["ok"]
        assert row["counters"]["Server:BatchSize"] >= 1.0
        # async submit + result poll
        code, sub, _ = _post(url + "/submit",
                             _req_obj(csv, str(tmp_path / "net2.txt")))
        assert code == 202 and sub["status"] == "queued"
        assert sub["priced_bytes"] > 0
        code, row2 = _get(url + f"/result/{sub['req_id']}?timeout=120")
        assert code == 200 and row2["ok"]
        # fetched results are popped: a second fetch is a 404
        code, _ = _get(url + f"/result/{sub['req_id']}",
                       expect_error=True)
        assert code == 404
        # metrics carries the server snapshot + the edge section + the
        # mergeable raw buckets
        code, snap = _get(url + "/metrics")
        assert code == 200
        assert snap["stats"]["served"] >= 2
        assert snap["edge"]["accepted"] == 2
        assert snap["hists_raw"]["queue_wait_ms"]["count"] >= 2
        code, health = _get(url + "/healthz")
        assert code == 200 and health["status"] == "serving"
        # malformed requests answer 400, not a stack trace
        code, err, _ = _post(url + "/submit",
                             {"job": "noSuchJob", "inputs": [csv],
                              "output": "x"}, expect_error=True)
        assert code == 400 and "KeyError" in err["error"]
        code, err, _ = _post(url + "/submit", {"jobb": "x"},
                             expect_error=True)
        assert code == 400
    srv.shutdown()
    twin = _twin("markovStateTransitionModel", MST_CONF, [csv],
                   str(tmp_path / "net_ref.txt"))
    for out in ("net1.txt", "net2.txt"):
        with open(tmp_path / out, "rb") as fa, \
                open(twin.outputs[0], "rb") as fb:
            assert fa.read() == fb.read()


def test_edge_sheds_flood_and_recovers_after_drain(tmp_path):
    """The load-shed contract: a flood priced over budget gets 429 with
    Retry-After AT THE EDGE, the server's peak priced bytes never
    exceed its budget, and a previously-shed request succeeds on retry
    once in-flight work drains."""
    csv = _seq(tmp_path)
    # deliberately NOT started yet: the first request stays queued, so
    # the flood's 429s below are deterministic — a warm process can
    # otherwise serve the first request between two POSTs and free the
    # edge capacity the flood was meant to breach
    srv = _server(tmp_path, budget_bytes=150 << 20,
                  pricer=lambda reqs, reserve: (100 << 20) * len(reqs),
                  rss_probe=lambda: 0)
    with NetListener(srv, port=0) as lis:
        url = f"http://127.0.0.1:{lis.port}"
        code, first, _ = _post(url + "/submit",
                               _req_obj(csv, str(tmp_path / "s0.txt")))
        assert code == 202
        shed = 0
        for i in range(4):
            code, err, headers = _post(
                url + "/submit",
                _req_obj(csv, str(tmp_path / f"sf{i}.txt"),
                         tenant=f"t{i}"),
                expect_error=True)
            assert code == 429
            assert int(headers["Retry-After"]) >= 1
            assert "budget" in err["error"]
            shed += 1
        assert shed == 4
        # the server starts, the in-flight request finishes, the edge
        # frees its priced bytes — the SAME previously-shed request
        # now succeeds
        srv.start()
        code, row = _get(url + f"/result/{first['req_id']}?timeout=240")
        assert code == 200 and row["ok"]
        deadline = time.perf_counter() + 30
        while True:
            code, retried, _ = _post(
                url + "/submit?wait=1",
                _req_obj(csv, str(tmp_path / "sf0.txt"), tenant="t0"),
                expect_error=True)
            if code == 200:
                break
            assert code == 429
            assert time.perf_counter() < deadline, \
                "shed request never recovered after drain"
            time.sleep(0.1)
        assert retried["ok"]
        edge = lis.edge_stats()
        assert edge["rejected"] >= 4
    stats = srv.stats()
    srv.shutdown()
    assert stats["peak_priced_bytes"] <= 150 << 20


def test_edge_hold_mode_parks_instead_of_429(tmp_path):
    csv = _seq(tmp_path)
    srv = _server(tmp_path, budget_bytes=150 << 20,
                  pricer=lambda reqs, reserve: (100 << 20) * len(reqs),
                  rss_probe=lambda: 0).start()
    policy = EdgePolicy(shed_mode="hold", hold_timeout_s=120.0)
    with NetListener(srv, port=0, policy=policy) as lis:
        url = f"http://127.0.0.1:{lis.port}"
        code, _first, _ = _post(url + "/submit",
                                _req_obj(csv, str(tmp_path / "h0.txt")))
        assert code == 202
        # over budget: the edge PARKS the accept until the first
        # request frees its priced bytes, then serves — never a 429
        code, row, _ = _post(url + "/submit?wait=1",
                             _req_obj(csv, str(tmp_path / "h1.txt"),
                                      tenant="b"))
        assert code == 200 and row["ok"]
        edge = lis.edge_stats()
        assert edge["rejected"] == 0
        assert edge["held_accepts"] >= 1
    srv.shutdown()


def test_edge_tenant_depth_bound(tmp_path):
    csv = _seq(tmp_path)
    srv = _server(tmp_path)          # deliberately NOT started: queued
    policy = EdgePolicy(max_tenant_depth=2)
    with NetListener(srv, port=0, policy=policy) as lis:
        url = f"http://127.0.0.1:{lis.port}"
        for i in range(2):
            code, _row, _ = _post(
                url + "/submit",
                _req_obj(csv, str(tmp_path / f"d{i}.txt"), tenant="t"))
            assert code == 202
        code, err, headers = _post(
            url + "/submit",
            _req_obj(csv, str(tmp_path / "d2.txt"), tenant="t"),
            expect_error=True)
        assert code == 429 and "depth" in err["error"]
        assert "Retry-After" in headers
        # another tenant is NOT shed by t's depth
        code, _row, _ = _post(
            url + "/submit",
            _req_obj(csv, str(tmp_path / "d3.txt"), tenant="u"))
        assert code == 202
        srv.start()
        srv.drain(timeout=240)
    srv.shutdown()


def test_edge_reused_req_id_does_not_leak_budget(tmp_path):
    """A client retrying with the SAME req_id while the first attempt
    is in flight must not ratchet the edge's outstanding total up —
    the replaced entry's priced bytes are freed on re-register."""
    csv = _seq(tmp_path)
    srv = _server(tmp_path, budget_bytes=250 << 20,
                  pricer=lambda reqs, reserve: (100 << 20) * len(reqs),
                  rss_probe=lambda: 0)   # not started: all stay queued
    with NetListener(srv, port=0) as lis:
        url = f"http://127.0.0.1:{lis.port}"
        for attempt in range(2):         # same req_id twice
            code, _row, _ = _post(url + "/submit", _req_obj(
                csv, str(tmp_path / f"rr_{attempt}.txt"),
                req_id="fixed-id"))
            assert code == 202
        # outstanding must be ONE 100MB entry, so a third distinct
        # request (100MB) still fits the 250MB edge budget
        assert lis.edge_stats()["outstanding_priced_bytes"] == 100 << 20
        code, _row, _ = _post(url + "/submit",
                              _req_obj(csv, str(tmp_path / "rr2.txt"),
                                       tenant="u"))
        assert code == 202
        srv.start()
        srv.drain(timeout=240)
    srv.shutdown()


def test_edge_unfetched_results_expire(tmp_path):
    """Fire-and-forget clients must not grow a resident edge forever:
    a served-but-never-fetched result is dropped after result_ttl_s."""
    csv = _seq(tmp_path)
    srv = _server(tmp_path).start()
    policy = EdgePolicy(result_ttl_s=0.2)
    with NetListener(srv, port=0, policy=policy) as lis:
        url = f"http://127.0.0.1:{lis.port}"
        code, sub, _ = _post(url + "/submit",
                             _req_obj(csv, str(tmp_path / "ttl.txt")))
        assert code == 202
        srv.drain(timeout=240)
        _wait_for(lambda: lis.edge_stats()["outstanding_requests"] == 0,
                  30, "unfetched result expired")
        code, _ = _get(url + f"/result/{sub['req_id']}",
                       expect_error=True)
        assert code == 404
    srv.shutdown()


def test_edge_malformed_timeout_is_400_not_crash(tmp_path):
    csv = _seq(tmp_path)
    srv = _server(tmp_path).start()
    with NetListener(srv, port=0) as lis:
        url = f"http://127.0.0.1:{lis.port}"
        code, err = _get(url + "/result/whatever?timeout=abc",
                         expect_error=True)
        assert code == 400 and "timeout" in err["error"]
        code, _err, _ = _post(url + "/submit?wait=1&timeout=nope",
                              _req_obj(csv, str(tmp_path / "tq.txt")),
                              expect_error=True)
        assert code == 400
        srv.drain(timeout=240)           # the 400'd job still ran
    srv.shutdown()


def test_edge_policy_not_mutated_across_listeners(tmp_path):
    """Resolving the default edge budget must never write through to a
    caller's shared EdgePolicy — listener B would inherit listener A's
    server budget and accept work B's admission can never hold."""
    policy = EdgePolicy(shed_mode="hold")
    srv_a = _server(tmp_path, budget_bytes=3 << 30)
    srv_b = JobServer(budget_bytes=150 << 20,
                      state_root=str(tmp_path / "b_state"), device=CPU)
    lis_a = NetListener(srv_a, port=0, policy=policy)
    lis_b = NetListener(srv_b, port=0, policy=policy)
    try:
        assert policy.budget_bytes is None       # caller's object intact
        assert lis_a.policy.budget_bytes == 3 << 30
        assert lis_b.policy.budget_bytes == 150 << 20
        assert lis_b.policy.shed_mode == "hold"  # knobs still copied
    finally:
        # never started: close the bound sockets directly (stop() joins
        # an accept loop these listeners never ran)
        lis_a._httpd.server_close()
        lis_b._httpd.server_close()
        srv_a.shutdown(drain=False)
        srv_b.shutdown(drain=False)


def test_listener_retry_after_jitter(tmp_path):
    """Shed responses carry a ±20%-jittered Retry-After so a cohort of
    synchronized shed clients does not retry in lockstep and
    re-stampede the edge at one instant."""
    csv = _seq(tmp_path)
    srv = _server(tmp_path, budget_bytes=150 << 20,
                  pricer=lambda reqs, reserve: (100 << 20) * len(reqs),
                  rss_probe=lambda: 0)     # not started: first queues
    policy = EdgePolicy(retry_after_s=10.0)
    with NetListener(srv, port=0, policy=policy) as lis:
        url = f"http://127.0.0.1:{lis.port}"
        code, _row, _ = _post(url + "/submit",
                              _req_obj(csv, str(tmp_path / "j0.txt")))
        assert code == 202
        hints = []
        for i in range(12):
            code, err, headers = _post(
                url + "/submit",
                _req_obj(csv, str(tmp_path / f"j{i}.txt"),
                         tenant=f"t{i}"),
                expect_error=True)
            assert code == 429
            hint = err["retry_after_s"]
            assert 8.0 <= hint <= 12.0        # ±20% of the 10s policy
            assert int(headers["Retry-After"]) >= 8
            hints.append(hint)
        assert min(hints) < max(hints)        # jittered, not lockstep
    srv.shutdown(drain=False)


def test_listener_healthz_supervision_states(tmp_path):
    """/healthz surfaces the supervision overlay: quarantined and
    restarting answer 503 with the state in-band (and refuse new
    submissions the same way draining does); clearing the overlay
    returns the edge to serving."""
    csv = _seq(tmp_path)
    srv = _server(tmp_path).start()
    with NetListener(srv, port=0) as lis:
        url = f"http://127.0.0.1:{lis.port}"
        code, health = _get(url + "/healthz")
        assert code == 200 and health["status"] == "serving"
        for state in ("quarantined", "restarting"):
            lis.set_health_state(state)
            code, health = _get(url + "/healthz", expect_error=True)
            assert code == 503 and health["status"] == state
            code, err, _ = _post(url + "/submit",
                                 _req_obj(csv, str(tmp_path / "hs.txt")),
                                 expect_error=True)
            assert code == 503 and err["status"] == state
        with pytest.raises(ValueError):
            lis.set_health_state("weird")
        lis.set_health_state(None)
        code, row, _ = _post(url + "/submit?wait=1",
                             _req_obj(csv, str(tmp_path / "hs2.txt")))
        assert code == 200 and row["ok"]
        assert lis.edge_stats()["health_state"] == "serving"
    srv.shutdown()


def test_listener_drain_state(tmp_path):
    csv = _seq(tmp_path)
    srv = _server(tmp_path).start()
    with NetListener(srv, port=0) as lis:
        url = f"http://127.0.0.1:{lis.port}"
        code, _row, _ = _post(url + "/submit?wait=1",
                              _req_obj(csv, str(tmp_path / "dr.txt")))
        assert code == 200
        lis.begin_drain()
        code, health = _get(url + "/healthz", expect_error=True)
        assert code == 503 and health["status"] == "draining"
        code, err, _ = _post(url + "/submit",
                             _req_obj(csv, str(tmp_path / "dr2.txt")),
                             expect_error=True)
        assert code == 503 and err["status"] == "draining"
    srv.shutdown()


def _wait_for(predicate, timeout, what):
    deadline = time.perf_counter() + timeout
    while not predicate():
        assert time.perf_counter() < deadline, f"timed out: {what}"
        time.sleep(0.05)


def test_serve_spool_sigterm_graceful_drain(tmp_path):
    """SIGTERM on a `serve --spool` session is a graceful drain: the
    claimed request finishes, the final metrics.json lands, exit 0."""
    csv = _seq(tmp_path)
    spool = str(tmp_path / "spool")
    os.makedirs(os.path.join(spool, "in"), exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-m", "avenir_tpu_torch", "serve", "--device", "cpu",
         "--spool", spool, "--workers", "1", "--metrics-interval", "0.2"],
        cwd=REPO, env=_SUB_ENV, stderr=subprocess.PIPE, text=True)
    try:
        req = _req_obj(csv, str(tmp_path / "sig.txt"))
        tmp = os.path.join(spool, "r1.json.tmp")
        with open(tmp, "w") as fh:
            json.dump(req, fh)
        os.replace(tmp, os.path.join(spool, "in", "r1.json"))
        out_path = os.path.join(spool, "out", "r1.json")
        _wait_for(lambda: os.path.exists(out_path), 240,
                  "spooled request served")
        proc.send_signal(signal.SIGTERM)
        _stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, stderr[-800:]
    assert '"drained": true' in stderr
    with open(os.path.join(spool, "metrics.json")) as fh:
        snap = json.load(fh)
    assert snap["stats"]["served"] >= 1
    with open(out_path) as fh:
        assert json.load(fh)["ok"]


def test_serve_listen_cli_sigterm(tmp_path):
    """`serve --listen 127.0.0.1:0`: ephemeral port via --port-file,
    HTTP round trip, SIGTERM drains to exit 0."""
    csv = _seq(tmp_path)
    port_file = str(tmp_path / "port")
    proc = subprocess.Popen(
        [sys.executable, "-m", "avenir_tpu_torch", "serve", "--device", "cpu",
         "--listen", "127.0.0.1:0", "--workers", "1", "--port-file",
         port_file],
        cwd=REPO, env=_SUB_ENV, stderr=subprocess.PIPE, text=True)
    try:
        _wait_for(lambda: os.path.exists(port_file), 120, "port file")
        with open(port_file) as fh:
            port = int(fh.read())
        url = f"http://127.0.0.1:{port}"
        code, row, _ = _post(url + "/submit?wait=1",
                             _req_obj(csv, str(tmp_path / "lc.txt")))
        assert code == 200 and row["ok"]
        code, health = _get(url + "/healthz")
        assert code == 200
        proc.send_signal(signal.SIGTERM)
        _stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, stderr[-800:]
    twin = _twin("markovStateTransitionModel", MST_CONF, [csv],
                   str(tmp_path / "lc_ref.txt"))
    with open(tmp_path / "lc.txt", "rb") as fa, \
            open(twin.outputs[0], "rb") as fb:
        assert fa.read() == fb.read()


def test_serve_stdin_still_killed_by_sigterm(tmp_path):
    """--stdin sessions keep the DEFAULT signal semantics (EOF is
    their graceful end): SIGTERM must terminate the process, not be
    absorbed by a drain handler nothing in the stdin path reads."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "avenir_tpu_torch", "serve", "--device", "cpu",
         "--stdin", "--workers", "1"],
        cwd=REPO, env=_SUB_ENV, stdin=subprocess.PIPE,
        stderr=subprocess.DEVNULL)
    try:
        time.sleep(1.0)                  # let it reach the read loop
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc != 0                       # killed by the signal, not hung


def test_spool_failure_row_keeps_nonce(tmp_path):
    """A nonce-carrying request that FAILS (unknown job) still writes
    its row at out/<nonce>.<name> — the polling client must see the
    failure, and the un-namespaced stem must stay unclobbered."""
    import threading

    from avenir_tpu_torch.server.spool import serve_spool

    spool = str(tmp_path / "spool")
    os.makedirs(os.path.join(spool, "in"), exist_ok=True)
    stop = threading.Event()
    srv = _server(tmp_path)
    with srv:
        t = threading.Thread(target=lambda: serve_spool(
            srv, spool, should_stop=stop.is_set))
        t.start()
        try:
            req = {"job": "noSuchJob", "conf": {}, "inputs": [],
                   "output": "x", "nonce": "cfail"}
            tmp = os.path.join(spool, "bad.tmp")
            with open(tmp, "w") as fh:
                json.dump(req, fh)
            os.replace(tmp, os.path.join(spool, "in", "bad.json"))
            out = os.path.join(spool, "out", "cfail.bad.json")
            _wait_for(lambda: os.path.exists(out), 60,
                      "nonce-namespaced failure row")
        finally:
            stop.set()
            t.join(30)
        assert not t.is_alive()
    with open(out) as fh:
        row = json.load(fh)
    assert not row["ok"] and row["nonce"] == "cfail"
    assert "noSuchJob" in row["error"]


def test_spool_dead_letters_torn_request(tmp_path):
    """A truncated request JSON leaves the claim loop FOR GOOD: moved
    to <spool>/dead/ with a reason file (the crash-loop fix), the
    in-band failure row still written, and the session keeps serving
    the next request."""
    import threading

    from avenir_tpu_torch.server.spool import serve_spool

    csv = _seq(tmp_path)
    spool = str(tmp_path / "spool")
    os.makedirs(os.path.join(spool, "in"), exist_ok=True)
    stop = threading.Event()
    srv = _server(tmp_path)
    with srv:
        t = threading.Thread(target=lambda: serve_spool(
            srv, spool, should_stop=stop.is_set))
        t.start()
        try:
            tmp = os.path.join(spool, "torn.tmp")
            with open(tmp, "w") as fh:     # truncated mid-object
                fh.write('{"job": "markovStateTransitionModel", "inp')
            os.replace(tmp, os.path.join(spool, "in", "torn.json"))
            out = os.path.join(spool, "out", "torn.json")
            _wait_for(lambda: os.path.exists(out), 60,
                      "failure row for the torn request")
            dead_dir = os.path.join(spool, "dead")
            dead = [n for n in os.listdir(dead_dir)
                    if n.startswith("torn.json")
                    and not n.endswith(".reason")]
            assert len(dead) == 1
            with open(os.path.join(dead_dir, dead[0])) as fh:
                assert fh.read().startswith('{"job"')  # bytes preserved
            with open(os.path.join(dead_dir, "torn.json.reason")) as fh:
                assert "JSONDecodeError" in fh.read()
            # never re-claimable: nothing left in work/ or in/
            assert not os.listdir(os.path.join(spool, "work"))
            assert not os.listdir(os.path.join(spool, "in"))
            # the loop survived: a well-formed request still serves
            good = _req_obj(csv, str(tmp_path / "after.txt"))
            tmp2 = os.path.join(spool, "good.tmp")
            with open(tmp2, "w") as fh:
                json.dump(good, fh)
            os.replace(tmp2, os.path.join(spool, "in", "good.json"))
            good_out = os.path.join(spool, "out", "good.json")
            _wait_for(lambda: os.path.exists(good_out), 240,
                      "request served after the dead-letter")
        finally:
            stop.set()
            t.join(30)
        assert not t.is_alive()
    with open(out) as fh:
        row = json.load(fh)
    assert not row["ok"] and "JSONDecodeError" in row["error"]
    with open(good_out) as fh:
        assert json.load(fh)["ok"]
