"""The port's fleet on the CPU: hosts, faults, stranded leases, stats.

One counterpart of each of the 18 tests of `tests/test_net.py` that drive
`net/fleet.py` (hosts as `python -m avenir_tpu_torch serve --spool ...
--device cpu` subprocesses behind the affinity router, the fleet CLI,
SIGKILL requeues, hedging a stalled host, stranded-lease rescue,
wall-clock steps, the /healthz heartbeat, the requeued refresh), the
`stats` roll-up and `tools/fleet_load.py`; the other 22 are in
`tests/test_torch_net.py`. Every served artifact is compared with the
port's solo run_job and with the JAX package's (`_twin`). Fault-policy
timeouts stay the reference's but where a port's host would boot past
them (a torch interpreter starts slower): each such change says so.
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


def test_fleet_quarantine_and_reinstate(tmp_path, monkeypatch):
    """Supervision policy end to end over stand-in host processes: a
    host that keeps dying is restarted with backoff, quarantined past
    max_restarts, routed around, and re-earns service on operator
    reinstate — all driven through the real _fault_tick."""

    class FakeProc:
        def __init__(self, rc=None):
            self.rc = rc
            self.pid = 4242

        def poll(self):
            return self.rc

    policy = FaultPolicy(poll_interval_s=0.05, max_restarts=1,
                         restart_backoff_base_s=0.0,
                         quarantine_window_s=60.0, hedge=False)
    fleet = _fleet(str(tmp_path / "fleet"), hosts=2,
                  fault_policy=policy)

    def fake_spawn_dying(i):
        with fleet._lock:
            fleet._procs[i] = FakeProc(rc=137)   # dies again instantly
            fleet._spawned_at[i] = time.time()
            fleet._spawned_mono[i] = time.monotonic()

    monkeypatch.setattr(fleet, "_spawn_host", fake_spawn_dying)
    with fleet._lock:
        fleet._procs[0] = FakeProc(rc=137)       # dead on arrival
        fleet._procs[1] = FakeProc()             # healthy
        fleet._spawned_at = [time.time()] * 2
        fleet._spawned_mono = [time.monotonic()] * 2
    fleet._fault_tick()              # death 1 -> restarting
    assert fleet.host_state(0) == "restarting"
    fleet._fault_tick()              # backoff elapsed -> respawn
    assert fleet.fault_snapshot()["stats"]["restarts"] == 1
    fleet._fault_tick()              # death 2 in-window -> quarantine
    assert fleet.host_state(0) == "quarantined"
    assert fleet.router.snapshot()["hosts"][0]["state"] == "quarantined"
    assert fleet.fault_snapshot()["stats"]["quarantined"] == 1
    # placement routes around the quarantined host
    placed = fleet.router.place(("k",), 10)
    assert placed.host == 1
    fleet.router.release(placed)
    # operator reinstate: record cleared, host serves again
    def fake_spawn_ok(i):
        with fleet._lock:
            fleet._procs[i] = FakeProc()
            fleet._spawned_at[i] = time.time()
            fleet._spawned_mono[i] = time.monotonic()

    monkeypatch.setattr(fleet, "_spawn_host", fake_spawn_ok)
    fleet.reinstate(0)
    assert fleet.host_state(0) == "serving"
    with pytest.raises(FleetError):
        fleet.reinstate(1)           # only quarantined hosts reinstate


def _wait_for(predicate, timeout, what):
    deadline = time.perf_counter() + timeout
    while not predicate():
        assert time.perf_counter() < deadline, f"timed out: {what}"
        time.sleep(0.05)


def test_fleet_two_hosts_round_trip(tmp_path):
    """2 subprocess hosts behind the router: byte-identical artifacts,
    corpus affinity (repeats hit the warm host), per-host metrics
    merged through the additive histogram algebra, SIGTERM exit 0."""
    a = _seq(tmp_path, seed=1, name="a.csv")
    b = _seq(tmp_path, seed=2, name="b.csv")
    # quiet fault policy: this is the ROUND-TRIP test, and its placed/
    # hit-rate assertions are exact — on a starved CI box the default
    # 10s lease TTL / hedging can fire mid-trip and legitimately add
    # placements (their own tests cover that); park them out of reach
    fleet = _fleet(str(tmp_path / "fleet"), hosts=2, workers=1,
                  env=_SUB_ENV,
                  fault_policy=FaultPolicy(lease_ttl_s=3600.0,
                                           heartbeat_timeout_s=3600.0,
                                           hedge=False))
    fleet.start()
    try:
        names = {}
        for i, corpus in enumerate([a, b, a, b]):
            names[i] = fleet.submit(_req_obj(
                corpus, str(tmp_path / f"fo{i}.txt"), tenant=f"t{i}"))
        rows = fleet.collect(list(names.values()), timeout=240)
        assert all(r["ok"] for r in rows.values())
        snap = fleet.merged_metrics()
        router = fleet.router.snapshot()
    finally:
        codes = fleet.stop()
    assert codes == [0, 0]             # SIGTERM drained both hosts
    assert snap["hosts"] == 2
    # 4 placements over 2 corpora: 2 misses seed the map, 2 repeats hit
    assert router["stats"]["affinity_misses"] == 2
    assert router["stats"]["affinity_hits"] == 2
    assert fleet.router.affinity_hit_rate() == 0.5
    for h in router["hosts"]:
        assert h["peak_assigned_bytes"] <= h["budget_bytes"]
    # the final fleet metrics.json was written by stop() from the
    # hosts' shutdown snapshots — the deterministic place to assert the
    # merged counters and the additive histogram fold (the live `snap`
    # depends on interval timing)
    with open(tmp_path / "fleet" / "metrics.json") as fh:
        final = json.load(fh)
    assert final["stats"]["served"] >= 4.0
    assert final["router"]["stats"]["placed"] == 4
    # merged hists fold both hosts' queue-wait distributions
    assert final["hists"]["queue_wait_ms"]["count"] >= 4
    twins = {
        a: _twin("markovStateTransitionModel", MST_CONF, [a],
                   str(tmp_path / "fa_ref.txt")),
        b: _twin("markovStateTransitionModel", MST_CONF, [b],
                   str(tmp_path / "fb_ref.txt")),
    }
    for i, corpus in enumerate([a, b, a, b]):
        with open(tmp_path / f"fo{i}.txt", "rb") as fa, \
                open(twins[corpus].outputs[0], "rb") as fb:
            assert fa.read() == fb.read()


def test_fleet_blocking_submit_sweeps_its_own_capacity(tmp_path):
    """A saturated single-threaded front must not livelock: a blocking
    submit sweeps finished results itself to free the budget vector,
    and the banked rows still arrive through their named collect."""
    csv = _seq(tmp_path)
    probe = _fleet(str(tmp_path / "probe"), hosts=1, env=_SUB_ENV)
    _req, priced, _cost = probe.price(_req_obj(csv, "x"))
    # budget fits exactly ONE request at a time
    fleet = _fleet(str(tmp_path / "fleet"), hosts=1,
                  budget_mb=priced * 1.5 / (1 << 20), env=_SUB_ENV)
    fleet.start()
    try:
        names = [fleet.submit(_req_obj(csv, str(tmp_path / f"sw{i}.txt"),
                                       tenant=f"t{i}"), timeout=240)
                 for i in range(3)]      # 2nd/3rd block until a sweep
        rows = fleet.collect(names, timeout=240)
    finally:
        codes = fleet.stop()
    assert codes == [0]
    assert sorted(rows) == sorted(names)
    assert all(r["ok"] for r in rows.values())
    snap = fleet.router.snapshot()
    assert snap["hosts"][0]["peak_assigned_bytes"] <= \
        snap["hosts"][0]["budget_bytes"]
    assert snap["hosts"][0]["assigned_bytes"] == 0   # all released


def test_fleet_cli_once(tmp_path):
    """`python -m avenir_tpu_torch fleet --root R --hosts 1 --once`: requests
    spooled into the FLEET root are routed, served, and answered in
    <root>/out with nonce namespacing; merged metrics land at the
    root."""
    csv = _seq(tmp_path)
    root = str(tmp_path / "froot")
    os.makedirs(os.path.join(root, "in"), exist_ok=True)
    drops = [("q1.json", _req_obj(csv, str(tmp_path / "fc.txt"),
                                  nonce="client7")),
             ("q2.json", {"job": "noSuchJob", "conf": {},
                          "inputs": [csv], "output": "x",
                          "nonce": "bad1"})]
    for name, req in drops:
        tmp = os.path.join(root, f"{name}.tmp")
        with open(tmp, "w") as fh:
            json.dump(req, fh)
        os.replace(tmp, os.path.join(root, "in", name))
    proc = subprocess.run(
        [sys.executable, "-m", "avenir_tpu_torch", "fleet", "--device", "cpu",
         "--root", root, "--hosts", "1", "--once", "--metrics-interval",
         "0.2"],
        cwd=REPO, env=_SUB_ENV, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 1, proc.stderr[-800:]   # 1 failed request
    with open(os.path.join(root, "out", "client7.q1.json")) as fh:
        row = json.load(fh)
    assert row["ok"] and row["nonce"] == "client7"
    # the FAILED request's row honors its nonce namespace too
    with open(os.path.join(root, "out", "bad1.q2.json")) as fh:
        bad = json.load(fh)
    assert not bad["ok"] and bad["nonce"] == "bad1"
    assert "noSuchJob" in bad["error"]
    with open(os.path.join(root, "metrics.json")) as fh:
        snap = json.load(fh)
    assert snap["router"]["stats"]["placed"] == 1
    # `stats` on a 1-host fleet root still renders the router section
    from avenir_tpu_torch.obs.report import stats_main

    assert stats_main([root]) == 0


def test_fleet_survives_host_sigkill(tmp_path):
    """The chaos contract at test scale: SIGKILL one host right after
    its requests were placed; supervision detects the death, requeues
    the stranded leases to the healthy host (zero lost), restarts the
    dead host, and every row is byte-identical to its solo twin (zero
    conflicting)."""
    a = _seq(tmp_path, seed=1, name="a.csv")
    b = _seq(tmp_path, seed=2, name="b.csv")
    policy = FaultPolicy(poll_interval_s=0.1, lease_ttl_s=1.0,
                         restart_backoff_base_s=0.2,
                         heartbeat_timeout_s=60.0, hedge=False)
    fleet = _fleet(str(tmp_path / "fleet"), hosts=2, workers=1,
                  env=_SUB_ENV, fault_policy=policy)
    fleet.start()
    try:
        names = {}
        for i, corpus in enumerate([a, b, a, b]):
            names[i] = fleet.submit(_req_obj(
                corpus, str(tmp_path / f"ck{i}.txt"), tenant=f"t{i}"))
        # corpus a's sticky host is 0 (first miss on an idle fleet)
        os.kill(fleet.host_pid(0), signal.SIGKILL)
        rows = fleet.collect(list(names.values()), timeout=240)
        assert all(r["ok"] for r in rows.values())
        snap = fleet.fault_snapshot()
        assert snap["stats"]["requeues"] >= 1       # leases swept over
        assert snap["leases_outstanding"] == 0      # ... and released
        _wait_for(lambda: fleet.fault_snapshot()["stats"]["restarts"]
                  >= 1 and fleet.host_state(0) == "serving", 120,
                  "killed host restarted and reintegrated")
    finally:
        codes = fleet.stop()
    # the surviving host drained gracefully; the restarted one may
    # still have been mid-boot when the TERM landed
    assert codes[1] == 0
    twins = {
        a: _twin("markovStateTransitionModel", MST_CONF, [a],
                   str(tmp_path / "cka_ref.txt")),
        b: _twin("markovStateTransitionModel", MST_CONF, [b],
                   str(tmp_path / "ckb_ref.txt")),
    }
    for i, corpus in enumerate([a, b, a, b]):
        with open(tmp_path / f"ck{i}.txt", "rb") as fa, \
                open(twins[corpus].outputs[0], "rb") as fb:
            assert fa.read() == fb.read()


def test_fleet_hedges_stalled_host(tmp_path):
    """Hedged tail dispatch: a SIGSTOPped host's queued request is
    mirrored to the least-loaded healthy host once its pending age
    blows past the fleet median, and the FIRST result wins — the fleet
    answers while the stalled original never finishes. After SIGCONT
    the late duplicate is an identical write, never a conflict."""
    csv = _seq(tmp_path)
    policy = FaultPolicy(poll_interval_s=0.1, hedge_multiple=2.0,
                         hedge_floor_ms=300.0, lease_ttl_s=3600.0,
                         heartbeat_timeout_s=3600.0)
    fleet = _fleet(str(tmp_path / "fleet"), hosts=2, workers=1,
                  env=_SUB_ENV, fault_policy=policy)
    fleet.start()
    try:
        # warm both hosts: each needs a MEASURED served tail (the
        # hedge gate) and resident compiles
        warm = [fleet.submit_to(h, _req_obj(
            csv, str(tmp_path / f"wh{h}.txt"))) for h in (0, 1)]
        fleet.collect(warm, timeout=240)
        # the hedge gate reads the SERVED tail from each host's
        # heartbeat snapshot: let both heartbeats catch up with the
        # warmups before freezing one (a stopped host can never
        # refresh its own)
        _wait_for(lambda: all(n >= 1 for _p, n in
                              fleet._rolled_p99().values()), 60,
                  "host heartbeats reflect the served warmups")
        os.kill(fleet.host_pid(0), signal.SIGSTOP)
        try:
            # fresh corpus on an idle fleet routes to host 0 — which
            # is stopped and will never serve it
            name = fleet.submit(_req_obj(csv, str(tmp_path / "hg.txt"),
                                         tenant="hg"))
            rows = fleet.collect([name], timeout=240)
            assert rows[name]["ok"]
            assert fleet.router.stats["hedges"] >= 1
            # the stall never looked like a death: no requeue, no
            # restart — hedging alone carried the tail
            snap = fleet.fault_snapshot()
            assert snap["stats"]["requeues"] == 0
            assert snap["stats"]["restarts"] == 0
            assert fleet.host_state(0) == "serving"
        finally:
            os.kill(fleet.host_pid(0), signal.SIGCONT)
    finally:
        codes = fleet.stop()
    assert codes == [0, 0]        # SIGCONT'd host drained gracefully
    twin = _twin("markovStateTransitionModel", MST_CONF, [csv],
                   str(tmp_path / "hg_ref.txt"))
    # byte-identical even though BOTH copies may have run (the resumed
    # original rewrites the same bytes — zero conflicting results)
    with open(tmp_path / "hg.txt", "rb") as fa, \
            open(twin.outputs[0], "rb") as fb:
        assert fa.read() == fb.read()


def test_stranded_lease_after_restart_respools(tmp_path):
    """The restart gap: a claim taken by a DEAD incarnation sits in
    its old work/ dir, which the restarted host never re-adopts. The
    lease sweep must detect a lease predating the current incarnation
    — and with no other host to requeue to, re-spool the request into
    the restarted host's own in/, riding the original budget charge
    (released exactly once when the result lands)."""

    class FakeProc:
        pid = 4242

        def poll(self):
            return None

    csv = _seq(tmp_path, rows=50)
    fleet = _fleet(str(tmp_path / "fleet"), hosts=1,
                  fault_policy=FaultPolicy(hedge=False))
    for sub in ("in", "out", "work"):
        os.makedirs(os.path.join(fleet.host_dirs[0], sub),
                    exist_ok=True)
    with fleet._lock:
        fleet._procs[0] = FakeProc()
    obj = _req_obj(csv, str(tmp_path / "st.txt"))
    req, priced, cost = fleet.price(obj)
    placement = fleet.router.assign_to(0, affinity_key(req), priced,
                                       cost)
    name = fleet._spool_to(placement, obj)
    entry = fleet._outstanding[name]
    spool_file = os.path.join(fleet.host_dirs[0], "in",
                              entry.copies[0].name)
    # restart happened AFTER the lease was claimed, but the spooled
    # file still sits in in/: the new incarnation will claim it, so
    # the sweep restamps instead of moving the request
    with fleet._lock:
        fleet._spawned_at[0] = entry.lease.claimed_at + 10.0
    fleet._sweep_leases(time.time() + 20.0)
    assert fleet.fault_snapshot()["stats"]["respools"] == 0
    assert os.path.exists(spool_file)
    # now the claim is GONE from in/ (the dead incarnation took it to
    # its grave): the sweep must re-spool — requeueing is impossible,
    # every other host is on the lease's exclusion trail
    os.remove(spool_file)
    with fleet._lock:
        fleet._spawned_at[0] = time.time() + 100.0
    fleet._sweep_leases(time.time() + 200.0)
    snap = fleet.fault_snapshot()
    assert snap["stats"]["respools"] == 1
    assert snap["stats"]["requeues"] == 0
    new_copy = fleet._outstanding[name].copies[-1]
    assert os.path.exists(os.path.join(fleet.host_dirs[0], "in",
                                       new_copy.name))
    # a row landing on the re-spooled copy completes the request and
    # releases the SINGLE shared budget charge exactly once
    with open(new_copy.out_path + ".tmp", "w") as fh:
        json.dump({"ok": True}, fh)
    os.replace(new_copy.out_path + ".tmp", new_copy.out_path)
    rows = fleet.collect([name], timeout=30)
    assert rows[name]["ok"]
    host = fleet.router.snapshot()["hosts"][0]
    assert host["assigned_bytes"] == 0
    assert host["assigned_requests"] == 0
    assert fleet.fault_snapshot()["leases_outstanding"] == 0


def _stranded_two_host_fleet(tmp_path, alive):
    """A 2-host fleet with stand-in processes and ONE outstanding
    request whose attempt trail already covers both hosts, lease held
    by host 1. ``alive`` flags which hosts have a live process."""

    class FakeProc:
        pid = 4242

        def poll(self):
            return None

    csv = _seq(tmp_path, rows=50)
    fleet = _fleet(str(tmp_path / "fleet"), hosts=2,
                  fault_policy=FaultPolicy(hedge=False))
    for h in range(2):
        for sub in ("in", "out", "work"):
            os.makedirs(os.path.join(fleet.host_dirs[h], sub),
                        exist_ok=True)
    with fleet._lock:
        fleet._procs = [FakeProc() if alive[h] else None
                        for h in range(2)]
        fleet._spawned_at = [time.time() - 1.0] * 2
        fleet._spawned_mono = [time.monotonic() - 1.0] * 2
    obj = _req_obj(csv, str(tmp_path / "stranded.txt"))
    req, priced, cost = fleet.price(obj)
    name = fleet._spool_to(
        fleet.router.assign_to(0, affinity_key(req), priced, cost), obj)
    entry = fleet._outstanding[name]
    # simulate the earlier requeue that put host 1 on the trail: a
    # second copy spooled at host 1, lease moved there
    copy = fleet._write_copy(
        fleet.router.assign_to(1, affinity_key(req), priced, cost),
        fleet._next_name(), obj)
    entry.copies.append(copy)
    entry.lease.host = 1
    entry.lease.hosts = [0, 1]
    fleet._leases.write(entry.lease)
    return fleet, name, entry


def test_stranded_request_respools_to_healthy_trail_host(tmp_path):
    """The stranded-request hang: a request whose attempt trail covers
    EVERY host can neither requeue (all hosts excluded) nor pass the
    max_requeues cap (attempts only grows on successful moves) when
    its lease host is dead — it used to sit until the collect()
    timeout. The sweep must respool it to a healthy trail host
    in-band: re-execution is safe by the idempotency contract."""
    from avenir_tpu_torch.net import fault

    fleet, name, entry = _stranded_two_host_fleet(
        tmp_path, alive=[True, False])
    with fleet._lock:
        fleet._host_state[1] = fault.RESTARTING   # host 1 died
    fleet._sweep_leases(time.time())
    snap = fleet.fault_snapshot()
    assert snap["stats"]["respools"] == 1
    assert snap["stats"]["requeues"] == 0
    assert snap["stats"]["abandoned"] == 0
    assert entry.lease.host == 0        # moved to the healthy trail host
    new_copy = entry.copies[-1]
    assert new_copy.placement.host == 0
    assert os.path.exists(os.path.join(fleet.host_dirs[0], "in",
                                       new_copy.name))
    # a row on the respooled copy completes the request; the shared
    # budget charges release exactly once each
    with open(new_copy.out_path + ".tmp", "w") as fh:
        json.dump({"ok": True}, fh)
    os.replace(new_copy.out_path + ".tmp", new_copy.out_path)
    rows = fleet.collect([name], timeout=30)
    assert rows[name]["ok"]
    for h in range(2):
        host = fleet.router.snapshot()["hosts"][h]
        assert host["assigned_bytes"] == 0
    assert fleet.fault_snapshot()["leases_outstanding"] == 0


def test_stranded_request_abandons_in_band_when_no_host_left(tmp_path):
    """Same trail-exhausted shape, but NO healthy host remains (lease
    host dead, the other quarantined): the request must resolve as an
    in-band failure row — collect() returns it instead of hanging to
    its timeout."""
    from avenir_tpu_torch.net import fault

    fleet, name, entry = _stranded_two_host_fleet(
        tmp_path, alive=[False, False])
    with fleet._lock:
        fleet._host_state = [fault.QUARANTINED, fault.QUARANTINED]
    fleet._sweep_leases(time.time())
    snap = fleet.fault_snapshot()
    assert snap["stats"]["abandoned"] == 1
    assert snap["stats"]["respools"] == 0
    assert snap["leases_outstanding"] == 0
    rows = {name: fleet._collected[name]}
    assert rows[name]["ok"] is False
    assert "stranded" in rows[name]["error"]


def test_stranded_request_waits_for_recovering_trail_host(tmp_path):
    """Trail exhausted but a trail host is RESTARTING: neither respool
    (nobody healthy yet) nor abandon (it may come back) — the sweep
    waits, then respools once the host serves again."""
    from avenir_tpu_torch.net import fault

    fleet, name, entry = _stranded_two_host_fleet(
        tmp_path, alive=[False, False])
    with fleet._lock:
        fleet._host_state = [fault.RESTARTING, fault.RESTARTING]
    fleet._sweep_leases(time.time())
    snap = fleet.fault_snapshot()
    assert snap["stats"]["abandoned"] == 0
    assert snap["stats"]["respools"] == 0
    # host 0 comes back: the next sweep respools onto it

    class FakeProc:
        pid = 4242

        def poll(self):
            return None

    with fleet._lock:
        fleet._procs[0] = FakeProc()
        fleet._host_state[0] = fault.SERVING
    fleet._sweep_leases(time.time())
    assert fleet.fault_snapshot()["stats"]["respools"] == 1
    assert entry.lease.host == 0


def test_stranded_request_patience_bounds_the_wait(tmp_path):
    """Permanently wedged recovery: when the only hosts left stay
    RESTARTING/STALLED forever (a stall never respawns — only an exit
    code does), the stranded wait is bounded by stranded_patience_s,
    after which the request abandons in-band instead of riding the
    collect() timeout."""
    from avenir_tpu_torch.net import fault

    fleet, name, entry = _stranded_two_host_fleet(
        tmp_path, alive=[False, False])
    with fleet._lock:
        fleet._host_state = [fault.STALLED, fault.RESTARTING]
    t0 = time.time()
    m0 = time.monotonic()
    fleet._sweep_leases(t0, mono=m0)     # starts the patience clock
    assert fleet.fault_snapshot()["stats"]["abandoned"] == 0
    assert entry.stranded_at is not None
    # patience is measured on the monotonic clock (a wall step must
    # never stretch or collapse it): advance mono past the bound
    fleet._sweep_leases(
        t0 + fleet.fault.stranded_patience_s + 1.0,
        mono=m0 + fleet.fault.stranded_patience_s + 1.0)
    snap = fleet.fault_snapshot()
    assert snap["stats"]["abandoned"] == 1
    assert snap["leases_outstanding"] == 0
    assert fleet._collected[name]["ok"] is False


def test_wall_clock_step_never_collapses_stranded_patience(tmp_path):
    """Two-clock discipline regression (graftlint --proto): stranded
    patience runs on the MONOTONIC clock, so an injected wall-clock
    step (NTP slam, +10000 s) must not abandon a stranded request
    early — only the monotonic clock crossing the bound may."""
    from avenir_tpu_torch.net import fault

    fleet, name, entry = _stranded_two_host_fleet(
        tmp_path, alive=[False, False])
    with fleet._lock:
        fleet._host_state = [fault.STALLED, fault.RESTARTING]
    t0 = time.time()
    m0 = time.monotonic()
    fleet._sweep_leases(t0, mono=m0)     # starts the patience clock
    assert entry.stranded_at is not None
    # the step: wall leaps four hours, monotonic advances one second
    fleet._sweep_leases(t0 + 10000.0, mono=m0 + 1.0)
    assert fleet.fault_snapshot()["stats"]["abandoned"] == 0
    assert fleet.fault_snapshot()["leases_outstanding"] == 1
    # real elapsed time (monotonic) past the bound is what abandons
    fleet._sweep_leases(
        t0 + 10000.0,
        mono=m0 + fleet.fault.stranded_patience_s + 1.0)
    assert fleet.fault_snapshot()["stats"]["abandoned"] == 1


def test_wall_clock_step_never_fires_restart_backoff_early(
        tmp_path, monkeypatch):
    """Same discipline, the supervisor's restart backoff: a wall-clock
    step must neither fire the respawn early nor push it out — the
    backoff window is monotonic elapsed time."""

    class FakeProc:
        pid = 4242

        def __init__(self, rc=None):
            self.rc = rc

        def poll(self):
            return self.rc

    policy = FaultPolicy(poll_interval_s=0.05, max_restarts=3,
                         restart_backoff_base_s=5.0, hedge=False)
    fleet = _fleet(str(tmp_path / "fleet"), hosts=1, fault_policy=policy)
    spawned = []

    def fake_spawn(i):
        spawned.append(i)
        with fleet._lock:
            fleet._procs[i] = FakeProc()
            fleet._spawned_at[i] = time.time()
            fleet._spawned_mono[i] = time.monotonic()

    monkeypatch.setattr(fleet, "_spawn_host", fake_spawn)
    t0 = time.time()
    m0 = time.monotonic()
    with fleet._lock:
        fleet._procs[0] = FakeProc(rc=137)           # dead on arrival
        fleet._spawned_at = [t0]
        fleet._spawned_mono = [m0]
    fleet._supervise_hosts(t0, mono=m0)              # death -> backoff
    assert fleet.host_state(0) == "restarting" and spawned == []
    # wall leaps past any backoff; monotonic has barely moved: no fire
    fleet._supervise_hosts(t0 + 10000.0, mono=m0 + 1.0)
    assert spawned == []
    # monotonic elapses the 5 s backoff: the respawn fires now
    fleet._supervise_hosts(t0 + 10000.0, mono=m0 + 6.0)
    assert spawned == [0]
    assert fleet.fault_snapshot()["stats"]["restarts"] == 1


def test_probe_healthz_drives_listener_host_heartbeat(tmp_path):
    """fault.probe_healthz wired into the supervisor tick: a host
    registered with a listen address heartbeats through /healthz —
    a "serving" answer keeps it placeable, a quarantined overlay (or
    a dead listener) marks it stalled, recovery reinstates it. Driven
    through the real _supervise_hosts against a fake listener."""
    import http.server
    import threading

    from avenir_tpu_torch.net import fault

    status = {"value": "serving"}

    class _Healthz(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps({"status": status["value"]}).encode()
            code = 200 if status["value"] == "serving" else 503
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Healthz)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    addr = f"http://127.0.0.1:{httpd.server_address[1]}"

    class FakeProc:
        pid = 4242

        def poll(self):
            return None

    try:
        fleet = _fleet(str(tmp_path / "fleet"), hosts=1,
                      fault_policy=FaultPolicy(hedge=False,
                                               heartbeat_timeout_s=0.1),
                      listen_addresses={0: addr})
        with fleet._lock:
            fleet._procs[0] = FakeProc()
            # well past the boot grace: the probe is the heartbeat now
            fleet._spawned_at[0] = time.time() - 60.0
            fleet._spawned_mono[0] = time.monotonic() - 60.0
        # each check advances the monotonic clock past the probe memo
        # window (the supervisor re-probes at most every hb_timeout/2,
        # so wedged listeners cannot stall every tick)
        now = time.time()
        m0 = time.monotonic()
        step = fleet._hb_timeout
        fleet._supervise_hosts(now, mono=m0)
        assert fleet.host_state(0) == "serving"
        # the host's own listener reports quarantined (its overlay):
        # the front marks it stalled — no placements land on it
        status["value"] = "quarantined"
        fleet._supervise_hosts(now + step, mono=m0 + step)
        assert fleet.host_state(0) == "stalled"
        assert fleet.router.snapshot()["hosts"][0]["state"] == "stalled"
        # recovery: a serving probe reinstates placement
        status["value"] = "serving"
        fleet._supervise_hosts(now + 2 * step, mono=m0 + 2 * step)
        assert fleet.host_state(0) == "serving"
        # a dead listener (probe refused) is stalled too — the
        # exit-code check stays the authority on actual death
        httpd.shutdown()
        httpd.server_close()
        fleet._supervise_hosts(now + 3 * step, mono=m0 + 3 * step)
        assert fleet.host_state(0) == "stalled"
    finally:
        try:
            httpd.shutdown()
            httpd.server_close()
        except Exception:
            pass
        thread.join(10)


def test_requeued_refresh_cold_fallback(tmp_path):
    """Crash-resume composition: a refresh request landing on a host
    WITHOUT the corpus's checkpoint (what a lease requeue does after
    the warm host dies) falls back to the cold scan — never a wrong
    resume — and still writes byte-identical output."""
    csv = _seq(tmp_path, rows=400)
    fleet = _fleet(str(tmp_path / "fleet"), hosts=2, workers=1,
                  env=_SUB_ENV)
    fleet.start()
    try:
        # cold seed on the sticky host (host 0: first miss), writing
        # its managed checkpoint
        n1 = fleet.submit(_req_obj(csv, str(tmp_path / "rf1.txt"),
                                   mode="refresh"))
        r1 = fleet.collect([n1], timeout=240)[n1]
        assert r1["ok"]
        assert r1["counters"]["Resume:SkippedBytes"] == 0
        # warm repeat on the SAME host restores the carry
        n2 = fleet.submit(_req_obj(csv, str(tmp_path / "rf2.txt"),
                                   mode="refresh"))
        r2 = fleet.collect([n2], timeout=240)[n2]
        assert r2["ok"] and r2["counters"]["Resume:SkippedBytes"] > 0
        # the requeue shape: the same refresh forced onto the OTHER
        # host finds no local checkpoint -> cold scan, not a wrong
        # resume
        n3 = fleet.submit_to(1, _req_obj(csv, str(tmp_path / "rf3.txt"),
                                         mode="refresh"))
        r3 = fleet.collect([n3], timeout=240)[n3]
        assert r3["ok"] and r3["counters"]["Resume:SkippedBytes"] == 0
    finally:
        codes = fleet.stop()
    assert codes == [0, 0]
    twin = _twin("markovStateTransitionModel", MST_CONF, [csv],
                   str(tmp_path / "rf_ref.txt"))
    for out in ("rf1.txt", "rf2.txt", "rf3.txt"):
        with open(tmp_path / out, "rb") as fa, \
                open(twin.outputs[0], "rb") as fb:
            assert fa.read() == fb.read()


def test_stats_merges_snapshots_and_fleet_dirs(tmp_path):
    from avenir_tpu_torch.obs.report import (expand_metrics_paths,
                                       merge_snapshots, render_metrics,
                                       stats_main)

    csv = _seq(tmp_path)
    paths = []
    for i in range(2):
        mp = str(tmp_path / f"host{i}" / "metrics.json")
        os.makedirs(os.path.dirname(mp), exist_ok=True)
        srv = JobServer(workers=1, metrics_path=mp,
                        state_root=str(tmp_path / f"state{i}"), device=CPU)
        t = srv.submit(JobRequest(
            "markovStateTransitionModel", MST_CONF, [csv],
            str(tmp_path / f"m{i}.txt"), tenant=f"t{i}"))
        with srv:
            t.result(240)
        paths.append(mp)
    snaps = [json.load(open(p)) for p in paths]
    merged = merge_snapshots(snaps)
    assert merged["hosts"] == 2
    assert merged["stats"]["served"] == 2.0
    # the histograms merged ADDITIVELY: merged count = sum of counts
    assert merged["hists"]["queue_wait_ms"]["count"] == sum(
        s["hists"]["queue_wait_ms"]["count"] for s in snaps)
    assert merged["hists"]["queue_wait_ms"]["max"] == max(
        s["hists"]["queue_wait_ms"]["max"] for s in snaps)
    text = render_metrics(merged)
    assert "2 hosts merged" in text
    # the CLI: N explicit paths, and the fleet-root glob, both exit 0
    assert stats_main(paths) == 0
    assert stats_main([str(tmp_path)]) == 0          # host*/ glob
    assert stats_main(paths + ["--json"]) == 0
    assert stats_main([str(tmp_path / "nope")]) == 2
    assert expand_metrics_paths([str(tmp_path)]) == paths


def test_fleet_load_harness_inproc(tmp_path, capsys):
    from avenir_tpu_torch.tools import fleet_load
    rc = fleet_load.main(["--requests", "4", "--tenants", "3",
                          "--corpora", "2", "--rows", "200",
                          "--rate", "50", "--arms", "inproc",
                          "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["offered_jobs_per_min"] > 0
    arm = lines[1]
    assert arm["arm"] == "inproc"
    assert arm["served"] == 4 and arm["shed"] == 0
    assert arm["lost_requests"] == 0 and arm["retries"] == 0
    assert arm["jobs_per_min"] > 0
    assert arm["p99_queue_wait_ms"] >= arm["p50_queue_wait_ms"] >= 0.0
    # the shed-retry backoff: Retry-After analog doubled per attempt,
    # capped, ±20% jittered — the client half of the 429 contract
    rng = np.random.default_rng(0)
    first = [fleet_load._backoff_s(0, rng) for _ in range(16)]
    assert all(0.8 <= v <= 1.2 for v in first)
    assert min(first) < max(first)            # jittered, not lockstep
    assert all(6.4 <= fleet_load._backoff_s(9, rng) <= 9.6
               for _ in range(4))             # capped at 8s nominal


def test_fleet_load_harness_retries_sheds(monkeypatch):
    """A shed request is retried with backoff until served, never
    dropped: the fleet arm reports shed>0, retries>0 and
    lost_requests==0 — the soak contract."""
    import types

    from avenir_tpu_torch.tools import fleet_load

    class FakeRouter:
        def affinity_hit_rate(self):
            return 1.0

    class FakeFleet:
        def __init__(self, root, hosts=2, workers=1, budget_mb=0.0,
                     device=None):
            self.router = FakeRouter()
            self.n = 0
            self.sheds_left = 2

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

        def submit(self, obj, block=True, count_held=True):
            if self.sheds_left > 0:
                self.sheds_left -= 1
                return None
            self.n += 1
            return f"r{self.n}"

        def collect(self, names, timeout=0.0):
            return {n: {"ok": True} for n in names}

        def merged_metrics(self):
            return {"hists": {}}

    monkeypatch.setattr("avenir_tpu_torch.net.fleet.Fleet", FakeFleet)
    args = types.SimpleNamespace(workers=1, budget_mb=1.0, seed=3,
                                 drain_timeout=30.0, device=CPU)
    load = [(0.0, {"i": i}) for i in range(3)]
    row = fleet_load.run_fleet(args, load, hosts=2)
    assert row["shed"] == 2 and row["retries"] >= 2
    assert row["served"] == 3 and row["lost_requests"] == 0
