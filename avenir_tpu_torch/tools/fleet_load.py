"""Open-loop load harness for the job-server fleet.

The port of `tools/fleet_load.py`; every server, fleet host and training
run goes on ``--device`` (default cuda; ``cpu`` runs the plain versions
of the kernels).

Synthetic tenants fire requests at the serving surface the way real
traffic does — on a Poisson arrival clock that does NOT wait for
completions (open loop: a slow server faces the same offered load as a
fast one, so queue-wait tails are honest), over a corpus population
with Zipfian popularity (a few hot corpora, a long cold tail — the
distribution that makes warm-affinity routing matter).

Arms:

- ``inproc``  — one in-process JobServer (no subprocess, the fast arm
  for tests and tier-1).
- ``solo``    — a 1-host fleet: one ``serve --spool`` subprocess.
- ``fleet``   — an N-host fleet behind the affinity router.
- ``query``   — QUERY-shaped traffic (PR 20): mixed ``POST /score``
  + job submits against ``--hosts`` in-process listener pairs, score
  routing by MODEL affinity through :class:`net.fleet.ScoreFront`.
  Model popularity is Zipf (hot models stay warm on their pinned
  host), arrivals are the same open-loop Poisson clock, and
  ``--score-fraction`` of arrivals are scores. Reports score p50/p99
  (folded from the servers' merged per-model ``score_*_total_ms``
  histograms) NEXT TO jobs/min — the queries-are-jobs-too view.

Per arm it prints ONE JSON line: offered vs served jobs/min, p50/p99
queue wait and p99 chunk latency (the PR 10 histograms, read from the
server's merged metrics — never recomputed client-side), shed count
(fleet arms shed when every host is over its budget-vector entry), the
retry count, a ``lost_requests`` column that MUST be zero, and the
router's affinity hit rate.

Shed handling honors the edge's shed contract the way a well-behaved
client does: a shed request is NOT dropped — it backs off by the
Retry-After hint with capped exponential growth and ±20% jitter (the
listener's own jitter policy, so a cohort of shed harness tenants does
not retry in lockstep) and resubmits until served. That makes every
load run double as a soak test: offered = served + failed, always, and
``lost_requests`` (offered minus accounted) is asserted 0 by the exit
code.

    python -m avenir_tpu_torch.tools.fleet_load --requests 40 \
        --tenants 20 --corpora 6 --rows 2000 --rate 5 \
        --arms inproc,fleet --hosts 2 [--device cpu]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

MST_CONF = {"mst.model.states": "L,M,H",
            "mst.class.label.field.ord": "1",
            "mst.skip.field.count": "2",
            "mst.class.labels": "T,F"}

#: the scoring view of the same classifier (server/score.py conf keys)
MARKOV_SCORE_CONF = {"field.delim": ",", "class.labels": "T,F",
                     "log.odds.threshold": "0", "skip.field.count": "2"}


def write_corpus(path: str, rows: int, seed: int) -> None:
    """A small markov-sequence corpus (the cheap byte-fold workload)."""
    rng = np.random.default_rng(seed)
    states = ["L", "M", "H"]
    with open(path, "w") as fh:
        for i in range(rows):
            up = i % 2 == 0
            s, toks = 1, []
            for _ in range(6):
                p = [0.1, 0.3, 0.6] if up else [0.6, 0.3, 0.1]
                s = int(np.clip(s + rng.choice([-1, 0, 1], p=p), 0, 2))
                toks.append(states[s])
            fh.write(f"c{i},{'T' if up else 'F'}," + ",".join(toks) + "\n")


def plan_load(args, corpora, out_dir):
    """The open-loop schedule: (arrival_s, request_obj) rows, fixed by
    the seed BEFORE any arm runs so every arm faces the identical
    offered load. Corpus popularity is Zipf(s) over the corpus list;
    arrivals are Poisson at --rate req/s."""
    rng = np.random.default_rng(args.seed)
    ranks = np.arange(1, len(corpora) + 1, dtype=float)
    pmf = ranks ** -args.zipf_s
    pmf /= pmf.sum()
    gaps = rng.exponential(1.0 / args.rate, size=args.requests)
    arrivals = np.cumsum(gaps)
    load = []
    for i in range(args.requests):
        corpus = corpora[int(rng.choice(len(corpora), p=pmf))]
        tenant = f"t{int(rng.integers(args.tenants)):04d}"
        load.append((float(arrivals[i]), {
            "job": "markovStateTransitionModel", "conf": MST_CONF,
            "inputs": [corpus],
            "output": os.path.join(out_dir, f"out_{i:05d}.txt"),
            "tenant": tenant,
        }))
    return load


def _hist_stats(hists, name):
    h = hists.get(name) or {}
    return {f"p50_{name}": h.get("p50", 0.0),
            f"p99_{name}": h.get("p99", 0.0)}


def run_inproc(args, load):
    from avenir_tpu_torch.server import JobRequest, JobServer
    from avenir_tpu_torch.server.spool import request_from_json

    with tempfile.TemporaryDirectory(prefix="fleet_load_state_") as sr:
        server = JobServer(workers=args.workers, state_root=sr,
                           device=args.device).start()
        tickets = []
        t0 = time.perf_counter()
        for arrival, obj in load:
            _sleep_until(t0, arrival)
            tickets.append(server.submit(request_from_json(obj)))
        server.drain(timeout=args.drain_timeout)
        wall = time.perf_counter() - t0
        served = sum(1 for t in tickets if _ok(t))
        stats = server.stats()
        server.shutdown()
    row = {"arm": "inproc", "hosts": 1, "served": served, "shed": 0,
           "retries": 0,
           "lost_requests": len(load) - len(tickets),
           "wall_s": round(wall, 2),
           "jobs_per_min": round(served / (wall / 60.0), 2)}
    row.update(_hist_stats(stats["hists"], "queue_wait_ms"))
    return row


def _ok(ticket):
    try:
        ticket.result(timeout=0)
        return True
    except BaseException:  # noqa: BLE001 — the count IS the report
        return False


#: shed-retry backoff: the Retry-After analog of the listener edge
#: (its EdgePolicy default), doubled per attempt, capped, ±20% jitter
RETRY_AFTER_S = 1.0
RETRY_CAP_S = 8.0
RETRY_JITTER = 0.2


def _backoff_s(attempt, rng):
    """Capped-jittered backoff before retry `attempt` (0-based) of a
    shed request — the client half of the edge's Retry-After contract."""
    nominal = min(RETRY_AFTER_S * (2.0 ** attempt), RETRY_CAP_S)
    return nominal * rng.uniform(1.0 - RETRY_JITTER, 1.0 + RETRY_JITTER)


def run_fleet(args, load, hosts):
    from avenir_tpu_torch.net.fleet import Fleet

    root = tempfile.mkdtemp(prefix=f"fleet_load_{hosts}h_")
    fleet = Fleet(root, hosts=hosts, workers=args.workers,
                  budget_mb=args.budget_mb, device=args.device)
    rng = np.random.default_rng(args.seed + 1)
    shed = retries = 0
    names = []
    #: shed requests waiting out their backoff: (due_s, attempt, obj)
    parked = []

    def pump(now_s):
        """Resubmit every parked request whose backoff elapsed."""
        nonlocal shed, retries
        due = [p for p in parked if p[0] <= now_s]
        for item in due:
            parked.remove(item)
            _due, attempt, obj = item
            retries += 1
            name = fleet.submit(obj, block=False, count_held=False)
            if name is None:
                parked.append((now_s + _backoff_s(attempt + 1, rng),
                               attempt + 1, obj))
            else:
                names.append(name)

    with fleet:
        t0 = time.perf_counter()
        for arrival, obj in load:
            _sleep_until(t0, arrival)
            pump(time.perf_counter() - t0)
            # open loop: a fleet with no budget headroom sheds the
            # arrival (the listener's 429 analog) — the harness backs
            # off and retries like a well-behaved client, so the run
            # doubles as a soak test: nothing is ever dropped
            name = fleet.submit(obj, block=False)
            if name is None:
                shed += 1
                parked.append((time.perf_counter() - t0
                               + _backoff_s(0, rng), 0, obj))
            else:
                names.append(name)
        deadline = time.perf_counter() + args.drain_timeout
        while parked:
            if time.perf_counter() > deadline:
                break              # lost_requests column goes nonzero
            pump(time.perf_counter() - t0)
            time.sleep(0.05)
        try:
            rows = fleet.collect(names, timeout=args.drain_timeout)
        except TimeoutError:
            # a submitted request that never completed is exactly the
            # loss the lost_requests column exists to report — collect
            # what DID land and let the column (and rc=1) say the rest
            done = [n for n in fleet.ready() if n in set(names)]
            rows = fleet.collect(done, timeout=30.0) if done else {}
        wall = time.perf_counter() - t0
        snap = fleet.merged_metrics()
        hit_rate = fleet.router.affinity_hit_rate()
    served = sum(1 for r in rows.values() if r.get("ok"))
    row = {"arm": "fleet" if hosts > 1 else "solo", "hosts": hosts,
           "served": served, "shed": shed, "retries": retries,
           "lost_requests": len(load) - len(rows),
           "wall_s": round(wall, 2),
           "jobs_per_min": round(served / (wall / 60.0), 2),
           "affinity_hit_rate": round(hit_rate, 3)}
    row.update(_hist_stats(snap.get("hists", {}), "queue_wait_ms"))
    row.update(_hist_stats(snap.get("hists", {}), "chunk_latency_ms"))
    return row


def _sleep_until(t0, arrival):
    delay = arrival - (time.perf_counter() - t0)
    if delay > 0:
        time.sleep(delay)


# ------------------------------------------------------------ query arm
def train_models(corpora, work, device=None):
    """One markov classifier per corpus — the model POPULATION the
    Zipf popularity draw runs over."""
    from avenir_tpu_torch.runner import run_job

    models = []
    for i, corpus in enumerate(corpora):
        path = os.path.join(work, f"model_{i:03d}.txt")
        run_job("markovStateTransitionModel", dict(MST_CONF), [corpus],
                path, device=device)
        models.append(path)
    return models


def plan_query_load(args, corpora, models, out_dir):
    """The mixed schedule: (arrival_s, ("score", model, row)) or
    (arrival_s, ("job", request_obj)) — model popularity Zipf(s),
    arrivals Poisson, ``--score-fraction`` of arrivals are scores.
    Fixed by the seed before any arm runs (the plan_load contract)."""
    rng = np.random.default_rng(args.seed + 2)
    ranks = np.arange(1, len(models) + 1, dtype=float)
    pmf = ranks ** -args.zipf_s
    pmf /= pmf.sum()
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate,
                                         size=args.requests))
    rows_by_model = []
    for corpus in corpora:
        with open(corpus) as fh:
            rows_by_model.append([ln.rstrip("\n") for ln in fh][:512])
    load = []
    for i in range(args.requests):
        if rng.random() < args.score_fraction:
            m = int(rng.choice(len(models), p=pmf))
            row = rows_by_model[m][int(rng.integers(
                len(rows_by_model[m])))]
            load.append((float(arrivals[i]), ("score", models[m], row)))
        else:
            corpus = corpora[int(rng.choice(len(corpora), p=pmf))]
            load.append((float(arrivals[i]), ("job", {
                "job": "markovStateTransitionModel", "conf": MST_CONF,
                "inputs": [corpus],
                "output": os.path.join(out_dir, f"qout_{i:05d}.txt"),
                "tenant": f"t{int(rng.integers(args.tenants)):04d}",
            })))
    return load


def _score_hist(snap):
    """Fold every per-model ``score_*_total_ms`` raw histogram into ONE
    end-to-end score-latency distribution (the exact-merge algebra —
    client-side we only fold, never recompute)."""
    from avenir_tpu_torch.obs.histogram import LatencyHistogram

    h = LatencyHistogram()
    for name, raw in (snap.get("hists_raw") or {}).items():
        if name.startswith("score_") and name.endswith("_total_ms"):
            h.merge(LatencyHistogram.from_dict(raw))
    return h.summary()


def run_query(args, qload, hosts):
    from avenir_tpu_torch.net.fleet import FleetError, ScoreFront
    from avenir_tpu_torch.net.listener import NetListener
    from avenir_tpu_torch.obs.report import merge_snapshots
    from avenir_tpu_torch.server import JobServer
    from avenir_tpu_torch.server.spool import request_from_json

    import tempfile as _tf
    import threading

    roots = [_tf.mkdtemp(prefix=f"query_load_h{i}_")
             for i in range(hosts)]
    servers = [JobServer(workers=args.workers, state_root=r,
                         device=args.device).start()
               for r in roots]
    listeners = [NetListener(s, port=0).start() for s in servers]
    score_errors = 0
    err_lock = threading.Lock()
    tickets, threads = [], []
    try:
        front = ScoreFront([f"http://127.0.0.1:{lis.port}"
                            for lis in listeners])

        def one_score(model, row):
            nonlocal score_errors
            try:
                front.score("markov", model, row,
                            conf=dict(MARKOV_SCORE_CONF))
            except (FleetError, OSError):
                with err_lock:
                    score_errors += 1

        t0 = time.perf_counter()
        for arrival, item in qload:
            _sleep_until(t0, arrival)
            if item[0] == "score":
                # open loop: the arrival never waits for the answer
                t = threading.Thread(target=one_score,
                                     args=(item[1], item[2]))
                t.start()
                threads.append(t)
            else:
                srv = servers[len(tickets) % hosts]
                tickets.append(srv.submit(request_from_json(item[1])))
        for t in threads:
            t.join(args.drain_timeout)
        for srv in servers:
            srv.drain(timeout=args.drain_timeout)
        wall = time.perf_counter() - t0
        served = sum(1 for t in tickets if _ok(t))
        snap = merge_snapshots([s.metrics_snapshot() for s in servers])
        hit_rate = front.router.affinity_hit_rate()
        front.close()
    finally:
        for lis in listeners:
            lis.stop()
        for srv in servers:
            srv.shutdown()
    scores = sum(1 for _a, item in qload if item[0] == "score")
    jobs = len(qload) - scores
    sh = _score_hist(snap)
    score_section = snap.get("score") or {}
    stats = score_section.get("stats", {})
    row = {"arm": "query", "hosts": hosts, "scores": scores,
           "jobs": jobs, "served_jobs": served,
           "score_errors": score_errors,
           "lost_requests": (jobs - len(tickets))
           + (scores - int(sh.get("count", 0)) - score_errors),
           "wall_s": round(wall, 2),
           "jobs_per_min": round(served / (wall / 60.0), 2),
           "scores_per_s": round(
               int(sh.get("count", 0)) / max(wall, 1e-9), 2),
           "score_p50_ms": round(sh.get("p50", 0.0), 3),
           "score_p99_ms": round(sh.get("p99", 0.0), 3),
           "score_predict_calls": int(stats.get("predict_calls", 0)),
           "score_model_loads": int(stats.get("model_loads", 0)),
           "score_affinity_hit_rate": round(hit_rate, 3)}
    row.update(_hist_stats(snap.get("hists", {}), "queue_wait_ms"))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="open-loop Zipf/Poisson load against the job-server "
                    "fleet (module docstring)")
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--tenants", type=int, default=200)
    ap.add_argument("--corpora", type=int, default=8)
    ap.add_argument("--rows", type=int, default=5_000,
                    help="rows per corpus (default 5000)")
    ap.add_argument("--rate", type=float, default=5.0,
                    help="Poisson arrival rate, requests/s (default 5)")
    ap.add_argument("--zipf-s", type=float, default=1.1,
                    help="Zipf exponent of corpus popularity")
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--budget-mb", type=float, default=3072.0)
    ap.add_argument("--arms", default="inproc,fleet",
                    help="comma list of inproc,solo,fleet,query")
    ap.add_argument("--score-fraction", type=float, default=0.8,
                    help="query arm: fraction of arrivals that are "
                         "scores (rest are job submits)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--drain-timeout", type=float, default=1800.0)
    ap.add_argument("--device", default=None,
                    help="torch device of every server and host (default "
                         "cuda)")
    args = ap.parse_args(argv)

    work = tempfile.mkdtemp(prefix="fleet_load_")
    corpora = []
    for i in range(args.corpora):
        path = os.path.join(work, f"corpus_{i:03d}.csv")
        write_corpus(path, args.rows, seed=100 + i)
        corpora.append(path)
    out_dir = os.path.join(work, "out")
    os.makedirs(out_dir, exist_ok=True)
    load = plan_load(args, corpora, out_dir)
    offered = args.requests / (load[-1][0] / 60.0)
    print(json.dumps({"offered_jobs_per_min": round(offered, 2),
                      "requests": args.requests,
                      "corpora": args.corpora, "tenants": args.tenants,
                      "zipf_s": args.zipf_s, "workdir": work}))
    rc = 0
    for arm in args.arms.split(","):
        arm = arm.strip()
        if arm == "inproc":
            row = run_inproc(args, load)
        elif arm == "solo":
            row = run_fleet(args, load, hosts=1)
        elif arm == "fleet":
            row = run_fleet(args, load, hosts=args.hosts)
        elif arm == "query":
            models = train_models(corpora, work, device=args.device)
            qload = plan_query_load(args, corpora, models, out_dir)
            row = run_query(args, qload, hosts=args.hosts)
        else:
            print(f"unknown arm {arm!r}", file=sys.stderr)
            return 2
        row["offered_jobs_per_min"] = round(offered, 2)
        if row["lost_requests"] > 0:
            rc = 1          # a dropped request: the soak contract broke
        print(json.dumps(row))
    return rc


if __name__ == "__main__":
    sys.exit(main())
