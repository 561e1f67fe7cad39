"""`python -m avenir_tpu_torch stats <paths...>` — render metrics snapshots.

The port of `avenir_tpu/obs/report.py` (host code, stdlib only): both
packages' snapshots share one schema, so either renders the other's.

The resident job server atomically renames a ``metrics.json`` snapshot
next to its spool every few seconds (jobserver.JobServer, the
``metrics_path`` surface); this renderer is the operator's one-command
view of it: queue depths, admission pressure, warm-store occupancy and
the latency histograms (queue wait / admission hold / dispatch /
chunk), without attaching to the server process. Accepts snapshot
files, directories holding one, or a FLEET root (``host*/metrics.json``
underneath); given several snapshots it renders the MERGED view —
counters summed, histograms folded through the additive
``LatencyHistogram.merge`` algebra over the snapshots' sparse
``hists_raw`` buckets, so a fleet's p99 is computed from the combined
distribution, never averaged from per-host summaries.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Dict, List


def load_metrics(path: str) -> Dict:
    """The snapshot dict at `path` (a metrics.json, or a directory —
    e.g. the spool dir — containing one)."""
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.json")
    with open(path) as fh:
        return json.load(fh)


def expand_metrics_paths(paths: List[str]) -> List[str]:
    """Every metrics.json the CLI arguments name: a file stays itself;
    a directory with a metrics.json contributes it; a directory with
    ``host*/metrics.json`` underneath (a fleet root) contributes every
    host's — so ``stats <fleet-root>`` sees the whole fleet."""
    out: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            own = os.path.join(path, "metrics.json")
            hosts = sorted(glob.glob(
                os.path.join(path, "host*", "metrics.json")))
            if hosts:
                # the per-host truth beats the (possibly stale) rolled-
                # up fleet file when both exist under a fleet root
                out.extend(hosts)
            elif os.path.exists(own):
                out.append(own)
            else:
                raise OSError(
                    f"no metrics.json (or host*/metrics.json) under "
                    f"{path!r}")
        else:
            out.append(path)
    return out


def merge_snapshots(snaps: List[Dict]) -> Dict:
    """Fold N metrics snapshots into one fleet view. Counters, queue
    depths and warm/inflight occupancy are additive and sum; the
    latency histograms merge EXACTLY through each snapshot's sparse
    ``hists_raw`` buckets (``LatencyHistogram.merge`` — the same
    algebra every fold state in the repo obeys). A snapshot predating
    the raw surface contributes its counters but no distribution;
    ``peak_priced_bytes`` sums to the fleet-wide upper bound (per-host
    peaks need not be simultaneous)."""
    from avenir_tpu_torch.obs.histogram import LatencyHistogram

    out: Dict = {"hosts": len(snaps), "ts_unix": 0.0, "uptime_s": 0.0,
                 "queues": {}, "inflight": {}, "warm": {}, "stats": {},
                 "hists": {}, "hists_raw": {}, "score": None,
                 "draining": False,
                 "trace": {"spans": 0, "dropped_spans": 0,
                           "enabled": False}}
    merged: Dict[str, LatencyHistogram] = {}
    for snap in snaps:
        out["ts_unix"] = max(out["ts_unix"], snap.get("ts_unix", 0.0))
        out["uptime_s"] = max(out["uptime_s"], snap.get("uptime_s", 0.0))
        out["draining"] = out["draining"] or bool(snap.get("draining"))
        for tenant, n in (snap.get("queues") or {}).items():
            out["queues"][tenant] = out["queues"].get(tenant, 0) + int(n)
        for section in ("inflight", "warm", "stats"):
            for key, val in (snap.get(section) or {}).items():
                if isinstance(val, (int, float)):
                    out[section][key] = out[section].get(key, 0) + val
        trace = snap.get("trace") or {}
        out["trace"]["spans"] += int(trace.get("spans", 0))
        out["trace"]["dropped_spans"] += int(trace.get("dropped_spans",
                                                       0))
        out["trace"]["enabled"] = out["trace"]["enabled"] \
            or bool(trace.get("enabled"))
        for name, raw in (snap.get("hists_raw") or {}).items():
            merged.setdefault(name, LatencyHistogram()).merge(
                LatencyHistogram.from_dict(raw))
        # score-plane roll-up: counters and per-model dispatch counts
        # are additive across hosts (the per-model latency hists
        # already merge above through hists_raw)
        score = snap.get("score")
        if score:
            if out["score"] is None:
                out["score"] = {"stats": {}, "per_model_predicts": {},
                                "cache": {}}
            for section in ("stats", "per_model_predicts", "cache"):
                for key, val in (score.get(section) or {}).items():
                    if isinstance(val, (int, float)):
                        bucket = out["score"][section]
                        bucket[key] = bucket.get(key, 0) + val
    out["hists"] = {name: h.summary() for name, h in merged.items()}
    out["hists_raw"] = {name: h.to_dict() for name, h in merged.items()}
    return out


def _fmt_bytes(n: float) -> str:
    return f"{n / (1 << 20):.1f}MB"


def _hist_rows(hists: Dict[str, Dict]) -> List[str]:
    lines = [f"  {'histogram':<22s} {'count':>7s} {'p50':>9s} "
             f"{'p95':>9s} {'p99':>9s} {'max':>9s}"]
    for name, h in sorted(hists.items()):
        lines.append(
            f"  {name:<22s} {int(h.get('count', 0)):>7d} "
            f"{h.get('p50', 0.0):>9.2f} {h.get('p95', 0.0):>9.2f} "
            f"{h.get('p99', 0.0):>9.2f} {h.get('max', 0.0):>9.2f}")
    return lines


def render_metrics(snap: Dict) -> str:
    """The snapshot as the operator table (pure function of the dict,
    so tests pin the rendering without a filesystem)."""
    lines: List[str] = []
    age = time.time() - snap.get("ts_unix", time.time())
    hosts = int(snap.get("hosts", 1))
    what = f"fleet metrics ({hosts} hosts merged, " if hosts > 1 \
        else "job server metrics (snapshot "
    lines.append(f"avenir {what}{age:.1f}s old, "
                 f"uptime {snap.get('uptime_s', 0.0):.1f}s"
                 + (", DRAINING)" if snap.get("draining") else ")"))
    router = snap.get("router")
    if router:
        rs = router.get("stats", {})
        lines.append(
            f"router: {rs.get('placed', 0)} placed, "
            f"hits={rs.get('affinity_hits', 0)} "
            f"misses={rs.get('affinity_misses', 0)} "
            f"spills={rs.get('spills', 0)} held={rs.get('held', 0)} "
            f"across {len(router.get('hosts', []))} host(s)")
    queues = snap.get("queues", {})
    depth = sum(queues.values())
    lines.append(f"queues: {depth} queued across {len(queues)} tenant(s)"
                 + ("" if not queues else "  [" + ", ".join(
                     f"{t}={n}" for t, n in sorted(queues.items())) + "]"))
    infl = snap.get("inflight", {})
    budget = infl.get("budget_bytes", 0) or 1
    lines.append(f"admission: {_fmt_bytes(infl.get('priced_bytes', 0))} "
                 f"priced in flight of {_fmt_bytes(budget)} budget "
                 f"({100.0 * infl.get('priced_bytes', 0) / budget:.1f}%), "
                 f"{infl.get('batches', 0)} batch(es) running, "
                 f"peak {_fmt_bytes(infl.get('peak_priced_bytes', 0))}")
    warm = snap.get("warm", {})
    lines.append(f"warm store: {int(warm.get('pinned_sources', 0))} "
                 f"pinned source(s), {_fmt_bytes(warm.get('pinned_bytes', 0))}"
                 f", hits={int(warm.get('hits', 0))} "
                 f"misses={int(warm.get('misses', 0))}")
    stats = snap.get("stats", {})
    lines.append(f"served: {int(stats.get('served', 0))} "
                 f"(failed {int(stats.get('failed', 0))}), "
                 f"batches={int(stats.get('batches', 0))} "
                 f"coalesced={int(stats.get('coalesced', 0))} "
                 f"holds={int(stats.get('admission_holds', 0))} "
                 f"compile-warm={int(stats.get('compile_warm_dispatches', 0))}"
                 f" warm-hits={int(stats.get('warm_hits', 0))}")
    hists = snap.get("hists", {})
    if hists:
        lines.append("latency histograms (ms):")
        lines.extend(_hist_rows(hists))
    return "\n".join(lines)


def stats_main(argv) -> int:
    """CLI body for ``python -m avenir_tpu_torch stats <paths...>`` — one
    snapshot renders as-is; several (or a fleet root) render the
    additive-merged fleet view."""
    import argparse

    ap = argparse.ArgumentParser(prog="avenir_tpu_torch stats")
    ap.add_argument("paths", nargs="+",
                    help="metrics.json file(s), directories containing "
                         "one, or a fleet root (host*/metrics.json)")
    ap.add_argument("--json", action="store_true",
                    help="emit the raw snapshot JSON instead of the table")
    args = ap.parse_args(argv)
    try:
        files = expand_metrics_paths(args.paths)
        snaps = [load_metrics(p) for p in files]
    except (OSError, ValueError) as e:
        print(f"cannot load metrics snapshot(s) from {args.paths}: {e}")
        return 2
    snap = snaps[0] if len(snaps) == 1 else merge_snapshots(snaps)
    # a fleet root's own rolled-up file carries the router section;
    # surface it next to the host counters whenever the arguments
    # named a fleet root — a 1-host fleet is still a fleet
    if "router" not in snap:
        for path in args.paths:
            own = os.path.join(path, "metrics.json") \
                if os.path.isdir(path) else path
            try:
                with open(own) as fh:
                    router = json.load(fh).get("router")
            except (OSError, ValueError):
                continue
            if router:
                snap["router"] = router
                break
    print(json.dumps(snap, indent=1) if args.json else render_metrics(snap))
    return 0
