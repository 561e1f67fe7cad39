"""The scale tripwires: the sharded driver, the delta scan, the sidecar.

The port of `bench_scaling.py`'s `host_parallel_capacity`,
`shard_tripwire`, `incremental_tripwire` and `sidecar_tripwire` (without
its job-server leg; the other tripwires wait for their modules):

    python -m avenir_tpu_torch.tools.bench_scaling [--tripwire shard|
        incremental|sidecar] [--rows N] [--floor X] [--device cpu]

prints one JSON line (`--floor 0` records the speedups without a
verdict on them; each tripwire has the reference's floor by default).

**incremental_tripwire** (floor 5x at 10,000,000 rows): a seeded cold
`run_incremental` of mutualInformation, a 1% append, then the timed cold
`run_job` against the timed refresh; the artifacts must be equal and the
refresh must have restored (Resume:SkippedBytes and Cache:HitBlocks > 0).

**sidecar_tripwire** (floor 2x at 10,000,000 rows): the fused churn trio
(bayesianDistr, mutualInformation, fisherDiscriminant through
`run_shared`) packs the sidecar once, then the cold scan
(`stream.sidecar=false`) and the warm replay are timed in turns, best of
two; every artifact equal, every warm job with Sidecar:HitBlocks >= 1 and
no parse span; then `run_sharded` over the packed corpus parses nothing in
its workers, and a cold `run_incremental` seed over it replays every
block.

**shard_tripwire**, three legs, each on `device` (default cuda):

- **Byte identity and speedup**: mutualInformation over churn rows and the
  per-class markovStateTransitionModel over sequence rows, solo in a child
  process pinned to one core (its seconds exclude the interpreter's boot)
  against ``run_sharded(procs=2)`` with each worker on a core of its own
  (its clock starts at the go barrier). The artifacts must be equal; the
  geometric-mean speedup is held to ``min(floor, capacity x 0.75)``, with
  the box's two-process capacity probed before and after, and only where
  that capacity is at least 1.7 (a box that cannot run two processes 1.7x
  faster than one records the numbers without a verdict).
- **The miner's per-k rounds**: frequentItemsApriori, the rounds counted
  in the workers by replaying their caches; equal bytes, ``Shard:PerKRounds
  >= 1`` and ``Shard:PerKBlocks >= Shard:Blocks`` always, the speedup under
  the same gate.
- **SIGSTOP chaos** (:func:`chaos_leg`): one worker is stopped while it
  holds an uncommitted claim; the other steals the tail and mirrors the
  stalled block; after the run the stopped worker is resumed, and its late
  commit is rejected. Every block committed, ``Shard:DedupBlocks >= 1``,
  bytes equal to the solo run's.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def host_parallel_capacity(n: int = 2, secs: float = 2.0) -> float:
    """The speedup this host gives `n` CPU-bound processes over one (a
    busy-loop probe): about n on n free cores, less on a throttled or
    shared host, which no sharded run can beat."""
    import multiprocessing as mp

    def run(k: int) -> int:
        # spawned, never forked: the caller may hold a CUDA context
        ctx = mp.get_context("spawn")
        vals = [ctx.Value("q", 0) for _ in range(k)]
        procs = [ctx.Process(target=_burn, args=(v, secs)) for v in vals]
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join()
        return sum(v.value for v in vals)

    solo = run(1)
    return run(n) / max(solo, 1)


def _burn(out, secs: float) -> None:
    t0 = time.perf_counter()
    x = 0
    while time.perf_counter() - t0 < secs:
        x += 1
    out.value = x


_SOLO = """
import json, sys, time
sys.path.insert(0, sys.argv[5])
from avenir_tpu_torch.runner import run_job
job, conf, inp, out, _root, device = (sys.argv[1], json.loads(sys.argv[2]),
                                      sys.argv[3], sys.argv[4], sys.argv[5],
                                      sys.argv[6])
t0 = time.perf_counter()
run_job(job, conf, [inp], out, device=device)
if device == "cuda":
    import torch
    torch.cuda.synchronize()
print(json.dumps({"seconds": time.perf_counter() - t0}))
"""


def solo_child(job: str, conf: Dict, inp: str, out: str, device: str,
               core: Optional[int] = None) -> float:
    """`run_job` in a fresh child (pinned to `core`): its seconds, imports
    excluded."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _SOLO, job, json.dumps(conf), inp, out, ROOT,
         device], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    if core is not None and hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(proc.pid, {core})
    try:
        stdout, stderr = proc.communicate(timeout=3600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"solo {job} failed: {stderr[-800:]}")
    return float(json.loads(stdout.strip().splitlines()[-1])["seconds"])


def same_files(solo_out: str, outputs: List[str]) -> bool:
    """The sharded outputs equal the solo run's file (or directory of
    files), compared sorted."""
    solo = ([solo_out] if os.path.isfile(solo_out) else
            sorted(os.path.join(solo_out, f) for f in os.listdir(solo_out)))
    if len(solo) != len(outputs):
        return False
    for a, b in zip(solo, sorted(outputs)):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                return False
    return True


def chaos_leg(job: str, conf: Dict, inp: str, out: str, device: str,
              policy=None, pin_cores=None, timeout_s: float = 900.0
              ) -> Tuple[object, Dict]:
    """run_sharded(procs=2) with one worker stopped (SIGSTOP) the moment it
    holds an uncommitted claim, resumed (SIGCONT) once every block is
    committed: returns (result, {"victim", "resumed"}). Raises when no
    worker was caught holding a claim."""
    from avenir_tpu_torch.dist import (BlockLedger, StragglerPolicy,
                                       load_plan, run_sharded)

    policy = policy or StragglerPolicy(mirror_floor_s=0.5,
                                       mirror_multiple=2.0, poll_s=0.02)
    stopped: Dict = {}
    watch_stop = threading.Event()

    def hook(pids, root):
        stopped["pids"], stopped["root"] = pids, root

    def watch():
        while "root" not in stopped:
            if watch_stop.wait(0.002):
                return
        pids, root = stopped["pids"], stopped["root"]
        ledger = BlockLedger(root)
        plan = victim = None
        while not watch_stop.is_set():
            if plan is None:
                try:
                    plan = load_plan(os.path.join(root, "plan.json"))
                except Exception:
                    time.sleep(0.005)
                    continue
            if victim is None:
                done = set(ledger.committed())
                for bid, info in ledger.claims().items():
                    if bid not in done:
                        victim = info["worker"]
                        os.kill(pids[victim], signal.SIGSTOP)
                        # the fold may have committed before the stop
                        if bid in set(ledger.committed()):
                            os.kill(pids[victim], signal.SIGCONT)
                            victim = None
                        break
                time.sleep(0.002)
                continue
            stopped["victim"] = victim
            if len(ledger.committed()) >= len(plan.blocks):
                os.kill(pids[victim], signal.SIGCONT)
                stopped["resumed"] = True
                return
            time.sleep(0.01)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        res = run_sharded(job, conf, [inp], out, procs=2, policy=policy,
                          pin_cores=pin_cores, worker_hook=hook,
                          timeout_s=timeout_s, device=device)
    finally:
        watch_stop.set()
        watcher.join(30)
        if watcher.is_alive():
            raise RuntimeError("chaos watcher failed to stop")
    if "victim" not in stopped:
        raise RuntimeError("chaos leg: no worker was caught holding an "
                           "uncommitted claim")
    return res, {"victim": int(stopped["victim"]),
                 "resumed": bool(stopped.get("resumed"))}


def shard_tripwire(rows: int = 10_000_000, floor: float = 1.5,
                   parallel_efficiency_floor: float = 0.75,
                   device: str = "cuda") -> dict:
    """The three legs above; raises on a failed check, returns the
    numbers."""
    from avenir_tpu_torch.data import churn_schema, generate_churn
    from avenir_tpu_torch.dist import run_sharded

    d = tempfile.mkdtemp(prefix="avenir_shard_tripwire_")
    try:
        churn = os.path.join(d, "churn.csv")
        blob = generate_churn(100_000, seed=51, as_csv=True)
        seq = os.path.join(d, "seq.csv")
        seq_blob = "".join(f"c{i},{'T' if i % 2 else 'F'},L,M,H,M,L\n"
                           for i in range(100_000))
        with open(churn, "w") as fc, open(seq, "w") as fs:
            for _ in range(max(rows // 100_000, 1)):
                fc.write(blob)
                fs.write(seq_blob)
        schema = os.path.join(d, "churn.json")
        churn_schema().save(schema)
        families = [
            ("mutualInformation",
             {"mut.feature.schema.file.path": schema,
              "mut.mutual.info.score.algorithms":
                  "mutual.info.maximization"}, churn),
            ("markovStateTransitionModel",
             {"mst.model.states": "L,M,H", "mst.class.label.field.ord": "1",
              "mst.skip.field.count": "2", "mst.class.labels": "T,F"}, seq),
            ("frequentItemsApriori",
             {"fia.support.threshold": "0.3", "fia.item.set.length": "3",
              "fia.skip.field.count": "2"}, seq)]
        n_cores = os.cpu_count() or 2
        pin = [i % n_cores for i in range(2)]
        out: Dict[str, object] = {"rows": rows, "device": device,
                                  "floor": floor}
        speedups = []
        cap0 = host_parallel_capacity(2)
        for job, conf, inp in families:
            solo_out = os.path.join(d, f"solo_{job}")
            solo_s = solo_child(job, conf, inp, solo_out, device, pin[0])
            res = run_sharded(job, conf, [inp], os.path.join(d, f"sh_{job}"),
                              procs=2, pin_cores=pin, device=device)
            if not same_files(solo_out, res.outputs):
                raise RuntimeError(f"sharded {job} differs from its solo run")
            shard_s = float(res.counters["Shard:ScanSeconds"])
            row = {"solo_seconds": solo_s, "sharded_seconds": shard_s,
                   "speedup": solo_s / max(shard_s, 1e-9),
                   "counters": {k: v for k, v in res.counters.items()
                                if k.startswith(("Shard:", "Cache:"))}}
            if job == "frequentItemsApriori":
                c = res.counters
                if c["Shard:PerKRounds"] < 1 \
                        or c["Shard:PerKBlocks"] < c["Shard:Blocks"]:
                    raise RuntimeError(f"the per-k rounds did not run in "
                                       f"the workers: {c}")
                out["miner"] = row
            else:
                out.setdefault("families", {})[job] = row
            speedups.append(row["speedup"])
        capacity = min(cap0, host_parallel_capacity(2))
        speedup = (speedups[0] * speedups[1]) ** 0.5
        effective = min(floor, capacity * parallel_efficiency_floor)
        gated = capacity >= 1.7
        out.update({"host_parallel_capacity": capacity,
                    "throughput_gated": gated, "speedup": speedup,
                    "effective_floor": effective})
        if gated and min(speedup, speedups[2]) < effective:
            raise RuntimeError(
                f"2-process sharded scan {speedup:.2f}x (miner "
                f"{speedups[2]:.2f}x) under the floor {effective:.2f}x at "
                f"capacity {capacity:.2f}")
        job, conf, inp = families[0]
        res, caught = chaos_leg(job, conf, inp, os.path.join(d, "chaos"),
                                device, pin_cores=pin)
        if res.counters["Shard:DedupBlocks"] < 1:
            raise RuntimeError(f"chaos leg: nothing was deduped "
                               f"({res.counters})")
        if not same_files(os.path.join(d, f"solo_{job}"), res.outputs):
            raise RuntimeError("chaos leg: the artifact differs from solo")
        out["chaos"] = {**caught, "counters": {
            k: v for k, v in res.counters.items() if k.startswith("Shard:")}}
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _churn_corpus(d: str, rows: int, seed: int) -> Tuple[str, str]:
    """(csv, schema) of `rows` churn rows (a 100,000-row seeded blob
    repeated) in `d`."""
    from avenir_tpu_torch.data import churn_schema, generate_churn

    blob = generate_churn(100_000, seed=seed, as_csv=True)
    csv = os.path.join(d, "churn.csv")
    with open(csv, "w") as fh:
        for _ in range(max(rows // 100_000, 1)):
            fh.write(blob)
    schema = os.path.join(d, "churn.json")
    churn_schema().save(schema)
    return csv, schema


def _file_bytes(res) -> List[bytes]:
    out = []
    for path in sorted(res.outputs):
        with open(path, "rb") as fh:
            out.append(fh.read())
    return out


def _span_seconds(spans) -> Dict[str, float]:
    """Seconds by span name (spans on worker threads overlap the fold's,
    so the names do not sum to the wall)."""
    out: Dict[str, float] = {}
    for sp in spans:
        out[sp.name] = out.get(sp.name, 0.0) + sp.dur
    return out


def incremental_tripwire(rows: int = 10_000_000, floor: float = 5.0,
                         device: str = "cuda") -> dict:
    """After a 1% append, `run_incremental` must write the cold re-scan's
    bytes `floor` times faster than `run_job`: the O(delta) claim of the
    delta scan. One seeded run through the driver writes the checkpoint
    (and warms both timed sides), then the append, then the timed cold
    `run_job` and the timed refresh."""
    from avenir_tpu_torch import obs
    from avenir_tpu_torch.data import generate_churn
    from avenir_tpu_torch.runner import run_incremental, run_job

    d = tempfile.mkdtemp(prefix="avenir_incr_tripwire_")
    try:
        csv, schema = _churn_corpus(d, rows, seed=21)
        conf = {"mut.feature.schema.file.path": schema,
                "mut.mutual.info.score.algorithms":
                    "mutual.info.maximization"}
        state = os.path.join(d, "state")
        run_incremental("mutualInformation", conf, [csv],
                        os.path.join(d, "out_seed.txt"), state_dir=state,
                        device=device)
        appended = max(rows // 100, 1_000)
        with open(csv, "a") as fh:
            fh.write(generate_churn(appended, seed=22, as_csv=True))
        t0 = time.perf_counter()
        cold = run_job("mutualInformation", conf, [csv],
                       os.path.join(d, "out_cold.txt"), device=device)
        t_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        with obs.capture() as rec:
            incr = run_incremental("mutualInformation", conf, [csv],
                                   os.path.join(d, "out_incr.txt"),
                                   state_dir=state, device=device)
        t_incr = time.perf_counter() - t0
        if _file_bytes(cold) != _file_bytes(incr):
            raise RuntimeError(
                "incremental refresh output drifted from the cold full "
                "re-scan: the delta fold is wrong, not slow")
        if incr.counters["Resume:SkippedBytes"] <= 0 \
                or incr.counters["Cache:HitBlocks"] <= 0:
            raise RuntimeError(
                "incremental refresh restored no checkpoint (it re-scanned "
                "cold)")
        speedup = t_cold / max(t_incr, 1e-9)
        if speedup < floor:
            raise RuntimeError(
                f"incremental refresh only {speedup:.2f}x faster than the "
                f"cold re-scan (floor {floor}x)")
        return {"speedup": speedup, "floor": floor, "t_cold_s": t_cold,
                "t_incremental_s": t_incr, "rows": rows,
                "appended_rows": appended, "device": device,
                "refresh_span_s": _span_seconds(rec.spans()),
                "skipped_bytes": int(incr.counters["Resume:SkippedBytes"]),
                "delta_blocks": int(incr.counters["Cache:DeltaBlocks"]),
                "outputs_byte_identical": True}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def sidecar_tripwire(rows: int = 10_000_000, floor: float = 2.0,
                     device: str = "cuda") -> dict:
    """After one pass packs the sidecar, the fused churn trio's repeat scan
    must beat the cold CSV scan `floor` times over, to the same bytes,
    with Sidecar:HitBlocks >= 1 on every job and no `stream.parse` span;
    then the sharded workers and a cold incremental seed over the packed
    corpus replay it without a parse too."""
    from avenir_tpu_torch import obs
    from avenir_tpu_torch.dist import run_sharded
    from avenir_tpu_torch.native import sidecar
    from avenir_tpu_torch.runner import run_incremental, run_shared

    d = tempfile.mkdtemp(prefix="avenir_sidecar_tripwire_")
    try:
        csv, schema = _churn_corpus(d, rows, seed=17)
        # about 12 blocks: the sharded leg's planner snaps its cuts to
        # the sidecar's offsets only when there are procs x factor (2 x 4)
        size_mb = os.path.getsize(csv) / (1 << 20)
        block = f"{max(size_mb / 12.0, 0.05):.3f}"
        scdir = os.path.join(d, "sidecar")
        trio = [("bayesianDistr", "bad"), ("mutualInformation", "mut"),
                ("fisherDiscriminant", "fid")]

        def conf(p, **extra):
            c = {f"{p}.feature.schema.file.path": schema,
                 f"{p}.stream.block.size.mb": block,
                 f"{p}.stream.sidecar.dir": scdir}
            if p == "mut":
                c["mut.mutual.info.score.algorithms"] = \
                    "mutual.info.maximization"
            c.update({f"{p}.{k}": v for k, v in extra.items()})
            return c

        def specs(tag, **extra):
            return [(j, conf(p, **extra), os.path.join(d, f"{tag}_{p}"))
                    for j, p in trio]

        pack = run_shared(specs("pack"), [csv], device=device)
        # best of two, in turns: one stolen scheduler slice cannot sink
        # the ratio
        t_colds, t_warms, colds, warms, spans = [], [], [], [], []
        for rnd in ("", "2"):
            t0 = time.perf_counter()
            colds.append(run_shared(
                specs(f"cold{rnd}", **{"stream.sidecar": "false"}), [csv],
                device=device))
            t_colds.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            with obs.capture() as rec:
                warms.append(run_shared(specs(f"warm{rnd}"), [csv],
                                        device=device))
            t_warms.append(time.perf_counter() - t0)
            spans.append(rec.spans())
        t_cold, t_warm = min(t_colds), min(t_warms)
        for j, _p in trio:
            want = _file_bytes(pack[j])
            if any(_file_bytes(res[j]) != want for res in colds + warms):
                raise RuntimeError(
                    f"sidecar replay output of {j} drifted from the cold "
                    f"CSV scan: the replay is wrong, not slow")
            for w in warms:
                if w[j].counters["Sidecar:HitBlocks"] < 1 \
                        or w[j].counters["Sidecar:DeltaBlocks"] != 0:
                    raise RuntimeError(
                        f"warm pass of {j} did not replay the sidecar: "
                        f"{w[j].counters}")
        parsed = sum(1 for run in spans for sp in run
                     if sp.name == "stream.parse")
        replayed = sum(1 for run in spans for sp in run
                       if sp.name == "stream.sidecar.replay")
        if parsed or replayed < 1:
            raise RuntimeError(
                f"warm fused pass parsed {parsed} block(s) and replayed "
                f"{replayed}: the repeat scan is not parse-free")
        speedup = t_cold / max(t_warm, 1e-9)
        if speedup < floor:
            raise RuntimeError(
                f"sidecar repeat scan only {speedup:.2f}x faster than the "
                f"cold CSV scan (floor {floor}x)")
        mi_cold = _file_bytes(colds[0]["mutualInformation"])
        # the planner snaps onto the verified offsets, so each claimed
        # range replays whole; the workers' span counts come home in
        # their stats
        shard = run_sharded("mutualInformation", conf("mut"), [csv],
                            os.path.join(d, "shard_out.txt"), procs=2,
                            device=device)
        if _file_bytes(shard) != mi_cold:
            raise RuntimeError("sharded sidecar replay output drifted")
        if shard.counters["Shard:ParseSpans"] != 0 \
                or shard.counters["Shard:ReplaySpans"] < 1:
            raise RuntimeError(
                f"sharded workers parsed over a warm sidecar: "
                f"{shard.counters}")
        # a cold seed of the incremental driver over the packed corpus
        # replays every block: its delta feed goes through the sidecar
        with obs.capture() as rec_i:
            incr = run_incremental(
                "mutualInformation", conf("mut"), [csv],
                os.path.join(d, "incr_out.txt"),
                state_dir=os.path.join(d, "incr_state"), device=device)
        if _file_bytes(incr) != mi_cold:
            raise RuntimeError("incremental sidecar replay output drifted")
        i_parsed = sum(1 for sp in rec_i.spans()
                       if sp.name == "stream.parse")
        if i_parsed or incr.counters["Sidecar:HitBlocks"] < 1:
            raise RuntimeError(
                f"incremental cold seed parsed {i_parsed} block(s) over a "
                f"packed corpus: {incr.counters}")
        sc_bytes = sum(sidecar.sidecar_nbytes(os.path.join(scdir, n))
                       for n in os.listdir(scdir))
        return {"speedup": speedup, "floor": floor, "t_cold_s": t_cold,
                "t_warm_s": t_warm, "t_cold_runs_s": t_colds,
                "t_warm_runs_s": t_warms,
                "warm_span_s": [_span_seconds(run) for run in spans],
                "rows": rows,
                "block_mb": float(block), "device": device,
                "corpus_bytes": os.path.getsize(csv),
                "sidecar_bytes": sc_bytes,
                "hit_blocks": {j: int(warms[0][j].counters[
                    "Sidecar:HitBlocks"]) for j, _p in trio},
                "warm_parse_spans": parsed, "warm_replay_spans": replayed,
                "shard_parse_spans": int(shard.counters["Shard:ParseSpans"]),
                "shard_replay_spans": int(
                    shard.counters["Shard:ReplaySpans"]),
                "incremental_parse_spans": i_parsed,
                "outputs_byte_identical": True}
    finally:
        shutil.rmtree(d, ignore_errors=True)


#: tripwire name -> (function, its default floor)
TRIPWIRES = {"shard": (shard_tripwire, 1.5),
             "incremental": (incremental_tripwire, 5.0),
             "sidecar": (sidecar_tripwire, 2.0)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="avenir_tpu_torch.tools.bench_scaling")
    ap.add_argument("--tripwire", choices=sorted(TRIPWIRES), default="shard")
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--floor", type=float, default=None,
                    help="the speedup floor (default: the tripwire's own)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fn, floor = TRIPWIRES[args.tripwire]
    print(json.dumps(fn(rows=args.rows,
                        floor=floor if args.floor is None else args.floor,
                        device=args.device)))


if __name__ == "__main__":
    main()
