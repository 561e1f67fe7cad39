"""The sharded driver's tripwire: byte identity, speedup and a SIGSTOP.

The port of `bench_scaling.py`'s `host_parallel_capacity` and
`shard_tripwire` (the other tripwires wait for their modules):

    python -m avenir_tpu_torch.tools.bench_scaling [--rows N] [--floor X]
                                                    [--device cpu]

prints one JSON line (`--floor 0` records the speedups without a
verdict on them). Three legs, each on `device` (default cuda):

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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="avenir_tpu_torch.tools.bench_scaling")
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--floor", type=float, default=1.5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(shard_tripwire(rows=args.rows, floor=args.floor,
                                    device=args.device)))


if __name__ == "__main__":
    main()
