"""The scale tripwires: the sharded driver, the delta scan, the sidecar,
the job server, the fleet, its faults, the score plane, the autotune loop,
the telemetry's overhead, the streamed miners, the shared scan and the
auditors.

The port of `bench_scaling.py`'s `host_parallel_capacity`,
`shard_tripwire`, `incremental_tripwire`, `sidecar_tripwire`,
`server_tripwire`, `fleet_tripwire`, `fleet_fault_tripwire`,
`score_tripwire`, `autotune_tripwire`, `obs_tripwire`, `miner_tripwire`
and `shared_scan_tripwire`, each with the reference's floor or ceiling,
and of every leg of its `graftlint_tripwire` (`audit_tripwire`):

    python -m avenir_tpu_torch.tools.bench_scaling [--tripwire shard|
        incremental|sidecar|server|fleet|fleet_fault|score|autotune|obs|
        miner|shared_scan|audit] [--rows N] [--floor X] [--device cpu]

prints one JSON line (`--floor 0` records the speedups without a
verdict on them; for `obs`, `--floor` is the overhead ceiling; `--rows`
is the score tripwire's query count, and defaults to each tripwire's
own). Every run, job server and fleet host is on `device` (default
cuda).

**miner_tripwire** (20,000 rows, no speed floor): both streamed miners
keep Basic:Records equal to the rows; GSP binds at most the subsequence
kernel's library, and at four times the blocks runs no nvcc and binds
nothing (the port's build and bind counts, `ops._build.counts`, stand
for the reference's jit cache size); Apriori's per-k rounds replay the
encoded-block cache, smaller than its CSV.

**shared_scan_tripwire** (floor 1.3x at 30,000 rows): the churn trio as
three scans against one `run_shared` scan, both parsing (sidecar off, a
departure from the reference, whose fused pass would replay what its
sequential pass packed); equal artifacts, no nvcc run and no library
bound by the fused pass.

**audit_tripwire** (no speed floor): the AST rules over the package, the
keys, proto and race audits over their 11, 13 and 8 sites (the race at
depth 3 and 64 seeds), the IR rules over the kernel manifest with the
eight families' payloads validated on a gloo world of eight CPU ranks,
then the flow invariance, mem footprint, merge
(with its incremental and sharded-steal legs) and span-coverage audits
over the eight stream entries, at least eight validated each; the
memory manifest goes to `build/avenir_tpu_torch/MEMORY_MANIFEST.json`.

**autotune_tripwire** (floor 1.15x at 10,000,000 rows): the fused churn
trio under the static default knobs, recording its signals and choosing
knobs, against the same trio under the chosen knobs pinned as conf keys;
equal artifacts, best of two a side, the knobs and their reasons in the
line.

**obs_tripwire** (ceiling 1.03x at 10,000,000 rows): the fused churn trio
in 8 MB blocks, parsing, with tracing off and on; equal artifacts, a
read, a parse and a fold span a chunk for every job.

**server_tripwire** (floor 1.5x at 10,000,000 rows): the reference's
six-request, three-tenant load (the churn trio, markov, two identical
Apriori requests) served by one JobServer against the six run one after
another; equal artifacts, a batch of at least two, the served phase's
peak RSS under budget + slack and the priced peak under the budget.

**fleet_tripwire** (floor 1.5x, gated on a two-process capacity of at
least 1.7): a 2-host fleet against a 1-host one, each host pinned to one
core, on two rounds of the churn trio over two corpora; affinity hit
rate at least 0.6, no budget entry passed, equal artifacts.

**fleet_fault_tripwire** (no speed floor): a SIGKILLed host's leases
requeue to the survivor (nothing lost, nothing conflicting, the host
restarts), and a SIGSTOPped host's request is mirrored and answered.

**score_tripwire** (floor 3x at 512 queries): 32 client threads into one
coalescing ScorePlane against `score_once` row by row, then two
JobServer + NetListener hosts behind a ScoreFront over keep-alive
sockets; every row its solo twin's.

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


def _blob_corpus(path: str, rows: int, blob: str, blob_rows: int) -> str:
    """`path` holding `blob` (`blob_rows` rows) repeated to about `rows`
    rows; the reference's corpora are 100,000-row blobs repeated, and a
    smaller `rows` (the CPU tests) writes the blob's first `rows` rows."""
    if rows < blob_rows:
        blob = "".join(blob.splitlines(keepends=True)[:rows])
    with open(path, "w") as fh:
        for _ in range(max(rows // blob_rows, 1)):
            fh.write(blob)
    return path


def _churn_corpus(d: str, rows: int, seed: int, name: str = "churn.csv"
                  ) -> Tuple[str, str]:
    """(csv, schema) of `rows` churn rows (a 100,000-row seeded blob
    repeated) in `d`."""
    from avenir_tpu_torch.data import churn_schema, generate_churn

    csv = _blob_corpus(os.path.join(d, name), rows,
                       generate_churn(100_000, seed=seed, as_csv=True),
                       100_000)
    schema = os.path.join(d, "churn.json")
    churn_schema().save(schema)
    return csv, schema


def _bytes_of(paths: List[str]) -> List[bytes]:
    out = []
    for path in sorted(paths):
        with open(path, "rb") as fh:
            out.append(fh.read())
    return out


def _file_bytes(res) -> List[bytes]:
    return _bytes_of(res.outputs)


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
        # a served batch replays the sidecar and pins it under the warm
        # store's budget; shutdown drops the pins and keeps the files
        from avenir_tpu_torch.server import JobRequest, JobServer

        with obs.capture() as rec_s:
            with JobServer(workers=1, state_root=os.path.join(d, "srv_state"),
                           device=device) as srv:
                tickets = [srv.submit(JobRequest(j, conf(p), [csv],
                                                 os.path.join(d, f"srv_{p}")))
                           for j, p in trio]
                served = {j: t.result(timeout=3600)
                          for (j, _p), t in zip(trio, tickets)}
                pinned = int(srv.warm.stats()["pinned_sources"])
        s_parsed = sum(1 for sp in rec_s.spans() if sp.name == "stream.parse")
        for j, _p in trio:
            if _file_bytes(served[j]) != _file_bytes(colds[0][j]):
                raise RuntimeError(f"served sidecar replay of {j} drifted")
            if served[j].counters.get("Sidecar:HitBlocks", 0) < 1:
                raise RuntimeError(
                    f"served batch of {j} did not replay the sidecar: "
                    f"{served[j].counters}")
        if s_parsed or pinned < 1:
            raise RuntimeError(
                f"served batch parsed {s_parsed} block(s) and pinned "
                f"{pinned} sidecar(s): the warm store does not hold the "
                f"sidecar")
        sc_bytes = sum(sidecar.sidecar_nbytes(os.path.join(scdir, n))
                       for n in os.listdir(scdir))
        if sc_bytes <= 0:
            raise RuntimeError(
                "the packed sidecar vanished after the server batch: "
                "shutdown must drop the pins, not the files")
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
                "server_parse_spans": s_parsed,
                "server_pinned_sidecars": pinned,
                "outputs_byte_identical": True}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _build_counts() -> Dict[str, object]:
    """The nvcc runs and library binds this process has made so far
    (`ops._build.counts`, counted where `build_all` and `bind` do them,
    whoever asked), and the libraries bound (`ops._build._loaded`): the
    port's counterpart of the reference's jit cache size."""
    from avenir_tpu_torch.ops import _build

    return {**_build.counts, "libraries": sorted(_build._loaded)}


def _build_delta(before: Dict[str, object]) -> Dict[str, object]:
    """The builds, binds and newly bound libraries since `before`."""
    now = _build_counts()
    return {"builds": now["builds"] - before["builds"],
            "binds": now["binds"] - before["binds"],
            "libraries": [n for n in now["libraries"]
                          if n not in before["libraries"]]}


def miner_tripwire(rows: int = 20_000, device: str = "cuda") -> dict:
    """Both streamed miners over `rows` sequence rows keep their
    throughput counters (Basic:Records equal to the rows); GSP's first
    run binds at most one library, the subsequence kernel's, and its
    rerun at a quarter of the block size (four times the blocks) runs no
    nvcc and binds nothing (`ops._build.counts`, counted in `build_all`
    and `bind`): a rebuild or re-bind a block would add to those counts
    with every block, the hazard the reference's bound on its kernel's
    compiled variants catches. Where an earlier run in the process bound
    the library already, the first run adds nothing either. Apriori's
    per-k rounds replay the encoded-block spill cache, which is smaller
    than its CSV. The subsequence kernel's launches are in the line."""
    from avenir_tpu_torch.models.association import (
        FrequentItemsApriori, StreamingTransactionSource)
    from avenir_tpu_torch.ops import sequence_kernels
    from avenir_tpu_torch.runner import run_job

    d = tempfile.mkdtemp(prefix="avenir_miner_tripwire_")
    try:
        path = os.path.join(d, "seq.csv")
        with open(path, "w") as fh:
            fh.write(_seq_blob(rows, 12))
        out: Dict[str, object] = {"rows": rows, "device": device}
        launched0 = sequence_kernels.subseq_support_fold.launches
        gsp = []
        for job, p, block in (
                ("frequentItemsApriori", "fia", "1"),
                ("candidateGenerationWithSelfJoin", "cgs", "1"),
                ("candidateGenerationWithSelfJoin", "cgs", "0.25")):
            conf = {f"{p}.support.threshold": "0.3",
                    f"{p}.item.set.length": "2",
                    f"{p}.skip.field.count": "2",
                    f"{p}.stream.block.size.mb": block}
            before = _build_counts()
            res = run_job(job, conf, [path],
                          os.path.join(d, f"{job}_{block}"), device=device)
            if job.startswith("candidate"):
                gsp.append(_build_delta(before))
            recs = res.counters.get("Basic:Records")
            if recs is None or int(recs) != rows:
                raise RuntimeError(
                    f"{job} lost its throughput counter: Basic:Records="
                    f"{recs!r} (expected {rows})")
            out.setdefault(job, {"rows": int(recs), "rows_per_sec":
                                 res.counters.get("Basic:RowsPerSec")})
        first, rerun = gsp
        if (first["binds"] > 1 or set(first["libraries"]) - {"subseq_support"}
                or rerun["builds"] or rerun["binds"]):
            raise RuntimeError(
                f"GSP built and bound {first} and then {rerun} at four "
                f"times the blocks: a kernel library rebuilt or re-bound "
                f"a block")
        out["gsp_build_counts"] = gsp
        out["gsp_subseq_support_launches"] = (
            sequence_kernels.subseq_support_fold.launches - launched0)
        src = StreamingTransactionSource([path], skip_field_count=2,
                                         block_bytes=1 << 20)
        try:
            FrequentItemsApriori(0.3, 2, device=device).mine_stream(src)
            replays, cache_bytes = src.cache_replays, src.cache_nbytes
        finally:
            src.close()
        csv_bytes = os.path.getsize(path)
        if replays < 1:
            raise RuntimeError(
                "the miner's per-k pass did not replay the encoded-block "
                "cache (it re-parsed the CSV)")
        if cache_bytes >= csv_bytes:
            raise RuntimeError(
                f"encoded-block cache ({cache_bytes} B) is not smaller than "
                f"the CSV it replaces ({csv_bytes} B)")
        out["miner_cache"] = {"replays": replays, "cache_bytes": cache_bytes,
                              "csv_bytes": csv_bytes}
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


def shared_scan_tripwire(rows: int = 30_000, floor: float = 1.3,
                         device: str = "cuda") -> dict:
    """The churn trio (bayesianDistr, mutualInformation,
    fisherDiscriminant, 0.1 MB blocks) as three one-job scans and as one
    `run_shared` scan: equal artifacts, the fused pass `floor` times
    faster, and no nvcc run and no library bind in the fused pass
    (`ops._build.counts`: the sinks see the chunks the solo jobs saw, and
    NB binds no library). Both sides parse
    (`stream.sidecar=false`): with the sidecar on, the fused pass would
    replay what the sequential pass packed, and the ratio would price the
    replay, not the shared scan. A 500-row fused warm-up first, then the
    two sides in turns, three times, each side's best kept: a pass takes
    a tenth of a second, so one stolen slice would sink a single pair."""
    from avenir_tpu_torch.data import churn_schema, generate_churn
    from avenir_tpu_torch.runner import run_job

    d = tempfile.mkdtemp(prefix="avenir_shared_scan_")
    try:
        csv = os.path.join(d, "churn.csv")
        with open(csv, "w") as fh:
            fh.write(generate_churn(rows, seed=11, as_csv=True))
        schema = os.path.join(d, "churn.json")
        churn_schema().save(schema)
        warm = os.path.join(d, "warm.csv")
        with open(warm, "w") as fh:
            fh.write(generate_churn(500, seed=12, as_csv=True))
        extra = {"stream.block.size.mb": "0.1", "stream.sidecar": "false"}
        _timed_shared(_trio_specs(d, schema, "warm", extra), warm, device)
        t_seqs, t_fuseds = [], []
        fused_counts = {"builds": 0, "binds": 0, "libraries": []}
        for rnd in range(3):
            _sync(device)
            t0 = time.perf_counter()
            seq_res = {j: run_job(j, c, [csv], o, device=device)
                       for j, c, o in _trio_specs(d, schema, f"seq{rnd}",
                                                  extra)}
            _sync(device)
            t_seqs.append(time.perf_counter() - t0)
            before = _build_counts()
            fused_res, t_fused = _timed_shared(
                _trio_specs(d, schema, f"fus{rnd}", extra), csv, device)
            t_fuseds.append(t_fused)
            for k, v in _build_delta(before).items():
                fused_counts[k] += v
            _same_outputs(seq_res, fused_res, "the shared scan")
        speedup = min(t_seqs) / max(min(t_fuseds), 1e-9)
        out = {"rows": rows, "floor": floor, "device": device,
               "speedup": speedup, "t_sequential_s": min(t_seqs),
               "t_fused_s": min(t_fuseds), "t_sequential_runs_s": t_seqs,
               "t_fused_runs_s": t_fuseds, "fused_build_counts": fused_counts,
               "outputs_byte_identical": True}
        if fused_counts["builds"] or fused_counts["binds"]:
            raise RuntimeError(
                f"the fused pass built or bound kernel libraries "
                f"{fused_counts} that the solo jobs did not: the fan-out "
                f"changed the chunks")
        if speedup < floor:
            raise RuntimeError(
                f"fused shared scan only {speedup:.2f}x faster than "
                f"sequential (floor {floor}x): {json.dumps(out)}")
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _seq_blob(n: int, seed: int) -> str:
    """`n` rows of the reference's two-class L/M/H sequence corpus."""
    import numpy as np

    rng = np.random.default_rng(seed)
    states = ["L", "M", "H"]
    lines = []
    for i in range(n):
        up = i % 2 == 0
        s, toks = 1, []
        for _ in range(6):
            p = [0.1, 0.3, 0.6] if up else [0.6, 0.3, 0.1]
            s = int(np.clip(s + rng.choice([-1, 0, 1], p=p), 0, 2))
            toks.append(states[s])
        lines.append(f"c{i},{'T' if up else 'F'}," + ",".join(toks))
    return "\n".join(lines) + "\n"


def server_load(churn: str, seq: str, schema: str) -> list:
    """The reference's 6-request, 3-tenant mixed load: (tenant, job, conf,
    corpus, tag) rows (the churn trio, markov, two identical Apriori
    requests)."""
    conf = lambda p: {f"{p}.feature.schema.file.path": schema}  # noqa: E731
    mi_conf = {**conf("mut"),
               "mut.mutual.info.score.algorithms":
                   "mutual.info.maximization"}
    fia_conf = {"fia.support.threshold": "0.3",
                "fia.item.set.length": "2",
                "fia.skip.field.count": "2"}
    mst_conf = {"mst.model.states": "L,M,H",
                "mst.class.label.field.ord": "1",
                "mst.skip.field.count": "2",
                "mst.class.labels": "T,F"}
    return [
        ("a", "bayesianDistr", conf("bad"), churn, "nb"),
        ("b", "mutualInformation", mi_conf, churn, "mi"),
        ("c", "fisherDiscriminant", conf("fid"), churn, "fid"),
        ("c", "markovStateTransitionModel", mst_conf, seq, "mst"),
        ("a", "frequentItemsApriori", fia_conf, seq, "fia_a"),
        ("b", "frequentItemsApriori", fia_conf, seq, "fia_b"),
    ]


def server_tripwire(rows: int = 10_000_000, floor: float = 1.5,
                    budget_mb: float = 3072.0, slack_mb: float = 512.0,
                    device: str = "cuda") -> dict:
    """The resident job server against one job at a time: `server_load`
    served by one JobServer (2 workers) must beat the same six requests
    run one after another through `run_job` by `floor` in jobs/min, every
    served artifact equal to its sequential twin's. Admission must hold
    the process: the peak RSS sampled during the served phase
    (`analysis.mem._RssSampler`) stays under budget + slack, and the
    priced peak under the budget. A warm-up on 500 rows runs each job
    first, off the clock (the kernels build there)."""
    from avenir_tpu_torch.analysis.mem import _read_rss_bytes, _RssSampler
    from avenir_tpu_torch.data import generate_churn
    from avenir_tpu_torch.runner import run_job
    from avenir_tpu_torch.server import JobRequest, JobServer

    d = tempfile.mkdtemp(prefix="avenir_server_tripwire_")
    try:
        churn, schema = _churn_corpus(d, rows, seed=31)
        # the reference's 100,000-row blob; a smaller run draws its first
        # `rows` rows alone (the same rows: one generator, in order)
        seq_blob = _seq_blob(min(rows, 100_000), seed=32)
        seq = _blob_corpus(os.path.join(d, "seq.csv"), rows, seq_blob,
                           100_000)
        load = server_load(churn, seq, schema)
        warm_churn = os.path.join(d, "warm_churn.csv")
        with open(warm_churn, "w") as fh:
            fh.write(generate_churn(500, seed=33, as_csv=True))
        warm_seq = _blob_corpus(os.path.join(d, "warm_seq.csv"), 500,
                                seq_blob, 100_000)
        for _t, job, cf, corpus, tag in load[:5]:
            run_job(job, cf, [warm_churn if corpus == churn else warm_seq],
                    os.path.join(d, f"warm_{tag}"), device=device)
        # the served phase first, its RSS sampled alone: the sequential
        # twin is not under admission
        server = JobServer(budget_bytes=int(budget_mb * (1 << 20)),
                           workers=2, state_root=os.path.join(d, "state"),
                           device=device)
        tickets = {tag: server.submit(JobRequest(
                       job, cf, [corpus], os.path.join(d, f"srv_{tag}"),
                       tenant=tenant))
                   for tenant, job, cf, corpus, tag in load}
        rss_before = _read_rss_bytes()
        t0 = time.perf_counter()
        with _RssSampler() as sampler:
            server.start()
            server.drain(timeout=7200)
            _sync(device)
        t_srv = time.perf_counter() - t0
        served = {tag: t.result(timeout=60) for tag, t in tickets.items()}
        stats = server.stats()
        server.shutdown()
        t0 = time.perf_counter()
        seq_res = {tag: run_job(job, cf, [corpus],
                                os.path.join(d, f"seq_{tag}"),
                                device=device)
                   for _t, job, cf, corpus, tag in load}
        _sync(device)
        t_seq = time.perf_counter() - t0
        for *_rest, tag in load:
            if _file_bytes(served[tag]) != _file_bytes(seq_res[tag]):
                raise RuntimeError(f"served {tag}: an artifact differs from "
                                   f"its sequential twin's")
        speedup = t_seq / max(t_srv, 1e-9)
        peak_rss = sampler.peak_rss / (1 << 20)
        waits = sorted(r.counters["Server:QueueWaitMs"]
                       for r in served.values())
        batched = max(r.counters["Server:BatchSize"]
                      for r in served.values())
        row = {"rows": rows, "requests": len(load), "floor": floor,
               "device": device, "t_served_s": t_srv,
               "t_sequential_s": t_seq,
               "jobs_per_min_sequential": len(load) / (t_seq / 60.0),
               "jobs_per_min_served": len(load) / (t_srv / 60.0),
               "speedup": speedup,
               "p50_queue_wait_ms": waits[len(waits) // 2],
               "p99_queue_wait_ms": waits[-1],
               "max_batch_size": int(batched),
               "coalesced": int(stats["coalesced"]),
               "warm_hits": int(stats["warm_hits"]),
               "rss_before_mb": rss_before / (1 << 20),
               "peak_rss_mb": peak_rss,
               "peak_device_mb": sampler.peak_live / (1 << 20),
               "peak_priced_mb": stats["peak_priced_bytes"] / (1 << 20),
               "budget_mb": budget_mb,
               "outputs_byte_identical": True}
        # every gate is read, and a failure carries the numbers
        missed = []
        if speedup < floor:
            missed.append(f"served load only {speedup:.2f}x sequential "
                          f"jobs/min (floor {floor}x)")
        if peak_rss > budget_mb + slack_mb:
            missed.append(
                f"peak RSS {peak_rss:.0f} MB during the served phase "
                f"exceeded the {budget_mb:.0f} MB budget + {slack_mb:.0f} "
                f"MB slack")
        if stats["peak_priced_bytes"] > budget_mb * (1 << 20):
            missed.append(
                f"admission let priced in-flight bytes "
                f"({stats['peak_priced_bytes']:.0f}) past the budget")
        if batched < 2:
            missed.append("no request was batched")
        if missed:
            raise RuntimeError("; ".join(missed) + f": {json.dumps(row)}")
        return row
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _sync(device: str) -> None:
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def _churn_trio(schema: str) -> list:
    """(job, prefix, conf, tag) of the churn profiling trio."""
    conf = lambda p: {f"{p}.feature.schema.file.path": schema}  # noqa: E731
    mi_conf = {**conf("mut"), "mut.mutual.info.score.algorithms":
               "mutual.info.maximization"}
    return [("bayesianDistr", "bad", conf("bad"), "nb"),
            ("mutualInformation", "mut", mi_conf, "mi"),
            ("fisherDiscriminant", "fid", conf("fid"), "fid")]


def fleet_tripwire(rows: int = 10_000_000, floor: float = 1.5,
                   budget_mb: float = 3072.0, min_hit_rate: float = 0.6,
                   rounds: int = 2, parallel_efficiency_floor: float = 0.75,
                   device: str = "cuda") -> dict:
    """A 2-host fleet against a 1-host one on the same open-loop load (the
    churn trio over two corpora, `rounds` rounds: 6 x rounds requests),
    each host pinned to one core and serving on `device`: the fleet must
    beat the single host by ``min(floor, capacity x 0.75)`` in jobs/min
    where the box's two-process capacity is at least 1.7 (else the
    numbers are recorded without a verdict); the router's affinity hit
    rate must reach `min_hit_rate` (round 2 returns to round 1's host);
    no host's admission peak and no router assignment may pass its
    budget entry; every first-round artifact equals its solo twin's."""
    from avenir_tpu_torch.data import generate_churn
    from avenir_tpu_torch.net.fleet import Fleet
    from avenir_tpu_torch.runner import run_job

    d = tempfile.mkdtemp(prefix="avenir_fleet_tripwire_")
    try:
        (c0, schema), (c1, _s) = (
            _churn_corpus(d, rows, seed=seed, name=f"churn_{i}.csv")
            for i, seed in enumerate((41, 43)))
        corpora = [c0, c1]
        trio = _churn_trio(schema)
        load = []
        for rnd in range(rounds):
            for ci, corpus in enumerate(corpora):
                for job, prefix, cf, short in trio:
                    # an inert key in the conf digest: round 2 runs again
                    # on its warm host instead of coalescing into round 1
                    load.append((f"{short}_c{ci}_r{rnd}", {
                        "job": job,
                        "conf": {**cf, f"{prefix}.bench.round": str(rnd)},
                        "inputs": [corpus], "tenant": f"tenant_{short}",
                        "output": os.path.join(d, "served",
                                               f"{short}_c{ci}_r{rnd}")}))
        warm = os.path.join(d, "warm.csv")
        with open(warm, "w") as fh:
            fh.write(generate_churn(500, seed=45, as_csv=True))
        n_cores = os.cpu_count() or 2

        def run_arm(hosts: int) -> dict:
            root = os.path.join(d, f"arm_{hosts}h")
            fleet = Fleet(root, hosts=hosts, workers=1, budget_mb=budget_mb,
                          metrics_interval_s=0.5,
                          pin_cores=[i % n_cores for i in range(hosts)],
                          device=device)
            with fleet:
                # every host builds its kernels and warms up off the clock
                fleet.collect([fleet.submit_to(h, {
                    "job": job, "conf": cf, "inputs": [warm],
                    "output": os.path.join(root, f"warm_{h}_{short}")})
                    for h in range(hosts) for job, _p, cf, short in trio],
                    timeout=600)
                t0 = time.perf_counter()
                names = {tag: fleet.submit(dict(obj, output=os.path.join(
                             d, "served", f"{hosts}h_{tag}")))
                         for tag, obj in load}
                got = fleet.collect(list(names.values()), timeout=7200)
                dt = time.perf_counter() - t0
                rows_by_tag = {tag: got[n] for tag, n in names.items()}
                router = fleet.router.snapshot()
                hit_rate = fleet.router.affinity_hit_rate()
            bad = [t for t, r in rows_by_tag.items() if not r.get("ok")]
            if bad:
                raise RuntimeError(
                    f"{hosts}-host arm failed requests {bad}: "
                    f"{rows_by_tag[bad[0]].get('error')}")
            per_host = []
            for i in range(hosts):
                with open(os.path.join(root, f"host{i}",
                                       "metrics.json")) as fh:
                    hs = json.load(fh)
                peak = hs["inflight"]["peak_priced_bytes"]
                if peak > budget_mb * (1 << 20):
                    raise RuntimeError(
                        f"host {i} admission peak {peak} breached its "
                        f"{budget_mb} MB budget entry")
                per_host.append({
                    "host": i, "served": hs["stats"].get("served", 0.0),
                    "p99_queue_wait_ms": hs["hists"].get(
                        "queue_wait_ms", {}).get("p99", 0.0),
                    "peak_priced_mb": peak / (1 << 20)})
            for h in router["hosts"]:
                if h["peak_assigned_bytes"] > h["budget_bytes"]:
                    raise RuntimeError(f"router assigned host {h['host']} "
                                       f"past its budget entry")
            return {"wall_s": dt, "jobs_per_min": len(load) / (dt / 60.0),
                    "hit_rate": hit_rate, "router": router["stats"],
                    "per_host": per_host, "rows": rows_by_tag}

        cap_before = host_parallel_capacity(2)
        solo = run_arm(1)
        fleet_arm = run_arm(2)
        capacity = min(cap_before, host_parallel_capacity(2))
        for tag, obj in load[:6]:
            twin = run_job(obj["job"], obj["conf"], obj["inputs"],
                           os.path.join(d, "twin", tag), device=device)
            if _file_bytes(twin) != _bytes_of(
                    fleet_arm["rows"][tag]["outputs"]):
                raise RuntimeError(f"fleet {tag}: an artifact differs from "
                                   f"its solo twin's")
        speedup = solo["wall_s"] / max(fleet_arm["wall_s"], 1e-9)
        effective_floor = min(floor, capacity * parallel_efficiency_floor)
        gated = capacity >= 1.7
        if gated and speedup < effective_floor:
            raise RuntimeError(
                f"2-host fleet only {speedup:.2f}x the 1-host server "
                f"(floor {effective_floor:.2f}x; solo {solo['wall_s']:.2f}"
                f" s, fleet {fleet_arm['wall_s']:.2f} s)")
        if fleet_arm["hit_rate"] < min_hit_rate:
            raise RuntimeError(
                f"affinity hit rate {fleet_arm['hit_rate']:.2f} under the "
                f"{min_hit_rate} floor")
        return {"rows": rows, "requests": len(load), "floor": floor,
                "device": device, "effective_floor": effective_floor,
                "host_parallel_capacity": capacity,
                "throughput_gated": gated, "speedup": speedup,
                "t_solo_s": solo["wall_s"], "t_fleet_s": fleet_arm["wall_s"],
                "jobs_per_min_solo": solo["jobs_per_min"],
                "jobs_per_min_fleet": fleet_arm["jobs_per_min"],
                "affinity_hit_rate": fleet_arm["hit_rate"],
                "router": fleet_arm["router"],
                "per_host": fleet_arm["per_host"],
                "outputs_byte_identical": True}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def fleet_fault_tripwire(rows: int = 10_000_000, budget_mb: float = 3072.0,
                         device: str = "cuda",
                         lease_ttl_s: float = 2.0) -> dict:
    """Dying and stalled hosts lose and corrupt nothing (no speed floor).

    **Chaos leg**: a 2-host fleet serves the churn trio over two corpora;
    once the first result lands, the host holding the most unfinished
    leases is SIGKILLed (stopped first, and killed only while a leased
    request of its has no result row: the kill strands work). Every request yields an ok row, each artifact
    equals its solo twin's, at least one requeue fired, no lease is
    left, and the killed host restarts and serves again.

    **Hedging leg**: both hosts warmed, one SIGSTOPped, a fresh corpus
    placed on it: the front mirrors it to the other host (router hedges
    >= 1), the first result wins while the original is stopped, with no
    requeue or restart; the late original's bytes equal the twin's.

    `lease_ttl_s` is the reference's 2 s."""
    from avenir_tpu_torch.data import generate_churn
    from avenir_tpu_torch.net.fault import FaultPolicy
    from avenir_tpu_torch.net.fleet import Fleet
    from avenir_tpu_torch.runner import run_job

    d = tempfile.mkdtemp(prefix="avenir_fleet_fault_")
    try:
        (c0, schema), (c1, _s) = (
            _churn_corpus(d, rows, seed=seed, name=f"churn_{i}.csv")
            for i, seed in enumerate((61, 67)))
        corpora = [c0, c1]
        trio = _churn_trio(schema)
        load = [(f"{short}_c{ci}", {
                    "job": job, "conf": cf, "inputs": [corpus],
                    "tenant": f"tenant_{short}",
                    "output": os.path.join(d, "served", f"{short}_c{ci}")})
                for ci, corpus in enumerate(corpora)
                for job, _p, cf, short in trio]
        warm = os.path.join(d, "warm.csv")
        with open(warm, "w") as fh:
            fh.write(generate_churn(500, seed=71, as_csv=True))
        n_cores = os.cpu_count() or 2
        pin = [i % n_cores for i in range(2)]

        chaos_policy = FaultPolicy(
            poll_interval_s=0.1, lease_ttl_s=lease_ttl_s,
            restart_backoff_base_s=0.5, heartbeat_timeout_s=60.0,
            hedge=False)
        fleet = Fleet(os.path.join(d, "chaos"), hosts=2, workers=1,
                      budget_mb=budget_mb, metrics_interval_s=0.5,
                      pin_cores=pin, fault_policy=chaos_policy,
                      device=device)
        with fleet:
            fleet.collect([fleet.submit_to(h, {
                "job": job, "conf": cf, "inputs": [warm],
                "output": os.path.join(d, "chaos", f"w_{h}_{short}")})
                for h in range(2) for job, _p, cf, short in trio],
                timeout=600)
            names = {tag: fleet.submit(obj) for tag, obj in load}
            deadline = time.perf_counter() + 3600
            while not fleet.ready():
                if time.perf_counter() > deadline:
                    raise RuntimeError("no fleet result within 3600 s")
                time.sleep(0.05)
            # the victim: the host holding the most unfinished leases (the
            # sweep races this loop; if the batch drains first, no kill)
            # the victim: the host holding the most unfinished leases. It
            # is stopped before its leases are read against the result
            # rows on disk, so what the kill strands is known: a host
            # whose leased requests all finished is resumed and the
            # choice made again (if the batch drains first, no kill)
            victim = victim_pid = None
            stranded: List[str] = []
            kill_deadline = time.perf_counter() + 60
            while victim_pid is None \
                    and time.perf_counter() < kill_deadline:
                held: Dict[int, List[str]] = {}
                for lease_name in fleet._leases.names():
                    lease = fleet._leases.load(lease_name)
                    if lease is not None:
                        held.setdefault(lease.host, []).append(lease_name)
                if not held and not fleet._outstanding:
                    break
                victim = max(held, key=lambda h: len(held[h])) \
                    if held else None
                pid = fleet.host_pid(victim) if held else None
                if pid is None:
                    time.sleep(0.02)
                    continue
                os.kill(pid, signal.SIGSTOP)
                with fleet._lock:
                    paths = {n: [c.out_path for c in fleet._outstanding[n]
                                 .copies] for n in held[victim]
                             if n in fleet._outstanding}
                stranded = [n for n, ps in paths.items()
                            if not any(os.path.exists(p) for p in ps)]
                if stranded:
                    victim_pid = pid
                else:
                    os.kill(pid, signal.SIGCONT)
                    time.sleep(0.02)
            killed = victim_pid is not None
            if killed:
                os.kill(victim_pid, signal.SIGKILL)
            got = fleet.collect(list(names.values()), timeout=7200)
            rows_by_tag = {tag: got[n] for tag, n in names.items()}
            bad = [t for t, r in rows_by_tag.items() if not r.get("ok")]
            if bad:
                raise RuntimeError(
                    f"chaos leg lost/failed requests {bad}: "
                    f"{rows_by_tag[bad[0]].get('error')}")
            chaos_snap = fleet.fault_snapshot()
            if killed and chaos_snap["stats"]["requeues"] < 1:
                raise RuntimeError("chaos leg: SIGKILL stranded no lease")
            if chaos_snap["leases_outstanding"] != 0:
                raise RuntimeError(f"chaos leg leaked "
                                   f"{chaos_snap['leases_outstanding']} "
                                   f"lease(s)")
            t0 = time.perf_counter()
            while killed:
                snap = fleet.fault_snapshot()
                if snap["stats"]["restarts"] >= 1 \
                        and snap["hosts"][victim]["state"] == "serving":
                    break
                if time.perf_counter() - t0 > 120:
                    raise RuntimeError(f"killed host {victim} never "
                                       f"reintegrated: {snap}")
                time.sleep(0.1)
        for tag, obj in load:
            twin = run_job(obj["job"], obj["conf"], obj["inputs"],
                           os.path.join(d, "twin", tag), device=device)
            if _file_bytes(twin) != _bytes_of(rows_by_tag[tag]["outputs"]):
                raise RuntimeError(f"chaos leg {tag}: an artifact differs "
                                   f"from its solo twin's (a conflicting "
                                   f"result)")

        hedge_policy = FaultPolicy(
            poll_interval_s=0.1, hedge_multiple=2.0, hedge_floor_ms=500.0,
            lease_ttl_s=3600.0, heartbeat_timeout_s=3600.0)
        hedge_fleet = Fleet(os.path.join(d, "hedge"), hosts=2, workers=1,
                            budget_mb=budget_mb, metrics_interval_s=0.5,
                            pin_cores=pin, fault_policy=hedge_policy,
                            device=device)
        job, _prefix, cf, short = trio[0]
        with hedge_fleet:
            hedge_fleet.collect([hedge_fleet.submit_to(h, {
                "job": job, "conf": cf, "inputs": [warm],
                "output": os.path.join(d, "hedge", f"w_{h}")})
                for h in range(2)], timeout=600)
            # the hedge gate reads each host's served tail from its
            # heartbeat snapshot: wait for both before stopping one
            t0 = time.perf_counter()
            while not all(n >= 1 for _p, n
                          in hedge_fleet._rolled_p99().values()):
                if time.perf_counter() - t0 > 60:
                    raise RuntimeError(
                        "host heartbeats never reflected the warm-ups")
                time.sleep(0.1)
            os.kill(hedge_fleet.host_pid(0), signal.SIGSTOP)
            try:
                hname = hedge_fleet.submit({
                    "job": job, "conf": cf, "inputs": [corpora[0]],
                    "tenant": "hedge",
                    "output": os.path.join(d, "served", "hedged")})
                hrow = hedge_fleet.collect([hname], timeout=7200)[hname]
            finally:
                os.kill(hedge_fleet.host_pid(0), signal.SIGCONT)
            if not hrow.get("ok"):
                raise RuntimeError(f"hedging leg request failed: "
                                   f"{hrow.get('error')}")
            hedges = hedge_fleet.router.stats["hedges"]
            hsnap = hedge_fleet.fault_snapshot()
            if hedges < 1:
                raise RuntimeError("hedging leg: the stalled host never "
                                   "triggered a mirror")
            if hsnap["stats"]["requeues"] or hsnap["stats"]["restarts"]:
                raise RuntimeError(f"hedging leg: a stall must hedge, not "
                                   f"requeue or restart ({hsnap['stats']})")
        twin = run_job(job, cf, [corpora[0]],
                       os.path.join(d, "twin", "hedged"), device=device)
        if _file_bytes(twin) != _bytes_of(hrow["outputs"]):
            raise RuntimeError("the hedged artifact differs from its solo "
                               "twin's")
        return {"rows": rows, "requests": len(load), "device": device,
                "lease_ttl_s": lease_ttl_s,
                "chaos_requeues": int(chaos_snap["stats"]["requeues"]),
                "chaos_restarts": int(chaos_snap["stats"]["restarts"]),
                "victim_host": int(victim) if killed else None,
                "chaos_kill_skipped": not killed,
                "stranded_at_kill": len(stranded), "hedges": int(hedges),
                "zero_lost": True, "zero_conflicting": True,
                "outputs_byte_identical": True}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def score_tripwire(queries: int = 512, floor: float = 3.0,
                   p99_ceiling_ms: float = 250.0, min_hit_rate: float = 0.9,
                   fleet_scores_per_model: int = 40,
                   device: str = "cuda") -> dict:
    """The score plane's coalescing and the score fleet, on `device`.

    **Coalescing leg**: `queries` markov scores (a 24-state model) from
    32 client threads into one ScorePlane (2 ms window, batch 64) must
    beat the same rows scored one by one through `score_once` (load,
    predict one row, drop) by `floor` in scores/s, with one model load,
    fewer predicts than requests, every row equal to its solo twin, and
    the per-model p99 under `p99_ceiling_ms`.

    **Fleet leg**: two in-process JobServer + NetListener hosts behind a
    ScoreFront, two models over keep-alive sockets: affinity hit rate at
    least `min_hit_rate`, every wire row equal to its solo twin, and the
    merged snapshot holding both models' histograms and every score."""
    import math

    from avenir_tpu_torch.net.fleet import ScoreFront
    from avenir_tpu_torch.net.listener import NetListener
    from avenir_tpu_torch.obs.report import merge_snapshots
    from avenir_tpu_torch.runner import run_job
    from avenir_tpu_torch.server import JobServer
    from avenir_tpu_torch.server.score import (ScorePlane, ScoreRequest,
                                               score_once)

    states = tuple(f"s{i:02d}" for i in range(24))
    mst_conf = {"mst.model.states": ",".join(states),
                "mst.class.label.field.ord": "1",
                "mst.skip.field.count": "2", "mst.class.labels": "T,F"}
    score_conf = {"field.delim": ",", "class.labels": "T,F",
                  "log.odds.threshold": "0", "skip.field.count": "2"}

    def seq_rows(start: int, n: int) -> list:
        return [f"c{i}," + ("T" if i % 2 else "F") + ","
                + ",".join(states[(i + j) % len(states)] for j in range(6))
                for i in range(start, start + n)]

    d = tempfile.mkdtemp(prefix="avenir_score_tripwire_")
    try:
        models = []
        for m, start in enumerate((0, 7)):
            corpus = os.path.join(d, f"train_{m}.csv")
            with open(corpus, "w") as fh:
                fh.write("\n".join(seq_rows(start, 600)) + "\n")
            model = os.path.join(d, f"model_{m}.txt")
            run_job("markovStateTransitionModel", dict(mst_conf), [corpus],
                    model, device=device)
            models.append(model)
        model = models[0]
        rows = [seq_rows(i * 3, 6)[0] for i in range(queries)]
        score_once("markov", model, rows[0], score_conf, device=device)
        t0 = time.perf_counter()
        solo = [score_once("markov", model, r, score_conf, device=device)
                for r in rows]
        t_solo = time.perf_counter() - t0
        plane = ScorePlane(window_ms=2.0, batch_max=64, device=device)
        try:
            plane.score(ScoreRequest("markov", model, rows[0],
                                     dict(score_conf)))
            warm_predicts = plane.predict_calls(model)
            out = [None] * queries
            n_threads = 32

            def client(t: int) -> None:
                for i in range(t, queries, n_threads):
                    out[i] = plane.score(ScoreRequest(
                        "markov", model, rows[i], dict(score_conf)),
                        timeout=60.0).row

            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            t_plane = time.perf_counter() - t0
            predicts = plane.predict_calls(model) - warm_predicts
            stats = plane.snapshot()["stats"]
            name = os.path.splitext(os.path.basename(model))[0]
            summary = plane.hist_summaries()[f"score_{name}_total_ms"]
        finally:
            plane.close()
        for i, (a, b) in enumerate(zip(solo, out)):
            if a != b:
                raise RuntimeError(f"coalesced row {i} differs from its "
                                   f"solo twin ({b!r} vs {a!r})")
        if stats["model_loads"] != 1:
            raise RuntimeError(f"the plane loaded the model "
                               f"{stats['model_loads']} times")
        if predicts >= queries:
            raise RuntimeError(f"{predicts} predicts for {queries} "
                               f"requests: the window never coalesced")
        speedup = t_solo / max(t_plane, 1e-9)
        if speedup < floor:
            raise RuntimeError(
                f"coalesced scoring only {speedup:.2f}x the solo reference "
                f"(floor {floor}x; solo {t_solo:.2f} s, plane "
                f"{t_plane:.2f} s)")
        if summary["p99"] > p99_ceiling_ms:
            raise RuntimeError(f"score p99 {summary['p99']:.1f} ms past "
                               f"the {p99_ceiling_ms} ms ceiling")

        fleet_rows = rows[:fleet_scores_per_model]
        solo_by_model = {m: [score_once("markov", m, r, score_conf,
                                        device=device) for r in fleet_rows]
                         for m in models}
        servers = [JobServer(workers=1, state_root=os.path.join(d, f"h{i}"),
                             device=device).start() for i in range(2)]
        listeners = [NetListener(s, port=0).start() for s in servers]
        try:
            front = ScoreFront([f"http://127.0.0.1:{lis.port}"
                                for lis in listeners])
            wire = {m: [None] * len(fleet_rows) for m in models}

            def fleet_client(m: str) -> None:
                for i, r in enumerate(fleet_rows):
                    wire[m][i] = front.score("markov", m, r,
                                             conf=dict(score_conf),
                                             timeout=60.0)["row"]

            fthreads = [threading.Thread(target=fleet_client, args=(m,))
                        for m in models]
            for t in fthreads:
                t.start()
            for t in fthreads:
                t.join()
            hit_rate = front.router.affinity_hit_rate()
            front.close()
            snap = merge_snapshots([s.metrics_snapshot() for s in servers])
        finally:
            for lis in listeners:
                lis.stop()
            for srv in servers:
                srv.shutdown()
        for m in models:
            for i, (a, b) in enumerate(zip(solo_by_model[m], wire[m])):
                if a != b:
                    raise RuntimeError(f"fleet row {i} of {m} differs from "
                                       f"its solo twin ({b!r} vs {a!r})")
        if hit_rate < min_hit_rate:
            raise RuntimeError(f"score affinity hit rate {hit_rate:.2f} "
                               f"under the {min_hit_rate} floor")
        total = 2 * len(fleet_rows)
        fleet_stats = (snap.get("score") or {}).get("stats", {})
        if int(fleet_stats.get("scores", 0)) != total:
            raise RuntimeError(f"merged snapshot counts "
                               f"{fleet_stats.get('scores')} scores, "
                               f"{total} were served")
        missing = [m for m in models
                   if "score_" + os.path.splitext(os.path.basename(m))[0]
                   .replace(".", "_") + "_total_ms"
                   not in (snap.get("hists_raw") or {})]
        if missing:
            raise RuntimeError(f"merged snapshot lacks the score "
                               f"histograms of {missing}")
        return {"queries": queries, "floor": floor, "device": device,
                "speedup": speedup, "t_solo_s": t_solo,
                "t_plane_s": t_plane,
                "scores_per_s_solo": queries / t_solo,
                "scores_per_s_coalesced": queries / max(t_plane, 1e-9),
                "vectorized_dispatches": int(predicts),
                "dispatch_bound": int(math.ceil(queries / 64)),
                "model_loads": int(stats["model_loads"]),
                "p50_total_ms": summary["p50"],
                "p99_total_ms": summary["p99"],
                "p99_ceiling_ms": p99_ceiling_ms,
                "fleet_scores": total,
                "fleet_affinity_hit_rate": hit_rate,
                "rows_byte_identical": True}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _trio_specs(d: str, schema: str, tag: str, extra=None) -> list:
    """(job, conf, output) of the churn trio, each conf with the `extra`
    keys (un-prefixed) under its job's prefix."""
    return [(job, {**cf, **{f"{prefix}.{k}": v
                            for k, v in (extra or {}).items()}},
             os.path.join(d, f"{tag}_{short}"))
            for job, prefix, cf, short in _churn_trio(schema)]


def _timed_shared(specs, csv: str, device: str) -> Tuple[dict, float]:
    """(results, seconds) of one `run_shared` of `specs` over `csv`, the
    clock stopped after the device drains."""
    from avenir_tpu_torch.runner import run_shared

    _sync(device)
    t0 = time.perf_counter()
    res = run_shared(specs, [csv], device=device)
    _sync(device)
    return res, time.perf_counter() - t0


def _same_outputs(a: dict, b: dict, what: str) -> None:
    for job in a:
        if _file_bytes(a[job]) != _file_bytes(b[job]):
            raise RuntimeError(
                f"{what} changed the output of {job}: the run may change "
                f"speed, never bytes")


def obs_tripwire(rows: int = 10_000_000, ceiling: float = 1.03,
                 device: str = "cuda") -> dict:
    """Telemetry overhead and coverage: the fused churn trio (one
    SharedScan, 8 MB blocks) runs once with tracing off and once with
    tracing on under a captured recorder; the traced run must stay within
    `ceiling` x the untraced wall clock, write the same bytes, and record
    a read and a parse span a chunk and a fold span a chunk for every
    job. Every pass parses (`stream.sidecar=false`): a sidecar replay
    records `stream.sidecar.replay` in place of the read and parse spans
    the coverage check counts, and parsing is the hot path whose
    instrumentation is measured. One untimed pass first, so that the
    page cache and the allocator price neither timed side."""
    from collections import Counter

    from avenir_tpu_torch import obs

    d = tempfile.mkdtemp(prefix="avenir_obs_tripwire_")
    try:
        csv, schema = _churn_corpus(d, rows, seed=21)
        extra = {"stream.block.size.mb": "8", "stream.sidecar": "false"}
        jobs = [j for j, _c, _o in _trio_specs(d, schema, "x")]
        _timed_shared(_trio_specs(d, schema, "warm", extra), csv, device)
        prev = obs.set_enabled(False)
        try:
            off_res, t_off = _timed_shared(
                _trio_specs(d, schema, "off", extra), csv, device)
        finally:
            obs.set_enabled(prev)
        with obs.capture() as rec:
            on_res, t_on = _timed_shared(
                _trio_specs(d, schema, "on", extra), csv, device)
        _same_outputs(off_res, on_res, "tracing")
        spans = rec.spans()
        chunks = next((int(sp.attrs["chunks"]) for sp in spans
                       if sp.name == "job.dispatch"), 0)
        names = Counter(sp.name for sp in spans)
        folds = Counter(sp.attrs.get("sink") for sp in spans
                        if sp.name == "stream.fold" and sp.attrs)
        if chunks < 1:
            raise RuntimeError("traced fused run recorded no job.dispatch "
                               "span: the scan executor went blind")
        blind = [j for j in jobs if folds.get(j, 0) < chunks]
        if (blind or names["stream.read"] < chunks
                or names["stream.parse"] < chunks):
            raise RuntimeError(
                f"trace coverage hole: {chunks} chunks scanned but "
                f"read={names['stream.read']} parse={names['stream.parse']} "
                f"folds={dict(folds)} (jobs missing folds: {blind})")
        overhead = t_on / max(t_off, 1e-9)
        out = {"rows": rows, "ceiling": ceiling, "device": device,
               "overhead_ratio": overhead, "t_off_s": t_off,
               "t_on_s": t_on, "chunks": chunks, "spans": len(spans),
               "spans_dropped": rec.dropped, "span_s": _span_seconds(spans),
               "outputs_byte_identical": True}
        if overhead > ceiling:
            raise RuntimeError(
                f"tracing overhead {overhead:.3f}x exceeds the {ceiling}x "
                f"ceiling (off {t_off:.2f}s, on {t_on:.2f}s): {out}")
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


def autotune_tripwire(rows: int = 10_000_000, floor: float = 1.15,
                      device: str = "cuda") -> dict:
    """The autotune loop pays: the fused churn trio runs under the static
    default knobs (64 MB blocks, prefetch depth 2, no stream.* sizing
    key) with the tuner recording its signals and choosing knobs, then
    under the knobs it chose, pinned as explicit conf keys; the tuned
    pass must beat the static one `floor` times over, to the same bytes.
    Each side has an untimed warm-up at its own knobs (the sidecar and
    the page cache), then the timed passes alternate static, tuned,
    static, tuned, each side's best kept; only the first static pass
    records into the profile store."""
    from avenir_tpu_torch.tune import (ProfileStore, corpus_digest,
                                       residual_factor)

    d = tempfile.mkdtemp(prefix="avenir_autotune_tripwire_")
    try:
        csv, schema = _churn_corpus(d, rows, seed=41)
        tune_dir = os.path.join(d, "tune")
        tuning = {"stream.autotune": "true", "stream.autotune.dir": tune_dir}
        jobs = [j for j, _c, _o in _trio_specs(d, schema, "x")]
        _timed_shared(_trio_specs(d, schema, "warm_static"), csv, device)
        static_res, t_static = _timed_shared(
            _trio_specs(d, schema, "static", tuning), csv, device)
        prof = ProfileStore(tune_dir).load("+".join(sorted(jobs)),
                                           corpus_digest([csv]))
        chosen = dict((prof or {}).get("knobs") or {})
        reasons = list((prof or {}).get("reasons") or [])
        signals = ((prof or {}).get("runs") or [{}])[-1].get("signals")
        if not chosen:
            raise RuntimeError(
                "autotuner chose no knobs from the static pass's signals: "
                f"the signal->policy leg is dead (profile={prof})")
        pinned = {k: f"{v:g}" for k, v in chosen.items()}
        _timed_shared(_trio_specs(d, schema, "warm_tuned", pinned), csv,
                      device)
        tuned_res, t_tuned = _timed_shared(
            _trio_specs(d, schema, "tuned", pinned), csv, device)
        static2, t_static2 = _timed_shared(
            _trio_specs(d, schema, "static2"), csv, device)
        tuned2, t_tuned2 = _timed_shared(
            _trio_specs(d, schema, "tuned2", pinned), csv, device)
        for res in (tuned_res, static2, tuned2):
            _same_outputs(static_res, res, "the tuned config")
        best_static, best_tuned = min(t_static, t_static2), \
            min(t_tuned, t_tuned2)
        speedup = best_static / max(best_tuned, 1e-9)
        # the residual the process's first streamed run (the untuned
        # warm-up: its store is beside the corpus) recorded: on a card it
        # holds what the run's first device use made resident
        first = {p["job"]: {"residuals": p.get("residuals"),
                            "factor": residual_factor(
                                p.get("residuals") or [])}
                 for p in ProfileStore(os.path.join(
                     d, ".avenir_tune")).profiles()}
        out = {"rows": rows, "floor": floor, "device": device,
               "speedup": speedup, "t_static_s": best_static,
               "t_tuned_s": best_tuned,
               "t_static_runs_s": [t_static, t_static2],
               "t_tuned_runs_s": [t_tuned, t_tuned2],
               "chosen_knobs": chosen, "reasons": reasons,
               "signals": signals, "first_run_residuals": first,
               "mem": {j: {k: v for k, v in static_res[j].counters.items()
                           if k.startswith("Mem:")} for j in jobs},
               "outputs_byte_identical": True}
        if speedup < floor:
            raise RuntimeError(
                f"tuned config only {speedup:.2f}x the static default "
                f"(floor {floor}x): the telemetry->knob loop stopped "
                f"paying: {json.dumps(out)}")
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _host_legs(device: str) -> dict:
    """The tripwire's host-service legs: the AST rules over the port's
    package, then the keys, proto and race tiers (the race at its
    default depth 3 and 64 seeds), each its rules and its audit over
    every registered site. Any finding past the allowlist, stale entry
    or site not validated raises RuntimeError; an audit that fails to
    run raises its own error."""
    from avenir_tpu_torch.analysis import keys, proto, race
    from avenir_tpu_torch.analysis.engine import load_baseline
    from avenir_tpu_torch.analysis.rules import run_rules

    def regression(name, rep):
        return RuntimeError(
            f"{name} audit regression: counts={rep.counts()} stale="
            f"{[e.key for e in rep.stale]} errors={len(rep.errors)}: "
            + "; ".join(f.render() for f in rep.findings[:5]))

    out: Dict[str, object] = {}
    t0 = time.perf_counter()
    rep = run_rules([os.path.join(ROOT, "avenir_tpu_torch")],
                    baseline=load_baseline(), root=ROOT)
    out["ast_s"] = time.perf_counter() - t0
    if not rep.clean:
        raise regression("AST", rep)
    out["ast_files"] = len(rep.scanned)
    out["ast_allowlisted"] = len(rep.suppressed)
    rows_out = {}
    for name, registry, run, attr, flag in (
            ("keys", keys.KEY_SITES, keys.run_keys, "key_audit",
             "key_validated"),
            ("proto", proto.COMMIT_SITES, proto.run_proto, "proto_audit",
             "commit_point_validated"),
            ("race", race.INTERLEAVE_SITES, race.run_race, "race_audit",
             "interleaving_validated")):
        t0 = time.perf_counter()
        rep = run(baseline=load_baseline(), root=ROOT, device=device)
        out[f"{name}_s"] = time.perf_counter() - t0
        if not rep.clean:
            raise regression(name, rep)
        rows = getattr(rep, attr)
        bad = [r["site"] for r in rows if not r[flag]]
        if bad or len(rows) < len(registry):
            raise RuntimeError(
                f"{name} audit regression: {len(rows)} of {len(registry)} "
                f"sites audited, failed={bad}")
        out[f"{name}_validated"] = len(rows)
        out[f"{name}_allowlisted"] = len(rep.suppressed)
        rows_out[name] = rows
    out["rows"] = rows_out
    return out


def _ir_leg(device: str) -> dict:
    """The tripwire's IR leg, the reference's: `run_ir` clean under the
    allowlist (the op entries on `device`, the families on a gloo world
    of eight CPU ranks) and all eight families' payloads validated.
    Raises RuntimeError on a finding past the allowlist, a stale entry or
    a drifted family; an entry that fails to run raises IRTraceError."""
    from avenir_tpu_torch.analysis.engine import load_baseline
    from avenir_tpu_torch.analysis.ir import run_ir

    t0 = time.perf_counter()
    rep = run_ir(baseline=load_baseline(), device=device)
    out: Dict[str, object] = {"ir_s": time.perf_counter() - t0}
    if not rep.clean:
        raise RuntimeError(
            f"IR audit regression: counts={rep.counts()} stale="
            f"{[e.key for e in rep.stale]}: "
            + "; ".join(f.render() for f in rep.findings[:5]))
    audit = rep.payload_audit
    bad = [a["family"] for a in audit if not a["payload_model_validated"]]
    if bad or len(audit) < 8:
        raise RuntimeError(
            f"collective payload audit regression: {len(audit)} families "
            f"audited, drifted={bad}")
    out["payload_validated"] = len(audit)
    out["ir_allowlisted"] = len(rep.suppressed)
    out["rows"] = audit
    return out


def audit_tripwire(device: str = "cuda", kernels: bool = True,
                   host: bool = True, ir: bool = True) -> dict:
    """Every leg of the reference's graftlint tripwire: first the host
    services (`_host_legs`: the AST rules, and the keys, proto and race
    tiers over every registered site; `host=False` leaves them out, for
    a caller that runs them itself), then the IR leg (`_ir_leg`: the IR
    rules clean and eight families' payloads validated; `ir=False`
    leaves it out, as `host`), then over the eight stream entries on
    `device` the
    flow rules and the chunk-invariance audit, the mem rules and the
    footprint audit, the merge rules and the shard-merge audit with its
    incremental and sharded-steal legs, and span coverage; at least
    eight entries validated in each, no finding past the allowlist. The
    memory manifest (with `kernels`, a row a CUDA kernel, measured on
    the card around calls of its own) goes to
    `build/avenir_tpu_torch/MEMORY_MANIFEST.json`; the rows are in the
    line. The entries' corpora are their own: the tripwire takes no
    `--rows`."""
    from avenir_tpu_torch.analysis.engine import load_baseline
    from avenir_tpu_torch.analysis.flow import run_flow
    from avenir_tpu_torch.analysis.mem import memory_manifest, run_mem
    from avenir_tpu_torch.analysis.merge import run_merge
    from avenir_tpu_torch.obs.coverage import audit_span_coverage

    out: Dict[str, object] = {"device": device}
    host_rows = {}
    if host:
        legs = _host_legs(device)
        host_rows = legs.pop("rows")
        out.update(legs)
    if ir:
        legs = _ir_leg(device)
        host_rows["payload"] = legs.pop("rows")
        out.update(legs)
    reports = {}
    for name, run in (("flow", run_flow), ("mem", run_mem),
                      ("merge", run_merge)):
        t0 = time.perf_counter()
        rep = run(baseline=load_baseline(), root=ROOT, device=device)
        out[f"{name}_s"] = time.perf_counter() - t0
        if not rep.clean:
            raise RuntimeError(
                f"{name} audit regression: counts={rep.counts()} stale="
                f"{[e.key for e in rep.stale]} errors={len(rep.errors)}: "
                + "; ".join(f.render() for f in rep.findings[:5]))
        out[f"{name}_allowlisted"] = len(rep.suppressed)
        reports[name] = rep
    gates = (("invariance", reports["flow"].invariance_audit,
              "invariance_validated"),
             ("footprint", reports["mem"].footprint_audit,
              "footprint_model_validated"),
             ("merge", reports["merge"].merge_audit, "merge_validated"),
             ("incremental", reports["merge"].merge_audit,
              "incremental_validated"),
             ("shard_dedup", reports["merge"].merge_audit,
              "shard_dedup_validated"))
    t0 = time.perf_counter()
    cov = audit_span_coverage(device=device)
    out["coverage_s"] = time.perf_counter() - t0
    gates += (("span_coverage", cov, "span_coverage_validated"),)
    for what, rows_, flag in gates:
        bad = [r["kernel"] for r in rows_ if not r.get(flag)]
        if bad or len(rows_) < 8:
            raise RuntimeError(
                f"{what} audit regression: {len(rows_)} stream entries "
                f"audited, failed={bad}")
        out[f"{what}_validated"] = len(rows_)
    manifest = memory_manifest(include_kernels=kernels, device=device)
    manifest["footprint_audit"] = reports["mem"].footprint_audit
    path = os.path.join(ROOT, "build", "avenir_tpu_torch",
                        "MEMORY_MANIFEST.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(manifest, fh, indent=1)
    out["memory_manifest"] = os.path.relpath(path, ROOT)
    out["kernels"] = manifest.get("kernels")
    out["rows"] = {"invariance": reports["flow"].invariance_audit,
                   "footprint": reports["mem"].footprint_audit,
                   "merge": reports["merge"].merge_audit,
                   "span_coverage": cov, **host_rows}
    return out


#: tripwire name -> (function, its default bound, the bound's keyword:
#: a speedup "floor" or an overhead "ceiling"; None: no speed bound)
TRIPWIRES = {"shard": (shard_tripwire, 1.5, "floor"),
             "incremental": (incremental_tripwire, 5.0, "floor"),
             "sidecar": (sidecar_tripwire, 2.0, "floor"),
             "server": (server_tripwire, 1.5, "floor"),
             "fleet": (fleet_tripwire, 1.5, "floor"),
             "fleet_fault": (fleet_fault_tripwire, None, None),
             "score": (score_tripwire, 3.0, "floor"),
             "autotune": (autotune_tripwire, 1.15, "floor"),
             "obs": (obs_tripwire, 1.03, "ceiling"),
             "miner": (miner_tripwire, None, None),
             "shared_scan": (shared_scan_tripwire, 1.3, "floor"),
             "audit": (audit_tripwire, None, None)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="avenir_tpu_torch.tools.bench_scaling")
    ap.add_argument("--tripwire", choices=sorted(TRIPWIRES), default="shard")
    ap.add_argument("--rows", type=int, default=None,
                    help="corpus rows, default the tripwire's own (the "
                         "score tripwire: its queries, default 512)")
    ap.add_argument("--floor", type=float, default=None,
                    help="the speedup floor, or the obs tripwire's "
                         "overhead ceiling (default: the tripwire's own)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fn, bound, keyword = TRIPWIRES[args.tripwire]
    kwargs = {"device": args.device}
    if args.rows is not None:
        if args.tripwire == "audit":
            ap.error("the audit tripwire takes no --rows")
        kwargs["queries" if args.tripwire == "score" else "rows"] = args.rows
    if bound is not None:
        kwargs[keyword] = bound if args.floor is None else args.floor
    print(json.dumps(fn(**kwargs)))


if __name__ == "__main__":
    main()
