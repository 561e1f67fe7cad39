"""Sharded streaming driver: N worker processes, one merged artifact.

The port of `avenir_tpu/dist/driver.py`. :func:`run_sharded` runs one
registered streamed job (the six `runner.stream_fold_names()`) across
`procs` worker processes on this host and writes the same artifact as
`run_job`:

1. The planner over-partitions every input into newline-aligned byte-range
   blocks (``factor`` x ``procs``) and publishes the atomic plan manifest,
   with the device every worker folds on.
2. Workers (:mod:`avenir_tpu_torch.dist.worker`, each a fresh interpreter:
   a process that holds a CUDA context is never forked) claim blocks
   through the block ledger, their home run first, then the unclaimed
   tail, fold each through the job's `StreamFoldOps` sink on the device,
   and commit its serialized carry first-commit-wins. A straggler's
   claimed block is folded again past the threshold its peers' telemetry
   sets; the ledger dedups, since every fold family is non-idempotent.
3. The coordinator restores every committed block state with
   `restore_state` and merges them in plan order with `merge_states`, then
   finishes the fold once. (The collective merge of
   :mod:`avenir_tpu_torch.dist.collective` is never called here, as in the
   reference.)

**The miners' per-k rounds run in the workers too** (``plan.per_k``):
after pass 1 the coordinator merges the k=1 supports, thresholds them, and
publishes each level's candidates as an atomic token-space manifest
(``<root>/candidates/k<k>.json``); the resident workers count each block's
supports by replaying their own encoded-block caches and commit the count
vectors in the level's ledger (``k<k>/b<id>``); the coordinator sums them
through `merge_support_counts` inside the miner's own `_merged_rounds`
loop (so the kept sets equal the in-process sharded miner's), and
publishes ``final.json`` when the frontier empties. For GSP the count is
`subseq_support.cu`, launched from the workers.

A sharded JobResult carries ``Shard:Blocks`` (plan blocks),
``Shard:StolenBlocks`` (claims outside the claimant's home run, every
namespace), ``Shard:DedupBlocks`` (rejected duplicate commits, every
namespace), ``Shard:MirroredBlocks``, ``Shard:MergeMs`` (restore and merge
wall), ``Shard:ScanSeconds`` (from the go barrier), ``Shard:Workers`` and,
for the miners, ``Shard:PerKRounds``, ``Shard:PerKBlocks``,
``Shard:PerKSeconds``, ``Cache:SpillBytes`` and ``Cache:EvictedBytes``
(summed over the workers), and the workers' own parse accounting:
``Sidecar:HitBlocks`` / ``Sidecar:DeltaBlocks`` and ``Shard:ParseSpans``
/ ``Shard:ReplaySpans``. Over a warm columnar sidecar the planner snaps
its cuts to the sidecar's verified block starts, and each worker replays
its range (read-only) instead of parsing it.

:func:`run_sharded_refresh` composes the driver with the incremental
refresh (``--shard N --incremental``): the checkpointed carry is restored
as `runner.run_incremental` restores it, only the appended tail is
planned and folded by the workers, the committed block states merge in
plan order into the restored carry, and the workers' fingerprints of the
chunks they folded extend the checkpoint.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from avenir_tpu_torch import obs
from avenir_tpu_torch.core.atomic import publish_bytes, sched_point
from avenir_tpu_torch.dist.detect import StragglerPolicy
from avenir_tpu_torch.dist.ledger import BlockLedger
from avenir_tpu_torch.dist.plan import (DEFAULT_FACTOR, ShardPlan, plan_shards,
                                        write_json_atomic, write_plan)
from avenir_tpu_torch.dist.worker import RESCAN_AT_FINISH
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device


class ShardError(RuntimeError):
    """A sharded run that lost workers or blocks."""


def _pkg_parent() -> str:
    import avenir_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(
        avenir_tpu_torch.__file__)))


def _worker_env() -> Dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_pkg_parent(), env.get("PYTHONPATH")) if p)
    return env


def _sidecar_snap(cfg, ops, inputs: Sequence[str], procs: int,
                  factor: int, schema=None
                  ) -> Optional[List[Optional[List[int]]]]:
    """Each input's verified sidecar block starts, for the planner to snap
    its cuts to, where the sidecar is at least as fine as the plan (at
    least procs x factor blocks: a coarser one would merge plan blocks and
    starve workers). None when no input qualifies: the planner scans for
    newlines and the workers parse."""
    from avenir_tpu_torch.native import sidecar

    opts = sidecar.opts_from_cfg(cfg)
    if opts is None:
        return None
    block_bytes = int(cfg.get_float("stream.block.size.mb", 64.0)
                      * (1 << 20))
    delim = cfg.field_delim_regex
    if ops.kind == "dataset" and schema is None:
        from avenir_tpu_torch.runner import _schema

        schema = _schema(cfg)
    snap: List[Optional[List[int]]] = []
    for path in inputs:
        if ops.kind == "dataset":
            dirpath = sidecar.dataset_dir(opts, path, schema, delim,
                                          block_bytes)
        else:
            dirpath = sidecar.bytes_dir(opts, path, delim,
                                        cfg.get_int("skip.field.count", 1),
                                        block_bytes)
        offs = sidecar.verified_offsets(dirpath, path, block_bytes)
        snap.append(offs if len(offs) >= procs * factor else None)
    return snap if any(sn is not None for sn in snap) else None


def _restore_inputs(canonical: str, plan: ShardPlan, block,
                    inputs: Sequence[str], workdir: str) -> List[str]:
    """The inputs a restored block state finishes against. A miner's
    finish() re-scans its inputs a round, so its block state must see only
    its block's lines: a slice file of the input (plan blocks are
    newline-aligned). Every other family's finish reads no input, so it
    keeps the real list. run_sharded's miners count in the workers and
    never come here; an in-process merge of miner block states does."""
    if canonical not in RESCAN_AT_FINISH:
        return list(inputs)
    slice_path = os.path.join(workdir, f"slice_b{block.id}.bin")
    if not os.path.exists(slice_path):
        with open(plan.inputs[block.input]["path"], "rb") as fh:
            fh.seek(block.start)
            data = fh.read(block.end - block.start)
        publish_bytes(data, slice_path)
    return [slice_path]


def merge_block_states(canonical: str, cfg, ops, plan: ShardPlan,
                       states: Dict[int, bytes], inputs: Sequence[str],
                       workdir: str, schema=None, device: DeviceLike = None):
    """Restore every committed block state on `device` and merge them in
    plan order (exactly one state a block id reaches this table). Returns
    the merged fold, ready for finish()."""
    merged = None
    for blk in plan.blocks:
        if blk.id not in states:
            raise ShardError(f"block {blk.id} has no committed state")
        rins = _restore_inputs(canonical, plan, blk, inputs, workdir)
        fold = ops.restore_state(cfg, rins, states[blk.id], schema=schema,
                                 device=device)
        merged = fold if merged is None else ops.merge_states(merged, fold)
    if merged is None:
        raise ShardError("shard plan has no blocks")
    return merged


# ----------------------------------------------------------- per-k rounds
def _miner_scan_state(blob: bytes):
    """(vocab, k=1 counts, row count) of one committed pass-1 miner block
    state: all the per-k merge needs of it."""
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        counts = np.asarray(z["counts"], np.int64)
    return list(meta["vocab"]), counts, int(meta["n"])


def _level_counts(blob: bytes) -> np.ndarray:
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        return np.asarray(z["counts"], np.int64)


def _level_tids(blob: bytes) -> List[List[str]]:
    return json.loads(blob.decode("utf-8"))["tids"]


def publish_candidates(cand_dir: str, name: str, man: dict) -> str:
    """Publish one per-k manifest (``k<k>.json``, ``tids.json`` or
    ``final.json``) into `cand_dir`."""
    path = os.path.join(cand_dir, f"{name}.json")
    sched_point("cand.publish")
    write_json_atomic(man, path)
    return path


def _wait_commits(ledger: BlockLedger, n_blocks: int, workers, logs: str,
                  deadline: float, poll_s: float) -> None:
    """Wait until every block id is committed in `ledger`'s namespace;
    raise when every worker died or the deadline passed."""
    while True:
        done = len(ledger.committed())
        if done >= n_blocks:
            return
        if not any(p.poll() is None for _log, p in workers):
            _raise_workers_dead(workers, logs, done, n_blocks)
        if time.perf_counter() > deadline:
            raise ShardError(
                f"sharded scan incomplete at run deadline "
                f"({done}/{n_blocks} blocks committed in namespace "
                f"{ledger.ns or 'pass-1'})")
        time.sleep(poll_s)


def _coordinate_per_k(canonical: str, cfg, plan: ShardPlan,
                      ledger: BlockLedger, root: str, workers, logs: str,
                      deadline: float, policy: StragglerPolicy,
                      device) -> Dict:
    """The coordinator's half of the miners' per-k rounds: merge the
    committed pass-1 states into the global k=1 supports, then run the
    miner's own `_merged_rounds` loop with a count function that publishes
    a level's manifest, waits for every block's first committed count
    vector and sums them (`merge_support_counts`). The coordinator counts
    no candidate itself."""
    from avenir_tpu_torch.models.association import (frequent_tokens,
                                                     merge_support_counts)
    from avenir_tpu_torch.runner import _build_miner

    t_perk = t0 = time.perf_counter()
    blocks_meta = []
    committed = set(ledger.committed())
    for blk in plan.blocks:
        if blk.id not in committed:
            raise ShardError(f"block {blk.id} has no committed pass-1 state")
        blocks_meta.append(_miner_scan_state(ledger.load_state(blk.id)))
    n = sum(nb for _v, _c, nb in blocks_meta)
    support1 = merge_support_counts(
        *[{vocab[i]: int(counts[i]) for i in range(len(vocab))}
          for vocab, counts, _nb in blocks_meta])
    miner = _build_miner(canonical, cfg, device)
    # the mask every block's source installs: the global frequent tokens
    mask = frequent_tokens(support1, miner.support_threshold * n)
    stats = {"rounds": 0, "blocks": 0, "tags": [],
             "merge_s": time.perf_counter() - t0}
    cand_dir = os.path.join(root, "candidates")
    os.makedirs(cand_dir, exist_ok=True)
    n_blocks = len(plan.blocks)

    def run_level(tag: str, cands, c_pad: int, parse_state):
        lk = ledger.level(tag)
        publish_candidates(
            cand_dir, tag,
            {"tag": tag, "job": canonical, "mask": mask,
             "cands": [list(cd) for cd in cands], "c_pad": int(c_pad)})
        _wait_commits(lk, n_blocks, workers, logs, deadline, policy.poll_s)
        t1 = time.perf_counter()
        payloads = [parse_state(lk.load_state(bid))
                    for bid in range(n_blocks)]
        stats["merge_s"] += time.perf_counter() - t1
        stats["blocks"] += n_blocks
        stats["tags"].append(tag)
        return payloads

    def count_level(k: int, cands, c_pad: int) -> np.ndarray:
        payloads = run_level(f"k{k}", cands, c_pad, _level_counts)
        t1 = time.perf_counter()
        merged = merge_support_counts(*[dict(zip(cands, p))
                                        for p in payloads])
        out = np.array([int(merged.get(cd, 0)) for cd in cands], np.int64)
        stats["merge_s"] += time.perf_counter() - t1
        stats["rounds"] += 1
        return out

    if canonical == "frequentItemsApriori":
        rounds = miner._merged_rounds(support1, n, count_level)
        tids = None
        if miner.emit_trans_id:
            all_sets = [cd for _k, sets_k, _c in rounds for cd in sets_k]
            tids = [[] for _ in all_sets]
            if all_sets:
                c_pad = max(64, 1 << (len(all_sets) - 1).bit_length())
                payloads = run_level("tids", all_sets, c_pad, _level_tids)
                for p in payloads:          # plan order is corpus order
                    for ci in range(len(all_sets)):
                        tids[ci].extend(p[ci])
        levels = miner._pack_merged_rounds(rounds, n, tids)
    else:
        levels = miner._merged_rounds(support1, n, count_level)
    publish_candidates(cand_dir, "final",
                       {"done": True, "rounds": stats["rounds"]})
    return {"levels": levels, "n": n, "rounds": stats["rounds"],
            "blocks": stats["blocks"], "tags": stats["tags"],
            "merge_s": stats["merge_s"],
            "perk_s": time.perf_counter() - t_perk}


def run_sharded(name: str, conf, inputs: Sequence[str], output: str,
                procs: int = 2, factor: int = DEFAULT_FACTOR,
                shard_root: Optional[str] = None,
                policy: Optional[StragglerPolicy] = None,
                pin_cores: Optional[Sequence[int]] = None,
                worker_hook: Optional[Callable] = None,
                timeout_s: float = 7200.0,
                device: DeviceLike = None) -> "JobResult":
    """Run one registered streamed job across `procs` worker processes on
    `device` (default cuda; every worker folds there, and the coordinator
    merges and finishes there): the same artifact bytes as `run_job`.

    ``worker_hook(pids, root)`` is the chaos and test tap, called once the
    workers are spawned, before the go barrier releases them.
    ``pin_cores`` pins worker i to core ``pin_cores[i % len]``. The shard
    root (a `tempfile.mkdtemp` unless `shard_root` is given) holds the
    ledger's tmp files beside their targets, on one filesystem."""
    from avenir_tpu_torch.runner import (_REGISTRY, _finish_fold, _job_cfg,
                                         _schema, finish_miner_levels,
                                         stream_fold_ops)

    canonical, cfg = _job_cfg(name, conf)
    ops = stream_fold_ops(canonical)
    dev = resolve_device(device)
    policy = policy or StragglerPolicy()
    root = shard_root or tempfile.mkdtemp(prefix="avenir_shard_")
    own_root = shard_root is None
    procs = max(int(procs), 1)
    per_k = canonical in RESCAN_AT_FINISH
    try:
        plan = plan_shards(list(inputs), procs, factor,
                           policy=policy.to_dict(),
                           snap=_sidecar_snap(cfg, ops, list(inputs),
                                              procs, factor))
        plan.job = canonical
        plan.prefix = _REGISTRY[canonical][1]
        plan.props = {k: str(v) for k, v in cfg.props.items()}
        plan.per_k = per_k
        plan.device = str(dev)
        write_plan(plan, os.path.join(root, "plan.json"))
        ledger = BlockLedger(root)
        logs = os.path.join(root, "logs")
        workers = _spawn_workers(root, procs, logs, pin_cores)
        mined = None
        try:
            t_scan, deadline = _release_workers(
                workers, ledger, plan, root, logs, procs, timeout_s,
                worker_hook)
            n_blocks = len(plan.blocks)
            if per_k:
                # pass 1: every block's state committed; the workers stay
                # up for the per-k rounds
                _wait_commits(ledger, n_blocks, workers, logs, deadline,
                              policy.poll_s)
                mined = _coordinate_per_k(canonical, cfg, plan, ledger,
                                          root, workers, logs, deadline,
                                          policy, dev)
            _drain_workers(workers, ledger, n_blocks, logs, deadline,
                           policy, timeout_s, per_k)
        finally:
            _stop_workers(workers)

        # ------------------------------------------------------- merge
        stats = _worker_stats(root, procs)
        if per_k:
            merge_ms = mined["merge_s"] * 1e3
            t0 = obs.now()
            res = finish_miner_levels(
                canonical, cfg, mined["levels"], mined["n"],
                time.perf_counter() - t_scan, output,
                extra_counters={
                    "Cache:SpillBytes": float(sum(
                        s.get("cache_bytes", 0) for s in stats)),
                    "Cache:EvictedBytes": float(sum(
                        s.get("cache_evicted", 0) for s in stats))})
            obs.record("job.dispatch", t0, mode="sharded", procs=procs,
                       blocks=n_blocks, perk_rounds=mined["rounds"],
                       jobs=canonical)
        else:
            t_merge = time.perf_counter()
            states = {bid: ledger.load_state(bid)
                      for bid in ledger.committed()}
            schema = _schema(cfg) if ops.kind == "dataset" else None
            merged = merge_block_states(canonical, cfg, ops, plan, states,
                                        list(inputs), root, schema=schema,
                                        device=dev)
            merge_ms = (time.perf_counter() - t_merge) * 1e3
            if output:
                os.makedirs(os.path.dirname(os.path.abspath(output)),
                            exist_ok=True)
            t0 = obs.now()
            res = _finish_fold(merged, output, canonical)
            obs.record("job.dispatch", t0, mode="sharded", procs=procs,
                       blocks=n_blocks, jobs=canonical)

        by_id = {b.id: b for b in plan.blocks}
        ledgers = [ledger] + [ledger.level(tag)
                              for tag in (mined["tags"] if mined else ())]
        stolen = dups = 0
        for led in ledgers:
            dups += led.dup_count()
            stolen += sum(1 for bid, info in led.claims().items()
                          if bid in by_id
                          and by_id[bid].home != info["worker"])
        res.counters["Shard:Blocks"] = float(n_blocks)
        res.counters["Shard:StolenBlocks"] = float(stolen)
        res.counters["Shard:DedupBlocks"] = float(dups)
        res.counters["Shard:MergeMs"] = round(merge_ms, 3)
        res.counters["Shard:ScanSeconds"] = round(
            time.perf_counter() - t_scan, 4)
        res.counters["Shard:Workers"] = float(procs)
        if stats:
            res.counters["Shard:MirroredBlocks"] = float(
                sum(s.get("mirrored", 0) + s.get("perk_mirrored", 0)
                    for s in stats))
            _add_worker_sidecar_counters(res, stats)
        if per_k:
            res.counters["Shard:PerKRounds"] = float(mined["rounds"])
            res.counters["Shard:PerKBlocks"] = float(mined["blocks"])
            res.counters["Shard:PerKSeconds"] = round(mined["perk_s"], 4)
        # the workers' own numbers, which this process cannot see: their
        # scan and per-k seconds and their kernels' launch counts
        res.payload = {"workers": stats}
        return res
    finally:
        if own_root:
            shutil.rmtree(root, ignore_errors=True)


def _spawn_workers(root: str, procs: int, logs: str,
                   pin_cores: Optional[Sequence[int]]) -> list:
    """Start `procs` worker interpreters on the published plan under
    `root`, each logging to ``<logs>/w<i>.log``: (log, process) pairs."""
    os.makedirs(logs, exist_ok=True)
    workers = []
    for w in range(procs):
        log = open(os.path.join(logs, f"w{w}.log"), "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "avenir_tpu_torch.dist.worker",
             root, str(w)],
            stdout=log, stderr=log, env=_worker_env(), cwd=_pkg_parent())
        if pin_cores and hasattr(os, "sched_setaffinity"):
            # pinned from here, so no Python runs between the fork and
            # the exec of a process that may hold a CUDA context
            os.sched_setaffinity(proc.pid, {pin_cores[w % len(pin_cores)]})
        workers.append((log, proc))
    return workers


def _release_workers(workers, ledger: BlockLedger, plan: ShardPlan,
                     root: str, logs: str, procs: int, timeout_s: float,
                     worker_hook: Optional[Callable]):
    """Call the test tap, wait at the boot barrier until every worker has
    booted (concurrently), and publish ``go``: (the scan's start, the
    run's deadline)."""
    if worker_hook is not None:
        worker_hook([p.pid for _log, p in workers], root)
    deadline = time.perf_counter() + timeout_s
    ready = os.path.join(root, "ready")
    while True:
        try:
            n_ready = len(os.listdir(ready))
        except OSError:
            n_ready = 0
        if n_ready >= procs:
            break
        _reap_check(workers, ledger, plan, logs)
        if time.perf_counter() > deadline:
            raise ShardError(
                f"{n_ready}/{procs} workers ready within {timeout_s}s")
        time.sleep(0.01)
    t_scan = time.perf_counter()
    publish_bytes(b"go", os.path.join(root, "go"))
    return t_scan, deadline


def _drain_workers(workers, ledger: BlockLedger, n_blocks: int, logs: str,
                   deadline: float, policy: StragglerPolicy,
                   timeout_s: float, per_k: bool) -> None:
    """Wait for every block's commit (the per-k rounds have waited
    already), then give straggling workers a bounded grace to exit on
    their own (a woken straggler records its rejected duplicate); past it
    _stop_workers kills them, so a wedged worker cannot hold a finished
    scan."""
    grace_until = None
    while True:
        alive = [p for _log, p in workers if p.poll() is None]
        done = len(ledger.committed())
        if per_k or done >= n_blocks:
            if not alive:
                return
            if grace_until is None:
                grace_until = time.perf_counter() + policy.exit_grace_s
            elif time.perf_counter() > grace_until:
                return
        elif not alive:
            _raise_workers_dead(workers, logs, done, n_blocks)
        if time.perf_counter() > deadline:
            raise ShardError(
                f"sharded scan incomplete after {timeout_s}s "
                f"({done}/{n_blocks} blocks committed)")
        time.sleep(0.02)


def _stop_workers(workers) -> None:
    for log, proc in workers:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def _extend_checkpoint(iplan, plan: ShardPlan, ledger: BlockLedger) -> bool:
    """Extend a refresh's fingerprints and watermarks, in plan order, by
    the fingerprints each block's winning worker recorded of the chunks it
    folded (never a re-read here: a source grown since the fold must not
    stamp bytes no fold saw). False when a block's fingerprints are
    missing or do not tile its range (a crash between a commit and its
    fingerprints): the merged carry holds that block, so a checkpoint
    without it would fold it twice next time, and the previous checkpoint
    stays the newest instead (the next refresh folds the delta again)."""
    for blk in plan.blocks:
        if blk.start >= blk.end:
            continue
        iplan.delta_blocks += 1
    for blk in plan.blocks:
        if blk.start >= blk.end:
            continue
        fps = ledger.load_fps(blk.id)
        expect = blk.start
        try:
            for fp in fps or ():
                if int(fp["offset"]) != expect:
                    return False
                expect += int(fp["length"])
        except (KeyError, TypeError, ValueError):
            return False
        if not fps or expect != blk.end:
            return False
        iplan.fps[blk.input].extend(fps)
        iplan.watermarks[blk.input] = blk.end
    return True


def run_sharded_refresh(name: str, conf, inputs: Sequence[str],
                        output: str, procs: int = 2,
                        factor: int = DEFAULT_FACTOR,
                        shard_root: Optional[str] = None,
                        policy: Optional[StragglerPolicy] = None,
                        pin_cores: Optional[Sequence[int]] = None,
                        worker_hook: Optional[Callable] = None,
                        timeout_s: float = 7200.0,
                        state_dir: Optional[str] = None,
                        device: DeviceLike = None) -> "JobResult":
    """``--shard N --incremental`` on `device` (default cuda): restore the
    last checkpointed carry as `runner.run_incremental` does (the same
    store and fingerprint gate, cold on any doubt), then fold only the
    verified prefix's appended tail across `procs` workers. The committed
    delta states merge in plan order into the restored carry, the workers'
    fingerprints extend the checkpoint, and the artifact equals a solo
    refresh's (and so a cold run's). With nothing appended no worker
    starts.

    The miners are refused: their per-k rounds re-scan the whole corpus a
    candidate length, so their "refresh" would be a full re-mine behind an
    incremental flag."""
    from avenir_tpu_torch.native import sidecar
    from avenir_tpu_torch.runner import (_REGISTRY, _job_cfg,
                                         _note_sidecar_counters,
                                         _plan_finish, _prepare_incremental,
                                         stream_fold_ops)

    canonical, cfg = _job_cfg(name, conf)
    if canonical in RESCAN_AT_FINISH:
        raise ShardError(
            f"{canonical} cannot refresh incrementally under --shard: "
            f"the miners' per-k rounds re-scan the whole corpus per "
            f"candidate length; run --shard (full re-mine) or "
            f"--incremental alone")
    ops = stream_fold_ops(canonical)
    dev = resolve_device(device)
    policy = policy or StragglerPolicy()
    inputs = [str(p) for p in inputs]
    iplan = _prepare_incremental(canonical, cfg, inputs, output, state_dir,
                                 dev)
    sc0 = sidecar.counters_snapshot()
    sizes = [os.path.getsize(p) for p in inputs]
    if all(w >= sz for w, sz in zip(iplan.watermarks, sizes)):
        # nothing appended: the artifact from the carry alone, no worker
        # started, no byte read
        res = _plan_finish(iplan)
        _note_sidecar_counters(canonical, res, sc0)
        res.counters["Shard:Blocks"] = 0.0
        res.counters["Shard:Workers"] = 0.0
        res.payload = {"workers": []}
        return res

    root = shard_root or tempfile.mkdtemp(prefix="avenir_refresh_")
    own_root = shard_root is None
    procs = max(int(procs), 1)
    try:
        plan = plan_shards(inputs, procs, factor, policy=policy.to_dict(),
                           starts=list(iplan.watermarks),
                           snap=_sidecar_snap(cfg, ops, inputs, procs,
                                              factor, schema=iplan.schema))
        plan.job = canonical
        plan.prefix = _REGISTRY[canonical][1]
        plan.props = {k: str(v) for k, v in cfg.props.items()}
        plan.record_fps = True
        plan.device = str(dev)
        write_plan(plan, os.path.join(root, "plan.json"))
        ledger = BlockLedger(root)
        logs = os.path.join(root, "logs")
        workers = _spawn_workers(root, procs, logs, pin_cores)
        n_blocks = len(plan.blocks)
        try:
            t_scan, deadline = _release_workers(
                workers, ledger, plan, root, logs, procs, timeout_s,
                worker_hook)
            _drain_workers(workers, ledger, n_blocks, logs, deadline,
                           policy, timeout_s, per_k=False)
        finally:
            _stop_workers(workers)

        # the delta merges into the restored carry, in plan order
        t_merge = time.perf_counter()
        states = {bid: ledger.load_state(bid) for bid in ledger.committed()}
        delta = merge_block_states(canonical, cfg, ops, plan, states,
                                   inputs, root, schema=iplan.schema,
                                   device=dev)
        iplan.fold = (ops.merge_states(iplan.fold, delta)
                      if iplan.hit_blocks > 0 else delta)
        tiled = _extend_checkpoint(iplan, plan, ledger)
        merge_ms = (time.perf_counter() - t_merge) * 1e3
        t0 = obs.now()
        res = _plan_finish(iplan, checkpoint=tiled)
        obs.record("job.dispatch", t0, mode="sharded-refresh", procs=procs,
                   blocks=n_blocks, jobs=canonical)
        _note_sidecar_counters(canonical, res, sc0)
        stats = _worker_stats(root, procs)
        by_id = {b.id: b for b in plan.blocks}
        res.counters["Shard:Blocks"] = float(n_blocks)
        res.counters["Shard:StolenBlocks"] = float(
            sum(1 for bid, info in ledger.claims().items()
                if bid in by_id and by_id[bid].home != info["worker"]))
        res.counters["Shard:DedupBlocks"] = float(ledger.dup_count())
        res.counters["Shard:MergeMs"] = round(merge_ms, 3)
        res.counters["Shard:ScanSeconds"] = round(
            time.perf_counter() - t_scan, 4)
        res.counters["Shard:Workers"] = float(procs)
        if stats:
            res.counters["Shard:MirroredBlocks"] = float(
                sum(s.get("mirrored", 0) for s in stats))
            _add_worker_sidecar_counters(res, stats)
        res.payload = {"workers": stats}
        return res
    finally:
        if own_root:
            shutil.rmtree(root, ignore_errors=True)


def _add_worker_sidecar_counters(res, stats: List[Dict]) -> None:
    """The workers' own sidecar and parse accounting, summed: a sharded
    run over a warm sidecar reports Shard:ParseSpans == 0 and
    Sidecar:HitBlocks equal to the blocks replayed."""
    res.counters["Sidecar:HitBlocks"] = float(
        sum(s.get("sidecar_hit_blocks", 0) for s in stats))
    res.counters["Sidecar:DeltaBlocks"] = float(
        sum(s.get("sidecar_delta_blocks", 0) for s in stats))
    res.counters["Shard:ParseSpans"] = float(
        sum(s.get("parse_spans", 0) for s in stats))
    res.counters["Shard:ReplaySpans"] = float(
        sum(s.get("replay_spans", 0) for s in stats))


def worker_launches(res) -> Dict[str, int]:
    """The kernel launches of a sharded run's workers, summed by wrapper
    (from the stats each worker wrote)."""
    out: Dict[str, int] = {}
    for s in (res.payload or {}).get("workers", []):
        for name, n in s.get("launches", {}).items():
            out[name] = out.get(name, 0) + int(n)
    return out


def _worker_stats(root: str, procs: int) -> List[Dict]:
    out = []
    for w in range(procs):
        try:
            with open(os.path.join(root, "stats", f"w{w}.json")) as fh:
                out.append(json.load(fh))
        except (OSError, ValueError):
            pass                  # a killed worker writes no stats
    return out


def _reap_check(workers, ledger, plan, logs: str) -> None:
    """Boot-phase liveness: a worker dead before the barrier (a config
    error, or a device it cannot open) fails the run at once."""
    if all(p.poll() is None for _log, p in workers):
        return
    _raise_workers_dead(workers, logs, len(ledger.committed()),
                        len(plan.blocks))


def _raise_workers_dead(workers, logs: str, done: int,
                        n_blocks: int) -> None:
    dead = [(i, p.returncode) for i, (_log, p) in enumerate(workers)
            if p.poll() is not None and p.returncode != 0]
    tails = []
    for i, rc in dead[:2]:
        try:
            with open(os.path.join(logs, f"w{i}.log"), "rb") as fh:
                tails.append(f"w{i} rc={rc}: "
                             + fh.read()[-800:].decode("utf-8", "replace"))
        except OSError:
            tails.append(f"w{i} rc={rc}: <no log>")
    raise ShardError(
        f"sharded scan lost its workers with {done}/{n_blocks} blocks "
        f"committed; dead={[(i, rc) for i, rc in dead]}\n"
        + "\n".join(tails))
