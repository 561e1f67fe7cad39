"""Sharded-scan worker process: claim blocks, fold them, commit states.

``python -m avenir_tpu_torch.dist.worker <shard-root> <worker-id>``, one
process a worker, spawned by :func:`avenir_tpu_torch.dist.driver.
run_sharded`. The port of `avenir_tpu/dist/worker.py`. The loop:

1. **Boot barrier**: open the plan's device (a worker that cannot dies
   here, and the coordinator fails the run with its log; it never folds on
   the CPU instead), write ``ready/w<i>`` and wait for the coordinator's
   ``go`` file, so the interpreter's and torch's boot stays off the
   measured scan.
2. **Home blocks**: claim and fold this worker's contiguous home run.
3. **Steal the tail**: then claim from the global unclaimed tail.
4. **Mirror stragglers**: with nothing unclaimed and blocks outstanding,
   this worker's own per-block telemetry (``stream.read`` / ``parse`` /
   ``fold`` spans through :func:`avenir_tpu_torch.tune.signals.
   extract_signals`) prices a block, and a peer's claim older than the
   policy's multiple is folded again. The ledger's first-commit-wins keeps
   every block folded into the result once; the rejected duplicate counts
   in ``Shard:DedupBlocks``.
5. **Per-k rounds** (miner plans, ``plan.per_k``): the worker stays up
   after pass 1 with its per-block folds and their committed encoded-block
   caches, and enters the same claim/steal/mirror loop once a candidate
   length against the level's ledger (``k<k>/b<id>``): the coordinator
   publishes each level's candidates under ``<root>/candidates/``, the
   worker counts a claimed block's supports by replaying its cache (a
   stolen block folds its byte range once, then replays; a block larger
   than the cache budget takes a slice file of its bytes), and commits the
   count vector first-commit-wins. ``final.json`` releases it.

Every block folds through the job's registered `StreamFoldOps` sink, driven
by `SharedScan` (`runner._drive_fold`), on the plan's device, and its carry
crosses processes as `serialize_state`'s npz. The stats file the worker
writes at the end carries its kernels' launch counts (`launches`), which
the coordinator's process cannot see.
"""

from __future__ import annotations

import io
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from avenir_tpu_torch import obs
from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.core.atomic import (publish_bytes, publish_json,
                                          sched_point)
from avenir_tpu_torch.dist.detect import (StragglerPolicy, mirror_after_s,
                                          mirror_after_wall_s)
from avenir_tpu_torch.dist.ledger import BlockLedger
from avenir_tpu_torch.dist.plan import ShardBlock, ShardPlan, load_plan

#: chaos hook for tests (cross-process, so an environment variable):
#: "worker:block:secs" makes that worker sleep that long after claiming
#: the pass-1 block and before folding it; "worker:level:block:secs"
#: (level "k2", "tids", ...) holds a per-k count block the same way
_HOLD_ENV = "AVENIR_SHARD_TEST_HOLD"

#: the fold families whose finish() re-scans their inputs (the miners'
#: per-k rounds): run_sharded runs those rounds in the workers
RESCAN_AT_FINISH = ("frequentItemsApriori", "candidateGenerationWithSelfJoin")


def _sidecar_range_feed(cfg, ops, schema, path: str, start: int, end: int,
                        block_bytes: int):
    """A read-only sidecar feed over one claimed byte range, or None. The
    ranged contract replays all of [start, end) from verified sidecar
    blocks or nothing: a worker never writes the shared sidecar (N
    processes extending one columns.bin would tear it) and never splices a
    replay with a parse mid-range. A plan snapped to the sidecar's block
    starts replays whole."""
    from avenir_tpu_torch.native import sidecar

    opts = sidecar.opts_from_cfg(cfg)
    if ops.kind == "dataset":
        return sidecar.dataset_blocks(opts, path, schema,
                                      cfg.field_delim_regex, block_bytes,
                                      byte_range=(start, end), write=False)
    return sidecar.byte_blocks(opts, path, cfg.field_delim_regex,
                               cfg.get_int("skip.field.count", 1),
                               block_bytes, byte_range=(start, end),
                               write=False)


def fold_block(canonical: str, cfg, ops, schema, inputs: List[str],
               path: str, start: int, end: int, device,
               fps_out: Optional[list] = None):
    """Fold one plan block, the byte range ``[start, end)`` of `path`,
    through the job's registered fold sink on `device`, and return the fed
    fold. A plan block is newline-aligned, so the range reads as a plain
    slice: a dataset job's `CsvBlockReader`, a bytes job's byte blocks, or
    the columnar sidecar's replay when the whole range re-proves against
    it (the fold sinks take a replayed payload as well).

    ``fps_out`` (refresh plans) collects the fingerprints of the exact
    chunks the fold consumed (the sidecar's verified hashes, or a hash of
    each raw block as it is read), tiling [start, end) without a gap."""
    from avenir_tpu_torch.core import incremental as incr
    from avenir_tpu_torch.core.stream import (CsvBlockReader, csv_engine,
                                              is_blank_block,
                                              iter_byte_blocks, prefetched)
    from avenir_tpu_torch.runner import _drive_fold

    fold = ops.factory(cfg, list(inputs), schema, device)
    block_bytes = int(cfg.get_float("stream.block.size.mb", 64.0)
                      * (1 << 20))
    feed = None
    if start < end:
        feed = _sidecar_range_feed(cfg, ops, schema, path, start, end,
                                   block_bytes)
    if feed is not None:
        def replayed():
            for off, length, hsh, payload in feed:
                if fps_out is not None:
                    fps_out.append({"offset": int(off),
                                    "length": int(length), "hash": hsh})
                if payload is not None:
                    yield payload
        chunks = replayed()
    elif fps_out is not None:
        engine = csv_engine(cfg)

        def fingerprinted():
            for off, data in prefetched(
                    iter_byte_blocks(path, block_bytes,
                                     byte_range=(start, end),
                                     with_offsets=True), depth=1):
                fps_out.append(incr.block_fingerprint(off, data))
                if is_blank_block(data):
                    continue
                yield (data if ops.kind != "dataset" else Dataset.from_csv(
                    data, schema, delim=cfg.field_delim_regex,
                    engine=engine))
        chunks = fingerprinted()
    elif ops.kind == "dataset":
        chunks = iter(CsvBlockReader(path, schema, cfg.field_delim_regex,
                                     block_bytes, engine=csv_engine(cfg),
                                     byte_range=(start, end)))
    else:
        chunks = iter_byte_blocks(path, block_bytes,
                                  byte_range=(start, end))
    _drive_fold(fold, chunks, canonical)
    return fold


def _hold(worker: int, block_id: int, level: Optional[str] = None) -> None:
    spec = os.environ.get(_HOLD_ENV, "")
    parts = spec.split(":")
    try:
        if len(parts) == 4:
            w, lvl, b, secs = parts
            if lvl != (level or ""):
                return
        else:
            w, b, secs = parts
            if level is not None:
                return
        if int(w) == worker and int(b) == block_id:
            time.sleep(float(secs))
    except ValueError:
        pass


def _kernel_launches() -> Dict[str, int]:
    """This process's launch count of every counted kernel wrapper."""
    from avenir_tpu_torch.ops import (cluster_kernels, knn_kernels,
                                      matmul_ceiling, sampling_kernels,
                                      sequence_kernels)

    fns = (knn_kernels.COUNTED_WRAPPERS + matmul_ceiling.KERNEL_WRAPPERS
           + sequence_kernels.KERNEL_WRAPPERS
           + cluster_kernels.KERNEL_WRAPPERS
           + sampling_kernels.KERNEL_WRAPPERS)
    return {fn.__name__: int(fn.launches) for fn in fns}


class _Worker:
    def __init__(self, root: str, worker: int):
        from avenir_tpu_torch.runner import (_build_miner, _job_cfg,
                                             _schema, stream_fold_ops)
        from avenir_tpu_torch.utils.devices import resolve_device

        self.root = root
        self.worker = worker
        self.plan: ShardPlan = load_plan(os.path.join(root, "plan.json"))
        self.policy = StragglerPolicy.from_dict(self.plan.policy)
        self.ledger = BlockLedger(root)
        self.per_k = bool(self.plan.per_k)
        self.stats = {"worker": worker, "claimed": 0, "stolen": 0,
                      "mirrored": 0, "dedup_rejected": 0, "folded": 0,
                      "perk_claimed": 0, "perk_stolen": 0,
                      "perk_mirrored": 0, "perk_dedup": 0,
                      "perk_folded": 0, "perk_levels": 0,
                      "scan_s": 0.0, "perk_s": 0.0}
        # the plan's device, opened now: a worker without it fails here,
        # before the barrier, and never folds anywhere else
        self.device = resolve_device(self.plan.device)
        if self.device.type == "cuda":
            import torch

            torch.zeros(1, device=self.device)
        self.canonical, cfg = _job_cfg(self.plan.job, dict(self.plan.props))
        self.ops = stream_fold_ops(self.canonical)
        self.cfg = cfg
        self.schema = _schema(cfg) if self.ops.kind == "dataset" else None
        self.inputs = self.plan.input_paths()
        # ---- per-k state (miner plans only) ----
        self._folds: Dict[int, object] = {}    # block id -> kept fold
        self._miner = (_build_miner(self.canonical, cfg, self.device)
                       if self.per_k else None)
        self._perk_wall = 0.0       # measured seconds over per-k blocks,
        self._perk_done = 0         # the per-k straggler detector's input
        #: the coordinator's pid at boot: a per-k worker leaves only at a
        #: manifest, so a coordinator that dies hard (its finally never
        #: runs) must not leave it polling; a new parent is the signal
        self._coord_pid = os.getppid()

    # ------------------------------------------------------- lifecycle
    def barrier(self, timeout_s: float = 300.0) -> None:
        ready = os.path.join(self.root, "ready")
        os.makedirs(ready, exist_ok=True)
        marker = os.path.join(ready, f"w{self.worker}")
        publish_bytes(str(os.getpid()).encode("utf-8"), marker)
        deadline = time.perf_counter() + timeout_s
        go = os.path.join(self.root, "go")
        while not os.path.exists(go):
            if time.perf_counter() > deadline:
                raise RuntimeError(
                    f"worker {self.worker}: no go signal in {timeout_s}s")
            time.sleep(0.01)

    def write_stats(self, signals) -> None:
        self.stats["signals"] = signals.to_json()
        self.stats["device"] = str(self.device)
        self.stats["launches"] = _kernel_launches()
        if self.per_k:
            # the per-k replay folds only (keys >= 0): the tids slice folds
            # (negative keys) cover the same byte ranges again
            replay = [f for bid, f in self._folds.items() if bid >= 0]
            self.stats["cache_bytes"] = float(sum(
                f.src.cache_nbytes for f in replay))
            self.stats["cache_evicted"] = float(sum(
                f.src.cache_evicted_bytes for f in replay))
        path = os.path.join(self.root, "stats", f"w{self.worker}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        publish_json(self.stats, path)

    # ------------------------------------------------------- fold path
    def _fold(self, path: str, start: int, end: int, inputs=None,
              fps_out: Optional[list] = None):
        return fold_block(self.canonical, self.cfg, self.ops, self.schema,
                          inputs or self.inputs, path, start, end,
                          self.device, fps_out=fps_out)

    def _fold_and_commit(self, blk: ShardBlock) -> None:
        # a refresh plan fingerprints the exact chunks this fold reads, so
        # the coordinator extends the checkpoint from folded bytes
        fps = [] if self.plan.record_fps else None
        fold = self._fold(self.plan.inputs[blk.input]["path"], blk.start,
                          blk.end, fps_out=fps)
        if self.per_k:
            # seal now: commits this block's spill cache for the per-k
            # rounds to replay
            fold._seal()
        blob = self.ops.serialize_state(fold)
        if self.ledger.commit(blk.id, self.worker, blob, fps=fps):
            self.stats["folded"] += 1
        else:
            self.stats["dedup_rejected"] += 1
        if self.per_k:
            # kept for the per-k rounds: even a rejected redundant fold is
            # a source this worker can replay
            self._folds[blk.id] = fold
        else:
            close = getattr(getattr(fold, "src", None), "close", None)
            if close is not None:
                close()

    def _next_unclaimed(self, ledger: BlockLedger
                        ) -> Optional[Tuple[ShardBlock, bool]]:
        """Home blocks first, then the global unclaimed tail (a steal):
        (block, stolen) or None. One loop serves pass 1 and every per-k
        level; only the ledger's namespace changes."""
        by_id = {b.id: b for b in self.plan.blocks}
        done = set(ledger.committed())
        claims = ledger.claims()
        home = [b.id for b in self.plan.blocks if b.home == self.worker]
        tail = [b.id for b in self.plan.blocks if b.home != self.worker]
        for bid in home + tail:
            if bid in done or bid in claims:
                continue
            if ledger.claim(bid, self.worker):
                blk = by_id[bid]
                return blk, blk.home != self.worker
        return None

    def _stale_peer_block(self, ledger: BlockLedger,
                          threshold: float) -> Optional[int]:
        """The oldest claimed, uncommitted block of a peer past the mirror
        threshold, or None."""
        stale = ledger.stale_claims(len(self.plan.blocks), threshold)
        claims = ledger.claims()
        stale = [b for b in stale
                 if (claims.get(b) or {}).get("worker") != self.worker]
        return stale[0] if stale else None

    def run(self) -> None:
        from avenir_tpu_torch.native import sidecar
        from avenir_tpu_torch.tune.signals import extract_signals

        self.barrier()
        sc0 = sidecar.counters_snapshot()
        by_id = {b.id: b for b in self.plan.blocks}
        t_run = time.perf_counter()
        try:
            with obs.capture() as rec:
                while True:
                    nxt = self._next_unclaimed(self.ledger)
                    if nxt is not None:
                        blk, stolen = nxt
                        self.stats["claimed"] += 1
                        if stolen:
                            self.stats["stolen"] += 1
                        _hold(self.worker, blk.id)
                        self._fold_and_commit(blk)
                        continue
                    if not self.ledger.pending(len(self.plan.blocks)):
                        break
                    # nothing unclaimed, blocks outstanding: price a block
                    # from this worker's spans, mirror an older claim
                    if self.policy.mirror:
                        threshold = mirror_after_s(
                            self.policy, extract_signals(rec.spans()),
                            self.stats["folded"])
                        bid = self._stale_peer_block(self.ledger, threshold)
                        if bid is not None:
                            self.stats["mirrored"] += 1
                            self._fold_and_commit(by_id[bid])
                            continue
                    time.sleep(self.policy.poll_s)
                self.stats["scan_s"] = round(time.perf_counter() - t_run, 4)
                if self.per_k:
                    self._run_per_k(by_id)
                    self.stats["perk_s"] = round(self._perk_wall, 4)
                # what this worker parsed and what it replayed from the
                # sidecar, which the coordinator's process cannot see
                spans = rec.spans()
                self.stats["parse_spans"] = sum(
                    1 for sp in spans if sp.name == "stream.parse")
                self.stats["replay_spans"] = sum(
                    1 for sp in spans if sp.name == "stream.sidecar.replay")
                now = sidecar.counters_snapshot()
                self.stats["sidecar_hit_blocks"] = \
                    now["hit_blocks"] - sc0["hit_blocks"]
                self.stats["sidecar_delta_blocks"] = \
                    now["delta_blocks"] - sc0["delta_blocks"]
                self.write_stats(extract_signals(spans))
        finally:
            for fold in self._folds.values():
                fold.src.close()

    # ------------------------------------------------------ per-k path
    def _load_manifest(self, path: str) -> Optional[Dict]:
        sched_point("cand.poll")
        try:
            with open(path) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None          # not published yet (writes are atomic)

    def _coordinator_gone(self) -> bool:
        return os.getppid() != self._coord_pid

    def _run_per_k(self, by_id: Dict[int, ShardBlock]) -> None:
        """Follow the coordinator's candidate manifests in publish order
        (k2, k3, ..., then tids when asked), count each level's blocks
        through its ledger, and leave at final.json, or raise when the
        coordinator died."""
        cand_dir = os.path.join(self.root, "candidates")
        next_k = 2
        tids_done = False
        while True:
            man = self._load_manifest(
                os.path.join(cand_dir, f"k{next_k}.json"))
            if man is not None:
                self._count_level(f"k{next_k}", man, by_id)
                next_k += 1
                continue
            if not tids_done:
                man = self._load_manifest(
                    os.path.join(cand_dir, "tids.json"))
                if man is not None:
                    self._count_level("tids", man, by_id)
                    tids_done = True
                    continue
            if os.path.exists(os.path.join(cand_dir, "final.json")):
                return
            if self._coordinator_gone():
                raise RuntimeError(
                    f"worker {self.worker}: coordinator died mid per-k "
                    f"rounds (no final.json will come)")
            time.sleep(self.policy.poll_s)

    def _count_level(self, tag: str, man: Dict,
                     by_id: Dict[int, ShardBlock]) -> None:
        """One level's claim/steal/mirror loop against ``ledger/<tag>/``,
        the count (a cache replay) in place of pass 1's fold."""
        cands = [tuple(cd) for cd in man["cands"]]
        c_pad = int(man["c_pad"])
        mask = [str(t) for t in man.get("mask", [])]
        ledger = self.ledger.level(tag)
        n_blocks = len(self.plan.blocks)
        self.stats["perk_levels"] += 1
        while True:
            nxt = self._next_unclaimed(ledger)
            if nxt is not None:
                blk, stolen = nxt
                self.stats["perk_claimed"] += 1
                if stolen:
                    self.stats["perk_stolen"] += 1
                _hold(self.worker, blk.id, tag)
                self._count_and_commit(ledger, tag, blk, cands, c_pad, mask)
                continue
            if not ledger.pending(n_blocks):
                return
            if self.policy.mirror:
                threshold = mirror_after_wall_s(
                    self.policy, self._perk_wall, self._perk_done)
                bid = self._stale_peer_block(ledger, threshold)
                if bid is not None:
                    self.stats["perk_mirrored"] += 1
                    self._count_and_commit(ledger, tag, by_id[bid], cands,
                                           c_pad, mask)
                    continue
            if self._coordinator_gone():
                raise RuntimeError(
                    f"worker {self.worker}: coordinator died waiting on "
                    f"level {tag} commits")
            time.sleep(self.policy.poll_s)

    def _count_and_commit(self, ledger: BlockLedger, tag: str,
                          blk: ShardBlock, cands, c_pad: int,
                          mask: List[str]) -> None:
        t0 = time.perf_counter()
        if tag == "tids":
            from avenir_tpu_torch.models.association import \
                collect_token_trans_ids

            # the id pass needs each row's id, which the cache drops: a
            # source over a slice file of exactly this block's lines
            src = self._slice_source(blk, mask)
            tids = collect_token_trans_ids(src, cands, c_pad,
                                           self._miner.block, self.device)
            blob = json.dumps({"tids": tids}).encode()
        else:
            src = self._block_source(blk, mask)
            counts = self._count_supports(src, cands, c_pad)
            buf = io.BytesIO()
            np.savez(buf, counts=np.asarray(counts, np.int64))
            blob = buf.getvalue()
        self._perk_wall += time.perf_counter() - t0
        self._perk_done += 1
        if ledger.commit(blk.id, self.worker, blob):
            self.stats["perk_folded"] += 1
        else:
            self.stats["perk_dedup"] += 1

    def _count_supports(self, src, cands, c_pad: int) -> np.ndarray:
        if self.canonical == "frequentItemsApriori":
            from avenir_tpu_torch.models.association import \
                count_token_supports
        else:
            from avenir_tpu_torch.models.sequence import count_token_supports
        return count_token_supports(src, cands, c_pad, self._miner.block,
                                    self.device)

    def _install_mask(self, src, mask: List[str]) -> None:
        """Install the global frequent-token mask once a source (every
        level publishes the same mask)."""
        if src._remap is not None:
            return
        keep = [src.index[t] for t in mask if t in src.index]
        if self.canonical == "frequentItemsApriori":
            src.mask_items(keep)
        else:
            src.mask_tokens(keep)

    def _replayable(self, fold) -> bool:
        """True when per-k counts over this fold's source are right: its
        committed cache replays the block's rows, or the source reads a
        slice file of exactly the block's lines."""
        if getattr(fold, "_perk_slice", False):
            return True
        cache = fold.src._cache
        return cache is not None and cache.valid

    def _block_source(self, blk: ShardBlock, mask: List[str]):
        """The source a per-k count reads for `blk`: this worker's kept
        pass-1 fold when its cache replays, else a rebuilt one (a stolen
        block folds its range once, then replays at every later level)."""
        fold = self._folds.get(blk.id)
        if fold is None or not self._replayable(fold):
            if fold is not None:
                fold.src.close()
            fold = self._rebuild_fold(blk)
            self._folds[blk.id] = fold
        self._install_mask(fold.src, mask)
        return fold.src

    def _rebuild_fold(self, blk: ShardBlock):
        """A pass-1 fold of a block this worker never folded, or whose
        cache was evicted. When even a fresh cache cannot serve (the block
        alone exceeds the budget), a source over a slice file of the
        block's bytes, whose re-reads see exactly its lines."""
        fold = self._fold(self.plan.inputs[blk.input]["path"], blk.start,
                          blk.end)
        fold._seal()
        if self._replayable(fold):
            return fold
        fold.src.close()
        slice_path = self._slice_path(blk)
        fold = self._fold(slice_path, 0, os.path.getsize(slice_path),
                          [slice_path])
        fold._seal()
        fold._perk_slice = True
        return fold

    def _slice_path(self, blk: ShardBlock) -> str:
        """This block's bytes as a file of their own, written once: legal
        because plan blocks are newline-aligned."""
        path = os.path.join(self.root, "slices",
                            f"w{self.worker}_b{blk.id}.bin")
        if os.path.exists(path):
            return path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(self.plan.inputs[blk.input]["path"], "rb") as fh:
            fh.seek(blk.start)
            data = fh.read(blk.end - blk.start)
        publish_bytes(data, path)
        return path

    def _slice_source(self, blk: ShardBlock, mask: List[str]):
        """A slice-file source for the id-bearing pass (tids): its Python
        feed parses exactly this block's lines, and its vocabulary comes
        from a pass-1 fold of the same bytes, so token codes agree with
        the count folds'."""
        slice_path = self._slice_path(blk)
        fold = self._fold(slice_path, 0, os.path.getsize(slice_path),
                          [slice_path])
        fold._seal()
        key = -(blk.id + 1)         # never collides with the replay folds
        old = self._folds.get(key)
        if old is not None:
            old.src.close()
        self._folds[key] = fold
        self._install_mask(fold.src, mask)
        return fold.src


def worker_main(argv) -> int:
    root, worker = argv[0], int(argv[1])
    _Worker(root, worker).run()
    return 0


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1:]))
