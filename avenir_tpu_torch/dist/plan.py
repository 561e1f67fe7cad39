"""Shard planner: over-partition inputs into newline-aligned blocks.

The port of `avenir_tpu/dist/plan.py`. The sharded driver
(:mod:`avenir_tpu_torch.dist.driver`) does not hand each worker one fixed
split, which one slow worker would turn into a tail: every input is cut
into ``factor`` x ``procs`` blocks and workers claim them through the
block ledger, their own home run first, then the unclaimed tail of the
others.

Blocks are newline-aligned: each boundary moves to just past the next
``\\n`` at or after its nominal ceil-division position
(``core.stream.split_byte_ranges``), so a block holds whole lines, the
ranges tile ``[0, size)`` without a gap, and a block's bytes can be sliced
out of the input verbatim (the miners' per-k fallback does). A corpus
whose last line has no newline, a corpus smaller than the block count
(trailing empty blocks) and a one-line corpus are all legal plans.

The plan is one atomic JSON manifest that the workers, separate processes
with no other channel, load to learn the job, its properties, the block
table, the straggler policy and the device they fold on. It keeps the
reference's keys (``record_fps`` set for a sharded refresh,
:func:`avenir_tpu_torch.dist.driver.run_sharded_refresh`) and adds
``device``. A refresh plan starts each input at its verified watermark
(``starts``), and a plan over a warm columnar sidecar snaps its cuts to
the sidecar's block starts (``snap``), so a worker replays its range.
"""

from __future__ import annotations

import bisect
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from avenir_tpu_torch.core.atomic import publish_json
from avenir_tpu_torch.core.stream import split_byte_ranges

#: default over-partitioning: blocks per worker. 4x keeps the steal/
#: mirror unit at ~25% of a worker's share — fine enough that a dead
#: worker strands little, coarse enough that per-block fold + serialize
#: overhead stays amortized.
DEFAULT_FACTOR = 4

#: how far past a nominal boundary the aligner will scan for a newline
#: before giving up and taking EOF — a single line longer than this is
#: pathological for a line-oriented corpus (64MB, one default block)
_ALIGN_SCAN_BYTES = 64 << 20


class PlanError(ValueError):
    """A shard plan that cannot be built or loaded."""


@dataclass(frozen=True)
class ShardBlock:
    """One claimable unit of work: a newline-aligned byte range of one
    input file, with a deterministic ``home`` worker (the worker that
    folds it when nobody is slow; any worker may steal it from the
    unclaimed tail)."""

    id: int
    input: int          # index into ShardPlan.inputs
    start: int
    end: int
    home: int

    def to_dict(self) -> Dict:
        return {"id": self.id, "input": self.input, "start": self.start,
                "end": self.end, "home": self.home}

    @classmethod
    def from_dict(cls, obj: Dict) -> "ShardBlock":
        return cls(id=int(obj["id"]), input=int(obj["input"]),
                   start=int(obj["start"]), end=int(obj["end"]),
                   home=int(obj["home"]))


@dataclass
class ShardPlan:
    """The atomic plan manifest: inputs (path + size, so a worker can
    detect a corpus that changed under the plan), the job and its
    prefixed properties, the block table, and the straggler policy
    knobs. ``blocks`` is in PLAN ORDER — the order the coordinator
    merges committed block states in, which is what makes the sharded
    artifact byte-identical to the solo scan under the proven merge
    algebra."""

    procs: int
    factor: int
    job: str = ""
    prefix: str = ""
    props: Dict[str, str] = field(default_factory=dict)
    inputs: List[Dict] = field(default_factory=list)
    blocks: List[ShardBlock] = field(default_factory=list)
    policy: Dict[str, float] = field(default_factory=dict)
    #: miner jobs: workers stay resident after pass 1 and re-enter the
    #: per-k candidate-counting loop against the level-namespaced
    #: ledger (driver publishes candidate manifests, workers count)
    per_k: bool = False
    #: refresh plans: each worker fingerprints the exact chunks its fold
    #: consumed and commits them with the block's state, so the
    #: coordinator extends the checkpoint from folded bytes, never from a
    #: re-read of a file a writer may have grown since
    record_fps: bool = False
    #: the torch device every worker folds on ("cuda" or "cpu")
    device: str = "cuda"

    def input_paths(self) -> List[str]:
        return [str(i["path"]) for i in self.inputs]

    def blocks_for(self, worker: int) -> List[ShardBlock]:
        return [b for b in self.blocks if b.home == worker]

    def to_dict(self) -> Dict:
        return {"procs": self.procs, "factor": self.factor,
                "job": self.job, "prefix": self.prefix,
                "props": dict(self.props),
                "inputs": [dict(i) for i in self.inputs],
                "blocks": [b.to_dict() for b in self.blocks],
                "policy": dict(self.policy),
                "per_k": bool(self.per_k),
                "record_fps": bool(self.record_fps),
                "device": str(self.device)}

    @classmethod
    def from_dict(cls, obj: Dict) -> "ShardPlan":
        return cls(procs=int(obj["procs"]), factor=int(obj["factor"]),
                   job=str(obj.get("job", "")),
                   prefix=str(obj.get("prefix", "")),
                   props=dict(obj.get("props", {})),
                   inputs=[dict(i) for i in obj.get("inputs", [])],
                   blocks=[ShardBlock.from_dict(b)
                           for b in obj.get("blocks", [])],
                   policy=dict(obj.get("policy", {})),
                   per_k=bool(obj.get("per_k", False)),
                   record_fps=bool(obj.get("record_fps", False)),
                   device=str(obj.get("device", "cuda")))


def _snap_cut(b: int, lo: int, size: int,
              snap: Sequence[int]) -> Optional[int]:
    """The snap offset nearest a nominal boundary ``b`` that still cuts
    strictly inside ``(lo, size)``, or None when the sorted snap list
    has none. Snap offsets are newline-aligned block starts (in the
    reference, a columnar sidecar's), so a snapped cut needs no newline
    scan and a fully snapped plan tiles that block layout exactly."""
    i = bisect.bisect_left(snap, b)
    best = None
    for j in (i - 1, i):
        if 0 <= j < len(snap) and lo < snap[j] < size:
            if best is None or abs(snap[j] - b) < abs(best - b):
                best = snap[j]
    return best


def _align_boundaries(path: str, size: int, n: int, start: int = 0,
                      snap: Optional[Sequence[int]] = None
                      ) -> List[Tuple[int, int]]:
    """Newline-aligned [lo, hi) ranges tiling ``[start, size)``: nominal
    ceil-division bounds, each interior boundary advanced to one past
    the next ``\\n`` at or after it — or, when a sorted ``snap`` offset
    list is given (verified sidecar block starts), moved to the nearest
    snap offset instead. Boundaries that run out of newlines collapse
    onto ``size`` — trailing empty ranges tile gap-free, exactly like
    ``split_byte_ranges`` on a corpus smaller than the split count."""
    nominal = split_byte_ranges(size - start, n)
    cuts = [start]
    with open(path, "rb") as fh:
        for _lo, hi in nominal[:-1]:
            b = max(start + hi, cuts[-1])
            if b >= size:
                cuts.append(size)
                continue
            if snap:
                snapped = _snap_cut(b, cuts[-1], size, snap)
                if snapped is not None:
                    cuts.append(snapped)
                    continue
            fh.seek(b)
            scanned = 0
            nl = -1
            while scanned < _ALIGN_SCAN_BYTES:
                buf = fh.read(min(1 << 16, _ALIGN_SCAN_BYTES - scanned))
                if not buf:
                    break
                nl = buf.find(b"\n")
                if nl >= 0:
                    nl = b + scanned + nl
                    break
                scanned += len(buf)
                nl = -1
            cuts.append(size if nl < 0 else min(nl + 1, size))
    cuts.append(size)
    return list(zip(cuts[:-1], cuts[1:]))


def plan_shards(inputs: Sequence[str], procs: int,
                factor: int = DEFAULT_FACTOR,
                policy: Optional[Dict[str, float]] = None,
                starts: Optional[Sequence[int]] = None,
                snap: Optional[Sequence[Optional[Sequence[int]]]] = None
                ) -> ShardPlan:
    """Build the over-partitioned plan: every input cut into
    ``procs * factor`` newline-aligned blocks, block ids global in
    (input, offset) order, homes assigned as CONTIGUOUS runs per input
    (worker w's home blocks are one disk-sequential stretch; the steal
    path is what breaks contiguity, and only when someone is slow).

    ``starts[i]`` plans input ``i`` from that byte offset instead of 0
    (a delta tail; it must sit on a line boundary). ``snap[i]`` is a
    sorted list of preferred cut offsets for input ``i``: boundaries move
    to the nearest one. The port's driver passes neither."""
    if procs < 1:
        raise PlanError(f"procs must be positive, got {procs}")
    if factor < 1:
        raise PlanError(f"factor must be positive, got {factor}")
    if not inputs:
        raise PlanError("shard plan needs at least one input")
    if starts is not None and len(starts) != len(inputs):
        raise PlanError("starts must align with inputs")
    if snap is not None and len(snap) != len(inputs):
        raise PlanError("snap must align with inputs")
    plan = ShardPlan(procs=procs, factor=factor,
                     policy=dict(policy or {}))
    bid = 0
    for ii, path in enumerate(inputs):
        if not os.path.exists(path):
            raise PlanError(f"no such input file: {path!r}")
        size = os.path.getsize(path)
        start = int(starts[ii]) if starts is not None else 0
        if not 0 <= start <= size:
            raise PlanError(
                f"start {start} outside [0, {size}] for {path!r}")
        plan.inputs.append({"path": os.path.abspath(path), "size": size})
        n = procs * factor
        ranges = _align_boundaries(
            path, size, n, start=start,
            snap=sorted(snap[ii]) if snap is not None and snap[ii]
            else None)
        for j, (lo, hi) in enumerate(ranges):
            # contiguous home runs: blocks [w*factor, (w+1)*factor) of
            # this input belong to worker w
            plan.blocks.append(ShardBlock(
                id=bid, input=ii, start=lo, end=hi, home=j // factor))
            bid += 1
    return plan


def write_json_atomic(obj: Dict, path: str) -> str:
    """Atomically publish one JSON manifest (unique sibling tmp and
    rename): a reader sees no manifest or a complete one. Shared by the
    plan and the per-k candidate manifests the sharded miners publish
    under ``<root>/candidates/``; the commit site ``plan.manifest``."""
    return publish_json(obj, path, site="plan.manifest", indent=1)


def write_plan(plan: ShardPlan, path: str) -> str:
    """Atomically publish the plan manifest — see write_json_atomic."""
    return write_json_atomic(plan.to_dict(), path)


def load_plan(path: str) -> ShardPlan:
    try:
        with open(path) as fh:
            return ShardPlan.from_dict(json.load(fh))
    except (OSError, ValueError, KeyError) as e:
        raise PlanError(f"cannot load shard plan {path!r}: {e}") from e
