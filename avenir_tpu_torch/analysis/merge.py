"""The merge auditor: the fold state of every streamed job is a merge
algebra, and a mid-scan carry resumes to the same bytes.

The port of `avenir_tpu/analysis/merge.py`. A streamed job's carry must
merge, ``merge(fold(A), fold(B)) == fold(A ++ B)`` byte for byte, and
restore from a checkpoint to the same bytes: the sharded driver, the
delta scan and the straggler mirrors all stand on it. Two layers:

- **Merge rules** over fold-sink classes (``consume`` and ``finish``,
  the shared-scan protocol): a sink with no merge op
  (``merge-missing-op``), a float carry whose merge regroups its summands
  (``merge-order-sensitive-float``), a carry mutated in place while a
  cache or closure aliases it (``merge-inplace-aliased-state``), and a
  carry holding threads, files or generators with no host round-trip
  (``merge-unserializable-carry``).
- **Shard-merge and resume audit** of every stream entry through its
  jobs' registered fold sinks (`runner.stream_fold_ops`) on the entry's
  device: (a) the corpus cut on block boundaries into P of 2 and 4
  shards, each folded alone, merged by `merge_states`, finished to the
  cold scan's bytes; (b) a carry serialized after half the chunks,
  restored into a fresh fold, finished to the same bytes; (c) an overlap
  probe (a block folded twice) that records whether the family is
  idempotent; (d) the real delta-scan driver (`run_incremental`) over a
  prefix, an append, a kill after its first mid-delta checkpoint and a
  resume; (e) the same through `run_incremental_shared`; (f) the sharded
  steal through `dist.plan`, `dist.ledger` and `dist.worker.fold_block`:
  worker 0 commits every block, worker 1 folds the boundary block again,
  its commit must lose, and the plan-order merge must give the cold
  bytes.

Findings go through the shared engine and allowlist. An entry that
fails to run raises :class:`MergeAuditError` (the CLI's exit 2); a
drift is a finding under ``merge-fold-algebra`` (exit 1), never
allowlisted: fix the fold's algebra.
"""

from __future__ import annotations

import ast
import os
import shutil
import tempfile
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from avenir_tpu_torch.analysis.engine import (BaselineEntry, Finding,
                                              ModuleContext, Report,
                                              apply_baseline,
                                              collect_findings)
from avenir_tpu_torch.analysis.flow import (OrderSensitiveFoldRule,
                                            _MUTATORS, default_flow_paths)
from avenir_tpu_torch.analysis.mem import _bind_key

#: the audit's pseudo-rule id: a shard merge or checkpoint resume whose
#: output drifted a byte surfaces as a finding under it (never allowlist
#: one — a fold state that is not a merge algebra blocks both the
#: resumable-scan and the multi-host streaming work)
MERGE_AUDIT_RULE = "merge-fold-algebra"

#: block size (MB) the auditor shards and checkpoints at: small enough
#: that both proxy corpora cut into well over 4 blocks, so P=4 shards
#: and the mid-scan checkpoint all land on real boundaries
AUDIT_BLOCK_MB = 0.001

#: shard counts the merge is proven at; 2 exercises one merge, 4
#: exercises merge chaining (associativity of the registered op)
AUDIT_SHARDS = (2, 4)

#: the fold-sink protocol: a class with both methods is a shared-scan
#: sink (runner._STREAM_FOLDS registers them; SharedScan fans to them)
_SINK_METHODS = {"consume", "finish"}

#: method names that count as a declared merge op on a sink class
_MERGE_METHODS = {"merge", "merge_states", "merge_from"}

#: method names that count as a declared host round-trip for the
#: unserializable-carry rule
_ROUNDTRIP_METHODS = {"state_dict", "load_state", "serialize_state",
                      "__getstate__"}

#: constructors whose result cannot cross a serialize/restore boundary
_UNSERIALIZABLE_CTORS = {
    "open", "iter",
    "threading.Thread", "threading.Lock", "threading.RLock",
    "threading.Condition", "threading.Semaphore",
    "threading.BoundedSemaphore", "threading.Event",
    "subprocess.Popen", "socket.socket", "socket.create_connection",
}

#: shared float-init recognizer (the flow tier's, applied to carries)
_FLOAT_INIT = OrderSensitiveFoldRule()


class MergeAuditError(RuntimeError):
    """A streamed fold kernel could not be prepared, driven or merged."""


# --------------------------------------------------------------------------
# shared AST helpers
# --------------------------------------------------------------------------
def _methods_of(node: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
    return {m.name: m for m in node.body
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _fold_sink_classes(ctx: ModuleContext
                       ) -> Iterator[Tuple[ast.ClassDef,
                                           Dict[str, ast.FunctionDef]]]:
    """Classes implementing the fold-sink protocol (consume + finish) —
    the carries whose merge algebra this tier judges."""
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef):
            methods = _methods_of(node)
            if _SINK_METHODS <= set(methods):
                yield node, methods


def _method_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Nodes of a method body, not descending into nested defs."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _self_attr(node: ast.AST) -> Optional[str]:
    """`attr` when `node` is a ``self.attr`` expression, else None."""
    key = _bind_key(node)
    return key[1:] if key is not None and key.startswith(".") else None


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------
class MergeRule:
    rule_id: str = ""
    description: str = ""
    hint: str = ""

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: ModuleContext, node: ast.AST, message: str,
                hint: Optional[str] = None) -> Finding:
        return Finding(ctx.path, getattr(node, "lineno", 1), self.rule_id,
                       message, hint or self.hint, ctx.scope_of(node))


class MergeMissingOpRule(MergeRule):
    """A fold-sink class (defines both ``consume`` and ``finish``) with
    no declared merge op (no ``merge``/``merge_states``/``merge_from``
    method). Its carry can be folded but never combined: the job cannot
    shard across hosts, cannot fold an appended delta into a saved
    carry, and cannot survive the redundant-work straggler designs —
    every path the ROADMAP's two heaviest items need. Every sink in
    ``runner._STREAM_FOLDS`` carries one by construction."""

    rule_id = "merge-missing-op"
    description = "fold sink has no registered merge/serialize op"
    hint = ("implement `merge(other)` as an additive combine of the "
            "sufficient statistic (the NaiveBayesModel.merge pattern; "
            "miners merge their support counts), or "
            "allowlist only a sink whose state provably merges at "
            "another level (say which)")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node, methods in _fold_sink_classes(ctx):
            if _MERGE_METHODS & set(methods):
                continue
            yield self.finding(
                ctx, node,
                f"fold sink `{node.name}` (consume + finish) declares no "
                f"merge op: its carry cannot combine across shards or "
                f"resume from a checkpoint")


class MergeOrderSensitiveFloatRule(MergeRule):
    """A fold-sink carry accumulating NON-integer floats: an attribute
    initialized to a float in ``__init__`` and ``+=``-folded in
    ``consume`` (or in the merge op itself). ``merge(A, B)`` computes
    ``(a1+...+an) + (b1+...+bm)`` — a different summation tree than the
    in-order fold — so float reassociation makes the merged result
    drift from ``fold(A++B)`` in the last bits, and the shard-merge
    audit's byte-identity is unprovable. Integer-dtype carries (and
    integer-valued float64 counts, the repo's standard) are exact under
    any grouping and stay silent."""

    rule_id = "merge-order-sensitive-float"
    description = "float accumulation in a carry whose merge reorders summands"
    hint = ("carry exact values (integer dtypes, or integer-valued "
            "float64 counts within the documented exactness bound — see "
            "the NB moments' panels), or use a compensated/"
            "fixed-order reduction and register the kernel's tolerance "
            "explicitly instead of claiming byte-identity")

    _FOLD_METHODS = ("consume",) + tuple(sorted(_MERGE_METHODS))

    def _float_attr_inits(self, ctx: ModuleContext,
                          init: ast.FunctionDef) -> Set[str]:
        out: Set[str] = set()
        for node in _method_nodes(init):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            attr = _self_attr(node.targets[0])
            if attr is None:
                continue
            if _FLOAT_INIT._is_float_init(ctx, node.value):
                out.add(attr)
        return out

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for cls, methods in _fold_sink_classes(ctx):
            init = methods.get("__init__")
            if init is None:
                continue
            floats = self._float_attr_inits(ctx, init)
            if not floats:
                continue
            seen: Set[str] = set()
            for mname in self._FOLD_METHODS:
                fn = methods.get(mname)
                if fn is None:
                    continue
                for node in _method_nodes(fn):
                    attr: Optional[str] = None
                    if isinstance(node, ast.AugAssign) \
                            and isinstance(node.op, ast.Add):
                        attr = _self_attr(node.target)
                    elif isinstance(node, ast.Assign) \
                            and len(node.targets) == 1 \
                            and isinstance(node.value, ast.BinOp) \
                            and isinstance(node.value.op, ast.Add):
                        tgt = _self_attr(node.targets[0])
                        left = _self_attr(node.value.left)
                        if tgt is not None and tgt == left:
                            attr = tgt
                    if attr in floats and attr not in seen:
                        seen.add(attr)
                        yield self.finding(
                            ctx, node,
                            f"float carry `self.{attr}` accumulates in "
                            f"`{cls.name}.{mname}`: a shard merge "
                            f"re-groups its summands, so merged output "
                            f"drifts from the in-order fold's bytes")


class MergeInplaceAliasedStateRule(MergeRule):
    """A fold-sink carry mutated IN PLACE while also aliased outside the
    sink — stored into a module/cache container or captured by a nested
    function. After ``restore_state`` builds a fresh carry, the alias
    still points at the pre-checkpoint object: the cache serves stale
    state and the closure mutates an orphan. Reassignment
    (``self.x = self.x + d``) rebinds instead of mutating and stays
    silent, as does state that never escapes the sink."""

    rule_id = "merge-inplace-aliased-state"
    description = "carry mutated in place while aliased by a cache/closure"
    hint = ("keep the carry private to the sink (hand copies outward), "
            "or rebind on every fold (`self.x = self.x + d`) so an old "
            "alias can never observe post-checkpoint mutation")

    def _inplace_attrs(self, methods) -> Dict[str, ast.AST]:
        out: Dict[str, ast.AST] = {}
        for fn in methods.values():
            for node in _method_nodes(fn):
                attr: Optional[str] = None
                if isinstance(node, ast.AugAssign):
                    attr = _self_attr(node.target)
                elif isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _MUTATORS:
                    attr = _self_attr(node.func.value)
                if attr is not None and attr not in out:
                    out[attr] = node
        return out

    def _escaped_attrs(self, methods) -> Set[str]:
        out: Set[str] = set()
        for fn in methods.values():
            for node in _method_nodes(fn):
                # CACHE[key] = self.attr — stored into a container that
                # is not the sink's own attribute
                if isinstance(node, ast.Assign):
                    attr = _self_attr(node.value)
                    if attr is not None and any(
                            isinstance(t, ast.Subscript)
                            and _self_attr(t.value) is None
                            for t in node.targets):
                        out.add(attr)
                # self.attr captured by a nested def/lambda
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                    for sub in ast.walk(node):
                        attr = _self_attr(sub)
                        if attr is not None:
                            out.add(attr)
        return out

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for cls, methods in _fold_sink_classes(ctx):
            inplace = self._inplace_attrs(methods)
            escaped = self._escaped_attrs(methods)
            for attr in sorted(set(inplace) & escaped):
                yield self.finding(
                    ctx, inplace[attr],
                    f"carry `self.{attr}` of `{cls.name}` is mutated in "
                    f"place AND aliased outside the sink: a restored "
                    f"checkpoint leaves the alias pointing at stale "
                    f"pre-checkpoint state")


class MergeUnserializableCarryRule(MergeRule):
    """A fold-sink carry binding resources that cannot cross a
    serialize/restore boundary — open files, threads, processes,
    sockets, locks, or live generators/iterators — in a class that
    declares no host round-trip (``state_dict``/``load_state``/
    ``serialize_state``/``__getstate__``). Checkpointing such a sink
    either fails outright or silently drops the resource's position.
    A sink that DOES declare the round-trip owns the problem (its
    state_dict must re-derive the resource) and stays silent."""

    rule_id = "merge-unserializable-carry"
    description = "carry holds threads/files/generators with no round-trip"
    hint = ("carry plain data (paths, offsets, count arrays) and "
            "re-open/re-derive the resource after restore, or declare "
            "the round-trip by implementing state_dict()/load_state() "
            "so the checkpoint contract is explicit")

    def _bad_value(self, ctx: ModuleContext, value: ast.AST
                   ) -> Optional[str]:
        if isinstance(value, ast.GeneratorExp):
            return "a live generator"
        if isinstance(value, ast.Call):
            name = ctx.dotted(value.func)
            if name in _UNSERIALIZABLE_CTORS:
                return f"`{name}(...)`"
        return None

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for cls, methods in _fold_sink_classes(ctx):
            if _ROUNDTRIP_METHODS & set(methods):
                continue
            for fn in methods.values():
                for node in _method_nodes(fn):
                    if not isinstance(node, ast.Assign) \
                            or len(node.targets) != 1:
                        continue
                    attr = _self_attr(node.targets[0])
                    if attr is None:
                        continue
                    what = self._bad_value(ctx, node.value)
                    if what is not None:
                        yield self.finding(
                            ctx, node,
                            f"carry `self.{attr}` of `{cls.name}` holds "
                            f"{what}: it cannot cross a checkpoint "
                            f"serialize/restore boundary and no host "
                            f"round-trip is declared")


ALL_MERGE_RULES = [MergeMissingOpRule, MergeOrderSensitiveFloatRule,
                   MergeInplaceAliasedStateRule,
                   MergeUnserializableCarryRule]


def merge_rule_ids() -> List[str]:
    return [r.rule_id for r in ALL_MERGE_RULES] + [MERGE_AUDIT_RULE]


# --------------------------------------------------------------------------
# shard-merge / resume auditor
# --------------------------------------------------------------------------
def _job_contexts(spec, ctx: dict, block_mb: float) -> List[tuple]:
    """[(job, prefix, props, cfg, ops)] of every fold the entry registers,
    its conf filled from the corpus ctx as the manifest's runners fill
    it; `props` is the prefixed dict the incremental legs feed to the
    delta-scan driver."""
    from avenir_tpu_torch.runner import _job_cfg, stream_fold_ops

    if not getattr(spec, "fold_specs", ()):
        raise MergeAuditError(
            f"{spec.name}: stream entry carries no fold_specs; the "
            f"merge auditor drives registered fold sinks directly")
    out = []
    for job, prefix, conf in spec.fold_specs:
        props = {k: (v.format(**ctx) if isinstance(v, str) else v)
                 for k, v in conf.items()}
        props[f"{prefix}.stream.block.size.mb"] = repr(float(block_mb))
        canonical, cfg = _job_cfg(job, props)
        out.append((canonical, prefix, props, cfg,
                    stream_fold_ops(canonical)))
    kinds = {ops.kind for _j, _p, _pr, _c, ops in out}
    if len(kinds) != 1:
        raise MergeAuditError(f"{spec.name}: mixed fold kinds {kinds}")
    return out


def _load_schema(ctx: dict):
    if "schema" not in ctx:
        return None
    from avenir_tpu_torch.core.schema import FeatureSchema

    return FeatureSchema.from_file(ctx["schema"])


def _chunk_list(kind: str, cfg, paths: Sequence[str], schema) -> list:
    """The runner's chunk feed (`stream_job_inputs` or
    `stream_job_byte_blocks`) as a list: the audit corpora are tens of
    KB, and the checkpoint split needs random access."""
    from avenir_tpu_torch.core.stream import (stream_job_byte_blocks,
                                              stream_job_inputs)

    if kind == "dataset":
        return list(stream_job_inputs(cfg, list(paths), schema))
    return list(stream_job_byte_blocks(cfg, list(paths)))


def _drive(jobs_ctx: List[tuple], paths: Sequence[str], schema,
           device) -> list:
    """Every job's registered fold sink over `paths` on `device`, fed by
    one `SharedScan` of the real chunk feed, as the fused runner feeds
    them; the fed folds."""
    from avenir_tpu_torch.core.stream import SharedScan

    kind = jobs_ctx[0][-1].kind
    folds = [ops.factory(cfg, list(paths), schema, device)
             for _job, _pfx, _props, cfg, ops in jobs_ctx]
    scan = SharedScan(iter(_chunk_list(kind, jobs_ctx[0][3], paths,
                                       schema)))
    for fold in folds:
        scan.add_sink(fold)
    scan.run()
    return folds


def _tagged_outputs(job: str, outputs: Sequence[str], out: str,
                    multi: bool) -> List[bytes]:
    """A job's output files, name-tagged as the manifest's runners tag
    them, so every leg compares byte for byte with `spec.run()`."""
    blobs = []
    for p in sorted(outputs):
        rel = os.path.relpath(p, out)
        tag = f"{job}:{rel}" if multi else rel
        with open(p, "rb") as fh:
            blobs.append(tag.encode() + b"\0" + fh.read())
    return blobs


def _finish_artifact(jobs_ctx: List[tuple], folds: list, out_base: str
                     ) -> bytes:
    """finish() every fold and render the runners' artifact."""
    multi = len(jobs_ctx) > 1
    blobs = []
    for (job, _pfx, _props, _cfg, _ops), fold in zip(jobs_ctx, folds):
        out = f"{out_base}_{job}"
        res = fold.finish(out)
        blobs.extend(_tagged_outputs(job, res.outputs, out, multi))
    return b"\n".join(blobs)


def _shard_files(workdir: str, blocks: List[bytes], P: int, tag: str,
                 overlap: bool = False) -> List[str]:
    """P shard files of consecutive block runs covering the corpus once
    (the blocks end at line boundaries); with `overlap`, shard 0 also
    holds shard 1's first block, the redundant-work probe."""
    bounds = [round(i * len(blocks) / P) for i in range(P + 1)]
    paths = []
    for i in range(P):
        part = blocks[bounds[i]:bounds[i + 1]]
        if overlap and i == 0 and bounds[1] < len(blocks):
            part = part + [blocks[bounds[1]]]
        p = os.path.join(workdir, f"shard_{tag}_{P}_{i}.csv")
        with open(p, "wb") as fh:
            fh.write(b"".join(part))
        paths.append(p)
    return paths


class _AuditInterrupt(Exception):
    """The injected kill of an incremental leg's append run."""


def _killed_after_first_checkpoint(run) -> bool:
    """Run `run()` with `core.incremental._checkpoint_hook` raising at
    the first mid-scan checkpoint: True when the kill landed."""
    from avenir_tpu_torch.core import incremental as incr

    def interrupter(meta: dict) -> None:
        if not meta.get("complete"):
            raise _AuditInterrupt()

    prev = incr._checkpoint_hook
    incr._checkpoint_hook = interrupter
    try:
        run()
    except _AuditInterrupt:
        return True
    finally:
        incr._checkpoint_hook = prev
    return False


def _checkpoint_every_block(props: dict, prefix: str) -> dict:
    """`props` checkpointing after every block, so the kill has a
    mid-delta watermark to die at and resume from."""
    return {**props, f"{prefix}.stream.checkpoint.interval.mb": "0.00001"}


def _incremental_leg(workdir: str, jobs_ctx: List[tuple],
                     blocks: List[bytes], baseline: bytes,
                     device) -> dict:
    """(d) the delta-scan driver (`runner.run_incremental`), a job at a
    time: a cold scan of half the blocks writes the checkpoint, the rest
    is appended, the refresh is killed after its first mid-delta
    checkpoint and run again; it must restore the carry, fold only the
    delta and give the cold scan's bytes."""
    from avenir_tpu_torch.runner import run_incremental

    grow = os.path.join(workdir, "grow.csv")
    half = max(1, len(blocks) // 2)
    with open(grow, "wb") as fh:
        fh.write(b"".join(blocks[:half]))
    multi = len(jobs_ctx) > 1

    def run_all(tag: str):
        blobs: List[bytes] = []
        results = []
        for job, prefix, props, _cfg, _ops in jobs_ctx:
            out = os.path.join(workdir, f"incr_{tag}_{job}")
            res = run_incremental(
                job, _checkpoint_every_block(props, prefix), [grow], out,
                state_dir=os.path.join(workdir, f"incr_state_{job}"),
                device=device)
            results.append(res)
            blobs.extend(_tagged_outputs(job, res.outputs, out, multi))
        return b"\n".join(blobs), results

    run_all("cold")                       # seeds the checkpoints
    with open(grow, "ab") as fh:
        fh.write(b"".join(blocks[half:]))
    interrupted = _killed_after_first_checkpoint(lambda: run_all("kill"))
    art, results = run_all("resume")
    # the least over the entry's jobs: every driver must have restored
    # its carry, or one job gone cold hides behind its sibling
    cs = [r.counters for r in results]
    return {
        "blocks": len(blocks), "prefix_blocks": half,
        "hit_blocks": min(int(c["Cache:HitBlocks"]) for c in cs),
        "delta_blocks": min(int(c["Cache:DeltaBlocks"]) for c in cs),
        "skipped_bytes": min(int(c["Resume:SkippedBytes"]) for c in cs),
        "resume_interrupted": interrupted,
        "byte_identical": art == baseline,
        "fused": _fused_incremental_leg(workdir, jobs_ctx, blocks,
                                        baseline, device),
    }


def _fused_incremental_leg(workdir: str, jobs_ctx: List[tuple],
                           blocks: List[bytes], baseline: bytes,
                           device) -> dict:
    """(e) the batched delta-scan driver (`runner.run_incremental_shared`,
    the job server's refresh path): every job of the entry seeded by one
    fused call on half the blocks, the rest appended, the fused refresh
    killed after its first mid-delta checkpoint and run again; each job
    must restore its carry and the artifacts give the cold scan's bytes.
    A one-job entry runs the driver with a group of one."""
    from avenir_tpu_torch.runner import run_incremental_shared

    grow = os.path.join(workdir, "grow_fused.csv")
    half = max(1, len(blocks) // 2)
    with open(grow, "wb") as fh:
        fh.write(b"".join(blocks[:half]))
    multi = len(jobs_ctx) > 1
    state_dirs = {job: os.path.join(workdir, f"fincr_state_{job}")
                  for job, _p, _pr, _c, _o in jobs_ctx}

    def run_fused(tag: str):
        specs = [(job, _checkpoint_every_block(props, prefix),
                  os.path.join(workdir, f"fincr_{tag}_{job}"))
                 for job, prefix, props, _cfg, _ops in jobs_ctx]
        shared = run_incremental_shared(specs, [grow],
                                        state_dirs=state_dirs,
                                        device=device)
        blobs: List[bytes] = []
        for job, _conf, out in specs:
            blobs.extend(_tagged_outputs(job, shared[job].outputs, out,
                                         multi))
        return b"\n".join(blobs), [shared[j] for j, *_ in jobs_ctx]

    run_fused("cold")                     # seeds every job's checkpoint
    with open(grow, "ab") as fh:
        fh.write(b"".join(blocks[half:]))
    interrupted = _killed_after_first_checkpoint(lambda: run_fused("kill"))
    art, results = run_fused("resume")
    cs = [r.counters for r in results]
    return {
        "jobs": len(jobs_ctx),
        "hit_blocks": min(int(c["Cache:HitBlocks"]) for c in cs),
        "skipped_bytes": min(int(c["Resume:SkippedBytes"]) for c in cs),
        "resume_interrupted": interrupted,
        "byte_identical": art == baseline,
    }


def _sharded_steal_leg(workdir: str, jobs_ctx: List[tuple], ctx: dict,
                       baseline: bytes, device) -> dict:
    """(f) the sharded steal through `dist`'s own pieces: the planner cuts
    the corpus into newline-aligned blocks, worker 0 claims and commits
    every block through the block ledger (half of them worker 1's: the
    fast worker's steal), then worker 1 folds the boundary block again,
    the first block of its own run, the block a straggler and its mirror
    race over, and its commit must be rejected, first commit wins. The
    plan-order merge of the committed states must give the cold bytes:
    every family is non-idempotent, so the ledger's dedup, not the fold,
    keeps redundant work safe."""
    from avenir_tpu_torch.dist.driver import merge_block_states
    from avenir_tpu_torch.dist.ledger import BlockLedger
    from avenir_tpu_torch.dist.plan import plan_shards
    from avenir_tpu_torch.dist.worker import fold_block

    csv = ctx["csv"]
    schema = _load_schema(ctx)
    plan = plan_shards([csv], procs=2, factor=2)
    boundary = plan.blocks_for(1)[0]
    dup_rejected = True
    committed_once = True
    folds = []

    def close_src(f) -> None:
        # a miner's fold owns its streaming source (spill cache, files)
        src = getattr(f, "src", None)
        if src is not None:
            src.close()

    for job, _prefix, _props, cfg, ops in jobs_ctx:
        root = os.path.join(workdir, f"steal_{job}")
        ledger = BlockLedger(root)
        for blk in plan.blocks:
            if not ledger.claim(blk.id, worker=0):
                raise MergeAuditError(
                    f"{job}: worker 0 lost an uncontended claim on "
                    f"block {blk.id}")
            fold = fold_block(job, cfg, ops, schema, [csv], csv,
                              blk.start, blk.end, device)
            committed = ledger.commit(blk.id, 0, ops.serialize_state(fold))
            close_src(fold)
            if not committed:
                raise MergeAuditError(
                    f"{job}: worker 0's first commit of block "
                    f"{blk.id} was rejected")
        fold = fold_block(job, cfg, ops, schema, [csv], csv,
                          boundary.start, boundary.end, device)
        won = ledger.commit(boundary.id, 1, ops.serialize_state(fold))
        close_src(fold)
        if won:
            dup_rejected = False
        if len(ledger.committed()) != len(plan.blocks) \
                or ledger.dup_count() < 1:
            committed_once = False
        states = {bid: ledger.load_state(bid) for bid in ledger.committed()}
        folds.append(merge_block_states(job, cfg, ops, plan, states, [csv],
                                        root, schema=schema, device=device))
    art = _finish_artifact(jobs_ctx, folds,
                           os.path.join(workdir, "steal_merge"))
    return {
        "blocks": len(plan.blocks),
        "boundary_block": boundary.id,
        "dup_rejected": dup_rejected,
        "committed_once": committed_once,
        "byte_identical": art == baseline,
    }


def audit_merge(spec, shard_counts: Sequence[int] = AUDIT_SHARDS,
                block_mb: float = AUDIT_BLOCK_MB
                ) -> Tuple[dict, Optional[Finding]]:
    """Prove one stream entry's fold state a merge algebra on its device:
    the legs (a)-(f) of the module docstring. (audit row, finding or
    None); an entry that fails to run raises :class:`MergeAuditError`."""
    from avenir_tpu_torch.core.stream import iter_byte_blocks
    from avenir_tpu_torch.utils.devices import resolve_device

    device = resolve_device(spec.device)
    workdir = tempfile.mkdtemp(prefix=f"audit_merge_{spec.name}_")
    try:
        ctx = spec.prepare(workdir)
        jobs_ctx = _job_contexts(spec, ctx, block_mb)
        kind = jobs_ctx[0][-1].kind
        baseline = spec.run(ctx, block_mb)
        schema = _load_schema(ctx)

        block_bytes = max(int(block_mb * (1 << 20)), 64)
        blocks = list(iter_byte_blocks(ctx["csv"], block_bytes))
        enough = len(blocks) >= max(shard_counts)

        shard_rows: List[dict] = []
        checkpoint: Optional[dict] = None
        overlap: Optional[dict] = None
        incremental: Optional[dict] = None
        sharded: Optional[dict] = None
        if enough:
            for P in shard_counts:
                folds = [_drive(jobs_ctx, [shard], schema, device)
                         for shard in _shard_files(workdir, blocks, P, "m")]
                merged = folds[0]
                for nxt in folds[1:]:
                    merged = [ops.merge_states(a, b)
                              for (_j, _p, _pr, _c, ops), a, b
                              in zip(jobs_ctx, merged, nxt)]
                art = _finish_artifact(
                    jobs_ctx, merged, os.path.join(workdir, f"merge{P}"))
                shard_rows.append({"P": P, "blocks": len(blocks),
                                   "byte_identical": art == baseline})

            # (b) serialize after half the chunks, restore into fresh
            # folds, finish
            chunks = _chunk_list(kind, jobs_ctx[0][3], [ctx["csv"]], schema)
            half = max(1, len(chunks) // 2)
            folds = [ops.factory(cfg, [ctx["csv"]], schema, device)
                     for _j, _p, _pr, cfg, ops in jobs_ctx]
            for chunk in chunks[:half]:
                for fold in folds:
                    fold.consume(chunk)
            states = [ops.serialize_state(fold)
                      for (_j, _p, _pr, _c, ops), fold
                      in zip(jobs_ctx, folds)]
            restored = [ops.restore_state(cfg, [ctx["csv"]], blob,
                                          schema=schema, device=device)
                        for (_j, _p, _pr, cfg, ops), blob
                        in zip(jobs_ctx, states)]
            for chunk in chunks[half:]:
                for fold in restored:
                    fold.consume(chunk)
            ck_art = _finish_artifact(jobs_ctx, restored,
                                      os.path.join(workdir, "resume"))
            checkpoint = {
                "chunks": len(chunks), "checkpoint_after": half,
                "state_bytes": int(sum(len(b) for b in states)),
                "byte_identical": ck_art == baseline,
            }

            # (c) shard 0 folds shard 1's first block again: a count
            # family's output must change (its merge is not idempotent,
            # so redundant work dedups by block before the fold); the row
            # records the contract
            folds = [_drive(jobs_ctx, [shard], schema, device)
                     for shard in _shard_files(workdir, blocks, 2, "o",
                                               overlap=True)]
            merged = [ops.merge_states(a, b)
                      for (_j, _p, _pr, _c, ops), a, b
                      in zip(jobs_ctx, folds[0], folds[1])]
            ov_art = _finish_artifact(jobs_ctx, merged,
                                      os.path.join(workdir, "overlap"))
            overlap = {
                "output_changed": ov_art != baseline,
                "contract": ("non-idempotent" if ov_art != baseline
                             else "overlap-insensitive"),
            }
            incremental = _incremental_leg(workdir, jobs_ctx, blocks,
                                           baseline, device)
            sharded = _sharded_steal_leg(workdir, jobs_ctx, ctx, baseline,
                                         device)
    except MergeAuditError:
        raise
    except Exception as e:
        raise MergeAuditError(
            f"{spec.name}: fold kernel failed to drive/merge: {e!r}") from e
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    ok = enough and all(r["byte_identical"] for r in shard_rows) \
        and checkpoint is not None and checkpoint["byte_identical"]
    fused = incremental.get("fused") if incremental else None
    solo_ok = (incremental is not None
               and incremental["byte_identical"]
               and incremental["resume_interrupted"]
               and incremental["skipped_bytes"] > 0)
    incr_ok = (solo_ok and fused is not None
               and fused["byte_identical"]
               and fused["resume_interrupted"]
               and fused["skipped_bytes"] > 0)
    shard_ok = (sharded is not None
                and sharded["dup_rejected"]
                and sharded["committed_once"]
                and sharded["byte_identical"])
    row = {
        "kernel": spec.name,
        "jobs": [j for j, _p, _pr, _c, _o in jobs_ctx],
        "block_mb": float(block_mb),
        "shards": shard_rows,
        "checkpoint": checkpoint,
        "overlap": overlap,
        "incremental": incremental,
        "sharded": sharded,
        "merge_validated": ok,
        "incremental_validated": incr_ok,
        "shard_dedup_validated": shard_ok,
    }
    finding = None
    if not ok or not incr_ok or not shard_ok:
        if not enough:
            why = (f"corpus cut into only {len(blocks)} blocks at "
                   f"{block_mb:g}MB — too few for P={max(shard_counts)} "
                   f"shards (auditor corpus too small)")
        else:
            bad = [f"P={r['P']}" for r in shard_rows
                   if not r["byte_identical"]]
            if not checkpoint["byte_identical"]:
                bad.append("checkpoint-resume")
            if not incr_ok:
                bad.append("fused-incremental-append/resume" if solo_ok
                           else "incremental-append/resume")
            if not shard_ok:
                bad.append("sharded-steal-dedup")
            why = f"output bytes drifted under: {', '.join(bad)}"
        finding = Finding(
            spec.path, spec.line, MERGE_AUDIT_RULE,
            f"streamed kernel `{spec.name}` is not a merge algebra: {why}",
            "make the carry an exact additive sufficient statistic with "
            "a lossless state_dict (see runner.StreamFoldOps); never "
            "allowlist a merge drift",
            spec.name)
    return row, finding


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------
def run_merge(paths: Optional[Sequence[str]] = None,
              rules: Optional[Sequence[MergeRule]] = None,
              baseline: Optional[Sequence[BaselineEntry]] = None,
              root: Optional[str] = None, include_md: bool = True,
              audit: bool = True, entries: Optional[Sequence] = None,
              shard_counts: Sequence[int] = AUDIT_SHARDS,
              device: str = "cuda") -> Report:
    """Check `paths` (default: the port's surface) with the merge rules,
    run the shard-merge and resume audit over the stream entries on
    `device`, and split both finding sets by the allowlist."""
    active = list(rules) if rules is not None else \
        [r() for r in ALL_MERGE_RULES]
    root = os.path.abspath(root or os.getcwd())
    scan = list(paths) if paths else default_flow_paths(root)
    report, raw = collect_findings(scan, active, root, include_md)
    if audit:
        specs = list(entries) if entries is not None else None
        if specs is None:
            from avenir_tpu_torch.analysis.manifest import stream_entries
            specs = stream_entries(device)
        for spec in specs:
            # not added to report.scanned, as in the flow audit
            row, finding = audit_merge(spec, shard_counts=shard_counts)
            report.merge_audit.append(row)
            if finding is not None:
                raw.append(finding)
    active_ids = {r.rule_id for r in active}
    if audit:
        active_ids.add(MERGE_AUDIT_RULE)
    apply_baseline(report, raw, baseline, active_ids)
    return report
