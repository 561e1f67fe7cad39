"""The flow auditor: concurrency and determinism of the host streaming
layer, and the chunk-invariance audit of the stream entries.

The port of `avenir_tpu/analysis/flow.py`. Two layers:

- **Flow rules**, interprocedural facts of each module's concurrency
  surface: a :class:`ConcurrencyModel` resolves which names and
  attributes hold queues, locks and threads (through assignment
  aliases), which functions run on worker threads (through
  ``Thread(target=...)`` and transitive ``self.method()`` calls), and
  which loops fold streamed chunks. Five rules judge those facts: a
  `queue.get()` without a timeout (a hang no watcher can tell from a
  stalled card), a thread nothing joins (truncation at shutdown), public
  state a worker mutates without a lock, blocking IO inside a fold body
  (it serializes the overlap the prefetch exists for), and a float
  accumulator folded across chunks (its sum regroups with the layout).
  `OrderSensitiveFoldRule` reads numpy's and torch's constructors.
- **Chunk-invariance auditor**: every stream entry
  (`analysis.manifest.stream_entries`) runs to its end at each of its
  three block sizes and once more under an adversarial scheduler (a
  seeded 0-3 ms delay at every block the readers produce, through
  `core.stream._produce_hook`), and its artifacts must be byte-identical.
  The same hook counts the blocks read, which must differ between the
  layouts, or the audit proves nothing.

Findings go through the shared engine and allowlist. An entry that
fails to run raises :class:`FlowAuditError` (the CLI's exit 2); a drift
is a finding under ``flow-chunk-invariance`` (exit 1), never
allowlisted: fix the fold.
"""

from __future__ import annotations

import ast
import os
import random
import shutil
import tempfile
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from avenir_tpu_torch.analysis.engine import (BaselineEntry, Finding,
                                              ModuleContext, Report,
                                              apply_baseline,
                                              collect_findings)

#: the auditor's rule id: a layout or scheduler drift is a finding under
#: it (never allowlist one: a fold whose result depends on the chunk
#: layout is wrong)
FLOW_AUDIT_RULE = "flow-chunk-invariance"

_THREAD_CTORS = ("threading.Thread",)
_QUEUE_CTORS = ("queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
                "queue.PriorityQueue", "multiprocessing.Queue")
_LOCK_CTORS = ("threading.Lock", "threading.RLock", "threading.Condition",
               "threading.Semaphore", "threading.BoundedSemaphore")
#: iterator factories whose `for` loops are chunk/fold loops — the
#: device-overlap pipeline the blocking-io and order rules protect
_FOLD_SOURCES = {"double_buffered", "prefetched", "stream_job_inputs",
                 "stream_job_lines", "stream_job_byte_blocks"}
#: method calls treated as container mutation for the shared-state rule
_MUTATORS = {"append", "extend", "insert", "add", "discard", "remove",
             "pop", "popitem", "clear", "update", "setdefault"}


class FlowAuditError(RuntimeError):
    """A streamed fold kernel could not be prepared or run."""


# --------------------------------------------------------------------------
# per-module concurrency model (shared by all five rules)
# --------------------------------------------------------------------------
def _target_ids(target: ast.AST) -> List[str]:
    """Identifier keys a binding target contributes to the alias graph:
    plain names as ``name``, self-attributes as ``.attr`` (attribute
    identity is keyed on the attr name — modules here are small and the
    coarseness is documented)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, ast.Attribute) and isinstance(target.value,
                                                        ast.Name) \
            and target.value.id == "self":
        return ["." + target.attr]
    return []


def _receiver_id(node: ast.AST) -> Optional[str]:
    """Identifier key of a call/attribute receiver, same keying as
    :func:`_target_ids`."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return "." + node.attr
    return None


class _Aliases:
    """Union-find over identifier keys, connected by plain assignments
    (including tuple-to-tuple unpacks like ``t, self.x = self.x, None``):
    the dataflow skeleton the queue/lock/thread facts ride on."""

    def __init__(self, tree: ast.Module):
        self.parent: Dict[str, str] = {}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            pairs: List[Tuple[ast.AST, ast.AST]] = []
            tgt, val = node.targets[0], node.value
            if isinstance(tgt, ast.Tuple) and isinstance(val, ast.Tuple) \
                    and len(tgt.elts) == len(val.elts):
                pairs.extend(zip(tgt.elts, val.elts))
            else:
                pairs.append((tgt, val))
            for t, v in pairs:
                vid = _receiver_id(v)
                if vid is None:
                    continue
                for tid in _target_ids(t):
                    self.union(tid, vid)

    def find(self, key: str) -> str:
        root = key
        while self.parent.get(root, root) != root:
            root = self.parent[root]
        while self.parent.get(key, key) != key:
            self.parent[key], key = root, self.parent[key]
        return root

    def union(self, a: str, b: str) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb

    def same(self, a: str, b: str) -> bool:
        return self.find(a) == self.find(b)


class ConcurrencyModel:
    """The module facts every flow rule consumes: which identifiers are
    bound (possibly through aliases) to queues/locks/threads, where each
    thread is created and whether anything in its alias chain is ever
    joined, and which functions execute on a worker thread."""

    def __init__(self, ctx: ModuleContext):
        self.ctx = ctx
        self.aliases = _Aliases(ctx.tree)
        self.queue_ids: Set[str] = set()
        self.lock_ids: Set[str] = set()
        # thread creations: (Thread(...) call node, bound id or None)
        self.threads: List[Tuple[ast.Call, Optional[str]]] = []
        self.joined_ids: Set[str] = set()
        self._collect()

    def _ctor_kind(self, call: ast.Call) -> Optional[str]:
        name = self.ctx.dotted(call.func)
        if name in _THREAD_CTORS:
            return "thread"
        if name in _QUEUE_CTORS:
            return "queue"
        if name in _LOCK_CTORS:
            return "lock"
        return None

    def _collect(self) -> None:
        tree = self.ctx.tree
        for node in ast.walk(tree):
            targets: List[ast.AST] = []
            value: Optional[ast.AST] = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            if value is not None and isinstance(value, ast.Call):
                kind = self._ctor_kind(value)
                if kind is not None:
                    ids = [i for t in targets for i in _target_ids(t)]
                    if kind == "queue":
                        self.queue_ids.update(ids)
                    elif kind == "lock":
                        self.lock_ids.update(ids)
                    else:
                        self.threads.append((value, ids[0] if ids else None))
        for node in ast.walk(tree):
            # bare `threading.Thread(...).start()` — never bindable, so
            # never joinable (track it with no id)
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute) \
                    and isinstance(node.func.value, ast.Call) \
                    and self._ctor_kind(node.func.value) == "thread" \
                    and node.func.attr == "start":
                self.threads.append((node.func.value, None))
            # join sites: `x.join(...)` where the receiver is an
            # identifier (str.join on literals never is)
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute) \
                    and node.func.attr == "join":
                rid = _receiver_id(node.func.value)
                if rid is not None:
                    self.joined_ids.add(rid)

    # ------------------------------------------------------------ queries
    def is_queue(self, receiver: ast.AST) -> bool:
        rid = _receiver_id(receiver)
        return rid is not None and any(self.aliases.same(rid, q)
                                       for q in self.queue_ids)

    def is_lock_expr(self, expr: ast.AST) -> bool:
        rid = _receiver_id(expr)
        if rid is not None:
            return any(self.aliases.same(rid, l) for l in self.lock_ids)
        # `with self._lock.acquire()`-ish / `with lock() as ...` shapes
        if isinstance(expr, ast.Call):
            return self.is_lock_expr(expr.func.value) \
                if isinstance(expr.func, ast.Attribute) else False
        return False

    def thread_joined(self, bound_id: Optional[str]) -> bool:
        if bound_id is None:
            return False
        return any(self.aliases.same(bound_id, j) for j in self.joined_ids)

    # -------------------------------------------------- worker reachability
    def worker_functions(self) -> List[ast.FunctionDef]:
        """Function defs that execute on a worker thread: every
        ``Thread(target=...)`` target resolved to a def in this module,
        plus same-class methods transitively called as ``self.m()`` from
        one — the interprocedural step that pins LearnerStream.replays."""
        ctx = self.ctx
        by_name: Dict[str, List[ast.FunctionDef]] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                by_name.setdefault(node.name, []).append(node)

        seeds: List[ast.FunctionDef] = []
        for call, _ in self.threads:
            target = next((kw.value for kw in call.keywords
                           if kw.arg == "target"), None)
            if target is None:
                continue
            if isinstance(target, ast.Name):
                seeds.extend(by_name.get(target.id, []))
            elif isinstance(target, ast.Attribute) \
                    and isinstance(target.value, ast.Name) \
                    and target.value.id == "self":
                seeds.extend(f for f in by_name.get(target.attr, [])
                             if self._same_class(f, call))

        reached: List[ast.FunctionDef] = []
        frontier = list(seeds)
        while frontier:
            fn = frontier.pop()
            if fn in reached:
                continue
            reached.append(fn)
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and isinstance(node.func.value, ast.Name) \
                        and node.func.value.id == "self":
                    for cand in by_name.get(node.func.attr, []):
                        if self._same_class(cand, fn):
                            frontier.append(cand)
        return reached

    def _enclosing_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        cur = self.ctx.parent(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            cur = self.ctx.parent(cur)
        return None

    def _same_class(self, a: ast.AST, b: ast.AST) -> bool:
        ca, cb = self._enclosing_class(a), self._enclosing_class(b)
        return ca is not None and ca is cb


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------
_MODEL_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _concurrency_model(ctx: ModuleContext) -> ConcurrencyModel:
    """One ConcurrencyModel per module, shared by the three rules that
    consume it (building it walks the full AST several times)."""
    model = _MODEL_CACHE.get(ctx)
    if model is None:
        model = ConcurrencyModel(ctx)
        _MODEL_CACHE[ctx] = model
    return model


class FlowRule:
    rule_id: str = ""
    description: str = ""
    hint: str = ""

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: ModuleContext, node: ast.AST, message: str,
                hint: Optional[str] = None) -> Finding:
        return Finding(ctx.path, getattr(node, "lineno", 1), self.rule_id,
                       message, hint or self.hint, ctx.scope_of(node))


class UnboundedQueueGetRule(FlowRule):
    """``X.get()`` with no timeout (and not ``block=False``) on a
    receiver whose alias chain holds a ``queue.Queue``. The blocked
    thread hangs forever if the producer dies or the sentinel is lost —
    from outside, indistinguishable from a hung device. Dict ``.get``
    never fires: the receiver must be queue-typed in the module's
    dataflow."""

    rule_id = "flow-unbounded-queue-get"
    description = "queue.get() with no timeout can block forever"
    hint = ("get(timeout=...) in a loop that re-checks a shutdown flag / "
            "worker liveness (see core.stream._Prefetcher.__next__), "
            "or get_nowait() + backoff")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        model = _concurrency_model(ctx)
        if not model.queue_ids:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute) \
                    or node.func.attr != "get":
                continue
            if node.args or any(kw.arg in ("timeout", "block")
                                for kw in node.keywords):
                continue
            if model.is_queue(node.func.value):
                yield self.finding(
                    ctx, node,
                    "bare queue .get() blocks forever if the producer "
                    "dies or the shutdown sentinel is lost: a hang no "
                    "watcher can tell from a stalled card")


class UnjoinedThreadRule(FlowRule):
    """A ``threading.Thread`` that nothing in its assignment-alias chain
    ever ``.join()``s. At interpreter shutdown a daemon worker is killed
    mid-block — for the prefetch pipeline that is silent output
    truncation; for a non-daemon it is a leak that outlives the job."""

    rule_id = "flow-unjoined-thread"
    description = "thread started but never joined anywhere in the module"
    hint = ("bind the Thread, join it on the owner's stop()/close() path "
            "(alias-chain joins like `t, self.t = self.t, None; t.join()` "
            "count), and verify is_alive() after a bounded join")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        model = _concurrency_model(ctx)
        for call, bound_id in model.threads:
            if model.thread_joined(bound_id):
                continue
            what = (f"thread bound to `{bound_id.lstrip('.')}`"
                    if bound_id else "unbound thread (Thread(...).start())")
            yield self.finding(
                ctx, call,
                f"{what} is never joined: shutdown kills the worker "
                f"mid-block (silent truncation) or leaks it past the job")


class SharedStateUnlockedRule(FlowRule):
    """Public ``self.`` attributes mutated from worker-thread-reachable
    code (the ``Thread(target=...)`` function and every same-class
    method it transitively calls) without holding a module-known lock.
    A public attribute is caller-readable by contract, so the mutation
    races every caller read. Queue attributes are exempt — a queue IS
    the sanctioned handoff — as are mutations lexically inside a
    ``with <lock>:`` block."""

    rule_id = "flow-shared-state-unlocked"
    description = "worker thread mutates caller-visible state without a lock"
    hint = ("guard the mutation (and the caller-facing reads) with a "
            "threading.Lock held attribute, or hand the data over a queue "
            "instead of sharing the field")

    def _under_lock(self, ctx: ModuleContext, model: ConcurrencyModel,
                    node: ast.AST) -> bool:
        cur = ctx.parent(node)
        while cur is not None:
            if isinstance(cur, (ast.With, ast.AsyncWith)) and any(
                    model.is_lock_expr(item.context_expr)
                    for item in cur.items):
                return True
            cur = ctx.parent(cur)
        return False

    def _mutated_attr(self, node: ast.AST) -> Optional[str]:
        """Public self-attr a statement/call mutates, else None."""
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                base = t.value if isinstance(t, ast.Subscript) else t
                rid = _receiver_id(base)
                if rid is not None and rid.startswith("."):
                    return rid[1:]
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            rid = _receiver_id(node.func.value)
            if rid is not None and rid.startswith("."):
                return rid[1:]
        return None

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        model = _concurrency_model(ctx)
        if not model.threads:
            return
        workers = model.worker_functions()
        seen: Set[Tuple[str, str]] = set()
        for fn in workers:
            for node in ast.walk(fn):
                attr = self._mutated_attr(node)
                if attr is None or attr.startswith("_"):
                    continue
                if model.is_queue(ast.Attribute(
                        value=ast.Name(id="self"), attr=attr)):
                    continue
                if self._under_lock(ctx, model, node):
                    continue
                key = (fn.name, attr)
                if key in seen:
                    continue
                seen.add(key)
                yield self.finding(
                    ctx, node,
                    f"worker-reachable `{fn.name}` mutates public "
                    f"`self.{attr}` without a lock: callers reading it "
                    f"race the worker (torn reads, lost updates)")


def _fold_loops(ctx: ModuleContext) -> Iterator[ast.For]:
    """`for` statements iterating a chunk/fold source (double_buffered,
    prefetched, stream_job_*) — the loops whose bodies are supposed to
    overlap with the producer thread."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.For, ast.AsyncFor)):
            continue
        for sub in ast.walk(node.iter):
            if isinstance(sub, ast.Call):
                name = ctx.dotted(sub.func)
                if name is not None \
                        and name.rpartition(".")[2] in _FOLD_SOURCES:
                    yield node
                    break


def _body_nodes(loop: ast.For) -> Iterator[ast.AST]:
    """Nodes in the loop body, not descending into nested defs (their
    statements run when called, not per-chunk)."""
    stack = list(loop.body)
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


class BlockingIoInFoldRule(FlowRule):
    """File/Redis/process IO inside the body of a fold loop over a
    prefetched/double-buffered source. The fold body is the overlap
    window — device compute on block k while the host parses k+1; a
    blocking syscall there serializes the pipeline the double buffer
    exists to overlap (and the bench reads it as device slowness)."""

    rule_id = "flow-blocking-io-in-fold"
    description = "blocking host IO inside a streamed fold body"
    hint = ("hoist the IO out of the fold (open before, write after — "
            "accumulate per-chunk results and flush once), or move it "
            "into the producer side where the prefetch thread absorbs it")

    IO_CALLS = {"open", "os.system", "subprocess.run", "subprocess.Popen",
                "subprocess.call", "subprocess.check_output",
                "subprocess.check_call", "time.sleep", "socket.create_connection"}
    IO_TAILS = {"rpop", "lpush", "rpush", "brpop", "blpop", "flushall",
                "urlopen"}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for loop in _fold_loops(ctx):
            for node in _body_nodes(loop):
                if not isinstance(node, ast.Call):
                    continue
                name = ctx.dotted(node.func)
                if name is None:
                    continue
                if name in self.IO_CALLS \
                        or name.rpartition(".")[2] in self.IO_TAILS:
                    yield self.finding(
                        ctx, node,
                        f"`{name}` inside a streamed fold body blocks the "
                        f"consumer once per chunk, serializing the "
                        f"double-buffered encode/count overlap")


class OrderSensitiveFoldRule(FlowRule):
    """A float accumulator folded across streamed chunks
    (``acc += ...`` / ``acc = acc + ...`` in a fold loop, where `acc`
    was initialized float in the same function). Float addition is not
    associative: the result depends on where the chunk boundaries fall,
    so the job's output changes with block size — the bit-reproducibility
    the chunk-invariance auditor exists to pin. Integer-dtype
    accumulators are exact under any grouping and stay silent."""

    rule_id = "flow-order-sensitive-fold"
    description = "float accumulation across chunks depends on chunk layout"
    hint = ("accumulate exact values (integer dtype, or integer-valued "
            "floats within the documented exactness bound — see "
            "the NB moments' panels), or register the kernel in the "
            "chunk-invariance manifest and accept allclose, not bytes")

    _FLOAT_DTYPES = {"float16", "float32", "float64", "bfloat16"}
    _CTORS = {"zeros", "ones", "empty", "full", "zeros_like", "ones_like"}

    def _float_inits(self, ctx: ModuleContext, fn: ast.AST) -> Set[str]:
        """Names bound in `fn` (not nested defs) to a float-default or
        explicitly-float initializer."""
        out: Set[str] = set()
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(node))
            if not isinstance(node, ast.Assign) or len(node.targets) != 1 \
                    or not isinstance(node.targets[0], ast.Name):
                continue
            if self._is_float_init(ctx, node.value):
                out.add(node.targets[0].id)
        return out

    def _is_float_init(self, ctx: ModuleContext, value: ast.AST) -> bool:
        if isinstance(value, ast.Constant):
            return isinstance(value.value, float)
        if not isinstance(value, ast.Call):
            return False
        name = ctx.dotted(value.func)
        if name is None:
            return False
        mod, _, func = name.rpartition(".")
        if mod not in ("numpy", "torch") or func not in self._CTORS:
            return False
        dtype = next((kw.value for kw in value.keywords
                      if kw.arg == "dtype"), None)
        # numpy takes the dtype positionally too; torch's positional
        # arguments of zeros/ones/empty are all sizes
        if dtype is None and mod == "numpy" and len(value.args) > 1 \
                and func != "full":
            dtype = value.args[1]
        if dtype is None and mod == "numpy" and len(value.args) > 2 \
                and func == "full":
            dtype = value.args[2]
        if dtype is None:
            # the dtype-less constructors default to float (numpy's
            # float64, torch's float32): a float accumulator either way;
            # `full` takes its fill value's type
            return func != "full" or not value.args or not isinstance(
                value.args[-1], ast.Constant) or isinstance(
                value.args[-1].value, float)
        dname = ctx.dotted(dtype)
        if dname is not None:
            return dname.rpartition(".")[2] in self._FLOAT_DTYPES
        return isinstance(dtype, ast.Constant) \
            and str(dtype.value) in self._FLOAT_DTYPES

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for loop in _fold_loops(ctx):
            owners = ctx.enclosing_functions(loop)
            owner = owners[0] if owners else ctx.tree
            floats = self._float_inits(ctx, owner)
            if not floats:
                continue
            for node in _body_nodes(loop):
                name: Optional[str] = None
                if isinstance(node, ast.AugAssign) \
                        and isinstance(node.target, ast.Name) \
                        and isinstance(node.op, ast.Add):
                    name = node.target.id
                elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and isinstance(node.value, ast.BinOp) \
                        and isinstance(node.value.op, ast.Add) \
                        and isinstance(node.value.left, ast.Name) \
                        and node.value.left.id == node.targets[0].id:
                    name = node.targets[0].id
                if name in floats:
                    yield self.finding(
                        ctx, node,
                        f"float accumulator `{name}` folds streamed "
                        f"chunks: addition reassociates with the chunk "
                        f"layout, so the result changes with block size")


ALL_FLOW_RULES = [UnboundedQueueGetRule, UnjoinedThreadRule,
                  SharedStateUnlockedRule, BlockingIoInFoldRule,
                  OrderSensitiveFoldRule]


def flow_rule_ids() -> List[str]:
    return [r.rule_id for r in ALL_FLOW_RULES] + [FLOW_AUDIT_RULE]


# --------------------------------------------------------------------------
# chunk-invariance auditor
# --------------------------------------------------------------------------
@contextmanager
def _stream_hook(fn):
    """`fn` as `core.stream._produce_hook` for the duration."""
    from avenir_tpu_torch.core import stream

    prev = stream._produce_hook
    stream._produce_hook = fn
    try:
        yield
    finally:
        stream._produce_hook = prev


class _ChunkCounter:
    """Counts the blocks the readers produce in a run: the proof that two
    layouts chunked differently (two one-block runs validate nothing)."""

    def __init__(self):
        self.n = 0
        self._lock = threading.Lock()

    def __call__(self) -> None:
        with self._lock:
            self.n += 1


class _AdversarialScheduler:
    """A seeded 0-3 ms delay at every block a reader produces, so queue
    occupancy, thread interleaving and the consumer's waits differ from
    the plain run. The fold's output must not."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def __call__(self) -> None:
        with self._lock:
            delay = self._rng.random() * 0.003
        time.sleep(delay)


def audit_stream(spec) -> Tuple[dict, Optional[Finding]]:
    """Run one stream entry at every layout of its spec and under the
    adversarial scheduler, and compare the artifacts byte for byte:
    (audit row, invariance finding or None)."""
    workdir = tempfile.mkdtemp(prefix=f"audit_flow_{spec.name}_")
    try:
        ctx = spec.prepare(workdir)
        outputs: List[bytes] = []
        chunk_counts: List[int] = []
        for mb in spec.layouts:
            counter = _ChunkCounter()
            with _stream_hook(counter):
                outputs.append(spec.run(ctx, mb))
            chunk_counts.append(counter.n)
        sched = _AdversarialScheduler(seed=len(spec.name) * 7919 + 17)
        with _stream_hook(sched):
            adversarial = spec.run(ctx, spec.layouts[-1])
    except FlowAuditError:
        raise
    except Exception as e:
        raise FlowAuditError(f"{spec.name}: stream kernel failed to run: "
                             f"{e!r}") from e
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    layouts_ok = all(o == outputs[0] for o in outputs[1:])
    scheduler_ok = adversarial == outputs[0]
    distinct = len(set(chunk_counts)) >= 2
    row = {
        "kernel": spec.name,
        "layouts_mb": [float(mb) for mb in spec.layouts],
        "chunk_counts": chunk_counts,
        "layouts_distinct": distinct,
        "layouts_byte_identical": layouts_ok,
        "scheduler_byte_identical": scheduler_ok,
        "invariance_validated": layouts_ok and scheduler_ok and distinct,
    }
    finding = None
    if not row["invariance_validated"]:
        why = ("chunk layouts did not differ (auditor corpus too small "
               "for its block sizes)" if not distinct else
               "output bytes drift with the chunk layout" if not layouts_ok
               else "output bytes drift under the adversarial scheduler")
        finding = Finding(
            spec.path, spec.line, FLOW_AUDIT_RULE,
            f"streamed kernel `{spec.name}` is not chunk-invariant: {why} "
            f"(chunk counts {chunk_counts})",
            "make the fold exact (integer counts, or floats summed in one "
            "fixed order) or fix the corpus so layouts differ; never "
            "allowlist a non-deterministic fold",
            spec.name)
    return row, finding


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------
def default_flow_paths(root: str) -> List[str]:
    """The checked surface: the port's package and its card script."""
    names = ["avenir_tpu_torch", "chip_smoke.py"]
    return [p for p in (os.path.join(root, n) for n in names)
            if os.path.exists(p)]


def run_flow(paths: Optional[Sequence[str]] = None,
             rules: Optional[Sequence[FlowRule]] = None,
             baseline: Optional[Sequence[BaselineEntry]] = None,
             root: Optional[str] = None, include_md: bool = True,
             audit: bool = True, entries: Optional[Sequence] = None,
             device: str = "cuda") -> Report:
    """Check `paths` (default: the port's surface) with the flow rules,
    run the chunk-invariance audit over the stream entries on `device`,
    and split both finding sets by the allowlist."""
    active = list(rules) if rules is not None else \
        [r() for r in ALL_FLOW_RULES]
    root = os.path.abspath(root or os.getcwd())
    scan = list(paths) if paths else default_flow_paths(root)
    report, raw = collect_findings(scan, active, root, include_md)
    if audit:
        specs = list(entries) if entries is not None else None
        if specs is None:
            from avenir_tpu_torch.analysis.manifest import stream_entries
            specs = stream_entries(device)
        for spec in specs:
            # not added to report.scanned: the audit runs the fold, it
            # does not check its file, and a claimed scan would stale
            # allowlist entries of files a path subset leaves out
            row, finding = audit_stream(spec)
            report.invariance_audit.append(row)
            if finding is not None:
                raw.append(finding)
    active_ids = {r.rule_id for r in active}
    if audit:
        active_ids.add(FLOW_AUDIT_RULE)
    apply_baseline(report, raw, baseline, active_ids)
    return report
