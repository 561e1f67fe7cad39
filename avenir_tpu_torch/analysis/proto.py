"""The shared-filesystem protocol tier: ``python -m avenir_tpu_torch.analysis
--proto``.

The port's copy of `avenir_tpu/analysis/proto.py`. The port's
distributed state is files on one filesystem: spool requests and
results, leases, ledger claims and block states, shard plans,
checkpoints, sidecar manifests, tune profiles and the reward journal.
Each is correct only under one discipline: write the whole payload to a
uniquely named sibling tmp file, commit with one atomic rename
(``os.replace``, or ``os.link`` for first-commit-wins), clean the tmp on
every exit path, guard every shared read against torn or absent files,
bound every poll, and keep in-process deadlines on the monotonic clock.

**Static rules** (AST, within a module) over the protocol surface
(``net/``, ``dist/``, ``server/spool.py``, ``server/jobserver.py``,
``server/score.py``, ``native/sidecar.py``, ``core/incremental.py``,
``core/atomic.py``, ``tune/store.py``):

- ``proto-nonatomic-publish``: a write-mode open of a non-tmp path in a
  function with no atomic commit and no publish helper;
- ``proto-tmp-not-sibling``: the rename source lives in another tree
  (``tempfile.*``, a ``/tmp`` literal) than its target, so the rename is
  a copy and a delete;
- ``proto-shared-tmp-name``: a fixed tmp name (``path + ".tmp"``)
  committed by rename: two writers collide on it;
- ``proto-torn-read-unguarded``: ``json.load``/``loads`` of a shared
  file with no guard for torn or absent content;
- ``proto-unbounded-poll``: a sleep-poll loop with no deadline, bound,
  stop predicate or raise;
- ``proto-wall-clock-deadline``: ``time.time()`` arithmetic driving an
  in-process deadline or backoff;
- ``proto-tmp-leak-on-raise``: a tmp written and renamed with no
  cleanup on the exception path.

**The commit-point auditor** (:func:`audit_commit_points`): every
publish function names its commit point (``crash_point(name, ...)`` or
``site=name`` through `core/atomic.py`), and :data:`COMMIT_SITES`
registers a driver a site. Each driver runs one real small publish in a
fresh interpreter with ``AVENIR_PROTO_CRASH`` armed, hard-killed
(``os._exit``) before the rename and after it; recovery (the publish
run again, then the startup stale-tmp sweep) must leave the artifact
byte-identical to an uncrashed run (wall-clock fields canonicalized
away) with no stranded tmp. The pseudo-rule ``proto-commit-point`` is
never allowlisted. :func:`check_site_registry` fails loudly when the
annotations in code and :data:`COMMIT_SITES` disagree. The sites are
host code: no kernel runs, so the tier takes no device.
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Set, Tuple)

from avenir_tpu_torch.analysis.engine import (BaselineEntry, Finding,
                                              ModuleContext, Report,
                                              apply_baseline, collect_findings)
from avenir_tpu_torch.core.atomic import (AFTER_RENAME, BEFORE_RENAME,
                                          CRASH_ENV, CRASH_EXIT, is_tmp_name,
                                          sweep_stale_tmps)

#: the audit pseudo-rule: commit-site kill-injection verdicts surface
#: under this id and are NEVER allowlisted
PROTO_AUDIT_RULE = "proto-commit-point"


class ProtoAuditError(RuntimeError):
    """The commit-point auditor could not run (driver crash, child
    failure, registry mismatch) — an environment/registry error, never
    a lint finding."""


def default_proto_paths(root: str) -> List[str]:
    """The protocol surface this tier lints: every module that reads or
    writes shared-filesystem protocol state."""
    names = [os.path.join("avenir_tpu_torch", "net"),
             os.path.join("avenir_tpu_torch", "dist"),
             os.path.join("avenir_tpu_torch", "server", "spool.py"),
             os.path.join("avenir_tpu_torch", "server", "jobserver.py"),
             os.path.join("avenir_tpu_torch", "native", "sidecar.py"),
             os.path.join("avenir_tpu_torch", "core", "incremental.py"),
             os.path.join("avenir_tpu_torch", "core", "atomic.py"),
             os.path.join("avenir_tpu_torch", "tune", "store.py"),
             os.path.join("avenir_tpu_torch", "server", "score.py")]
    return [p for p in (os.path.join(root, n) for n in names)
            if os.path.exists(p)]


# --------------------------------------------------------------------------
# shared AST helpers
# --------------------------------------------------------------------------
_WRITE_MODES = {"w", "wb", "x", "xb", "w+", "wb+", "w+b", "x+b", "xb+"}
_COMMIT_CALLS = {"os.replace", "os.rename", "os.link"}
_REMOVE_CALLS = {"os.remove", "os.unlink"}
#: a call whose terminal name contains one of these delegates the
#: commit to the core.atomic discipline — the function under it is a
#: publish wrapper, not a hand-rolled protocol
_PUBLISH_MARKERS = ("publish", "write_json_atomic", "_write_atomic")
#: naming evidence that a tmp path carries a per-writer uniquifier
_UNIQUE_MARKERS = ("uuid", "getpid", "mkstemp", "namedtemporary",
                   "nonce", "unique")
_GUARD_EXCEPTIONS = {"ValueError", "JSONDecodeError", "KeyError",
                     "Exception", "BaseException"}
#: evidence that a sleep-poll loop is bounded (deadline/patience
#: arithmetic, a stop predicate, liveness checks)
_POLL_BOUND_MARKERS = ("deadline", "monotonic", "perf_counter",
                       "patience", "stop", "done", "alive", "is_set",
                       "expired", "timeout", "until", "attempts",
                       "retries", "bound", "remaining")
#: deadline-flavored target names for wall-clock deadline construction
_DEADLINE_NAMES = ("deadline", "backoff", "restart_at", "retry_at",
                   "expires", "until", "_at")

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _functions(ctx: ModuleContext) -> Iterator[ast.FunctionDef]:
    for node in ast.walk(ctx.tree):
        if isinstance(node, _FUNC_NODES):
            yield node


def _calls(node: ast.AST) -> Iterator[ast.Call]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            yield sub


def _terminal_name(ctx: ModuleContext, call: ast.Call) -> str:
    """The last dotted segment of the callee (``fh.write`` -> `write`),
    lower-cased; empty for non-name callees."""
    dotted = ctx.dotted(call.func)
    if dotted:
        return dotted.rsplit(".", 1)[-1].lower()
    if isinstance(call.func, ast.Attribute):
        return call.func.attr.lower()
    return ""


def _write_open_path(ctx: ModuleContext, call: ast.Call
                     ) -> Optional[ast.AST]:
    """The path expression of an ``open(path, "w"/"wb"/...)`` call, or
    None when the call is not a literal write-mode open."""
    if ctx.dotted(call.func) not in ("open", "io.open") or not call.args:
        return None
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if not (isinstance(mode, ast.Constant)
            and isinstance(mode.value, str)):
        return None
    if mode.value not in _WRITE_MODES and "a" not in mode.value:
        return None
    if "a" in mode.value:
        return None                 # append is its own (log) discipline
    return call.args[0]


def _resolve_map(ctx: ModuleContext,
                 fn: ast.FunctionDef) -> Dict[str, List[ast.AST]]:
    """Name -> assigned value expressions, for soup resolution: the
    function's simple local assigns plus the enclosing class's
    ``self.x = ...`` assigns across all its methods (a tmp path is
    often built in ``__init__`` and renamed in ``commit``)."""
    out: Dict[str, List[ast.AST]] = {}

    def note(target: ast.AST, value: ast.AST) -> None:
        if isinstance(target, ast.Name):
            out.setdefault(target.id, []).append(value)
        elif isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id == "self":
            out.setdefault(f"self.{target.attr}", []).append(value)

    def harvest(scope: ast.AST) -> None:
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    note(t, node.value)
            elif isinstance(node, ast.AnnAssign) and node.value:
                note(node.target, node.value)

    harvest(fn)
    cur = ctx.parent(fn)
    while cur is not None and not isinstance(cur, ast.ClassDef):
        cur = ctx.parent(cur)
    if cur is not None:
        harvest(cur)
    return out


def _soup(ctx: ModuleContext, expr: ast.AST,
          resolve: Optional[Dict[str, List[ast.AST]]] = None,
          depth: int = 2) -> str:
    """A lower-cased bag of the names, attributes, string constants and
    callee names an expression (and, up to `depth` levels, the local
    assignments it references) is built from — the naming-evidence
    substrate the tmp-likeness and uniquifier checks read."""
    parts: List[str] = []
    stack: List[Tuple[ast.AST, int]] = [(expr, depth)]
    while stack:
        node, d = stack.pop()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Constant) and isinstance(sub.value,
                                                            str):
                parts.append(sub.value.lower())
            elif isinstance(sub, ast.Name):
                parts.append(sub.id.lower())
                if resolve and d > 0:
                    for v in resolve.get(sub.id, ()):
                        stack.append((v, d - 1))
            elif isinstance(sub, ast.Attribute):
                parts.append(sub.attr.lower())
                if resolve and d > 0 \
                        and isinstance(sub.value, ast.Name) \
                        and sub.value.id == "self":
                    for v in resolve.get(f"self.{sub.attr}", ()):
                        stack.append((v, d - 1))
    return " ".join(parts)


def _tmp_like(soup: str) -> bool:
    return "tmp" in soup or "temp" in soup


def _has_unique_marker(soup: str) -> bool:
    return any(m in soup for m in _UNIQUE_MARKERS)


def _foreign_tmp_root(ctx: ModuleContext, expr: ast.AST,
                      resolve: Dict[str, List[ast.AST]]) -> bool:
    """True when the expression (shallow-resolved) is derived from a
    tempfile.* directory or a ``/tmp`` literal — a root with no
    same-filesystem guarantee relative to the rename target."""
    stack: List[Tuple[ast.AST, int]] = [(expr, 2)]
    while stack:
        node, d = stack.pop()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                dotted = ctx.dotted(sub.func) or ""
                if dotted.startswith("tempfile."):
                    return True
            elif isinstance(sub, ast.Constant) \
                    and isinstance(sub.value, str) \
                    and sub.value.startswith("/tmp"):
                return True
            elif isinstance(sub, ast.Name) and d > 0:
                for v in resolve.get(sub.id, ()):
                    stack.append((v, d - 1))
    return False


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------
class ProtoRule:
    rule_id: str = ""
    description: str = ""
    hint: str = ""

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: ModuleContext, node: ast.AST, message: str,
                hint: Optional[str] = None) -> Finding:
        return Finding(ctx.path, getattr(node, "lineno", 1),
                       self.rule_id, message, hint or self.hint,
                       ctx.scope_of(node))


class NonatomicPublishRule(ProtoRule):
    """A function write-opens a non-tmp path and never commits anything
    atomically (no replace/rename/link, no publish helper): whatever it
    writes is observable half-written by any concurrent reader — the
    exact torn state every protocol reader in this repo is specified
    never to see."""

    rule_id = "proto-nonatomic-publish"
    description = "shared-file write without tmp + atomic rename commit"
    hint = ("publish through core.atomic.publish_bytes/publish_json "
            "(unique sibling tmp + os.replace), or os.link for "
            "first-commit-wins records")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in _functions(ctx):
            commits = False
            for call in _calls(fn):
                dotted = ctx.dotted(call.func) or ""
                term = _terminal_name(ctx, call)
                if dotted in _COMMIT_CALLS \
                        or any(m in term for m in _PUBLISH_MARKERS):
                    commits = True
                    break
            if commits:
                continue
            resolve = _resolve_map(ctx, fn)
            for call in _calls(fn):
                path_expr = _write_open_path(ctx, call)
                if path_expr is None:
                    continue
                if _tmp_like(_soup(ctx, path_expr, resolve)):
                    continue        # a staged tmp: the commit is elsewhere
                yield self.finding(
                    ctx, call,
                    f"`{fn.name}` write-opens a shared path with no "
                    f"atomic commit in sight: a concurrent reader can "
                    f"observe the half-written file")


class TmpNotSiblingRule(ProtoRule):
    """An atomic-looking rename whose source was staged under a
    DIFFERENT directory tree (tempfile.*, a /tmp literal): when the
    stage and the target sit on different filesystems, os.replace
    degrades to EXDEV failure and the usual fallback (copy+delete) is
    not atomic — the tmp must be a sibling of its target."""

    rule_id = "proto-tmp-not-sibling"
    description = "rename source staged outside the target's directory"
    hint = ("stage with core.atomic.unique_tmp(path) — the tmp is a "
            "same-directory sibling by construction, so the commit "
            "rename is same-filesystem and atomic")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in _functions(ctx):
            resolve = _resolve_map(ctx, fn)
            for call in _calls(fn):
                if ctx.dotted(call.func) not in _COMMIT_CALLS \
                        or len(call.args) < 2:
                    continue
                src, dst = call.args[0], call.args[1]
                if _foreign_tmp_root(ctx, src, resolve) \
                        and not _foreign_tmp_root(ctx, dst, resolve):
                    yield self.finding(
                        ctx, call,
                        f"`{fn.name}` renames from a tempfile/tmpdir "
                        f"stage into a different tree: a cross-"
                        f"filesystem rename is not atomic")


class SharedTmpNameRule(ProtoRule):
    """A rename-committed tmp path with a FIXED name (``path + '.tmp'``
    and friends, no uuid/pid/mkstemp uniquifier): two racing writers
    collide on the tmp — the slower one overwrites the faster one's
    bytes mid-publish and the rename commits a torn hybrid."""

    rule_id = "proto-shared-tmp-name"
    description = "fixed-name tmp two racing writers collide on"
    hint = ("uniquify the stage per writer: core.atomic.unique_tmp "
            "(uuid sibling), or a pid/uuid suffix when hand-rolling "
            "a first-commit-wins link")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in _functions(ctx):
            resolve = _resolve_map(ctx, fn)
            for call in _calls(fn):
                if ctx.dotted(call.func) not in _COMMIT_CALLS \
                        or not call.args:
                    continue
                soup = _soup(ctx, call.args[0], resolve)
                if _tmp_like(soup) and not _has_unique_marker(soup):
                    yield self.finding(
                        ctx, call,
                        f"`{fn.name}` commits a fixed-name tmp: two "
                        f"racing writers share one stage path and one "
                        f"publishes the other's half-written bytes")


class TornReadUnguardedRule(ProtoRule):
    """A ``json.load``/``json.loads`` of shared state with no enclosing
    try guarding torn/absent content (ValueError/JSONDecodeError/
    KeyError): writers are atomic, but a reader still races deletion
    and external truncation — every protocol reader in this repo
    treats an unparsable record as absent, never as a crash."""

    rule_id = "proto-torn-read-unguarded"
    description = "shared-file json.load without torn/absent guard"
    hint = ("wrap in try/except (OSError, ValueError, KeyError) and "
            "treat the torn record as absent (the claim_info / "
            "load_plan / load_claimed policy)")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) \
                    or ctx.dotted(node.func) not in ("json.load",
                                                     "json.loads"):
                continue
            if self._guarded(ctx, node):
                continue
            yield self.finding(
                ctx, node,
                "json.load of a shared file with no torn/absent guard: "
                "a reader racing deletion or truncation crashes instead "
                "of treating the record as absent")

    @staticmethod
    def _guarded(ctx: ModuleContext, node: ast.AST) -> bool:
        cur = ctx.parent(node)
        while cur is not None:
            if isinstance(cur, _FUNC_NODES):
                return False
            if isinstance(cur, ast.Try):
                for handler in cur.handlers:
                    if handler.type is None:
                        return True
                    names = {n.rsplit(".", 1)[-1]
                             for n in (ctx.dotted(t) or ""
                                       for t in ast.walk(handler.type))
                             if n}
                    if names & _GUARD_EXCEPTIONS:
                        return True
            cur = ctx.parent(cur)
        return False


class UnboundedPollRule(ProtoRule):
    """A sleep-poll while-loop with no deadline, patience bound, stop
    predicate, liveness check or in-loop raise: when the awaited file
    never appears (its writer died), the loop spins to the caller's
    outermost timeout — or forever."""

    rule_id = "proto-unbounded-poll"
    description = "sleep-poll loop with no deadline or stop predicate"
    hint = ("bound the loop: a time.monotonic()/perf_counter deadline "
            "that raises, a should_stop()/patience predicate, or a "
            "liveness check on the awaited writer")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.While):
                continue
            sleeps = any(
                _terminal_name(ctx, c) in ("sleep", "wait")
                for c in _calls(node))
            if not sleeps:
                continue
            if any(isinstance(sub, ast.Raise) for sub in ast.walk(node)):
                continue
            soup = _soup(ctx, node)
            if any(m in soup for m in _POLL_BOUND_MARKERS):
                continue
            yield self.finding(
                ctx, node,
                "sleep-poll loop with no deadline, stop predicate or "
                "liveness bound: it hangs forever when the awaited "
                "writer is gone")


class WallClockDeadlineRule(ProtoRule):
    """``time.time()`` arithmetic driving an in-process deadline or
    duration comparison (both compared values wall-derived locals):
    an NTP step stretches or collapses the bound — leases expire
    instantly or never. ``time.monotonic()`` is required for every
    in-process duration; wall time belongs only in persisted records
    compared across processes (attribute/subscript loads are exempt
    for exactly that reason). Wall taint propagates through same-module
    call sites into callee parameters, like flow.py's interprocedural
    passes."""

    rule_id = "proto-wall-clock-deadline"
    description = "wall-clock arithmetic driving an in-process deadline"
    hint = ("use time.monotonic() for in-process backoff/patience/"
            "deadline arithmetic; keep time.time() only for persisted "
            "cross-process record timestamps")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        taint = self._module_taint(ctx)
        for fn in _functions(ctx):
            tainted = taint.get(fn, set())
            seen: Set[int] = set()
            for node in ast.walk(fn):
                sides: List[ast.AST] = []
                if isinstance(node, ast.Compare):
                    sides = [node.left] + list(node.comparators)
                elif isinstance(node, ast.BinOp) \
                        and isinstance(node.op, ast.Sub):
                    sides = [node.left, node.right]
                if len(sides) < 2:
                    continue
                wall = [s for s in sides
                        if self._pure_wall(ctx, s, tainted)]
                if len(wall) < 2 or node.lineno in seen:
                    continue
                seen.add(node.lineno)
                yield self.finding(
                    ctx, node,
                    f"`{fn.name}` compares/differences two wall-clock "
                    f"(time.time-derived) values in-process: an NTP "
                    f"step makes this bound fire instantly or never")

    # -------------------------------------------------- wall taint
    @staticmethod
    def _is_wall_call(ctx: ModuleContext, node: ast.AST) -> bool:
        return isinstance(node, ast.Call) \
            and ctx.dotted(node.func) == "time.time"

    def _expr_tainted(self, ctx: ModuleContext, expr: ast.AST,
                      tainted: Set[str]) -> bool:
        for sub in ast.walk(expr):
            if self._is_wall_call(ctx, sub):
                return True
            if isinstance(sub, ast.Name) and sub.id in tainted:
                return True
        return False

    def _pure_wall(self, ctx: ModuleContext, expr: ast.AST,
                   tainted: Set[str]) -> bool:
        """Wall-derived AND built only from locals/constants — an
        attribute or subscript load means a persisted cross-process
        record is involved, which is the legitimate use of wall time."""
        wall = False
        for sub in ast.walk(expr):
            if self._is_wall_call(ctx, sub):
                wall = True
            elif isinstance(sub, ast.Call):
                return False
            elif isinstance(sub, ast.Attribute):
                if (ctx.dotted(sub) or "") != "time.time":
                    return False
            elif isinstance(sub, ast.Subscript):
                return False
            elif isinstance(sub, ast.Name):
                if sub.id in tainted:
                    wall = True
        return wall

    def _module_taint(self, ctx: ModuleContext
                      ) -> Dict[ast.FunctionDef, Set[str]]:
        fns = list(_functions(ctx))
        by_name: Dict[str, List[ast.FunctionDef]] = {}
        for fn in fns:
            by_name.setdefault(fn.name, []).append(fn)
        taint: Dict[ast.FunctionDef, Set[str]] = {fn: set() for fn in fns}
        for _ in range(3):
            changed = False
            for fn in fns:
                tainted = taint[fn]
                # local propagation: assignments from wall expressions
                for _pass in range(2):
                    for node in ast.walk(fn):
                        if not isinstance(node, ast.Assign):
                            continue
                        if not self._expr_tainted(ctx, node.value,
                                                  tainted):
                            continue
                        for t in node.targets:
                            if isinstance(t, ast.Name) \
                                    and t.id not in tainted:
                                tainted.add(t.id)
                                changed = True
                # call-site propagation into same-module callees
                for call in _calls(fn):
                    name = _terminal_name(ctx, call)
                    targets = by_name.get(name)
                    if not targets or len(targets) != 1:
                        continue
                    callee = targets[0]
                    params = [a.arg for a in callee.args.args]
                    offset = 1 if params[:1] == ["self"] else 0
                    for i, arg in enumerate(call.args):
                        if not self._expr_tainted(ctx, arg, taint[fn]):
                            continue
                        idx = i + offset
                        if idx < len(params) \
                                and params[idx] not in taint[callee]:
                            taint[callee].add(params[idx])
                            changed = True
                    for kw in call.keywords:
                        if kw.arg and kw.arg in params \
                                and self._expr_tainted(ctx, kw.value,
                                                       taint[fn]) \
                                and kw.arg not in taint[callee]:
                            taint[callee].add(kw.arg)
                            changed = True
            if not changed:
                break
        return taint


class TmpLeakOnRaiseRule(ProtoRule):
    """A function stages a tmp and commits by rename but never removes
    the tmp on the exception path (no remove/unlink in any except
    handler or finally): every crash between stage and commit strands
    a tmp file in the shared root forever."""

    rule_id = "proto-tmp-leak-on-raise"
    description = "staged tmp not cleaned on the exception path"
    hint = ("wrap stage+commit so the tmp is removed on failure "
            "(try/finally os.remove, or the core.atomic.publish_* "
            "helpers which do it for you)")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in _functions(ctx):
            resolve = _resolve_map(ctx, fn)
            staged = None
            commits = False
            for call in _calls(fn):
                path_expr = _write_open_path(ctx, call)
                if path_expr is not None \
                        and _tmp_like(_soup(ctx, path_expr, resolve)):
                    staged = staged or call
                if ctx.dotted(call.func) in _COMMIT_CALLS:
                    commits = True
            if staged is None or not commits:
                continue
            if self._cleans_on_failure(ctx, fn):
                continue
            yield self.finding(
                ctx, staged,
                f"`{fn.name}` stages a tmp and renames it but never "
                f"removes the tmp on the exception path: a crash "
                f"between stage and commit strands it forever")

    @staticmethod
    def _cleans_on_failure(ctx: ModuleContext,
                           fn: ast.FunctionDef) -> bool:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Try):
                continue
            failure_bodies = list(node.finalbody)
            for handler in node.handlers:
                failure_bodies.extend(handler.body)
            for stmt in failure_bodies:
                for call in _calls(stmt):
                    if ctx.dotted(call.func) in _REMOVE_CALLS:
                        return True
        return False


ALL_PROTO_RULES = [NonatomicPublishRule, TmpNotSiblingRule,
                   SharedTmpNameRule, TornReadUnguardedRule,
                   UnboundedPollRule, WallClockDeadlineRule,
                   TmpLeakOnRaiseRule]


def proto_rule_ids() -> List[str]:
    return [r.rule_id for r in ALL_PROTO_RULES] + [PROTO_AUDIT_RULE]


# --------------------------------------------------------------------------
# commit-site registry
# --------------------------------------------------------------------------
@dataclass
class CommitSite:
    """One registered commit point: a name (matching the site string
    its publish function passes to ``crash_point``/``site=``), the
    module that implements it, and a driver that runs ONE real small
    publish of that site rooted at a given directory. The driver must
    be deterministic (volatile wall timestamps excepted — the audit
    canonicalizes those) and IDEMPOTENT under re-run: recovery after a
    crash is literally running it again, exactly like the restarted
    writer would."""

    name: str
    path: str
    run: Callable[[str], None]
    #: override the crash child's ``python -c`` source (tests inject
    #: deliberately-broken sites the package does not export);
    #: ``__ROOT__`` is substituted with the crash root
    child_source: Optional[str] = None


def _run_ledger_claim(root: str) -> None:
    from avenir_tpu_torch.dist.ledger import BlockLedger
    BlockLedger(root).claim(1, 0)


def _run_ledger_commit(root: str) -> None:
    from avenir_tpu_torch.dist.ledger import BlockLedger
    led = BlockLedger(root)
    if 2 not in led.committed():      # the restarted worker's recovery
        led.commit(2, 0, b"block-2-state")


def _run_ledger_dup(root: str) -> None:
    from avenir_tpu_torch.dist.ledger import BlockLedger
    led = BlockLedger(root)
    if 3 not in led.committed():
        led.commit(3, 0, b"block-3-state")
    led.commit(3, 1, b"block-3-dup")  # rejected: records the dup marker


def _run_ledger_format(root: str) -> None:
    from avenir_tpu_torch.dist.ledger import BlockLedger
    BlockLedger(root)      # construction stamps states/FORMAT.json


def _run_plan_manifest(root: str) -> None:
    from avenir_tpu_torch.dist.plan import write_json_atomic
    write_json_atomic({"procs": 1, "factor": 1, "blocks": []},
                      os.path.join(root, "plan.json"))


def _run_lease_write(root: str) -> None:
    from avenir_tpu_torch.net.fault import Lease, LeaseStore
    LeaseStore(root).write(Lease(name="r000001.json", host=0,
                                 claimed_at=1000.0, ttl_s=5.0))


def _run_spool_result(root: str) -> None:
    from avenir_tpu_torch.server.spool import publish_result
    out_dir = os.path.join(root, "out")
    os.makedirs(out_dir, exist_ok=True)
    publish_result(out_dir, "r1.json", {"ok": True, "name": "audit"})


def _run_spool_dead_letter(root: str) -> None:
    from avenir_tpu_torch.server.spool import dead_letter
    work_dir = os.path.join(root, "work")
    os.makedirs(work_dir, exist_ok=True)
    work_path = os.path.join(work_dir, "q.json")
    with open(work_path, "w") as fh:   # the torn request being buried
        fh.write("{not json")
    dead_letter(root, "q.json", work_path, "ValueError: torn request")


def _run_spool_port(root: str) -> None:
    from avenir_tpu_torch.server.spool import write_port_file
    write_port_file(os.path.join(root, "port"), 43210)


def _run_checkpoint_save(root: str) -> None:
    from avenir_tpu_torch.core.incremental import CheckpointStore
    CheckpointStore(os.path.join(root, "state")).save(
        {"seq": 1, "job": "audit"}, b"carry-bytes")


def _run_profile_save(root: str) -> None:
    from avenir_tpu_torch.tune.store import ProfileStore
    ProfileStore(os.path.join(root, "tune")).set_knobs(
        "audit", "deadbeef", {}, ["proto audit"])


def _run_score_reward(root: str) -> None:
    from avenir_tpu_torch.server.score import append_reward
    artifact = os.path.join(root, "bandit_stats.csv")
    try:
        with open(artifact, "x") as fh:     # EAFP: re-run keeps the file
            fh.write("g1,i1,5,2.0\ng1,i2,3,4.0\n")
    except FileExistsError:
        pass
    # the nonce makes the recovery (re-running the append) idempotent:
    # an entry that already committed dedupes instead of doubling
    append_reward(artifact, "g1", "i2", 7.0, count=1,
                  nonce="proto-audit-reward")


def _run_sidecar_manifest(root: str) -> None:
    from avenir_tpu_torch.native.sidecar import FORMAT, _write_manifest
    dirpath = os.path.join(root, "sc")
    os.makedirs(dirpath, exist_ok=True)
    _write_manifest(dirpath, {"format": FORMAT, "blocks": []})


#: every registered commit point — each publish function on the
#: protocol surface annotates its commit (``crash_point(name, ...)``
#: directly or ``site=name`` through the atomic helpers) and registers
#: a driver here; check_site_registry fails loudly on a mismatch in
#: either direction
COMMIT_SITES: List[CommitSite] = [
    CommitSite("ledger.claim", "avenir_tpu_torch/dist/ledger.py",
               _run_ledger_claim),
    CommitSite("ledger.commit", "avenir_tpu_torch/dist/ledger.py",
               _run_ledger_commit),
    CommitSite("ledger.dup", "avenir_tpu_torch/dist/ledger.py",
               _run_ledger_dup),
    CommitSite("ledger.format", "avenir_tpu_torch/dist/ledger.py",
               _run_ledger_format),
    CommitSite("plan.manifest", "avenir_tpu_torch/dist/plan.py",
               _run_plan_manifest),
    CommitSite("lease.write", "avenir_tpu_torch/net/fault.py",
               _run_lease_write),
    CommitSite("spool.result", "avenir_tpu_torch/server/spool.py",
               _run_spool_result),
    CommitSite("spool.dead_letter", "avenir_tpu_torch/server/spool.py",
               _run_spool_dead_letter),
    CommitSite("spool.port", "avenir_tpu_torch/server/spool.py",
               _run_spool_port),
    CommitSite("checkpoint.save", "avenir_tpu_torch/core/incremental.py",
               _run_checkpoint_save),
    CommitSite("profile.save", "avenir_tpu_torch/tune/store.py",
               _run_profile_save),
    CommitSite("sidecar.manifest", "avenir_tpu_torch/native/sidecar.py",
               _run_sidecar_manifest),
    CommitSite("score.reward", "avenir_tpu_torch/server/score.py",
               _run_score_reward),
]


def commit_sites() -> List[CommitSite]:
    return list(COMMIT_SITES)


def _drive_site(name: str, root: str) -> None:
    """The crash child's entry point: run one registered site's driver
    with the ``AVENIR_PROTO_CRASH`` hook armed by the parent."""
    for site in COMMIT_SITES:
        if site.name == name:
            site.run(root)
            return
    raise SystemExit(f"unknown commit site {name!r}")


# --------------------------------------------------------------------------
# registry cross-check
# --------------------------------------------------------------------------
#: a site annotation in protocol code: crash_point("name", ...) or a
#: site="name" keyword into the atomic publish helpers
_SITE_REF_RE = re.compile(r'(?:crash_point\(\s*|site\s*=\s*)"([a-z_.]+)"')


def _open_device(device: str, error) -> None:
    """Raise `error` when `device` cannot run (cuda wanted, no card):
    an audit then fails to run, it never falls back to the CPU."""
    from avenir_tpu_torch.utils.devices import resolve_device

    try:
        resolve_device(device)
    except (RuntimeError, ValueError) as e:
        raise error(str(e)) from e


def _pkg_root() -> str:
    """The checkout the port's package under audit lives in."""
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def site_annotations(root: Optional[str] = None
                     ) -> Dict[str, Tuple[str, int]]:
    """Every site name annotated on the protocol surface, mapped to
    the (repo-relative path, line) of its first annotation."""
    root = root or _pkg_root()
    refs: Dict[str, Tuple[str, int]] = {}
    files: List[str] = []
    for p in default_proto_paths(root):
        if os.path.isdir(p):
            for dirpath, dirnames, names in os.walk(p):
                dirnames.sort()
                files.extend(os.path.join(dirpath, n)
                             for n in sorted(names)
                             if n.endswith(".py"))
        else:
            files.append(p)
    for path in files:
        try:
            with open(path, encoding="utf-8") as fh:
                text = fh.read()
        except OSError:
            continue
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        for i, line in enumerate(text.splitlines(), 1):
            for m in _SITE_REF_RE.finditer(line):
                refs.setdefault(m.group(1), (rel, i))
    return refs


def check_site_registry(root: Optional[str] = None
                        ) -> Dict[str, Tuple[str, int]]:
    """Fail loudly when the code annotations and COMMIT_SITES disagree:
    an annotated-but-unregistered site escapes the crash audit, a
    registered-but-unannotated site means the registry points at a
    publish that no longer exists. Returns the annotation locations
    (the audit rows' path/line source)."""
    refs = site_annotations(root)
    names = {s.name for s in COMMIT_SITES}
    unregistered = sorted(set(refs) - names)
    unannotated = sorted(names - set(refs))
    problems = []
    if unregistered:
        problems.append(
            f"annotated in code but not in COMMIT_SITES (no crash "
            f"audit covers them): {unregistered}")
    if unannotated:
        problems.append(
            f"registered in COMMIT_SITES but never annotated in code "
            f"(dangling registry entries): {unannotated}")
    if problems:
        raise ProtoAuditError(
            "commit-site registry mismatch: " + "; ".join(problems))
    return refs


# --------------------------------------------------------------------------
# crash-point auditor
# --------------------------------------------------------------------------
#: wall-clock fields protocol records legitimately persist — stripped
#: before byte comparison (two correct runs stamp different times)
_VOLATILE_KEYS = ("claimed_at", "rejected_at", "ts_unix")


def _canon(rel: str, data: bytes) -> bytes:
    """Canonical bytes of one artifact: JSON files are re-serialized
    with volatile wall-timestamp fields dropped and keys sorted, so
    byte comparison proves structural identity; everything else
    compares raw."""
    if not rel.endswith(".json"):
        return data
    try:
        obj = json.loads(data.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return data                 # torn JSON: compare (and fail) raw
    if isinstance(obj, dict):
        for key in _VOLATILE_KEYS:
            obj.pop(key, None)
    return json.dumps(obj, sort_keys=True).encode("utf-8")


def _snapshot(root: str) -> Dict[str, bytes]:
    out: Dict[str, bytes] = {}
    for dirpath, dirnames, names in os.walk(root):
        dirnames.sort()
        for n in sorted(names):
            if is_tmp_name(n):
                continue
            path = os.path.join(dirpath, n)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            try:
                with open(path, "rb") as fh:
                    out[rel] = _canon(rel, fh.read())
            except OSError:
                out[rel] = b"<unreadable>"
    return out


def _tmp_leftovers(root: str) -> List[str]:
    out = []
    for dirpath, _dirnames, names in os.walk(root):
        out.extend(os.path.relpath(os.path.join(dirpath, n), root)
                   for n in names if is_tmp_name(n))
    return sorted(out)


def _spawn_crash_child(site: CommitSite, root: str,
                       stage: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env[CRASH_ENV] = f"{site.name}:{stage}"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_pkg_root(), env.get("PYTHONPATH")) if p)
    if site.child_source is not None:
        code = site.child_source.replace("__ROOT__", root)
    else:
        code = ("from avenir_tpu_torch.analysis.proto import _drive_site; "
                f"_drive_site({site.name!r}, {root!r})")
    try:
        return subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True,
                              timeout=120)
    except subprocess.TimeoutExpired as e:
        raise ProtoAuditError(
            f"commit site {site.name} [{stage}]: crash child timed "
            f"out after 120s") from e


def audit_commit_points(sites: Optional[Sequence[CommitSite]] = None,
                        locations: Optional[
                            Dict[str, Tuple[str, int]]] = None
                        ) -> Tuple[List[dict], List[Finding]]:
    """Kill-injection audit of every registered commit site: per site,
    run the publish uncrashed (the reference artifact), then twice in a
    subprocess hard-killed at *before-rename* and *after-rename*, then
    recover (re-run the publish + the startup stale-tmp sweep) and
    assert the recovered artifact is byte-identical to the reference
    with no stranded tmp. Returns (rows, findings) — one row per site,
    one ``proto-commit-point`` finding per failed site. Driver/child
    infrastructure failures raise :class:`ProtoAuditError`.

    Each child is a fresh interpreter that imports its site's modules
    (torch among them), a few seconds each, so the children of every
    site and stage run at once, as many at a time as the host has cores
    (at most 8: the children wait on their imports, not on each other);
    the clean runs, the recoveries and the verdicts stay in order in
    this process."""
    sites = list(sites) if sites is not None else list(COMMIT_SITES)
    locations = locations or {}
    rows: List[dict] = []
    findings: List[Finding] = []
    base = tempfile.mkdtemp(prefix="avenir_proto_")
    stages = (BEFORE_RENAME, AFTER_RENAME)

    def site_dir(site: CommitSite) -> str:
        return os.path.join(base, site.name.replace(".", "_"))

    def crash(job: Tuple[CommitSite, str]) -> subprocess.CompletedProcess:
        site, stage = job
        crash_root = os.path.join(site_dir(site), stage)
        os.makedirs(crash_root, exist_ok=True)
        return _spawn_crash_child(site, crash_root, stage)

    try:
        jobs = [(site, stage) for site in sites for stage in stages]
        with ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1)) as pool:
            children = dict(zip([(s.name, st) for s, st in jobs],
                                pool.map(crash, jobs)))
        for site in sites:
            loc = locations.get(site.name)
            clean_root = os.path.join(site_dir(site), "clean")
            os.makedirs(clean_root, exist_ok=True)
            try:
                site.run(clean_root)
            except Exception as e:
                raise ProtoAuditError(
                    f"commit site {site.name}: clean driver failed: "
                    f"{type(e).__name__}: {e}") from e
            want = _snapshot(clean_root)
            if not want:
                raise ProtoAuditError(
                    f"commit site {site.name}: clean driver published "
                    f"no artifact — nothing to validate")
            problems: List[str] = []
            stage_rows: List[dict] = []
            for stage in stages:
                crash_root = os.path.join(site_dir(site), stage)
                proc = children[(site.name, stage)]
                crashed = proc.returncode == CRASH_EXIT
                if not crashed and proc.returncode != 0:
                    raise ProtoAuditError(
                        f"commit site {site.name} [{stage}]: crash "
                        f"child failed rc={proc.returncode}: "
                        f"{(proc.stderr or '').strip()[-400:]}")
                # recovery = what the next writer does: re-run the
                # publish, then the startup sweep (age-forced — the
                # audit plays the 'later' startup)
                try:
                    site.run(crash_root)
                    recovered = True
                except Exception as e:  # noqa: BLE001 — verdict, not crash
                    recovered = False
                    problems.append(
                        f"{stage}: recovery raised "
                        f"{type(e).__name__}: {e}")
                sweep_stale_tmps(crash_root, min_age_s=0.0)
                got = _snapshot(crash_root)
                identical = got == want
                leftovers = _tmp_leftovers(crash_root)
                stage_rows.append({"stage": stage, "crashed": crashed,
                                   "recovered": recovered,
                                   "byte_identical": identical,
                                   "tmp_clean": not leftovers})
                if not crashed:
                    problems.append(
                        f"{stage}: crash hook never reached (the "
                        f"publish does not pass this site to "
                        f"crash_point)")
                if not identical:
                    drift = sorted(set(want) ^ set(got)) or \
                        sorted(k for k in want
                               if got.get(k) != want[k])
                    problems.append(
                        f"{stage}: recovered artifact differs from the "
                        f"uncrashed run (drifting: {drift[:4]})")
                if leftovers:
                    problems.append(
                        f"{stage}: stranded tmp files survive recovery "
                        f"+ sweep: {leftovers[:4]}")
            validated = not problems
            rows.append({"site": site.name,
                         "path": loc[0] if loc else site.path,
                         "line": loc[1] if loc else 1,
                         "stages": stage_rows,
                         "commit_point_validated": validated})
            if not validated:
                findings.append(Finding(
                    loc[0] if loc else site.path,
                    loc[1] if loc else 1,
                    PROTO_AUDIT_RULE,
                    f"commit site `{site.name}` failed crash-point "
                    f"validation: {'; '.join(problems)}",
                    "publish through core.atomic (unique sibling tmp, "
                    "atomic rename, tmp cleaned on every path) and "
                    "keep the recovery re-run idempotent; never "
                    "allowlist a commit-point failure",
                    site.name))
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return rows, findings


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------
def run_proto(paths: Optional[Sequence[str]] = None,
              rules: Optional[Sequence[ProtoRule]] = None,
              baseline: Optional[Sequence[BaselineEntry]] = None,
              root: Optional[str] = None, include_md: bool = True,
              audit: bool = True,
              sites: Optional[Sequence[CommitSite]] = None,
              device: str = "cuda") -> Report:
    """Lint `paths` (default: the protocol surface) with the proto
    rules, run the commit-point crash auditor over the registered
    sites (default: COMMIT_SITES, after the registry cross-check), and
    apply the allowlist baseline to the rule findings — audit findings
    are never baselined away."""
    active = list(rules) if rules is not None else \
        [r() for r in ALL_PROTO_RULES]
    root = os.path.abspath(root or os.getcwd())
    scan = list(paths) if paths else default_proto_paths(root)
    report, raw = collect_findings(scan, active, root, include_md)
    if audit:
        _open_device(device, ProtoAuditError)
        locations: Dict[str, Tuple[str, int]] = {}
        if sites is None:
            # default registry: prove code annotations and registry
            # agree before trusting either, and source row locations
            # from the real annotation lines
            locations = check_site_registry()
        rows, audit_findings = audit_commit_points(
            sites=sites, locations=locations)
        # audit drivers are NOT added to report.scanned — the audit
        # drives the publish functions, it does not lint their files
        report.proto_audit.extend(rows)
        raw.extend(audit_findings)
    active_ids = {r.rule_id for r in active}
    if audit:
        active_ids.add(PROTO_AUDIT_RULE)
    apply_baseline(report, raw, baseline, active_ids)
    return report
