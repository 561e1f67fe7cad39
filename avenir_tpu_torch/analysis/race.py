"""The interleaving tier: ``python -m avenir_tpu_torch.analysis --race``.

The port's copy of `avenir_tpu/analysis/race.py`. The proto tier proves
that each commit point survives one actor being killed; this tier
proves that the shared-file protocols survive each other.

**Static rules** (AST) over the multi-writer surface (``dist/``,
``net/``, ``server/``, ``native/sidecar.py``, ``core/incremental.py``,
``tune/store.py``):

- ``race-check-then-act``: an ``os.path.exists``/``isdir`` gate followed
  by a mutation of the same shared path with no atomic claim between;
- ``race-rmw-shared-record``: a scope that reads and republishes one
  shared record with no ``os.link`` CAS and no declared ownership
  (``single-writer`` / ``last-write-wins`` in the docstring);
- ``race-stale-listdir-snapshot``: acting on each entry of an
  ``os.listdir`` snapshot with no guard for the entry vanishing;
- ``race-delete-while-checked-out``: a class that keeps a checkout,
  refcount or pin yet deletes files in a method that never reads it;
- ``race-monotonic-persisted``: a ``time.monotonic()`` or
  ``perf_counter()`` stamp written into a persisted cross-process
  record (durations are fine).

**The interleaving explorer** (:func:`audit_interleavings`): every
schedule-sensitive step calls ``sched_point(name)`` (`core/atomic.py`),
and :data:`INTERLEAVE_SITES` names two actors a site. Two resident actor
processes (fresh interpreters: ``subprocess.Popen``, nothing run
between fork and exec, so the coordinator may hold a CUDA context) are
stepped by a file turnstile that grants a step only when every
unfinished actor is parked, so the choices follow the program, not the
host's timing, and every schedule is a replayable trace. Schedules run
exhaustively over the first ``depth`` two-way choices, then ``seeds``
seeded-random ones; each must leave no actor crashed, the site's
invariants holding (``site.verify``: one winner, no double fold,
conservation), no stranded tmp, and the declared artifacts equal to a
solo run's. A failing schedule is a ``race-interleaving`` finding with
its ``--schedule <site>:<steps>`` trace, never allowlisted.
:func:`check_sched_registry` fails loudly when ``sched_point`` calls in
code and the registry disagree. The actors are host code: no kernel
runs, so the tier takes no device.
"""

from __future__ import annotations

import ast
import itertools
import json
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Set, Tuple)

from avenir_tpu_torch.analysis.engine import (BaselineEntry, Finding,
                                              ModuleContext, Report,
                                              apply_baseline, collect_findings)
from avenir_tpu_torch.analysis.proto import (_calls, _functions,
                                             _open_device,
                                             _has_unique_marker, _pkg_root,
                                             _resolve_map, _soup,
                                             _terminal_name, _tmp_leftovers,
                                             _tmp_like, _write_open_path)
from avenir_tpu_torch.core.atomic import SCHED_ENV

#: the audit pseudo-rule: interleaving-schedule verdicts surface under
#: this id and are NEVER allowlisted (the runner applies them AFTER the
#: baseline pass, so no allowlist entry can suppress one)
RACE_AUDIT_RULE = "race-interleaving"

#: test seam: a module name the resident actor children import before
#: serving jobs — its import side effect may register extra (fixture)
#: sites into INTERLEAVE_SITES, so tests can drive deliberately-racy
#: protocols through the real scheduler. Production never sets it.
SITE_MODULE_ENV = "AVENIR_RACE_SITE_MODULE"


class RaceAuditError(RuntimeError):
    """The interleaving explorer could not run (actor pool death,
    scheduler stall, registry mismatch, missing native machinery) — an
    environment/registry error, never a lint finding."""


def default_race_paths(root: str) -> List[str]:
    """The multi-writer protocol surface this tier lints."""
    names = [os.path.join("avenir_tpu_torch", "dist"),
             os.path.join("avenir_tpu_torch", "net"),
             os.path.join("avenir_tpu_torch", "server"),
             os.path.join("avenir_tpu_torch", "native", "sidecar.py"),
             os.path.join("avenir_tpu_torch", "core", "incremental.py"),
             os.path.join("avenir_tpu_torch", "tune", "store.py")]
    return [p for p in (os.path.join(root, n) for n in names)
            if os.path.exists(p)]


# --------------------------------------------------------------------------
# shared AST helpers
# --------------------------------------------------------------------------
_CHECK_GATES = {"os.path.exists", "os.path.isfile", "os.path.isdir",
                "os.path.lexists"}
_MUTATE_CALLS = {"os.replace", "os.rename", "os.remove", "os.unlink",
                 "os.rmdir", "shutil.rmtree"}
_OS_GUARDS = {"OSError", "IOError", "FileNotFoundError",
              "FileExistsError", "PermissionError", "Exception",
              "BaseException"}
#: docstring evidence that concurrent writers were DESIGNED away
_OWNERSHIP_MARKERS = ("single-writer", "single writer",
                      "last-write-wins", "last write wins",
                      "one writer", "sole writer", "first-commit-wins")
#: attribute-name evidence of a checkout/refcount/pin guard
_GUARD_ATTR_MARKERS = ("refcount", "ref_count", "pin", "inuse",
                       "in_use", "checked_out", "holders")
_MONO_CALLS = {"time.monotonic", "time.perf_counter", "monotonic",
               "perf_counter"}
_PERSIST_TERMINALS = ("publish_json", "publish_bytes",
                      "write_json_atomic", "_write_atomic")
#: naming noise dropped before two path soups are compared for overlap
_STOP_TOKENS = {"os", "path", "join", "self", "dir", "dirs", "name",
                "names", "base", "root", "file", "f", "p", "n", "fh",
                "str", "s", "abspath", "dirname", "basename"}


def _soup_tokens(soup: str) -> Set[str]:
    out: Set[str] = set()
    for part in soup.split():
        for tok in re.split(r"[^a-z0-9]+", part):
            if len(tok) >= 2 and tok not in _STOP_TOKENS:
                out.add(tok)
    return out


def _overlap(soup_a: str, soup_b: str) -> bool:
    return bool(_soup_tokens(soup_a) & _soup_tokens(soup_b))


def _handler_catches(ctx: ModuleContext, handler: ast.ExceptHandler,
                     names: Set[str]) -> bool:
    if handler.type is None:
        return True                 # bare except catches everything
    types = handler.type.elts if isinstance(handler.type, ast.Tuple) \
        else [handler.type]
    for t in types:
        dotted = ctx.dotted(t) or ""
        if dotted.rsplit(".", 1)[-1] in names:
            return True
    return False


def _guarded(ctx: ModuleContext, node: ast.AST,
             stop: Optional[ast.AST] = None,
             names: Set[str] = _OS_GUARDS) -> bool:
    """True when `node` sits inside a Try (below `stop`) whose handlers
    catch one of `names` — the EAFP idiom that makes a losing racer
    recover instead of crash."""
    cur = ctx.parent(node)
    while cur is not None and cur is not stop:
        if isinstance(cur, ast.Try):
            if any(_handler_catches(ctx, h, names)
                   for h in cur.handlers):
                return True
        cur = ctx.parent(cur)
    return False


def _gate_paths(ctx: ModuleContext, test: ast.AST) -> List[ast.AST]:
    """The path expressions checked by os.path.exists/isfile/isdir
    calls inside one If/While test."""
    out = []
    for call in _calls(test):
        if (ctx.dotted(call.func) or "") in _CHECK_GATES and call.args:
            out.append(call.args[0])
    return out


def _read_open_path(ctx: ModuleContext, call: ast.Call
                    ) -> Optional[ast.AST]:
    """The path expression of a read-mode ``open`` call (no mode, or a
    literal "r"/"rb"), or None."""
    if ctx.dotted(call.func) not in ("open", "io.open") or not call.args:
        return None
    mode = call.args[1] if len(call.args) >= 2 else None
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return call.args[0]
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str) \
            and mode.value in ("r", "rb", "rt"):
        return call.args[0]
    return None


def _docstring_of(node: ast.AST) -> str:
    try:
        return (ast.get_docstring(node) or "").lower()
    except TypeError:
        return ""


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------
class RaceRule:
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


class CheckThenActRule(RaceRule):
    """An ``os.path.exists``-family gate followed, in the gated suite,
    by a mutation of an overlapping shared path with no atomic claim
    between: any concurrent actor can invalidate the checked fact
    before the act lands — the textbook TOCTOU. The sanctioned shapes
    are EAFP (do the act, catch OSError/FileExistsError) and the
    link-CAS claim (``os.link`` + EEXIST), both exempted."""

    rule_id = "race-check-then-act"
    description = "exists/isdir gate then unclaimed mutation (TOCTOU)"
    hint = ("act first and catch OSError/FileExistsError (EAFP), or "
            "take an atomic claim between check and act (os.link CAS, "
            "rename-aside) — a checked fact is stale the instant a "
            "concurrent writer exists")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in _functions(ctx):
            has_link_cas = any(
                (ctx.dotted(c.func) or "") == "os.link"
                for c in _calls(fn))
            if has_link_cas:
                continue            # the link-CAS discipline governs
            resolve = _resolve_map(ctx, fn)
            for node in ast.walk(fn):
                if not isinstance(node, (ast.If, ast.While)):
                    continue
                gates = _gate_paths(ctx, node.test)
                if not gates:
                    continue
                gate_soup = " ".join(
                    _soup(ctx, g, resolve) for g in gates)
                if _tmp_like(gate_soup):
                    continue        # tmp files are writer-private
                for call in _calls(node):
                    if call in list(_calls(node.test)):
                        continue
                    dotted = ctx.dotted(call.func) or ""
                    if dotted in _MUTATE_CALLS:
                        acted = call.args
                    else:
                        wp = _write_open_path(ctx, call)
                        acted = [wp] if wp is not None else []
                    if not acted:
                        continue
                    act_soup = " ".join(
                        _soup(ctx, a, resolve) for a in acted)
                    if _tmp_like(act_soup) \
                            or not _overlap(gate_soup, act_soup):
                        continue
                    if _guarded(ctx, call, stop=fn):
                        continue    # EAFP recovery present
                    yield self.finding(
                        ctx, call,
                        f"`{ctx.scope_of(call)}` mutates a shared path "
                        f"behind an exists/isdir gate with no atomic "
                        f"claim between: a concurrent actor can "
                        f"invalidate the check before the act lands")
                    break           # one finding per gate


class RmwSharedRecordRule(RaceRule):
    """A scope (class, or the module's free functions) that both READS
    a shared record and atomically REPUBLISHES an overlapping path,
    with no ``os.link`` CAS and no declared ownership: two concurrent
    read-modify-write passes interleave as read/read/write/write and
    one writer's update silently vanishes. Scopes whose docstring
    declares the design (``single-writer``, ``last-write-wins``,
    ``first-commit-wins``) are exempt — the marker is the reviewable
    claim this rule forces into the code."""

    rule_id = "race-rmw-shared-record"
    description = "read-modify-write of a shared record without CAS " \
                  "or declared ownership"
    hint = ("serialize writers through an os.link CAS / rename-aside "
            "claim, or declare the design in the writer's / class's / "
            "module's docstring ('single-writer: ...' / "
            "'last-write-wins: ...') so the lost-update window is a "
            "reviewed decision")

    def _scopes(self, ctx: ModuleContext
                ) -> Iterator[Tuple[ast.AST, List[ast.AST]]]:
        classes = [n for n in ast.walk(ctx.tree)
                   if isinstance(n, ast.ClassDef)]
        for cls in classes:
            yield cls, [cls]
        in_class = {id(sub) for cls in classes
                    for sub in ast.walk(cls)}
        free = [n for n in ctx.tree.body
                if id(n) not in in_class]
        yield ctx.tree, free

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        module_doc = _docstring_of(ctx.tree)
        for scope, bodies in self._scopes(ctx):
            doc = _docstring_of(scope) if scope is not ctx.tree \
                else module_doc
            if any(m in doc or m in module_doc
                   for m in _OWNERSHIP_MARKERS):
                continue
            calls = [c for b in bodies for c in _calls(b)]
            if any((ctx.dotted(c.func) or "") == "os.link"
                   for c in calls):
                continue
            reads: List[str] = []
            for fn in (n for b in bodies for n in ast.walk(b)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))):
                resolve = _resolve_map(ctx, fn)
                for call in _calls(fn):
                    rp = _read_open_path(ctx, call)
                    if rp is None \
                            and (ctx.dotted(call.func) or "") \
                            in ("np.load", "numpy.load") and call.args:
                        rp = call.args[0]
                    if rp is not None:
                        reads.append(_soup(ctx, rp, resolve))
            if not reads:
                continue
            read_soup = " ".join(reads)
            for fn in (n for b in bodies for n in ast.walk(b)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))):
                if any(m in _docstring_of(fn)
                       for m in _OWNERSHIP_MARKERS):
                    continue        # ownership declared at the writer
                resolve = _resolve_map(ctx, fn)
                for call in _calls(fn):
                    term = _terminal_name(ctx, call)
                    dotted = ctx.dotted(call.func) or ""
                    if term not in _PERSIST_TERMINALS \
                            and dotted != "os.replace":
                        continue
                    pub_soup = " ".join(
                        _soup(ctx, a, resolve) for a in call.args)
                    if not _overlap(read_soup, pub_soup):
                        continue
                    if dotted == "os.replace" \
                            and _has_unique_marker(pub_soup):
                        continue    # rename-to-unique IS a claim CAS
                    yield self.finding(
                        ctx, call,
                        f"`{ctx.scope_of(call)}` republishes a shared "
                        f"record its scope also reads, with no link-"
                        f"CAS and no declared ownership: concurrent "
                        f"read-modify-write passes lose updates")
                    break
                else:
                    continue
                break               # one finding per scope


class StaleListdirSnapshotRule(RaceRule):
    """A loop over an ``os.listdir`` snapshot that acts on each entry
    (open, stat, remove, rename, parse) without surviving the entry
    vanishing: every directory listing is stale the moment it returns
    — claimers, sweepers and evictors delete entries concurrently, so
    per-entry acts must re-verify via the OSError they get back."""

    rule_id = "race-stale-listdir-snapshot"
    description = "listdir snapshot iterated without per-entry " \
                  "vanish guard"
    hint = ("wrap the per-entry act in try/except OSError and treat "
            "a vanished entry as claimed-by-someone-else (the spool/"
            "sweep idiom), or re-verify with a parse that returns "
            "None on torn/absent")

    _ACTS = {"os.stat", "os.remove", "os.unlink", "os.replace",
             "os.rename", "os.utime", "json.load", "open", "io.open"}

    def _listdir_iter(self, ctx: ModuleContext, fn: ast.AST,
                      node: ast.For) -> bool:
        def is_listdir(expr: ast.AST) -> bool:
            for call in _calls(expr):
                if (ctx.dotted(call.func) or "") == "os.listdir":
                    return True
            return False

        if is_listdir(node.iter):
            return True
        if isinstance(node.iter, ast.Name):
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Assign) \
                        and any(isinstance(t, ast.Name)
                                and t.id == node.iter.id
                                for t in sub.targets) \
                        and is_listdir(sub.value):
                    return True
        return False

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in _functions(ctx):
            for node in ast.walk(fn):
                if not isinstance(node, ast.For):
                    continue
                if not self._listdir_iter(ctx, fn, node):
                    continue
                targets = {t.id for t in ast.walk(node.target)
                           if isinstance(t, ast.Name)}
                for call in _calls(node):
                    if (ctx.dotted(call.func) or "") not in self._ACTS:
                        continue
                    uses_entry = any(
                        isinstance(sub, ast.Name) and sub.id in targets
                        for a in call.args for sub in ast.walk(a))
                    if not uses_entry:
                        continue
                    if _guarded(ctx, call, stop=node):
                        continue
                    yield self.finding(
                        ctx, call,
                        f"`{ctx.scope_of(call)}` acts on a listdir "
                        f"entry without surviving it vanishing: the "
                        f"snapshot is stale the moment it returns")
                    break


class DeleteWhileCheckedOutRule(RaceRule):
    """A class that tracks checkouts/refcounts/pins yet deletes state
    in a method that never consults the guard: the eviction can pull a
    directory or file out from under a live holder. An attribute only
    COUNTS as a deletion guard when some method in the class both
    consults it and deletes (the eviction idiom — WarmStore's budget
    sweep skipping ``_dir_inuse`` victims); a checkout-ish name the
    class never uses to gate a delete (CPU ``pin_cores`` affinity) is
    not one. Once the class demonstrates the guard discipline, every
    OTHER deleting method must follow it."""

    rule_id = "race-delete-while-checked-out"
    description = "delete path ignores the class's checkout/refcount " \
                  "guard"
    hint = ("consult the checkout/refcount/pin state before deleting "
            "(skip in-use victims, like WarmStore's budget sweep), or "
            "make the consumer survive mid-use deletion and document "
            "it at the delete site")

    _DELETES = {"shutil.rmtree", "os.remove", "os.unlink", "os.rmdir"}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for cls in (n for n in ast.walk(ctx.tree)
                    if isinstance(n, ast.ClassDef)):
            guards: Set[str] = set()
            for sub in ast.walk(cls):
                if isinstance(sub, ast.Attribute) \
                        and isinstance(sub.value, ast.Name) \
                        and sub.value.id == "self" \
                        and any(m in sub.attr.lower()
                                for m in _GUARD_ATTR_MARKERS):
                    guards.add(sub.attr)
            if not guards:
                continue

            def consults_guard(fn: ast.AST) -> bool:
                return any(
                    isinstance(sub, ast.Attribute) and sub.attr in guards
                    for sub in ast.walk(fn)) or any(
                    isinstance(sub, ast.Name) and sub.id in guards
                    for sub in ast.walk(fn))

            def deletes(fn: ast.AST) -> bool:
                return any((ctx.dotted(c.func) or "") in self._DELETES
                           for c in _calls(fn))

            methods = [n for n in ast.walk(cls)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
            # the guard discipline must be DEMONSTRATED: some method
            # gates a delete on the guard, or the name is a coincidence
            if not any(consults_guard(fn) and deletes(fn)
                       for fn in methods):
                continue
            for fn in methods:
                if consults_guard(fn):
                    continue
                for call in _calls(fn):
                    if (ctx.dotted(call.func) or "") in self._DELETES:
                        yield self.finding(
                            ctx, call,
                            f"`{ctx.scope_of(call)}` deletes state in "
                            f"a class that tracks checkouts "
                            f"({sorted(guards)}) without consulting "
                            f"the guard: a live holder loses its "
                            f"files mid-use")
                        break


class MonotonicPersistedRule(RaceRule):
    """A bare ``time.monotonic()`` / ``perf_counter()`` stamp flowing
    into a persisted cross-process record: monotonic clocks have a
    process-local epoch, so the persisted value is meaningless in any
    other process — the inverse of proto's wall-clock-deadline rule
    (wall time belongs in records, monotonic in in-process deadline
    math). Differences (durations) are legitimate and not flagged."""

    rule_id = "race-monotonic-persisted"
    description = "bare monotonic stamp persisted to a cross-process " \
                  "record"
    hint = ("persist time.time() (wall) in cross-process records and "
            "keep time.monotonic() for in-process durations/deadlines "
            "— a monotonic stamp read by another process compares "
            "epochs that have nothing to do with each other")

    _SINKS = ("dump", "dumps") + _PERSIST_TERMINALS

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in _functions(ctx):
            tainted: Set[str] = set()
            dicts: Dict[str, ast.Dict] = {}
            for sub in ast.walk(fn):
                if not isinstance(sub, ast.Assign):
                    continue
                names = [t.id for t in sub.targets
                         if isinstance(t, ast.Name)]
                if isinstance(sub.value, ast.Call) \
                        and (ctx.dotted(sub.value.func) or "") \
                        in _MONO_CALLS:
                    tainted.update(names)
                elif isinstance(sub.value, ast.Dict):
                    for nm in names:
                        dicts[nm] = sub.value

            def stamped(expr: ast.AST) -> bool:
                # a BARE stamp: the tainted name or call itself, or a
                # dict literal carrying one as a value — NOT inside
                # arithmetic (a difference is a duration, fine)
                if isinstance(expr, ast.Name):
                    if expr.id in tainted:
                        return True
                    inner = dicts.get(expr.id)
                    return inner is not None and stamped(inner)
                if isinstance(expr, ast.Call):
                    return (ctx.dotted(expr.func) or "") in _MONO_CALLS
                if isinstance(expr, ast.Dict):
                    return any(stamped(v) for v in expr.values
                               if v is not None)
                return False

            for call in _calls(fn):
                if _terminal_name(ctx, call) not in self._SINKS:
                    continue
                if any(stamped(a) for a in call.args) \
                        or any(stamped(kw.value)
                               for kw in call.keywords):
                    yield self.finding(
                        ctx, call,
                        f"`{ctx.scope_of(call)}` persists a bare "
                        f"monotonic stamp into a cross-process "
                        f"record: the epoch is process-local, so "
                        f"every other process reads garbage")


ALL_RACE_RULES = [CheckThenActRule, RmwSharedRecordRule,
                  StaleListdirSnapshotRule, DeleteWhileCheckedOutRule,
                  MonotonicPersistedRule]


def race_rule_ids() -> List[str]:
    return [r.rule_id for r in ALL_RACE_RULES] + [RACE_AUDIT_RULE]


# --------------------------------------------------------------------------
# interleave sites: seed / two actors / invariants
# --------------------------------------------------------------------------
@dataclass
class InterleaveSite:
    """One registered two-actor protocol seam. ``seed`` prepares a
    fresh root; ``actors`` are the two racing drivers (JSON-serializable
    returns — they run in resident subprocesses); ``verify`` checks the
    site's invariants given the final root, both actors' values and the
    solo run's values; ``artifacts`` are root-relative files that must
    be byte-identical (canonicalized) to the solo run under EVERY
    schedule; ``sched`` names the sched_point hooks this seam steps
    (the registry half of the cross-check)."""

    name: str
    path: str
    sched: Tuple[str, ...]
    seed: Callable[[str], None]
    actors: Tuple[Callable[[str], dict], Callable[[str], dict]]
    verify: Callable[[str, dict, dict, dict, dict], List[str]]
    artifacts: Tuple[str, ...] = ()


# ---------------------------------------------------------- ledger.claim
def _seed_ledger(root: str) -> None:
    from avenir_tpu_torch.dist.ledger import BlockLedger
    BlockLedger(root)


def _actor_claim_0(root: str) -> dict:
    from avenir_tpu_torch.dist.ledger import BlockLedger
    return {"won": bool(BlockLedger(root).claim(7, worker=0))}


def _actor_claim_1(root: str) -> dict:
    from avenir_tpu_torch.dist.ledger import BlockLedger
    return {"won": bool(BlockLedger(root).claim(7, worker=1))}


def _verify_ledger_claim(root, a, b, solo_a, solo_b) -> List[str]:
    from avenir_tpu_torch.dist.ledger import BlockLedger
    problems = []
    wins = int(bool(a["won"])) + int(bool(b["won"]))
    if wins != 1:
        problems.append(f"{wins} claim winners (exactly-one expected)")
    info = BlockLedger(root).claim_info(7)
    if info is None:
        problems.append("no well-formed claim on disk after the race")
    elif wins == 1 and info["worker"] != (0 if a["won"] else 1):
        problems.append(
            f"claim file names worker {info['worker']} but the "
            f"winner was {0 if a['won'] else 1}")
    return problems


# --------------------------------------------------------- ledger.commit
_COMMIT_BLOB = b"level-9-fold-state"


def _actor_commit_0(root: str) -> dict:
    from avenir_tpu_torch.dist.ledger import BlockLedger
    return {"won": bool(BlockLedger(root).commit(9, 0, _COMMIT_BLOB))}


def _actor_commit_1(root: str) -> dict:
    from avenir_tpu_torch.dist.ledger import BlockLedger
    return {"won": bool(BlockLedger(root).commit(9, 1, _COMMIT_BLOB))}


def _verify_ledger_commit(root, a, b, solo_a, solo_b) -> List[str]:
    from avenir_tpu_torch.dist.ledger import BlockLedger
    problems = []
    wins = int(bool(a["won"])) + int(bool(b["won"]))
    if wins != 1:
        problems.append(f"{wins} commit winners — a double-fold "
                        f"(exactly-one expected: folds are "
                        f"non-idempotent)")
    led = BlockLedger(root)
    if led.committed() != [9]:
        problems.append(f"committed set {led.committed()} != [9]")
    elif led.load_state(9) != _COMMIT_BLOB:
        problems.append("committed state bytes differ from the blob")
    dups = sorted(os.listdir(os.path.join(root, "ledger", "dups")))
    if wins == 1:
        loser = 1 if a["won"] else 0
        if dups != [f"b9.w{loser}.json"]:
            problems.append(
                f"dup markers {dups} != exactly the loser's "
                f"(worker {loser})")
    return problems


# ----------------------------------------------------------- lease.sweep
def _seed_lease(root: str) -> None:
    from avenir_tpu_torch.net.fault import Lease, LeaseStore
    LeaseStore(root).write(
        Lease(name="r1.json", host=0, claimed_at=1000.0, ttl_s=5.0))


def _actor_lease_owner(root: str) -> dict:
    import time as _t
    from avenir_tpu_torch.net.fault import Lease, LeaseStore
    store = LeaseStore(root)
    lease = Lease(name="r1.json", host=0, claimed_at=1000.0, ttl_s=5.0)
    for _ in range(2):
        store.renew(lease, _t.time())
    store.remove("r1.json")
    return {"renewed": 2}


def _actor_lease_sweeper(root: str) -> dict:
    import time as _t
    from avenir_tpu_torch.net.fault import LeaseStore
    store = LeaseStore(root)
    now = _t.time()
    lease = store.load("r1.json")
    if lease is None or not lease.expired(now):
        return {"requeued": False, "taken_at": None}
    taken = store.take("r1.json")
    if taken is None:
        return {"requeued": False, "taken_at": None}
    if not taken.expired(now):
        store.write(taken)          # renewed under us: CAS lost
        return {"requeued": False, "taken_at": taken.claimed_at}
    return {"requeued": True, "taken_at": taken.claimed_at}


def _verify_lease_sweep(root, a, b, solo_a, solo_b) -> List[str]:
    from avenir_tpu_torch.net.fault import LeaseStore
    problems = []
    if b["requeued"] and b["taken_at"] != 1000.0:
        problems.append(
            f"sweeper requeued a RENEWED lease (claimed_at "
            f"{b['taken_at']}, seeded 1000.0): the owner's renew was "
            f"destroyed — a double-placement")
    store = LeaseStore(root)
    for n in store.names():
        if store.load(n) is None:
            problems.append(f"torn lease file {n} after the race")
    return problems


# ----------------------------------------------------------- spool.claim
def _seed_spool(root: str) -> None:
    from avenir_tpu_torch.core.atomic import publish_json
    from avenir_tpu_torch.server.spool import spool_dirs
    in_dir, _work, _out = spool_dirs(root)
    publish_json({"job": "probe"}, os.path.join(in_dir, "q1.json"))


def _actor_spool_claim(root: str) -> dict:
    from avenir_tpu_torch.server.spool import _claim, spool_dirs
    in_dir, work_dir, _out = spool_dirs(root)
    out = []
    for name, wp in _claim(in_dir, work_dir):
        with open(wp) as fh:
            out.append([name, fh.read()])
    return {"claimed": out}


def _verify_spool_claim(root, a, b, solo_a, solo_b) -> List[str]:
    problems = []
    total = a["claimed"] + b["claimed"]
    if len(total) != 1:
        problems.append(
            f"request claimed {len(total)} times (exactly-one-winner)")
    elif total[0][0] != "q1.json" \
            or json.loads(total[0][1]) != {"job": "probe"}:
        problems.append("claimed request name/content mangled")
    leftover = [n for n in os.listdir(os.path.join(root, "in"))
                if n.endswith(".json")]
    if leftover:
        problems.append(f"request still spooled after claim: "
                        f"{leftover}")
    work = os.listdir(os.path.join(root, "work"))
    if len(work) != 1:
        problems.append(f"work dir holds {len(work)} claims "
                        f"(conservation: exactly 1)")
    return problems


# ------------------------------------------------------------ warm.evict
def _warm_opts(root: str) -> dict:
    return {"dir": os.path.join(root, "cache"), "budget": 1 << 30}


def _warm_corpus(root: str) -> str:
    return os.path.join(root, "corpus.csv")


_WARM_BLOCK = 64


def _seed_warm(root: str) -> None:
    path = _warm_corpus(root)
    with open(path, "w") as fh:
        for i in range(24):
            fh.write(f"k{i:02d},v{i:02d}\n")
    from avenir_tpu_torch.native.sidecar import byte_blocks
    feed = byte_blocks(_warm_opts(root), path, ",", 0, _WARM_BLOCK)
    if feed is None:
        raise RaceAuditError(
            "sidecar machinery unavailable (native ingest missing): "
            "the warm.evict / sidecar.manifest interleave sites "
            "cannot run")
    list(feed)                      # pack the sidecar warm


def _actor_warm_reader(root: str) -> dict:
    from avenir_tpu_torch.native.sidecar import byte_blocks
    feed = byte_blocks(_warm_opts(root), _warm_corpus(root), ",", 0,
                       _WARM_BLOCK)
    if feed is None:
        raise RuntimeError("sidecar feed refused to engage")
    return {"blocks": [[off, ln, h] for off, ln, h, _p in feed]}


def _actor_warm_evictor(root: str) -> dict:
    from avenir_tpu_torch.native.sidecar import SidecarHandle, bytes_dir
    dirpath = bytes_dir(_warm_opts(root), _warm_corpus(root), ",", 0,
                        _WARM_BLOCK)
    SidecarHandle(_warm_corpus(root), dirpath).close()
    return {"evicted": True}


def _verify_warm_evict(root, a, b, solo_a, solo_b) -> List[str]:
    problems = []
    if a["blocks"] != solo_a["blocks"]:
        problems.append(
            "scan coverage changed under eviction: the reader must "
            "yield the same (offset, length, hash) tiling cold as "
            "warm")
    return problems


# ------------------------------------------------------ sidecar.manifest
def _seed_sidecar_manifest(root: str) -> None:
    _seed_warm(root)                # 24 lines, packed warm
    path = _warm_corpus(root)
    prefix_end = os.path.getsize(path)
    with open(path, "a") as fh:
        for i in range(24, 40):
            fh.write(f"k{i:02d},v{i:02d}\n")
    with open(os.path.join(root, "prefix.json"), "w") as fh:
        json.dump({"prefix_end": prefix_end}, fh)


def _actor_sidecar_writer(root: str) -> dict:
    from avenir_tpu_torch.native.sidecar import byte_blocks
    feed = byte_blocks(_warm_opts(root), _warm_corpus(root), ",", 0,
                       _WARM_BLOCK)
    if feed is None:
        raise RuntimeError("sidecar feed refused to engage")
    return {"blocks": [[off, ln, h] for off, ln, h, _p in feed]}


def _actor_sidecar_replayer(root: str) -> dict:
    from avenir_tpu_torch.native.sidecar import byte_blocks
    with open(os.path.join(root, "prefix.json")) as fh:
        prefix_end = json.load(fh)["prefix_end"]
    feed = byte_blocks(_warm_opts(root), _warm_corpus(root), ",", 0,
                       _WARM_BLOCK, byte_range=(0, prefix_end),
                       write=False)
    if feed is None:
        return {"blocks": None}     # legal: replay-all-or-nothing
    return {"blocks": [[off, ln, h] for off, ln, h, _p in feed]}


def _verify_sidecar_manifest(root, a, b, solo_a, solo_b) -> List[str]:
    from avenir_tpu_torch.native.sidecar import _load_manifest, bytes_dir
    problems = []
    if a["blocks"] != solo_a["blocks"]:
        problems.append("writer's extend pass tiled differently from "
                        "the solo run")
    if b["blocks"] is not None and b["blocks"] != solo_b["blocks"]:
        problems.append("reader replayed a tiling the solo run never "
                        "saw")
    man = _load_manifest(bytes_dir(_warm_opts(root),
                                   _warm_corpus(root), ",", 0,
                                   _WARM_BLOCK))
    if man is None:
        problems.append("no readable manifest after the race")
    else:
        covered = sum(int(e["length"]) for e in man["blocks"])
        size = os.path.getsize(_warm_corpus(root))
        if covered != size:
            problems.append(
                f"manifest covers {covered} of {size} corpus bytes "
                f"(conservation: the extend must tile gap-free)")
    return problems


# ------------------------------------------------------- checkpoint.save
def _ckpt_dir(root: str) -> str:
    return os.path.join(root, "state")


def _seed_ckpt(root: str) -> None:
    from avenir_tpu_torch.core.incremental import CheckpointStore
    CheckpointStore(_ckpt_dir(root)).save({"seq": 1}, b"carry-one")


def _actor_ckpt_saver(root: str) -> dict:
    from avenir_tpu_torch.core.incremental import CheckpointStore
    meta = CheckpointStore(_ckpt_dir(root)).save({"seq": 2},
                                                 b"carry-two")
    return {"seq": int(meta["seq"])}


def _actor_ckpt_loader(root: str) -> dict:
    from avenir_tpu_torch.core.incremental import CheckpointStore
    store = CheckpointStore(_ckpt_dir(root))
    loads = []
    for _ in range(3):
        got = store.load()
        loads.append(None if got is None
                     else [int(got[0]["seq"]), got[1].decode()])
    return {"loads": loads}


def _verify_ckpt(root, a, b, solo_a, solo_b) -> List[str]:
    from avenir_tpu_torch.core.incremental import block_hash
    problems = []
    legal = {(1, "carry-one"), (2, "carry-two")}
    seqs = []
    for got in b["loads"]:
        if got is None:
            continue                # GC'd-carry cold fallback: legal
        if tuple(got) not in legal:
            problems.append(f"torn checkpoint load {got}: neither "
                            f"seeded nor saved pair")
        seqs.append(got[0])
    if seqs != sorted(seqs):
        problems.append(f"checkpoint loads went backwards: {seqs}")
    want = {"MANIFEST.json",
            f"carry_000002_{block_hash(b'carry-two')[:8]}.npz"}
    have = set(os.listdir(_ckpt_dir(root)))
    if have != want:
        problems.append(f"final state dir {sorted(have)} != "
                        f"{sorted(want)} (superseded carry must be "
                        f"GC'd, the live one kept)")
    return problems


# -------------------------------------------------------- cand.publish
_CAND_MAN = {"tag": "k2", "job": "probe", "mask": ["a", "b"],
             "cands": [["a", "b"]], "c_pad": 64}


def _seed_cand(root: str) -> None:
    os.makedirs(os.path.join(root, "candidates"), exist_ok=True)


def _actor_cand_publisher(root: str) -> dict:
    from avenir_tpu_torch.dist.driver import publish_candidates
    cand_dir = os.path.join(root, "candidates")
    publish_candidates(cand_dir, "k2", dict(_CAND_MAN))
    publish_candidates(cand_dir, "final", {"done": True, "rounds": 1})
    return {"published": ["k2", "final"]}


def _actor_cand_poller(root: str) -> dict:
    from avenir_tpu_torch.dist.worker import _Worker
    path = os.path.join(root, "candidates", "k2.json")
    polls = []
    for _ in range(4):
        man = _Worker._load_manifest(None, path)
        polls.append(None if man is None else sorted(man))
    return {"polls": polls}


def _verify_cand(root, a, b, solo_a, solo_b) -> List[str]:
    problems = []
    want_keys = sorted(_CAND_MAN)
    seen_published = False
    for got in b["polls"]:
        if got is None:
            if seen_published:
                problems.append(
                    "a published manifest vanished from a later poll")
            continue
        seen_published = True
        if got != want_keys:
            problems.append(f"worker polled a PARTIAL manifest "
                            f"{got} (atomic publish must be "
                            f"complete-or-absent)")
    return problems


INTERLEAVE_SITES: List[InterleaveSite] = [
    InterleaveSite(
        "ledger.claim", "avenir_tpu_torch/dist/ledger.py",
        ("ledger.claim",), _seed_ledger,
        (_actor_claim_0, _actor_claim_1), _verify_ledger_claim,
        ("ledger/claims/b7.json",)),
    InterleaveSite(
        "ledger.commit", "avenir_tpu_torch/dist/ledger.py",
        ("ledger.commit",), _seed_ledger,
        (_actor_commit_0, _actor_commit_1), _verify_ledger_commit,
        ("ledger/states/b9.npz",)),
    InterleaveSite(
        "lease.sweep", "avenir_tpu_torch/net/fault.py",
        ("lease.renew", "lease.sweep"), _seed_lease,
        (_actor_lease_owner, _actor_lease_sweeper), _verify_lease_sweep),
    InterleaveSite(
        "spool.claim", "avenir_tpu_torch/server/spool.py",
        ("spool.claim",), _seed_spool,
        (_actor_spool_claim, _actor_spool_claim), _verify_spool_claim),
    InterleaveSite(
        "warm.evict", "avenir_tpu_torch/native/sidecar.py",
        ("warm.evict", "sidecar.replay"), _seed_warm,
        (_actor_warm_reader, _actor_warm_evictor), _verify_warm_evict),
    InterleaveSite(
        "sidecar.manifest", "avenir_tpu_torch/native/sidecar.py",
        ("sidecar.manifest",), _seed_sidecar_manifest,
        (_actor_sidecar_writer, _actor_sidecar_replayer),
        _verify_sidecar_manifest),
    InterleaveSite(
        "checkpoint.save", "avenir_tpu_torch/core/incremental.py",
        ("checkpoint.save", "checkpoint.load"), _seed_ckpt,
        (_actor_ckpt_saver, _actor_ckpt_loader), _verify_ckpt),
    InterleaveSite(
        "cand.publish", "avenir_tpu_torch/dist/driver.py",
        ("cand.publish", "cand.poll"), _seed_cand,
        (_actor_cand_publisher, _actor_cand_poller), _verify_cand,
        ("candidates/k2.json", "candidates/final.json")),
]


def interleave_sites() -> List[InterleaveSite]:
    return list(INTERLEAVE_SITES)


def _drive_actor(name: str, idx: int, root: str) -> dict:
    """The resident actor child's per-round entry: run one side of one
    registered interleave site."""
    for site in INTERLEAVE_SITES:
        if site.name == name:
            return site.actors[idx](root)
    raise SystemExit(f"unknown interleave site {name!r}")


# --------------------------------------------------------------------------
# registry cross-check
# --------------------------------------------------------------------------
_SCHED_REF_RE = re.compile(r'sched_point\(\s*"([a-z_.]+)"')


def sched_annotations(root: Optional[str] = None
                      ) -> Dict[str, Tuple[str, int]]:
    """Every sched_point name annotated on the protocol surface,
    mapped to the (repo-relative path, line) of its first call site."""
    root = root or _pkg_root()
    refs: Dict[str, Tuple[str, int]] = {}
    files: List[str] = []
    for p in default_race_paths(root):
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
            for m in _SCHED_REF_RE.finditer(line):
                refs.setdefault(m.group(1), (rel, i))
    return refs


def check_sched_registry(root: Optional[str] = None
                         ) -> Dict[str, Tuple[str, int]]:
    """Fail loudly when the sched_point call sites and the registry's
    union of per-site hook names disagree: an annotated-but-
    unregistered hook parks an actor nobody steps (a guaranteed
    stall), a registered-but-unannotated hook means the registry
    describes a step that no longer exists. Returns the annotation
    locations (the audit rows' path/line source)."""
    refs = sched_annotations(root)
    names: Set[str] = set()
    for site in INTERLEAVE_SITES:
        names.update(site.sched)
    unregistered = sorted(set(refs) - names)
    unannotated = sorted(names - set(refs))
    problems = []
    if unregistered:
        problems.append(
            f"sched_point hooks in code but in no INTERLEAVE_SITES "
            f"entry (no schedule ever steps them): {unregistered}")
    if unannotated:
        problems.append(
            f"registered in INTERLEAVE_SITES but never annotated in "
            f"code (dangling registry entries): {unannotated}")
    if problems:
        raise RaceAuditError(
            "interleave-site registry mismatch: " + "; ".join(problems))
    return refs


# --------------------------------------------------------------------------
# the file-turnstile scheduler
# --------------------------------------------------------------------------
#: wall-clock and winner-identity fields two correct racing runs may
#: legitimately differ in — canonicalized away before byte comparison
_RACE_VOLATILE_KEYS = ("claimed_at", "rejected_at", "ts_unix", "worker",
                       "host")


def _race_canon(rel: str, data: bytes) -> bytes:
    if not rel.endswith(".json"):
        return data
    try:
        obj = json.loads(data.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return data                 # torn JSON: compare (and fail) raw
    if isinstance(obj, dict):
        for key in _RACE_VOLATILE_KEYS:
            obj.pop(key, None)
    return json.dumps(obj, sort_keys=True).encode("utf-8")


def _artifact_snapshot(root: str, rels: Sequence[str]
                       ) -> Dict[str, Optional[bytes]]:
    out: Dict[str, Optional[bytes]] = {}
    for rel in rels:
        path = os.path.join(root, rel)
        try:
            with open(path, "rb") as fh:
                out[rel] = _race_canon(rel, fh.read())
        except OSError:
            out[rel] = None
    return out


class _ActorPool:
    """Two RESIDENT actor subprocesses for the whole audit: each polls
    a job spool, runs its side of the named site with the turnstile
    armed, publishes its result, and waits for the next round —
    amortizing interpreter+import startup over hundreds of schedules."""

    def __init__(self, base: str):
        self.base = base
        self.jobs = os.path.join(base, "jobs")
        os.makedirs(self.jobs, exist_ok=True)
        env = dict(os.environ)
        env.pop(SCHED_ENV, None)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_pkg_root(), env.get("PYTHONPATH")) if p)
        self.procs = []
        self.logs = []
        for idx in (0, 1):
            log = open(os.path.join(base, f"actor{idx}.log"), "w")
            self.logs.append(log)
            code = ("from avenir_tpu_torch.analysis.race import _actor_main; "
                    f"_actor_main({idx}, {base!r})")
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=env,
                stdout=log, stderr=log))
        self.round_no = 0

    def dispatch(self, site_name: str, root: str,
                 turnstile: str) -> int:
        n = self.round_no
        self.round_no += 1
        for idx in (0, 1):
            job = os.path.join(self.jobs, f"j{n}.{idx}.json")
            wip = job + ".wip"
            with open(wip, "w") as fh:
                json.dump({"site": site_name, "root": root,
                           "turnstile": turnstile}, fh)
            os.replace(wip, job)
        return n

    def check_alive(self) -> None:
        for idx, proc in enumerate(self.procs):
            rc = proc.poll()
            if rc is not None:
                tail = ""
                try:
                    with open(os.path.join(self.base,
                                           f"actor{idx}.log")) as fh:
                        tail = fh.read().strip()[-400:]
                except OSError:
                    pass
                raise RaceAuditError(
                    f"actor child {idx} died rc={rc}: {tail}")

    def close(self) -> None:
        with open(os.path.join(self.base, "stop"), "w") as fh:
            fh.write("stop")
        for proc in self.procs:
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for log in self.logs:
            log.close()


def _actor_main(idx: int, base: str) -> None:
    """Resident actor child loop: job spool in, result file out."""
    extra = os.environ.get(SITE_MODULE_ENV, "")
    if extra:
        import importlib
        importlib.import_module(extra)
    jobs = os.path.join(base, "jobs")
    stop = os.path.join(base, "stop")
    n = 0
    idle_deadline = time.monotonic() + 600.0
    while True:
        job = os.path.join(jobs, f"j{n}.{idx}.json")
        spec = None
        try:
            with open(job) as fh:
                spec = json.load(fh)
        except (OSError, ValueError):
            spec = None
        if spec is None:
            if os.path.exists(stop) or time.monotonic() > idle_deadline:
                return
            time.sleep(0.001)
            continue
        idle_deadline = time.monotonic() + 600.0
        os.environ[SCHED_ENV] = f"{spec['turnstile']}:{idx}"
        out: dict = {"ok": True, "value": None}
        try:
            out["value"] = _drive_actor(spec["site"], idx, spec["root"])
        except BaseException as exc:  # noqa: BLE001 — verdict, not crash
            out = {"ok": False,
                   "error": f"{type(exc).__name__}: {exc}"}
        finally:
            os.environ.pop(SCHED_ENV, None)
        done = os.path.join(spec["turnstile"], f"done.{idx}")
        wip = done + ".wip"
        with open(wip, "w") as fh:
            json.dump(out, fh)
        os.replace(wip, done)
        n += 1


def _run_schedule(pool: _ActorPool, site: InterleaveSite,
                  decider: Callable[[int, List[int], List[int]], int],
                  round_dir: str, timeout_s: float = 90.0
                  ) -> Tuple[dict, dict, List[int], List[str]]:
    """Drive one schedule of one site: seed a fresh root, dispatch both
    resident actors, and grant turnstile steps per `decider` until both
    finish. Returns (result_a, result_b, trace, step names). The
    scheduler only decides once every unfinished actor is parked (or
    done), so the ready set — and therefore the trace — is a pure
    function of the decider and the actors' program structure."""
    root = os.path.join(round_dir, "root")
    os.makedirs(root, exist_ok=True)
    site.seed(root)
    turnstile = os.path.join(round_dir, "ts")
    os.makedirs(turnstile, exist_ok=True)
    pool.dispatch(site.name, root, turnstile)
    granted = [0, 0]
    results: List[Optional[dict]] = [None, None]
    trace: List[int] = []
    names: List[str] = []
    deadline = time.monotonic() + timeout_s
    while not all(r is not None for r in results):
        pool.check_alive()
        if time.monotonic() > deadline:
            raise RaceAuditError(
                f"site {site.name}: schedule stalled after grants "
                f"{''.join(map(str, trace))} (scheduler timeout)")
        ready: List[int] = []
        for idx in (0, 1):
            if results[idx] is not None:
                continue
            dpath = os.path.join(turnstile, f"done.{idx}")
            if os.path.exists(dpath):
                with open(dpath) as fh:
                    results[idx] = json.load(fh)
                continue
            rpath = os.path.join(turnstile,
                                 f"ready.{idx}.{granted[idx]:04d}")
            if os.path.exists(rpath):
                ready.append(idx)
        waiting = [i for i in (0, 1) if results[i] is None]
        if not waiting:
            break
        if len(ready) < len(waiting):
            time.sleep(0.0003)      # someone is still running
            continue
        pick = decider(len(trace), ready, trace)
        if pick not in ready:
            raise RaceAuditError(
                f"site {site.name}: replay trace diverged at step "
                f"{len(trace)} (trace wants actor {pick}, ready "
                f"{ready}) — the schedule does not belong to this "
                f"code")
        tag = f"{pick}.{granted[pick]:04d}"
        with open(os.path.join(turnstile, f"ready.{tag}")) as fh:
            names.append(fh.read().strip())
        go = os.path.join(turnstile, f"go.{tag}")
        with open(go + ".wip", "w") as fh:
            fh.write("go")
        os.replace(go + ".wip", go)
        granted[pick] += 1
        trace.append(pick)
    return results[0], results[1], trace, names


# ------------------------------------------------------------- deciders
def _exhaustive_decider(bits: Sequence[int]):
    """Enumerate the first ``len(bits)`` genuine (two-way) choices;
    beyond them, prefer the lowest ready actor. Forced steps (one
    actor ready) consume no bit."""
    state = {"used": 0}

    def decide(step: int, ready: List[int], trace: List[int]) -> int:
        if len(ready) == 1:
            return ready[0]
        i = state["used"]
        state["used"] += 1
        if i < len(bits):
            return ready[-1] if bits[i] else ready[0]
        return min(ready)

    return decide


def _seeded_decider(site_name: str, seed: int):
    rnd = random.Random(f"{site_name}:{seed}")

    def decide(step: int, ready: List[int], trace: List[int]) -> int:
        return rnd.choice(ready)

    return decide


def _replay_decider(steps: Sequence[int]):
    def decide(step: int, ready: List[int], trace: List[int]) -> int:
        if step < len(steps):
            return steps[step]
        return min(ready)

    return decide


def parse_schedule(spec: str) -> Tuple[str, List[int]]:
    """Parse a ``--schedule`` trace: ``<site>:<digits>`` where digit i
    names the actor granted at step i (e.g. ``ledger.claim:01101``)."""
    site, sep, digits = spec.rpartition(":")
    if not sep or not site or not re.fullmatch(r"[01]+", digits):
        raise ValueError(
            f"bad schedule {spec!r} (want <site>:<01-digits>, e.g. "
            f"ledger.claim:01101)")
    return site, [int(d) for d in digits]


# --------------------------------------------------------------------------
# the interleaving auditor
# --------------------------------------------------------------------------
def audit_interleavings(sites: Optional[Sequence[InterleaveSite]] = None,
                        locations: Optional[
                            Dict[str, Tuple[str, int]]] = None,
                        depth: int = 3, seeds: int = 64,
                        schedule: Optional[Tuple[str, List[int]]] = None
                        ) -> Tuple[List[dict], List[Finding]]:
    """Explore two-actor schedules for every registered interleave
    site: exhaustive over the first `depth` genuine choices, plus
    `seeds` seeded-random schedules — or exactly one replayed trace
    when `schedule` is given. Per schedule, assert: neither actor
    crashed, the site's invariants hold, zero stranded protocol tmps,
    and the declared artifacts are byte-identical to the solo run.
    Returns (rows, findings): one row per site with per-kind schedule
    counts, one ``race-interleaving`` finding (carrying a replayable
    trace) per failed site. Infrastructure failures raise
    :class:`RaceAuditError`."""
    sites = list(sites) if sites is not None else list(INTERLEAVE_SITES)
    if schedule is not None:
        want, steps = schedule
        sites = [s for s in sites if s.name == want]
        if not sites:
            raise RaceAuditError(f"unknown interleave site {want!r}")
    locations = locations or {}
    rows: List[dict] = []
    findings: List[Finding] = []
    base = tempfile.mkdtemp(prefix="avenir_race_")
    pool = _ActorPool(base)
    try:
        for site in sites:
            loc = locations.get(site.name)
            site_dir = os.path.join(base, site.name.replace(".", "_"))
            solo_root = os.path.join(site_dir, "solo")
            os.makedirs(solo_root, exist_ok=True)
            try:
                site.seed(solo_root)
                solo_a = site.actors[0](solo_root)
                solo_b = site.actors[1](solo_root)
            except RaceAuditError:
                raise
            except Exception as exc:
                raise RaceAuditError(
                    f"interleave site {site.name}: solo driver "
                    f"failed: {type(exc).__name__}: {exc}") from exc
            solo_snap = _artifact_snapshot(solo_root, site.artifacts)
            deciders: List[Tuple[str, Callable]] = []
            if schedule is not None:
                deciders.append(("replay", _replay_decider(steps)))
            else:
                for bits in itertools.product((0, 1), repeat=depth):
                    deciders.append(
                        ("exhaustive", _exhaustive_decider(bits)))
                for s in range(seeds):
                    deciders.append(
                        ("seeded", _seeded_decider(site.name, s)))
            counts = {"exhaustive": 0, "seeded": 0, "replay": 0}
            problems: List[str] = []
            failing: Optional[str] = None
            for n, (kind, decider) in enumerate(deciders):
                round_dir = os.path.join(site_dir, f"r{n:04d}")
                os.makedirs(round_dir, exist_ok=True)
                ra, rb, trace, _names = _run_schedule(
                    pool, site, decider, round_dir)
                counts[kind] += 1
                sched_str = "".join(map(str, trace))
                rproblems: List[str] = []
                for idx, res in ((0, ra), (1, rb)):
                    if not res.get("ok"):
                        rproblems.append(
                            f"actor {idx} crashed: {res.get('error')}")
                root = os.path.join(round_dir, "root")
                if not rproblems:
                    rproblems.extend(site.verify(
                        root, ra["value"], rb["value"],
                        solo_a, solo_b) or [])
                leftovers = _tmp_leftovers(root)
                if leftovers:
                    rproblems.append(
                        f"stranded protocol tmps: {leftovers[:4]}")
                got = _artifact_snapshot(root, site.artifacts)
                if got != solo_snap:
                    drift = sorted(r for r in solo_snap
                                   if got.get(r) != solo_snap[r])
                    rproblems.append(
                        f"artifacts differ from the solo run "
                        f"(drifting: {drift[:4]})")
                shutil.rmtree(round_dir, ignore_errors=True)
                if rproblems:
                    failing = sched_str
                    problems.append(
                        f"schedule {site.name}:{sched_str} ({kind}): "
                        + "; ".join(rproblems))
                    break           # first failing schedule is THE repro
            validated = not problems
            rows.append({"site": site.name,
                         "path": loc[0] if loc else site.path,
                         "line": loc[1] if loc else 1,
                         "schedules": dict(counts),
                         "depth": depth,
                         "failing_schedule":
                             f"{site.name}:{failing}" if failing
                             else None,
                         "interleaving_validated": validated})
            if not validated:
                findings.append(Finding(
                    loc[0] if loc else site.path,
                    loc[1] if loc else 1,
                    RACE_AUDIT_RULE,
                    f"interleave site `{site.name}` failed schedule "
                    f"exploration: {'; '.join(problems)} — replay "
                    f"with: python -m avenir_tpu_torch.analysis --race --schedule "
                    f"{site.name}:{failing}",
                    "make the losing actor recover (EAFP / link-CAS / "
                    "take-CAS) instead of acting on a stale check; "
                    "never allowlist an interleaving failure",
                    site.name))
    finally:
        pool.close()
        shutil.rmtree(base, ignore_errors=True)
    return rows, findings


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------
def run_race(paths: Optional[Sequence[str]] = None,
             rules: Optional[Sequence[RaceRule]] = None,
             baseline: Optional[Sequence[BaselineEntry]] = None,
             root: Optional[str] = None, include_md: bool = True,
             audit: bool = True,
             sites: Optional[Sequence[InterleaveSite]] = None,
             depth: int = 3, seeds: int = 64,
             schedule: Optional[Tuple[str, List[int]]] = None,
             device: str = "cuda") -> Report:
    """Lint `paths` (default: the multi-writer protocol surface) with
    the race rules, run the interleaving explorer over the registered
    sites (default: INTERLEAVE_SITES, after the sched_point registry
    cross-check), and apply the allowlist baseline to the RULE findings
    only — ``race-interleaving`` findings are appended after the
    baseline pass and can never be suppressed."""
    active = list(rules) if rules is not None else \
        [r() for r in ALL_RACE_RULES]
    root = os.path.abspath(root or os.getcwd())
    scan = list(paths) if paths else default_race_paths(root)
    report, raw = collect_findings(scan, active, root, include_md)
    audit_findings: List[Finding] = []
    if audit:
        _open_device(device, RaceAuditError)
        locations: Dict[str, Tuple[str, int]] = {}
        if sites is None:
            locations = check_sched_registry()
        rows, audit_findings = audit_interleavings(
            sites=sites, locations=locations, depth=depth, seeds=seeds,
            schedule=schedule)
        report.race_audit.extend(rows)
    active_ids = {r.rule_id for r in active}
    apply_baseline(report, raw, baseline, active_ids)
    # the never-baselined contract: schedule failures join findings
    # AFTER the allowlist pass, so no entry can ever suppress one
    report.findings.extend(audit_findings)
    return report
