"""The cache-key tier: ``python -m avenir_tpu_torch.analysis --keys``.

The port's copy of `avenir_tpu/analysis/keys.py`. Every cache of the
port (the sidecar directories, the incremental checkpoint, the warm
miner source and the exec-coalesce map, the batching key, the autotune
profile, the encoded-block cache, the served model and the shard
ledger's committed states) rests on one claim: the key is a proof of
the value. Two reads that agree on the key must see the same bytes, and
any input that can change the bytes must change the key.

**Static rules** (AST) over the cache surface (``native/sidecar.py``,
``native/ingest.py``, ``core/incremental.py``, ``core/keys.py``,
``server/jobserver.py``, ``tune/store.py``, ``dist/ledger.py``):

- ``keys-undigested-input``: a function that builds a cache key and
  consults a cache reads a config literal the key function never folds
  (and that is not view-neutral); a ``key-covered:`` docstring line and
  a transitive ``conf_digest`` call are the sanctioned exits;
- ``keys-overdigested-neutral``: a key function folds a config key
  declared view-neutral (`core/keys.py` ``VIEW_NEUTRAL_KEYS``);
- ``keys-mtime-validity``: cache validity from an mtime stat with no
  content re-proof (``verified_prefix``, ``block_hash``, ...) in reach;
  age arithmetic is fine;
- ``keys-unversioned-format``: a persisted cache manifest written with
  no ``format_version``;
- ``keys-digest-drift``: two key functions of one module fold the same
  input under different normalizations (a ``normalization:`` docstring
  line is the exit).

**The perturbation auditor** (:func:`audit_keys`): every key function
is annotated ``key_site("<name>")`` and :data:`KEY_SITES` drives a
seed, perturb and serve probe a site, moving each registered input
dimension one at a time against a fresh root that holds a warm cache:

- a view-affecting move must change the key, and the bytes served over
  the warm cache must equal a cold recompute (else ``keys-stale-serve``,
  the tier's pseudo-rule, applied after the allowlist and so never
  allowlisted);
- a view-neutral move must keep the key and warm-hit with the same
  bytes;
- a format move stamps a foreign ``format_version`` into the persisted
  manifest, and the serve must refuse it and equal a cold recompute.

The drivers' jobs (Apriori, the Markov model and its incremental run,
the Markov scorer) run on the audit's device: cuda unless the caller
asks for the CPU. :func:`check_key_registry` fails loudly when code and
registry disagree.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import shutil
import tempfile
from dataclasses import dataclass
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Set, Tuple)

from avenir_tpu_torch.analysis.engine import (BaselineEntry, Finding,
                                              ModuleContext, Report,
                                              apply_baseline, collect_findings)
from avenir_tpu_torch.analysis.proto import (_calls, _functions,
                                             _open_device, _pkg_root,
                                             _terminal_name)
from avenir_tpu_torch.core.keys import is_view_neutral

#: the audit pseudo-rule: perturbation verdicts surface under this id
#: and are NEVER allowlisted (the runner applies them AFTER the
#: baseline pass, so no allowlist entry can suppress one)
KEYS_AUDIT_RULE = "keys-stale-serve"


class KeysAuditError(RuntimeError):
    """The key-perturbation auditor could not run (driver failure,
    registry mismatch, missing native machinery) — an environment or
    registry error, never a lint finding."""


def default_keys_paths(root: str) -> List[str]:
    """The cache surface this tier lints: every module that builds a
    cache key or persists a keyed artifact, plus the canonical digest
    home itself."""
    names = [os.path.join("avenir_tpu_torch", "native", "sidecar.py"),
             os.path.join("avenir_tpu_torch", "native", "ingest.py"),
             os.path.join("avenir_tpu_torch", "core", "incremental.py"),
             os.path.join("avenir_tpu_torch", "core", "keys.py"),
             os.path.join("avenir_tpu_torch", "server", "jobserver.py"),
             os.path.join("avenir_tpu_torch", "tune", "store.py"),
             os.path.join("avenir_tpu_torch", "dist", "ledger.py")]
    return [p for p in (os.path.join(root, n) for n in names)
            if os.path.exists(p)]


# --------------------------------------------------------------------------
# shared AST helpers
# --------------------------------------------------------------------------
#: the JobConfig getter surface: a literal first argument to one of
#: these on a config-shaped receiver is a config-key read
_CFG_GETTERS = {"get", "get_int", "get_float", "get_bool"}
_CFG_RECV_TOKENS = ("cfg", "conf", "config")
#: a function is a KEY FUNCTION when its name carries key/digest/
#: fingerprint vocabulary or it carries a key_site() annotation
_KEYFN_NAME_RE = re.compile(r"(^|_)(key|keys|digest|fingerprint)($|_|s$)")
#: the content-proof machinery whose reachability exempts an mtime read
_CONTENT_PROOF_CALLS = {"verified_prefix", "block_hash",
                        "block_fingerprint", "_content_coverage",
                        "_verified_blocks", "schema_digest",
                        "note_block", "note_fingerprint"}
_CONTENT_PROOF_METHOD_RE = re.compile(
    r"(coverage|verified|content|hash|fingerprint)")
_MTIME_ATTRS = {"st_mtime", "st_mtime_ns"}
#: persistence sinks whose dict payloads must carry a format_version
_DUMP_TERMINALS = {"publish_json", "dump"}
#: receiver-name evidence that a .get()/.pop()/subscript is a CACHE
#: consultation (vs an ordinary dict read)
_CACHE_RECV_TOKENS = ("cache", "store", "warm", "memo", "entries",
                      "profiles", "sources", "seen", "pinned", "table")
_CACHE_CONSULT_METHODS = {"get", "pop", "setdefault", "lookup"}
#: normalization wrappers rule 5 compares — a call OUTSIDE this
#: vocabulary is opaque delegation and records nothing
_NORM_WRAPPERS = {"abspath", "realpath", "basename", "dirname",
                  "normpath", "open", "read", "dumps", "sorted", "str",
                  "repr", "int", "float", "round", "lower", "encode",
                  "sha1", "sha256", "md5", "blake2b"}
#: the input dimensions rule 5 tracks, by identifier token
_DIM_TOKENS = {"schema": "schema", "delim": "delim", "corpus": "corpus",
               "input": "corpus", "inputs": "corpus", "skip": "skip",
               "block": "block", "marker": "marker"}


def _docstring(fn: ast.AST) -> str:
    try:
        return ast.get_docstring(fn) or ""
    except TypeError:
        return ""


def _covered_decl(fn: ast.AST) -> Tuple[Set[str], bool]:
    """The ``key-covered:`` docstring declaration of a key function:
    (declared config keys, covers-all flag)."""
    doc = _docstring(fn)
    m = re.search(r"key-covered:\s*(.{0,400})", doc, re.S)
    if not m:
        return set(), False
    blob = m.group(1)
    if re.match(r"\s*all\b", blob):
        return set(), True
    keys = set(re.findall(r"[a-z][a-z0-9_]*(?:\.[a-z0-9_]+)+", blob))
    return keys, False


def _ident_soup(node: ast.AST) -> str:
    out: List[str] = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.append(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.append(sub.attr)
    return " ".join(out).lower()


def _is_cfg_receiver(node: ast.AST) -> bool:
    soup = _ident_soup(node)
    return any(tok in soup for tok in _CFG_RECV_TOKENS)


def _literal_reads(ctx: ModuleContext, fn: ast.AST) -> Dict[str, int]:
    """Direct config-literal reads in `fn`: literal -> line. Covers the
    getter surface plus the ``field_delim_regex`` property (which reads
    the two delimiter keys)."""
    out: Dict[str, int] = {}
    for call in _calls(fn):
        f = call.func
        if not isinstance(f, ast.Attribute) \
                or f.attr not in _CFG_GETTERS \
                or not _is_cfg_receiver(f.value):
            continue
        if call.args and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            out.setdefault(call.args[0].value, call.args[0].lineno)
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) \
                and node.attr == "field_delim_regex" \
                and _is_cfg_receiver(node.value):
            out.setdefault("field.delim.regex", node.lineno)
            out.setdefault("field.delim.in", node.lineno)
    return out


def _local_fn_table(ctx: ModuleContext) -> Dict[str, List[ast.AST]]:
    table: Dict[str, List[ast.AST]] = {}
    for fn in _functions(ctx):
        table.setdefault(fn.name, []).append(fn)
    return table


def _callee_names(ctx: ModuleContext, fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for call in _calls(fn):
        name = _terminal_name(ctx, call)
        if name:
            out.add(name)
    return out


def _transitive_reads(ctx: ModuleContext, fn: ast.AST,
                      table: Dict[str, List[ast.AST]],
                      seen: Optional[Set[int]] = None,
                      depth: int = 4) -> Dict[str, int]:
    """Config-literal reads of `fn` plus its module-local callees, a
    few hops deep (matching the flow tier's interprocedural reach)."""
    seen = set() if seen is None else seen
    if id(fn) in seen or depth <= 0:
        return {}
    seen.add(id(fn))
    out = dict(_literal_reads(ctx, fn))
    for name in _callee_names(ctx, fn):
        for callee in table.get(name, ()):
            for lit, line in _transitive_reads(
                    ctx, callee, table, seen, depth - 1).items():
                out.setdefault(lit, line)
    return out


def _transitive_calls(ctx: ModuleContext, fn: ast.AST,
                      table: Dict[str, List[ast.AST]],
                      needles: Set[str],
                      seen: Optional[Set[int]] = None,
                      depth: int = 4) -> bool:
    """Whether `fn` (or a module-local callee, a few hops deep) calls
    any function named in `needles`."""
    seen = set() if seen is None else seen
    if id(fn) in seen or depth <= 0:
        return False
    seen.add(id(fn))
    names = _callee_names(ctx, fn)
    if names & needles:
        return True
    return any(_transitive_calls(ctx, callee, table, needles, seen,
                                 depth - 1)
               for name in names for callee in table.get(name, ()))


def _is_key_fn(ctx: ModuleContext, fn: ast.AST) -> bool:
    if _KEYFN_NAME_RE.search(fn.name):
        return True
    return any(_terminal_name(ctx, c) == "key_site" for c in _calls(fn))


def _enclosing_class(ctx: ModuleContext, node: ast.AST
                     ) -> Optional[ast.ClassDef]:
    cur = node
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur
        cur = ctx.parent(cur)
    return None


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------
class KeysRule:
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


class UndigestedInputRule(KeysRule):
    """A function that builds a cache key (calls a module-local key
    function) AND consults a cache reads a config literal the key
    function never folds: the served bytes depend on an input the key
    cannot see — the under-keyed cache, the exact shape the live
    stale-serve probe exists to catch. Exempt when the key function
    (transitively) calls ``conf_digest`` (every non-neutral property
    folds in), when the literal is declared view-neutral, or when the
    key function's ``key-covered:`` docstring names the literal as
    deliberately excluded (with the reason)."""

    rule_id = "keys-undigested-input"
    description = "cached path reads a cfg key its cache key omits"
    hint = ("fold the key into the digest (or route through "
            "core.keys.conf_digest), or declare the deliberate "
            "exclusion in the key function's `key-covered:` docstring "
            "line — an input the key cannot see is a stale serve "
            "waiting for the first config change")

    def _consults_cache(self, ctx: ModuleContext, fn: ast.AST) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.Compare) and any(
                    isinstance(op, (ast.In, ast.NotIn))
                    for op in node.ops):
                return True
            if isinstance(node, ast.Subscript):
                soup = _ident_soup(node.value)
                if any(t in soup for t in _CACHE_RECV_TOKENS):
                    return True
        for call in _calls(fn):
            f = call.func
            if isinstance(f, ast.Attribute) \
                    and f.attr in _CACHE_CONSULT_METHODS \
                    and not _is_cfg_receiver(f.value):
                soup = _ident_soup(f.value)
                if any(t in soup for t in _CACHE_RECV_TOKENS):
                    return True
        return False

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        table = _local_fn_table(ctx)
        key_fns = {fn.name: fn for fn in _functions(ctx)
                   if _is_key_fn(ctx, fn)}
        for fn in _functions(ctx):
            if _is_key_fn(ctx, fn):
                continue
            called = [key_fns[n] for n in _callee_names(ctx, fn)
                      if n in key_fns]
            if not called or not self._consults_cache(ctx, fn):
                continue
            covered: Set[str] = set()
            covers_all = False
            for kfn in called:
                decl, all_flag = _covered_decl(kfn)
                covered |= decl
                covered |= set(_transitive_reads(ctx, kfn, table))
                if all_flag or _transitive_calls(
                        ctx, kfn, table, {"conf_digest"}):
                    covers_all = True
            own_decl, own_all = _covered_decl(fn)
            covered |= own_decl
            if covers_all or own_all:
                continue
            reads = _transitive_reads(ctx, fn, table)
            for lit in sorted(reads):
                if lit in covered or is_view_neutral(lit):
                    continue
                yield Finding(
                    ctx.path, reads[lit], self.rule_id,
                    f"`{fn.name}` consults a cache keyed by "
                    f"`{', '.join(k.name for k in called)}` but reads "
                    f"config key `{lit}` that the key never folds — "
                    f"a change to it serves stale bytes",
                    self.hint, ctx.scope_of(fn.body[0]))


class OverdigestedNeutralRule(KeysRule):
    """A key/digest function folds a config key declared view-neutral
    in :data:`~avenir_tpu_torch.core.keys.VIEW_NEUTRAL_KEYS`: the key then
    changes when a state directory moves or the tuner toggles
    recording, and every such non-view change spuriously invalidates
    the cache (the dual of the stale serve — cold cost, not wrong
    bytes, but it defeats the cache exactly when operators touch
    deployment knobs). A neutral literal inside a comparison or an
    ``if`` test is the skip GUARD (the sanctioned shape) and is
    exempt."""

    rule_id = "keys-overdigested-neutral"
    description = "view-neutral cfg key folded into a cache digest"
    hint = ("skip the key (guard with core.keys.is_view_neutral, the "
            "conf_digest shape) — view-neutral keys name WHERE state "
            "lives, not WHAT bytes are served; folding one makes every "
            "deployment change a spurious cold rescan")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in _functions(ctx):
            if not _is_key_fn(ctx, fn):
                continue
            guarded: Set[int] = set()
            for node in ast.walk(fn):
                zone = None
                if isinstance(node, ast.Compare):
                    zone = node
                elif isinstance(node, (ast.If, ast.While)):
                    zone = node.test
                elif isinstance(node, ast.Call) and _terminal_name(
                        ctx, node) == "is_view_neutral":
                    zone = node
                if zone is not None:
                    guarded.update(id(s) for s in ast.walk(zone))
            for node in ast.walk(fn):
                if isinstance(node, ast.Constant) \
                        and isinstance(node.value, str) \
                        and id(node) not in guarded \
                        and is_view_neutral(node.value):
                    yield self.finding(
                        ctx, node,
                        f"key function `{fn.name}` folds view-neutral "
                        f"config key `{node.value}` into the digest — "
                        f"every state-dir/tuner change now spuriously "
                        f"invalidates the cache")


class MtimeValidityRule(KeysRule):
    """Cache validity derived from an mtime stat instead of content
    fingerprints. A touch, copy-back or clock skew then either torches
    a perfectly valid cache (spurious cold rescan) or — with a
    coarse-granularity filesystem — serves stale bytes for an in-place
    edit inside the mtime tick. The standing contract
    is content re-proof: a scope is exempt when it (transitively)
    reaches the content machinery, when its class carries a
    content-proof method, or when the stat only feeds age arithmetic
    (durations are fine — they gate GC, not validity)."""

    rule_id = "keys-mtime-validity"
    description = "cache validity from mtime instead of content proof"
    hint = ("re-prove content (core.incremental.verified_prefix / "
            "block_hash) instead of trusting the stat — mtime is a "
            "hint, never a proof; see the `mtime-ok:` docstring "
            "declaration for deliberate non-cache uses")

    def _mtime_uses(self, ctx: ModuleContext,
                    fn: ast.AST) -> List[ast.AST]:
        out: List[ast.AST] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) \
                    and node.attr in _MTIME_ATTRS:
                out.append(node)
            elif isinstance(node, ast.Call):
                dotted = ctx.dotted(node.func) or ""
                if dotted.endswith("getmtime"):
                    out.append(node)
        return out

    def _age_only(self, ctx: ModuleContext, fn: ast.AST,
                  use: ast.AST) -> bool:
        cur = use
        while cur is not None and cur is not fn:
            if isinstance(cur, ast.BinOp) \
                    and isinstance(cur.op, ast.Sub):
                return True
            cur = ctx.parent(cur)
        return False

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        table = _local_fn_table(ctx)
        for fn in _functions(ctx):
            uses = self._mtime_uses(ctx, fn)
            if not uses:
                continue
            if "mtime-ok:" in _docstring(fn):
                continue
            if fn.name in _CONTENT_PROOF_CALLS or _transitive_calls(
                    ctx, fn, table, _CONTENT_PROOF_CALLS):
                continue
            cls = _enclosing_class(ctx, fn)
            if cls is not None and any(
                    isinstance(m, (ast.FunctionDef,
                                   ast.AsyncFunctionDef))
                    and _CONTENT_PROOF_METHOD_RE.search(m.name)
                    for m in cls.body):
                continue
            for use in uses:
                if self._age_only(ctx, fn, use):
                    continue
                yield self.finding(
                    ctx, use,
                    f"`{fn.name}` derives validity from an mtime stat "
                    f"with no content re-proof in reach — a touch or "
                    f"copy-back serves stale bytes or torches a valid "
                    f"cache")


class UnversionedFormatRule(KeysRule):
    """A persisted cache manifest/record written with no
    ``format_version`` field: the next layout change ships a reader
    that silently misparses (or silently serves) yesterday's caches —
    the standing contract is stamp on write, refuse-and-go-cold on a
    PRESENT mismatched stamp, serve on a missing one (pre-versioning
    caches survive the upgrade). Flags dict literals flowing into the
    persistence sinks (``publish_json`` / ``json.dump``) and dict
    literals built by manifest-builder functions. Advisory non-cache
    records opt out with a ``not a cache`` docstring note."""

    rule_id = "keys-unversioned-format"
    description = "persisted cache manifest has no format_version"
    hint = ("stamp `format_version` at every writer and refuse-and-go-"
            "cold on a present mismatch — an unversioned layout makes "
            "the NEXT format change a silent misparse of every cache "
            "already on disk")

    _BUILDER_RE = re.compile(r"(manifest|fresh|meta)")

    def _dict_keys(self, d: ast.Dict) -> Set[str]:
        return {k.value for k in d.keys
                if isinstance(k, ast.Constant)
                and isinstance(k.value, str)}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in _functions(ctx):
            if "not a cache" in _docstring(fn):
                continue
            assigned: Dict[str, ast.Dict] = {}
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) \
                        and isinstance(node.value, ast.Dict):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            assigned[tgt.id] = node.value
            flagged: Set[int] = set()
            for call in _calls(fn):
                term = _terminal_name(ctx, call)
                if term not in _DUMP_TERMINALS or not call.args:
                    continue
                obj = call.args[0]
                d = obj if isinstance(obj, ast.Dict) else (
                    assigned.get(obj.id)
                    if isinstance(obj, ast.Name) else None)
                if d is None:
                    continue
                keys = self._dict_keys(d)
                if not keys or "format_version" in keys:
                    continue
                flagged.add(id(d))
                yield self.finding(
                    ctx, d,
                    f"`{fn.name}` persists a manifest with keys "
                    f"{sorted(keys)[:5]} and no `format_version` "
                    f"stamp")
            if self._BUILDER_RE.search(fn.name):
                for node in ast.walk(fn):
                    if isinstance(node, ast.Dict) \
                            and id(node) not in flagged:
                        keys = self._dict_keys(node)
                        if len(keys) >= 3 \
                                and "format_version" not in keys:
                            yield self.finding(
                                ctx, node,
                                f"manifest builder `{fn.name}` emits a "
                                f"record with keys {sorted(keys)[:5]} "
                                f"and no `format_version` stamp")


class DigestDriftRule(KeysRule):
    """Two key functions in one module fold the same input dimension
    under DIFFERENT normalizations (one ``abspath``, one bare string;
    one reads file bytes, one hashes the path): the same view lands on
    different keys depending on which recipe a caller reached — the
    drift that scattering digest helpers across modules breeds, and
    the reason the recipes were unified into core/keys.py. A function
    whose docstring carries a ``normalization:`` declaration documents
    its choice and is exempt (the declaration is the reviewable
    contract)."""

    rule_id = "keys-digest-drift"
    description = "same dimension, different normalization, one module"
    hint = ("route both through one core.keys recipe, or declare the "
            "normalization in each docstring (`normalization: "
            "abspath`) so the difference is a reviewed contract, not "
            "drift")

    def _folds(self, ctx: ModuleContext, fn: ast.AST
               ) -> Dict[str, Set[str]]:
        out: Dict[str, Set[str]] = {}
        wrapped: Set[int] = set()
        for call in _calls(fn):
            term = _terminal_name(ctx, call) or ""
            in_vocab = term in _NORM_WRAPPERS
            for arg in call.args:
                for sub in ast.walk(arg):
                    wrapped.add(id(sub))
                if not in_vocab:
                    continue
                soup = _ident_soup(arg)
                for tok in soup.split():
                    dim = _DIM_TOKENS.get(tok)
                    if dim:
                        out.setdefault(dim, set()).add(term)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Return) or node.value is None:
                continue
            elts = node.value.elts \
                if isinstance(node.value, ast.Tuple) else [node.value]
            for e in elts:
                if isinstance(e, ast.Call):
                    continue
                for sub in ast.walk(e):
                    if id(sub) in wrapped:
                        break
                else:
                    for tok in _ident_soup(e).split():
                        dim = _DIM_TOKENS.get(tok)
                        if dim:
                            out.setdefault(dim, set()).add("bare")
        return out

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        fns = [fn for fn in _functions(ctx) if _is_key_fn(ctx, fn)]
        folded = [(fn, self._folds(ctx, fn)) for fn in fns]
        for i, (fa, da) in enumerate(folded):
            for fb, db in folded[i + 1:]:
                if "normalization:" in _docstring(fa) \
                        or "normalization:" in _docstring(fb):
                    continue
                for dim in sorted(set(da) & set(db)):
                    if da[dim] and db[dim] and not (da[dim] & db[dim]):
                        yield self.finding(
                            ctx, fb,
                            f"`{fa.name}` and `{fb.name}` both fold "
                            f"dimension `{dim}` but normalize "
                            f"differently ({sorted(da[dim])} vs "
                            f"{sorted(db[dim])}) — the same view "
                            f"lands on different keys")


ALL_KEYS_RULES = [UndigestedInputRule, OverdigestedNeutralRule,
                  MtimeValidityRule, UnversionedFormatRule,
                  DigestDriftRule]


def keys_rule_ids() -> List[str]:
    return [r.rule_id for r in ALL_KEYS_RULES] + [KEYS_AUDIT_RULE]


# --------------------------------------------------------------------------
# registry cross-check
# --------------------------------------------------------------------------
_KEY_REF_RE = re.compile(r'key_site\(\s*"([a-z_.]+)"')


def key_annotations(root: Optional[str] = None
                    ) -> Dict[str, Tuple[str, int]]:
    """Every key_site name annotated on the cache surface, mapped to
    the (repo-relative path, line) of its first call site. The
    definition of ``key_site`` itself takes a bare parameter, so only
    real annotations (string-literal calls) match."""
    root = root or _pkg_root()
    refs: Dict[str, Tuple[str, int]] = {}
    for path in default_keys_paths(root):
        try:
            with open(path, encoding="utf-8") as fh:
                text = fh.read()
        except OSError:
            continue
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        for i, line in enumerate(text.splitlines(), 1):
            for m in _KEY_REF_RE.finditer(line):
                refs.setdefault(m.group(1), (rel, i))
    return refs


def check_key_registry(root: Optional[str] = None
                       ) -> Dict[str, Tuple[str, int]]:
    """Fail loudly when the key_site annotations and the KEY_SITES
    registry disagree: an annotated-but-unregistered key function is a
    cache the auditor never perturbs (an unproven key), a registered-
    but-unannotated site means the registry describes a key function
    that no longer exists. Returns the annotation locations (the audit
    rows' path/line source)."""
    refs = key_annotations(root)
    names = {site.name for site in KEY_SITES}
    unregistered = sorted(set(refs) - names)
    unannotated = sorted(names - set(refs))
    problems = []
    if unregistered:
        problems.append(
            f"key_site annotations in code but in no KEY_SITES entry "
            f"(caches whose key is never perturb-proven): "
            f"{unregistered}")
    if unannotated:
        problems.append(
            f"registered in KEY_SITES but never annotated in code "
            f"(dangling registry entries): {unannotated}")
    if problems:
        raise KeysAuditError(
            "key-site registry mismatch: " + "; ".join(problems))
    return refs


# --------------------------------------------------------------------------
# the perturbation auditor
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class KeyPerturb:
    """One registered input dimension of a key site and how to move
    it: ``kind`` is ``affecting`` (must change the key; warm serve
    must equal a cold recompute), ``neutral`` (must keep the key;
    must warm-hit byte-identically) or ``format`` (a foreign
    format_version stamped into the persisted manifest; the serve
    must refuse and equal a cold recompute)."""

    name: str
    kind: str
    apply: Callable[[str], None]


@dataclass(frozen=True)
class KeySite:
    """One registered cache-key surface: ``seed`` populates a fresh
    root, ``key`` evaluates the real key function over the root's
    current view, ``serve`` produces the cache's served bytes (first
    call in a fresh root is the cold fill; later calls may warm-hit),
    and ``perturbs`` enumerates every registered input dimension.
    ``warm_proof``, when given, re-serves and returns True only if the
    serve was a warm hit — the spurious-miss probe for neutral
    perturbations."""

    name: str
    path: str
    seed: Callable[[str], None]
    key: Callable[[str], object]
    serve: Callable[[str], object]
    perturbs: Tuple[KeyPerturb, ...] = ()
    warm_proof: Optional[Callable[[str], bool]] = None


def _canon(value) -> str:
    return json.dumps(value, sort_keys=True, default=repr)


#: the device the drivers' jobs run on, set by `audit_keys` for its run
_RUN = {"device": "cuda"}


# ---------------------------------------------------------- driver infra
_DELIM = ","
_BLOCK = 2048


def _p(root: str, *names: str) -> str:
    return os.path.join(root, *names)


def _write(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(text)


def _file_sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha1(fh.read()).hexdigest()


def _tree_sha(path: str) -> str:
    """Content digest of a job artifact that may be one file or a
    directory of them (the miner emits a directory)."""
    if not os.path.isdir(path):
        return _file_sha(path)
    h = hashlib.sha1()
    for dirpath, dirnames, filenames in sorted(os.walk(path)):
        dirnames.sort()
        for name in sorted(filenames):
            full = os.path.join(dirpath, name)
            h.update(os.path.relpath(full, path).encode())
            with open(full, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def _conf(root: str) -> Dict[str, str]:
    with open(_p(root, "conf.json"), encoding="utf-8") as fh:
        return json.load(fh)


def _set_conf(root: str, key: str, value: str) -> None:
    conf = _conf(root)
    conf[key] = value
    _write(_p(root, "conf.json"), json.dumps(conf, indent=1))


def _meta(root: str) -> Dict[str, str]:
    with open(_p(root, "meta.json"), encoding="utf-8") as fh:
        return json.load(fh)


def _set_meta(root: str, key: str, value: str) -> None:
    meta = _meta(root)
    meta[key] = value
    _write(_p(root, "meta.json"), json.dumps(meta, indent=1))


def _corpus_path(root: str) -> str:
    return _p(root, _meta(root).get("corpus", "corpus.csv"))


def _churn_seed(root: str, conf: Dict[str, str],
                schema: bool = False) -> None:
    from avenir_tpu_torch.data.generators import churn_schema, generate_churn

    _write(_p(root, "corpus.csv"),
           generate_churn(120, seed=11, as_csv=True))
    _write(_p(root, "meta.json"), json.dumps({"corpus": "corpus.csv"}))
    _write(_p(root, "conf.json"), json.dumps(conf, indent=1))
    if schema:
        churn_schema().save(_p(root, "schema.json"))


def _edit_corpus_row(root: str) -> None:
    """Perturb one content dimension: bump the first row's integer
    field in place (same schema vocabulary, different bytes from
    block 0 on)."""
    path = _corpus_path(root)
    with open(path, encoding="utf-8") as fh:
        lines = fh.read().splitlines()
    fields = lines[0].split(_DELIM)
    fields[-2] = str(int(fields[-2]) + 1)
    lines[0] = _DELIM.join(fields)
    _write(path, "\n".join(lines) + "\n")


def _append_corpus_rows(root: str, rows: List[str]) -> None:
    with open(_corpus_path(root), "a", encoding="utf-8") as fh:
        fh.write("\n".join(rows) + "\n")


def _touch_corpus(root: str) -> None:
    os.utime(_corpus_path(root), (946684800, 946684800))


def _edit_schema(root: str) -> None:
    """Append an (unused) category to a non-discovered cardinality:
    parse-compatible, digest-visible."""
    path = _p(root, "schema.json")
    with open(path, encoding="utf-8") as fh:
        schema = json.load(fh)
    for f in schema["fields"]:
        if f.get("name") == "payment":
            f["cardinality"] = list(f["cardinality"]) + ["extracat"]
    _write(path, json.dumps(schema, indent=1))


def _stamp_manifest(path: str, version: int = 99) -> None:
    """Stamp a FOREIGN format_version into a persisted JSON manifest —
    the refuse-and-go-cold probe."""
    with open(path, encoding="utf-8") as fh:
        man = json.load(fh)
    man["format_version"] = version
    _write(path, json.dumps(man, indent=1))


def _memo_serve(root: str, fname: str, key, compute: Callable[[], object]):
    """A transparent micro-cache over the REAL key function under
    audit: serve from the entry when the key matches, recompute and
    store otherwise. A registered dimension the real key fails to fold
    leaves the key unchanged under perturbation, so the memo replays
    the pre-perturbation value — exactly the stale serve the auditor
    then catches against the cold recompute."""
    path = _p(root, fname)
    try:
        with open(path, encoding="utf-8") as fh:
            memo = json.load(fh)
    except (OSError, ValueError):
        memo = {"entries": {}, "hits": 0}
    kstr = _canon(key)
    if kstr in memo["entries"]:
        memo["hits"] += 1
        _write(path, json.dumps(memo))
        return memo["entries"][kstr]
    value = compute()
    memo["entries"][kstr] = value
    _write(path, json.dumps(memo))
    return value


def _memo_hits(root: str, fname: str) -> int:
    try:
        with open(_p(root, fname), encoding="utf-8") as fh:
            return int(json.load(fh).get("hits", 0))
    except (OSError, ValueError):
        return 0


def _memo_proof(fname: str, serve: Callable[[str], object]
                ) -> Callable[[str], bool]:
    def proof(root: str) -> bool:
        before = _memo_hits(root, fname)
        serve(root)
        return _memo_hits(root, fname) > before
    return proof


# ------------------------------------------------------- sidecar drivers
def _sc_opts(root: str) -> dict:
    return {"dir": _p(root, "sc"), "budget": 1 << 30}


def _sc_schema(root: str):
    from avenir_tpu_torch.core.schema import FeatureSchema

    return FeatureSchema.from_file(_p(root, "schema.json"))


def _sc_tiling(feed) -> List[List[object]]:
    if feed is None:
        raise KeysAuditError(
            "sidecar machinery unavailable (native library not built)")
    return [[off, length, digest]
            for off, length, digest, _payload in feed]


def _sc_dataset_seed(root: str) -> None:
    _churn_seed(root, {"delim": _DELIM, "block": str(_BLOCK)},
                schema=True)


def _sc_dataset_dir(root: str) -> str:
    from avenir_tpu_torch.native import sidecar as sc

    conf = _conf(root)
    return sc.dataset_dir(_sc_opts(root), _corpus_path(root),
                          _sc_schema(root), conf["delim"],
                          int(conf["block"]))


def _sc_dataset_key(root: str):
    return [os.path.basename(_sc_dataset_dir(root)),
            _file_sha(_corpus_path(root))]


def _sc_dataset_serve(root: str):
    from avenir_tpu_torch.native import sidecar as sc

    conf = _conf(root)
    return _sc_tiling(sc.dataset_blocks(
        _sc_opts(root), _corpus_path(root), _sc_schema(root),
        conf["delim"], int(conf["block"])))


def _sc_dataset_stamp(root: str) -> None:
    _stamp_manifest(_p(_sc_dataset_dir(root), "MANIFEST.json"))


def _sc_warm_proof(serve: Callable[[str], object]
                   ) -> Callable[[str], bool]:
    def proof(root: str) -> bool:
        from avenir_tpu_torch.native.sidecar import counters_snapshot

        before = counters_snapshot()["hit_blocks"]
        serve(root)
        return counters_snapshot()["hit_blocks"] > before
    return proof


def _sc_bytes_seed(root: str) -> None:
    _churn_seed(root, {"delim": _DELIM, "block": str(_BLOCK),
                       "skip": "2"})


def _sc_bytes_dir(root: str) -> str:
    from avenir_tpu_torch.native import sidecar as sc

    conf = _conf(root)
    return sc.bytes_dir(_sc_opts(root), _corpus_path(root),
                        conf["delim"], int(conf["skip"]),
                        int(conf["block"]))


def _sc_bytes_key(root: str):
    return [os.path.basename(_sc_bytes_dir(root)),
            _file_sha(_corpus_path(root))]


def _sc_bytes_serve(root: str):
    from avenir_tpu_torch.native import sidecar as sc

    conf = _conf(root)
    return _sc_tiling(sc.byte_blocks(
        _sc_opts(root), _corpus_path(root), conf["delim"],
        int(conf["skip"]), int(conf["block"])))


# ---------------------------------------------------- checkpoint driver
_MST_CONF = {"mst.model.states": "L,M,H",
             "mst.class.label.field.ord": "1",
             "mst.skip.field.count": "2",
             "mst.class.labels": "T,F"}


def _seq_rows(start: int, n: int) -> List[str]:
    states = ("L", "M", "H")
    rows = []
    for i in range(start, start + n):
        label = "T" if i % 3 else "F"
        toks = [states[(i + j) % 3] for j in range(6)]
        rows.append(f"c{i},{label}," + _DELIM.join(toks))
    return rows


def _ckpt_seed(root: str) -> None:
    _write(_p(root, "corpus.csv"), "\n".join(_seq_rows(0, 120)) + "\n")
    _write(_p(root, "meta.json"), json.dumps({"corpus": "corpus.csv"}))
    _write(_p(root, "conf.json"), json.dumps(dict(_MST_CONF), indent=1))


def _ckpt_key(root: str):
    from avenir_tpu_torch.core.keys import conf_digest
    from avenir_tpu_torch.server.jobserver import _scoped

    _canonical, _prefix, cfg = _scoped("markovStateTransitionModel",
                                       _conf(root))
    return [conf_digest(cfg), _file_sha(_corpus_path(root))]


def _ckpt_serve(root: str):
    from avenir_tpu_torch.runner import run_incremental

    out = _p(root, "out.txt")
    run_incremental("markovStateTransitionModel", dict(_conf(root)),
                    [_corpus_path(root)], output=out,
                    state_dir=_p(root, "state"), device=_RUN["device"])
    return _file_sha(out)


def _ckpt_stamp(root: str) -> None:
    _stamp_manifest(_p(root, "state", "MANIFEST.json"))


# ------------------------------------------------- warm miner driver
_FIA_CONF = {"fia.support.threshold": "0.3",
             "fia.item.set.length": "2",
             "fia.skip.field.count": "2"}


def _fia_run_sha(root: str) -> str:
    from avenir_tpu_torch.runner import run_job

    out = _p(root, "out.txt")
    # the miner emits a directory of artifacts; a previous run's files
    # must not leak into this view's digest
    shutil.rmtree(out, ignore_errors=True)
    run_job("frequentItemsApriori", dict(_conf(root)),
            [_corpus_path(root)], output=out, device=_RUN["device"])
    return _tree_sha(out)


def _miner_seed(root: str) -> None:
    _churn_seed(root, dict(_FIA_CONF))


def _miner_key(root: str):
    from avenir_tpu_torch.server.jobserver import WarmStore, _scoped

    corpus = _corpus_path(root)
    canonical, _prefix, cfg = _scoped("frequentItemsApriori",
                                     _conf(root))
    return [list(WarmStore.source_key(canonical, [corpus], cfg)),
            _file_sha(corpus)]


def _miner_serve(root: str):
    return _memo_serve(root, "warmcache.json", _miner_key(root),
                       lambda: _fia_run_sha(root))


# ---------------------------------------------- exec / compat drivers
def _job_request(root: str):
    from avenir_tpu_torch.server.jobserver import JobRequest

    return JobRequest(job="frequentItemsApriori", conf=_conf(root),
                      inputs=[_corpus_path(root)], output="")


def _exec_seed(root: str) -> None:
    _churn_seed(root, dict(_FIA_CONF))


def _exec_key(root: str):
    from avenir_tpu_torch.server.jobserver import _exec_key as real_exec_key

    return [list(real_exec_key(_job_request(root))),
            _file_sha(_corpus_path(root))]


def _exec_serve(root: str):
    return _memo_serve(root, "execcache.json", _exec_key(root),
                       lambda: _fia_run_sha(root))


def _compat_seed(root: str) -> None:
    conf = dict(_FIA_CONF)
    conf["stream.block.size.mb"] = "0.002"
    _churn_seed(root, conf)


def _compat_key(root: str):
    from avenir_tpu_torch.server.jobserver import compat_key

    key = compat_key(_job_request(root))
    if key is None:
        raise KeysAuditError("compat_key returned None for a "
                             "registered stream fold")
    return [list(key), _file_sha(_corpus_path(root))]


def _compat_scan(root: str):
    """The SharedScan view two equal compat keys ride: the byte tiling
    under the request's block size / delimiter / skip."""
    from avenir_tpu_torch.native import sidecar as sc
    from avenir_tpu_torch.server.jobserver import _scoped

    _canonical, _prefix, cfg = _scoped("frequentItemsApriori",
                                       _conf(root))
    block = int(cfg.get_float("stream.block.size.mb", 64.0) * (1 << 20))
    return _sc_tiling(sc.byte_blocks(
        _sc_opts(root), _corpus_path(root), cfg.field_delim_regex,
        cfg.get_int("skip.field.count", 1), block))


def _compat_serve(root: str):
    return _memo_serve(root, "compatcache.json", _compat_key(root),
                       lambda: _compat_scan(root))


# ------------------------------------------------- sidecar pin driver
def _pin_seed(root: str) -> None:
    conf = dict(_FIA_CONF)
    conf["stream.block.size.mb"] = "0.002"
    conf["stream.sidecar.dir"] = _p(root, "sc")
    _churn_seed(root, conf)


def _pin_keys(root: str):
    from avenir_tpu_torch.server.jobserver import JobServer

    out = JobServer._sidecar_keys(None, [_job_request(root)])
    if not out:
        raise KeysAuditError("_sidecar_keys resolved no pinnable "
                             "sidecar for a streamed request")
    return [list(key) for key, _path, _dirpath in out]


def _pin_key(root: str):
    return [_pin_keys(root), _file_sha(_corpus_path(root))]


def _pin_serve(root: str):
    from avenir_tpu_torch.native import sidecar as sc
    from avenir_tpu_torch.server.jobserver import _scoped

    _canonical, _prefix, cfg = _scoped("frequentItemsApriori",
                                       _conf(root))
    block = int(cfg.get_float("stream.block.size.mb", 64.0) * (1 << 20))
    opts = sc.opts_from_cfg(cfg)
    return _sc_tiling(sc.byte_blocks(
        opts, _corpus_path(root), cfg.field_delim_regex,
        cfg.get_int("skip.field.count", 1), block))


# -------------------------------------------------- autotune driver
def _prof_store(root: str):
    from avenir_tpu_torch.tune.store import ProfileStore

    return ProfileStore(_p(root, "tune"))


def _prof_digest(root: str) -> str:
    from avenir_tpu_torch.core.keys import corpus_digest

    return corpus_digest([_corpus_path(root)])


def _prof_knobs(root: str) -> Dict[str, float]:
    """The 'learned' knob value, a deterministic function of the
    corpus content — so knobs recorded for one view are DISTINGUISHABLE
    from knobs the tuner would learn for another."""
    return {"stream.block.size.mb":
            float(2 + os.path.getsize(_corpus_path(root)) % 7)}


def _prof_seed(root: str) -> None:
    _write(_p(root, "corpus.csv"), "a,b,c\nd,e,f\n")
    _write(_p(root, "meta.json"),
           json.dumps({"corpus": "corpus.csv",
                       "job": "mutualInformation"}))
    _write(_p(root, "conf.json"), json.dumps({}, indent=1))
    _prof_store(root).set_knobs(
        "mutualInformation", _prof_digest(root), _prof_knobs(root),
        ["seeded by the keys audit"])


def _prof_key(root: str):
    return [_meta(root)["job"], _prof_digest(root)]


def _prof_serve(root: str):
    store = _prof_store(root)
    job, digest = _meta(root)["job"], _prof_digest(root)
    prof = store.load(job, digest)
    if prof is None:
        # the real recovery for a missed/refused profile: the tuner
        # re-learns over the current view and re-records (set_knobs
        # overwrites a version-skewed file — the go-cold half)
        store.set_knobs(job, digest, _prof_knobs(root),
                        ["re-learned after refused load"])
        prof = store.load(job, digest)
    return None if prof is None else prof.get("knobs")


def _prof_move_corpus(root: str) -> None:
    os.rename(_p(root, "corpus.csv"), _p(root, "moved.csv"))
    _set_meta(root, "corpus", "moved.csv")


def _prof_stamp(root: str) -> None:
    store = _prof_store(root)
    _stamp_manifest(store.path(_meta(root)["job"], _prof_digest(root)))


# -------------------------------------------- encoded cache driver
_ENC_CACHES: Dict[str, object] = {}
_ENC_BUILDS: Dict[str, int] = {}


def _enc_reset() -> None:
    for cache in _ENC_CACHES.values():
        try:
            cache.abort()
        except Exception:
            pass
    _ENC_CACHES.clear()
    _ENC_BUILDS.clear()


def _enc_seed(root: str) -> None:
    _churn_seed(root, {})


def _enc_key(root: str):
    return [_file_sha(_corpus_path(root))]


def _enc_blocks(path: str) -> Iterator[Tuple[int, bytes]]:
    with open(path, "rb") as fh:
        data = fh.read()
    off = 0
    while off < len(data):
        end = data.find(b"\n", min(off + _BLOCK, len(data)) - 1)
        end = len(data) if end < 0 else end + 1
        yield off, data[off:end]
        off = end


def _enc_serve(root: str):
    import numpy as np

    from avenir_tpu_torch.native.ingest import EncodedBlockCache

    corpus = _corpus_path(root)
    cache = _ENC_CACHES.get(root)
    if cache is None:
        cache = EncodedBlockCache([corpus], cache_dir=_p(root, "enc"),
                                  byte_budget=1 << 30)
        _ENC_CACHES[root] = cache
    if not cache.valid:
        _ENC_BUILDS[root] = _ENC_BUILDS.get(root, 0) + 1
        cache.begin()
        cache.set_source(0)
        for off, data in _enc_blocks(corpus):
            cache.note_block(off, data)
            rows = [r for r in data.split(b"\n") if r]
            counts = np.array([r.count(b",") + 1 for r in rows],
                              dtype=np.int32)
            codes = np.array([len(f) for r in rows
                              for f in r.split(b",")], dtype=np.int32)
            cache.add_block(counts, codes)
        if not cache.commit():
            raise KeysAuditError("encoded-block cache refused commit "
                                 "on an unchanged source")
    h = hashlib.sha1()
    for counts, codes in cache.blocks():
        h.update(counts.tobytes())
        h.update(codes.tobytes())
    return h.hexdigest()


def _enc_warm_proof(root: str) -> bool:
    before = _ENC_BUILDS.get(root, 0)
    _enc_serve(root)
    return _ENC_BUILDS.get(root, 0) == before


# ------------------------------------------------------ ledger driver
def _led_seed(root: str) -> None:
    _write(_p(root, "corpus.csv"), "r1,10,a\nr2,20,b\nr3,30,c\n")
    _write(_p(root, "meta.json"),
           json.dumps({"corpus": "corpus.csv", "worker": "0"}))
    _write(_p(root, "conf.json"), json.dumps({}, indent=1))
    _led_serve(root)


def _led_ns(root: str) -> str:
    return _file_sha(_corpus_path(root))[:8]


def _led_handle(root: str, name: str = "led"):
    from avenir_tpu_torch.dist.ledger import BlockLedger

    return BlockLedger(_p(root, name)).level(_led_ns(root))


def _led_key(root: str):
    return [_led_ns(root), 1]


def _led_blob(root: str) -> bytes:
    with open(_corpus_path(root), "rb") as fh:
        return b"state:" + fh.read()


def _led_serve(root: str):
    # the documented version-skew recovery (ledger.load_state): a
    # states dir whose marker mismatches serves NOTHING and accepts no
    # commit the reader could trust — the driver starts a fresh ledger
    # root and recomputes there (the go-cold half of the contract)
    for name in ("led", "led.cold"):
        led = _led_handle(root, name)
        if 1 in led.committed():
            return hashlib.sha1(led.load_state(1)).hexdigest()
        blob = _led_blob(root)
        if led.commit(1, int(_meta(root).get("worker", "0")), blob):
            return hashlib.sha1(blob).hexdigest()
        if 1 in led.committed():    # lost to a racing winner: serve it
            return hashlib.sha1(led.load_state(1)).hexdigest()
    raise KeysAuditError(
        "ledger driver: commit refused in a fresh ledger root")


def _led_warm_proof(root: str) -> bool:
    return 1 in _led_handle(root).committed()


def _led_stamp(root: str) -> None:
    from avenir_tpu_torch.dist.ledger import STATES_FORMAT

    _stamp_manifest(_p(root, "led", "ledger", _led_ns(root), "states",
                       STATES_FORMAT))


# -------------------------------------------------- score model driver
def _score_model_path(root: str) -> str:
    return _p(root, "mst_model.txt")


def _score_conf(root: str) -> Dict[str, str]:
    """The SCORING view of conf.json — the knobs model_tuple folds as
    kind dims (the same names the batch classifier reads)."""
    conf = _conf(root)
    return {"field.delim": ",",
            "class.labels": conf.get("class.labels", "T,F"),
            "log.odds.threshold": conf.get("log.odds.threshold", "0"),
            "skip.field.count": conf.get("skip.field.count", "2")}


def _score_train(root: str) -> None:
    from avenir_tpu_torch.runner import run_job

    run_job("markovStateTransitionModel", dict(_MST_CONF),
            [_corpus_path(root)], output=_score_model_path(root),
            device=_RUN["device"])


def _score_seed(root: str) -> None:
    _write(_p(root, "corpus.csv"), "\n".join(_seq_rows(0, 120)) + "\n")
    _write(_p(root, "meta.json"), json.dumps({"corpus": "corpus.csv"}))
    _write(_p(root, "conf.json"),
           json.dumps({"class.labels": "T,F",
                       "log.odds.threshold": "0",
                       "skip.field.count": "2"}, indent=1))
    _score_train(root)


def _score_key(root: str):
    from avenir_tpu_torch.server.score import model_cache_key

    return list(model_cache_key("markov", _score_model_path(root),
                                _score_conf(root)))


def _score_rows(root: str) -> List[str]:
    with open(_corpus_path(root), encoding="utf-8") as fh:
        return [ln.strip() for ln in fh if ln.strip()][:3]


def _score_serve(root: str):
    from avenir_tpu_torch.models.artifact import ModelFormatSkew
    from avenir_tpu_torch.server.score import score_once

    model, conf = _score_model_path(root), _score_conf(root)

    def compute():
        try:
            return [score_once("markov", model, row, conf,
                               device=_RUN["device"])
                    for row in _score_rows(root)]
        except ModelFormatSkew:
            # the documented recovery for a version-skewed artifact:
            # REFUSE the load, go cold — retrain over the current
            # corpus (save restamps at this build's version) and score
            # the fresh artifact
            _score_train(root)
            return [score_once("markov", model, row, conf,
                               device=_RUN["device"])
                    for row in _score_rows(root)]

    return _memo_serve(root, "scorecache.json", _score_key(root), compute)


def _score_retrain(root: str) -> None:
    # the seed walks L->M->H cyclically; these walk H->M->L, so the
    # transition mass actually moves and the artifact BYTES change
    # (an append that re-trains to the same matrix is not a retrain)
    rows = [f"x{i}," + ("T" if i % 2 else "F") + ","
            + _DELIM.join(("H", "M", "L")[(i + j) % 3]
                          for j in range(6))
            for i in range(30)]
    _append_corpus_rows(root, rows)
    _score_train(root)


def _score_touch_model(root: str) -> None:
    os.utime(_score_model_path(root), (946684800, 946684800))


def _score_stamp(root: str) -> None:
    from avenir_tpu_torch.models.artifact import stamp_path

    _stamp_manifest(stamp_path(_score_model_path(root)))


# --------------------------------------------------------- the registry
def _perturb(name: str, kind: str,
             apply: Callable[[str], None]) -> KeyPerturb:
    return KeyPerturb(name=name, kind=kind, apply=apply)


def _set(key: str, value: str) -> Callable[[str], None]:
    return lambda root: _set_conf(root, key, value)


#: Every registered cache-key surface, one entry per annotated
#: ``key_site``. The perturbation lists are the REGISTERED input
#: dimensions: the auditor moves each one at a time and holds the key
#: to its contract. Deliberately excluded dimensions are documented at
#: the key function (``key-covered:`` lines), not here.
KEY_SITES: List[KeySite] = [
    # The sidecar dataset directory: parse view (delimiter, schema
    # content, block size) names the dir; content validity is the
    # manifest's per-block fingerprint re-proof. The budget knob and
    # an mtime touch are view-neutral.
    KeySite(
        name="sidecar.dataset",
        path="avenir_tpu_torch/native/sidecar.py",
        seed=_sc_dataset_seed,
        key=_sc_dataset_key,
        serve=_sc_dataset_serve,
        perturbs=(
            _perturb("conf:block", "affecting", _set("block", "4096")),
            _perturb("schema:content", "affecting", _edit_schema),
            _perturb("corpus:content", "affecting", _edit_corpus_row),
            _perturb("corpus:mtime", "neutral", _touch_corpus),
            _perturb("manifest:format_version", "format",
                     _sc_dataset_stamp),
        ),
        warm_proof=_sc_warm_proof(_sc_dataset_serve)),
    # The sidecar bytes directory: skip count and delimiter shape the
    # parse view; the byte budget does not.
    KeySite(
        name="sidecar.bytes",
        path="avenir_tpu_torch/native/sidecar.py",
        seed=_sc_bytes_seed,
        key=_sc_bytes_key,
        serve=_sc_bytes_serve,
        perturbs=(
            _perturb("conf:skip", "affecting", _set("skip", "1")),
            _perturb("conf:delim", "affecting", _set("delim", ";")),
            _perturb("corpus:content", "affecting", _edit_corpus_row),
            _perturb("corpus:mtime", "neutral", _touch_corpus),
        ),
        warm_proof=_sc_warm_proof(_sc_bytes_serve)),
    # The incremental checkpoint manifest: conf_digest (every
    # non-neutral property) + the corpus content the fingerprints
    # re-prove. The autotune control keys are the registered neutral
    # dimension — the reason VIEW_NEUTRAL_KEYS exists.
    KeySite(
        name="checkpoint.manifest",
        path="avenir_tpu_torch/core/keys.py",
        seed=_ckpt_seed,
        key=_ckpt_key,
        serve=_ckpt_serve,
        perturbs=(
            _perturb("conf:mst.class.labels", "affecting",
                     _set("mst.class.labels", "F,T")),
            _perturb("corpus:append", "affecting",
                     lambda root: _append_corpus_rows(
                         root, _seq_rows(120, 30))),
            _perturb("conf:stream.autotune.dir", "neutral",
                     _set("stream.autotune.dir", "elsewhere")),
            _perturb("manifest:format_version", "format", _ckpt_stamp),
        )),
    # The warm miner source identity: scan-shaping config + corpus
    # paths; content validity is the encoded cache's own per-block
    # gate. Mining parameters are documented exclusions (key-covered:
    # at source_tuple), so they are not registered dimensions here.
    KeySite(
        name="warm.miner",
        path="avenir_tpu_torch/core/keys.py",
        seed=_miner_seed,
        key=_miner_key,
        serve=_miner_serve,
        perturbs=(
            _perturb("conf:fia.skip.field.count", "affecting",
                     _set("fia.skip.field.count", "3")),
            _perturb("conf:fia.infreq.item.marker", "affecting",
                     _set("fia.infreq.item.marker", "RARE")),
            _perturb("corpus:content", "affecting", _edit_corpus_row),
            _perturb("conf:stream.autotune.dir", "neutral",
                     _set("stream.autotune.dir", "elsewhere")),
        ),
        warm_proof=_memo_proof("warmcache.json", _miner_serve)),
    # The warm sidecar pin key: the dir basename IS the parse-view
    # digest, so parse config changes repin; fold parameters and the
    # byte budget do not.
    KeySite(
        name="warm.sidecar.pin",
        path="avenir_tpu_torch/server/jobserver.py",
        seed=_pin_seed,
        key=_pin_key,
        serve=_pin_serve,
        perturbs=(
            _perturb("conf:fia.skip.field.count", "affecting",
                     _set("fia.skip.field.count", "1")),
            _perturb("corpus:content", "affecting", _edit_corpus_row),
            _perturb("conf:fia.support.threshold", "neutral",
                     _set("fia.support.threshold", "0.5")),
            _perturb("conf:stream.sidecar.budget.mb", "neutral",
                     _set("stream.sidecar.budget.mb", "32")),
        ),
        warm_proof=_sc_warm_proof(_pin_serve)),
    # The exec-coalesce key: conf_digest means EVERY non-neutral
    # property is view-affecting; the two view-neutral families must
    # keep the key — the live proof of the VIEW_NEUTRAL_KEYS registry.
    KeySite(
        name="exec.coalesce",
        path="avenir_tpu_torch/server/jobserver.py",
        seed=_exec_seed,
        key=_exec_key,
        serve=_exec_serve,
        perturbs=(
            _perturb("conf:fia.support.threshold", "affecting",
                     _set("fia.support.threshold", "0.5")),
            _perturb("corpus:content", "affecting", _edit_corpus_row),
            _perturb("conf:stream.autotune.dir", "neutral",
                     _set("stream.autotune.dir", "elsewhere")),
            _perturb("conf:stream.incremental.state.dir", "neutral",
                     _set("stream.incremental.state.dir",
                          "elsewhere")),
        ),
        warm_proof=_memo_proof("execcache.json", _exec_serve)),
    # The compat batching key: block size and delimiter split batches;
    # mining parameters deliberately do NOT (two different fold params
    # ride one SharedScan) — the mirror image of exec.coalesce.
    KeySite(
        name="compat.batch",
        path="avenir_tpu_torch/core/keys.py",
        seed=_compat_seed,
        key=_compat_key,
        serve=_compat_serve,
        perturbs=(
            _perturb("conf:stream.block.size.mb", "affecting",
                     _set("stream.block.size.mb", "0.004")),
            _perturb("conf:field.delim.in", "affecting",
                     _set("field.delim.in", ";")),
            _perturb("corpus:content", "affecting", _edit_corpus_row),
            _perturb("conf:fia.support.threshold", "neutral",
                     _set("fia.support.threshold", "0.5")),
        ),
        warm_proof=_memo_proof("compatcache.json", _compat_serve)),
    # The autotune profile key: (job, corpus paths) — content-
    # independent BY DESIGN (the profile follows a corpus through
    # appends), so a content append is the registered neutral
    # dimension and a path move is affecting.
    KeySite(
        name="autotune.profile",
        path="avenir_tpu_torch/core/keys.py",
        seed=_prof_seed,
        key=_prof_key,
        serve=_prof_serve,
        perturbs=(
            _perturb("corpus:path", "affecting", _prof_move_corpus),
            _perturb("meta:job", "affecting",
                     lambda root: _set_meta(
                         root, "job", "numericalAttrStats")),
            _perturb("corpus:append", "neutral",
                     lambda root: _append_corpus_rows(root,
                                                      ["g,h,i"])),
            _perturb("manifest:format_version", "format", _prof_stamp),
        )),
    # The encoded-block cache replay identity: per-block CONTENT
    # fingerprints — an mtime touch must replay,
    # a content edit must rebuild.
    KeySite(
        name="cache.fingerprint",
        path="avenir_tpu_torch/native/ingest.py",
        seed=_enc_seed,
        key=_enc_key,
        serve=_enc_serve,
        perturbs=(
            _perturb("corpus:content", "affecting", _edit_corpus_row),
            _perturb("corpus:mtime", "neutral", _touch_corpus),
        ),
        warm_proof=_enc_warm_proof),
    # The served-model warm identity (the score plane's ModelCache):
    # artifact CONTENT digest + stamped format version + classifier
    # dims — a retrain or a conf change misses, an mtime touch hits,
    # a foreign restamp refuses-and-goes-cold (retrain + restamp).
    KeySite(
        name="score.model",
        path="avenir_tpu_torch/core/keys.py",
        seed=_score_seed,
        key=_score_key,
        serve=_score_serve,
        perturbs=(
            _perturb("model:retrain", "affecting", _score_retrain),
            _perturb("conf:log.odds.threshold", "affecting",
                     _set("log.odds.threshold", "5")),
            _perturb("model:mtime", "neutral", _score_touch_model),
            _perturb("stamp:format_version", "format", _score_stamp),
        ),
        warm_proof=_memo_proof("scorecache.json", _score_serve)),
    # The ledger committed-state identity: the path IS the key
    # (namespace + block id), first-commit-wins pins the bytes; the
    # committing worker's id is the registered neutral dimension.
    KeySite(
        name="ledger.committed",
        path="avenir_tpu_torch/dist/ledger.py",
        seed=_led_seed,
        key=_led_key,
        serve=_led_serve,
        perturbs=(
            _perturb("corpus:content", "affecting", _edit_corpus_row),
            _perturb("meta:worker", "neutral",
                     lambda root: _set_meta(root, "worker", "7")),
            _perturb("states:format_version", "format", _led_stamp),
        ),
        warm_proof=_led_warm_proof),
]


# --------------------------------------------------------------------------
# the audit
# --------------------------------------------------------------------------
def audit_keys(sites: Optional[Sequence[KeySite]] = None,
               locations: Optional[Dict[str, Tuple[str, int]]] = None,
               device: str = "cuda") -> Tuple[List[dict], List[Finding]]:
    """Drive the seed/perturb/serve probe for every registered key
    site. Per site: seed a fresh root, prove the driver re-serves its
    own bytes deterministically, then per registered perturbation —
    seed, cold-fill, perturb IN PLACE (the warm cache stays), key and
    serve again, and cold-recompute the perturbed view in a separate
    root. A view-affecting perturbation must change the key and the
    warm-path serve must equal the cold recompute (same key +
    different cold bytes = ``keys-stale-serve``); a view-neutral one
    must keep the key and warm-hit byte-identically; a format
    perturbation must refuse-and-go-cold. Returns (rows, findings):
    one row per site with per-kind perturbation counts, one finding
    per failed site. Infrastructure failures raise
    :class:`KeysAuditError`. The drivers' jobs run on `device`."""
    _open_device(device, KeysAuditError)
    _RUN["device"] = device
    sites = list(sites) if sites is not None else list(KEY_SITES)
    locations = locations or {}
    rows: List[dict] = []
    findings: List[Finding] = []
    base = tempfile.mkdtemp(prefix="avenir_keys_")
    try:
        for site in sites:
            loc = locations.get(site.name)
            site_dir = os.path.join(base, site.name.replace(".", "_"))
            broot = os.path.join(site_dir, "base")
            os.makedirs(broot, exist_ok=True)
            try:
                site.seed(broot)
                k0 = _canon(site.key(broot))
                b0 = _canon(site.serve(broot))
                b0w = _canon(site.serve(broot))
            except KeysAuditError:
                raise
            except Exception as exc:
                raise KeysAuditError(
                    f"key site {site.name}: driver failed: "
                    f"{type(exc).__name__}: {exc}") from exc
            if b0w != b0:
                raise KeysAuditError(
                    f"key site {site.name}: driver does not re-serve "
                    f"its own bytes deterministically (key {k0})")
            counts = {"affecting": 0, "neutral": 0, "format": 0}
            problems: List[str] = []
            failing: Optional[str] = None
            for n, p in enumerate(site.perturbs):
                warm = os.path.join(site_dir, f"p{n:02d}_warm")
                cold = os.path.join(site_dir, f"p{n:02d}_cold")
                os.makedirs(warm, exist_ok=True)
                os.makedirs(cold, exist_ok=True)
                try:
                    site.seed(warm)
                    ka = _canon(site.key(warm))
                    sa = _canon(site.serve(warm))    # the cold fill
                    p.apply(warm)
                    kb = _canon(site.key(warm))
                    sb = _canon(site.serve(warm))    # over the warm cache
                    site.seed(cold)
                    if p.kind != "format":
                        # a format perturbation corrupts the WARM
                        # cache's manifest; the view is unchanged, so
                        # the cold reference is a plain cold serve
                        p.apply(cold)
                    sc_ = _canon(site.serve(cold))   # the cold recompute
                except KeysAuditError:
                    raise
                except Exception as exc:
                    raise KeysAuditError(
                        f"key site {site.name}: perturbation "
                        f"{p.name} ({p.kind}) crashed the driver: "
                        f"{type(exc).__name__}: {exc}") from exc
                counts[p.kind] += 1
                pproblems: List[str] = []
                if p.kind == "affecting":
                    if kb == ka:
                        pproblems.append(
                            "view-affecting perturbation left the key "
                            "unchanged — the key cannot see this "
                            "dimension")
                    if sb != sc_:
                        pproblems.append(
                            "stale serve: bytes served over the warm "
                            "cache differ from a cold recompute of "
                            "the perturbed view")
                elif p.kind == "neutral":
                    if kb != ka:
                        pproblems.append(
                            "spurious miss: view-neutral perturbation "
                            "changed the key — every such change "
                            "re-scans cold for nothing")
                    if sb != sa:
                        pproblems.append(
                            "view-neutral perturbation changed the "
                            "served bytes")
                    elif site.warm_proof is not None \
                            and not site.warm_proof(warm):
                        pproblems.append(
                            "spurious miss: view-neutral perturbation "
                            "forced a cold recompute (warm hit not "
                            "proven)")
                else:                                # format
                    if sb != sc_:
                        pproblems.append(
                            "version-skewed cache still served: bytes "
                            "differ from a cold recompute (the "
                            "refuse-and-go-cold contract)")
                shutil.rmtree(warm, ignore_errors=True)
                shutil.rmtree(cold, ignore_errors=True)
                if pproblems:
                    failing = p.name
                    problems.append(
                        f"perturbation {p.name} ({p.kind}): "
                        + "; ".join(pproblems))
                    break        # first failing perturbation is THE repro
            validated = not problems
            rows.append({"site": site.name,
                         "path": loc[0] if loc else site.path,
                         "line": loc[1] if loc else 1,
                         "perturbations": dict(counts),
                         "failing_perturbation":
                             f"{site.name}:{failing}" if failing
                             else None,
                         "key_validated": validated})
            if not validated:
                findings.append(Finding(
                    loc[0] if loc else site.path,
                    loc[1] if loc else 1,
                    KEYS_AUDIT_RULE,
                    f"key site `{site.name}` failed perturbation "
                    f"audit: {'; '.join(problems)}",
                    "fold the failing dimension into the key (or "
                    "re-prove content before serving); never "
                    "allowlist a stale serve",
                    site.name))
    finally:
        _enc_reset()
        shutil.rmtree(base, ignore_errors=True)
    return rows, findings


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------
def run_keys(paths: Optional[Sequence[str]] = None,
             rules: Optional[Sequence[KeysRule]] = None,
             baseline: Optional[Sequence[BaselineEntry]] = None,
             root: Optional[str] = None, include_md: bool = True,
             audit: bool = True,
             sites: Optional[Sequence[KeySite]] = None,
             device: str = "cuda") -> Report:
    """Lint `paths` (default: the cache surface) with the keys rules,
    drive the perturbation auditor over the registered sites (default:
    KEY_SITES, after the key_site registry cross-check) with their jobs
    on `device`, and apply the
    allowlist baseline to the RULE findings only —
    ``keys-stale-serve`` findings are appended after the baseline pass
    and can never be suppressed."""
    active = list(rules) if rules is not None else \
        [r() for r in ALL_KEYS_RULES]
    root = os.path.abspath(root or os.getcwd())
    scan = list(paths) if paths else default_keys_paths(root)
    report, raw = collect_findings(scan, active, root, include_md)
    audit_findings: List[Finding] = []
    if audit:
        locations: Dict[str, Tuple[str, int]] = {}
        if sites is None:
            locations = check_key_registry()
        rows, audit_findings = audit_keys(sites=sites,
                                          locations=locations,
                                          device=device)
        report.key_audit.extend(rows)
    active_ids = {r.rule_id for r in active}
    apply_baseline(report, raw, baseline, active_ids)
    # the never-baselined contract: stale-serve findings join findings
    # AFTER the allowlist pass, so no entry can ever suppress one
    report.findings.extend(audit_findings)
    return report
