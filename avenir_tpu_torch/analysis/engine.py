"""The auditors' engine: source discovery, AST context, allowlist, runner.

The port of `avenir_tpu/analysis/engine.py` without its jit helpers
(they serve only the JAX rules of the reference's `rules.py`, which are
not ported); `ModuleContext.compiled_names` takes their place for the
host-sync rule.
Every rule is a lexical pattern over one module's AST plus import-alias
resolution. Findings are keyed ``path::rule::scope`` (scope: the dotted
enclosing class and function, ``<module>`` at the top), not by line, so
an allowlist entry survives unrelated edits to its file. Markdown files
contribute their ```python fences.

The port keeps its own allowlist, `audit_baseline.txt` beside this
file: one ``key -- justification`` a line.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

_FENCE = re.compile(r"```python[ \t]*\n(.*?)```", re.DOTALL)

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef)

#: wrappers whose result is a compiled device callable
_COMPILERS = {"jax.jit", "jit", "torch.compile", "torch.jit.script"}


@dataclass(frozen=True)
class Finding:
    """One rule hit: location, rule id, message and a fix hint."""

    path: str          # posix path relative to the scan root
    line: int
    rule: str
    message: str
    hint: str
    scope: str         # dotted enclosing def/class chain, '<module>' at top

    @property
    def key(self) -> str:
        """The allowlist identity (lines drift; scopes do not)."""
        return f"{self.path}::{self.rule}::{self.scope}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} [{self.scope}] "
                f"{self.message}\n    fix: {self.hint}")

    def to_json(self) -> dict:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "scope": self.scope, "message": self.message,
                "hint": self.hint, "key": self.key}


@dataclass
class BaselineEntry:
    key: str
    justification: str
    lineno: int
    used: int = 0


@dataclass
class Report:
    """One auditor run: the surviving findings and what the allowlist
    absorbed. `payload_audit` is filled by IR runs (a row a distributed
    family: the collective bytes its process group was handed, those it
    recorded and the model's), `invariance_audit` by flow runs (a row a
    stream entry: its chunk-layout and scheduler byte identity),
    `footprint_audit` by mem runs (measured RSS against the footprint
    model), `merge_audit` by merge runs (shard merge, resume,
    incremental and sharded-steal byte identity), `proto_audit` by proto
    runs (a row a commit site: its kill-injected recovery),
    `race_audit` by race runs (a row an interleave site: its schedules)
    and `key_audit` by keys runs (a row a key site: its perturbations);
    the keys are in every JSON report, so one schema parses them all."""

    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    stale: List[BaselineEntry] = field(default_factory=list)
    scanned: List[str] = field(default_factory=list)
    errors: List[Finding] = field(default_factory=list)
    payload_audit: List[dict] = field(default_factory=list)
    invariance_audit: List[dict] = field(default_factory=list)
    footprint_audit: List[dict] = field(default_factory=list)
    merge_audit: List[dict] = field(default_factory=list)
    proto_audit: List[dict] = field(default_factory=list)
    race_audit: List[dict] = field(default_factory=list)
    key_audit: List[dict] = field(default_factory=list)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    @property
    def clean(self) -> bool:
        return not self.findings and not self.stale and not self.errors

    def to_json(self) -> dict:
        return {
            "findings": [f.to_json() for f in self.findings],
            "counts": self.counts(),
            "suppressed": len(self.suppressed),
            "stale_baseline_entries": [e.key for e in self.stale],
            "errors": [f.to_json() for f in self.errors],
            "files_scanned": len(self.scanned),
            "payload_audit": self.payload_audit,
            "invariance_audit": self.invariance_audit,
            "footprint_audit": self.footprint_audit,
            "merge_audit": self.merge_audit,
            "proto_audit": self.proto_audit,
            "race_audit": self.race_audit,
            "key_audit": self.key_audit,
            "clean": self.clean,
        }


class ModuleContext:
    """A parsed module and the lookups every rule needs: parent links,
    import-alias resolution, loop and scope ancestry, and the names bound
    to compiled callables."""

    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.aliases = self._collect_aliases(tree)
        self.compiled_names = self._collect_compiled_names(tree)

    @staticmethod
    def _collect_aliases(tree: ast.Module) -> Dict[str, str]:
        aliases: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        return aliases

    def _is_compiler(self, expr: ast.AST) -> bool:
        """`expr` wraps a function into a compiled callable: a compiler
        itself (``@torch.compile``), a call of one (``@jax.jit(...)``,
        ``torch.compile(f)``) or a ``functools.partial`` of one."""
        if self.dotted(expr) in _COMPILERS:
            return True
        if not isinstance(expr, ast.Call):
            return False
        callee = self.dotted(expr.func)
        if callee in _COMPILERS:
            return True
        return (callee in ("functools.partial", "partial") and bool(expr.args)
                and self.dotted(expr.args[0]) in _COMPILERS)

    def _collect_compiled_names(self, tree: ast.Module) -> Set[str]:
        """Names bound (at any nesting) to compiled callables: a def
        decorated by a compiler, and ``f = compiler(g)``."""
        names: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(self._is_compiler(d) for d in node.decorator_list):
                    names.add(node.name)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call) \
                    and self._is_compiler(node.value):
                names.add(node.targets[0].id)
        return names

    def dotted(self, node: ast.AST) -> Optional[str]:
        """The dotted name of an expression like ``np.random.choice``,
        import aliases resolved; None for any other expression."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        head = self.aliases.get(parts[0], parts[0])
        return ".".join([head] + parts[1:])

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(node)

    def in_loop(self, node: ast.AST) -> bool:
        """True when `node` runs once an iteration of a lexical loop (for,
        while, comprehension), up to its function. A `for`'s iterable and
        a comprehension's first source run once, so they do not count
        for the loop they feed (an enclosing loop still does)."""
        path = [node]
        cur = self.parent(node)
        while cur is not None:
            path.append(cur)
            cur = self.parent(cur)
        for i in range(1, len(path)):
            anc, below = path[i], path[i - 1]
            if isinstance(anc, _SCOPE_NODES):
                return False
            if isinstance(anc, (ast.For, ast.AsyncFor)):
                if below is not anc.iter:
                    return True
            elif isinstance(anc, ast.While):
                return True
            elif isinstance(anc, (ast.ListComp, ast.SetComp, ast.DictComp,
                                  ast.GeneratorExp)):
                gens = anc.generators
                if gens and gens[0].iter in path[:i]:
                    continue
                return True
        return False

    def scope_of(self, node: ast.AST) -> str:
        names: List[str] = []
        cur = self.parent(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                names.append(cur.name)
            cur = self.parent(cur)
        return ".".join(reversed(names)) if names else "<module>"

    def enclosing_functions(self, node: ast.AST) -> List[ast.FunctionDef]:
        """Function defs lexically around `node`, innermost first."""
        out: List[ast.FunctionDef] = []
        cur = self.parent(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(cur)
            cur = self.parent(cur)
        return out


# --------------------------------------------------------------- discovery
def iter_sources(paths: Sequence[str], include_md: bool = True
                 ) -> Iterator[Tuple[str, str, int]]:
    """(file path, python source, line offset) units to check: a
    directory walks recursively, a ``.py`` file is one unit at offset 0,
    a ``.md`` file one unit a ```python fence at the fence's offset."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if not d.startswith((".", "__pycache__")))
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames)
                             if f.endswith(".py")
                             or (include_md and f.endswith(".md")))
        else:
            files.append(p)
    for f in files:
        if f.endswith(".md"):
            if not include_md:
                continue
            text = open(f, encoding="utf-8").read()
            for m in _FENCE.finditer(text):
                yield f, m.group(1), text[:m.start(1)].count("\n")
        else:
            yield f, open(f, encoding="utf-8").read(), 0


# ---------------------------------------------------------------- baseline
def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "audit_baseline.txt")


def load_baseline(path: Optional[str] = None) -> List[BaselineEntry]:
    """The allowlist: one ``key -- justification`` a line, ``#``
    comments. A missing file is an empty allowlist."""
    path = path or default_baseline_path()
    entries: List[BaselineEntry] = []
    if not os.path.exists(path):
        return entries
    for i, raw in enumerate(open(path, encoding="utf-8"), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        key, sep, why = line.partition(" -- ")
        if not sep or not why.strip():
            raise ValueError(
                f"{path}:{i}: an allowlist entry needs a ' -- "
                f"justification' suffix (got {line!r})")
        if key.count("::") != 2:
            raise ValueError(
                f"{path}:{i}: an allowlist key is path::rule::scope "
                f"(got {key!r})")
        entries.append(BaselineEntry(key.strip(), why.strip(), i))
    return entries


# -------------------------------------------------------------------- run
def collect_findings(paths: Sequence[str], rules: Sequence,
                     root: Optional[str] = None, include_md: bool = True
                     ) -> Tuple[Report, List[Finding]]:
    """Parse `paths` and run `rules` over them: the partial report (the
    scanned files, parse errors) and the raw findings, before the
    allowlist splits them (an auditor appends its own findings first)."""
    root = os.path.abspath(root or os.getcwd())
    report = Report()
    raw: List[Finding] = []
    for file_path, source, offset in iter_sources(paths, include_md):
        rel = os.path.relpath(os.path.abspath(file_path), root)
        rel = rel.replace(os.sep, "/")
        if rel.startswith("../"):
            rel = file_path.replace(os.sep, "/")
        if rel not in report.scanned:
            report.scanned.append(rel)
        try:
            tree = ast.parse(source)
        except SyntaxError as e:
            report.errors.append(Finding(
                rel, offset + (e.lineno or 1), "parse-error",
                f"could not parse: {e.msg}", "fix the syntax error",
                "<module>"))
            continue
        if offset:
            ast.increment_lineno(tree, offset)
        ctx = ModuleContext(rel, tree)
        for rule in rules:
            raw.extend(rule.check(ctx))
    return report, raw


def run_paths(paths: Sequence[str], rules: Sequence,
              baseline: Optional[Sequence[BaselineEntry]] = None,
              root: Optional[str] = None, include_md: bool = True) -> Report:
    """Check `paths` with `rules` and split the findings by the
    allowlist."""
    report, raw = collect_findings(paths, rules, root, include_md)
    apply_baseline(report, raw, baseline, {r.rule_id for r in rules})
    return report


def apply_baseline(report: Report, raw: Sequence[Finding],
                   baseline: Optional[Sequence[BaselineEntry]],
                   active_ids: Set[str]) -> Report:
    """Split `raw` into surviving and allowlisted findings on `report`,
    and flag the stale entries: an entry is stale only when its file was
    scanned and its rule ran, so a subset of the rules condemns no
    other entry."""
    entries = list(baseline) if baseline is not None else []
    by_key: Dict[str, BaselineEntry] = {}
    for e in entries:
        by_key.setdefault(e.key, e)
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        hit = by_key.get(f.key)
        if hit is not None:
            hit.used += 1
            report.suppressed.append(f)
        else:
            report.findings.append(f)
    scanned = set(report.scanned)
    report.stale = [e for e in entries
                    if not e.used
                    and e.key.split("::")[0] in scanned
                    and e.key.split("::")[1] in active_ids]
    return report
