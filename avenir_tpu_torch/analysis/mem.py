"""The mem auditor: memory-footprint rules and the admission oracle.

The port of `avenir_tpu/analysis/mem.py`. Two layers:

- **Mem rules**, code shapes whose cost is O(corpus) rather than
  O(block): a fold carry that grows with the rows seen
  (``mem-unbounded-carry``), a temporary that materializes the whole
  stream (``mem-corpus-scaled-temporary``), an encoded-block spill with
  no byte budget (``mem-cache-spill-unbudgeted``), and a 64-bit widening
  of a block-sized array on a hot path (``mem-dtype-expansion-at-parse``).
  The array constructors they read are numpy's and torch's.
- **The footprint model and its audit**: `footprint_model` and
  `combined_footprint` sum a job's host byte terms (raw blocks in flight
  times the prefetch depth, the parse's column outputs, the CSR
  transients, the fold buffers, the miners' replay pages), the
  reference's terms one for one, so both packages price a request alike
  (the job server admits by them, `server.jobserver.price_request_bytes`).
  `audit_footprint` runs every stream entry through the real runner at
  two block sizes while `_RssSampler` reads `/proc/self/statm`, and holds
  the sampled peak inside the model's band; the byte-accounting hook of
  `core.stream` (`_bytes_hook`) holds the model's block term against the
  blocks that flowed. `memory_manifest` writes the oracle, with a row a
  CUDA kernel of the port (`kernel_device_entries`).

They are HOST terms: the port's device-resident state (the carries and
kernel workspaces on the card) is not priced; the admission budget is a
host RSS budget in both packages. On the card the audit opens the CUDA
context and binds the kernel libraries before it samples
(`_warm_device`): they add hundreds of MB of RSS to a process's first
run, which the model does not price and the slack is not for.

Findings go through the shared engine and allowlist. A job that fails
to run, or a host without procfs, raises :class:`MemAuditError` (the
CLI's exit 2); a peak outside the band is a finding under
``mem-footprint-model`` (exit 1), never allowlisted.
"""

from __future__ import annotations

import ast
import os
import shutil
import tempfile
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterator, List, Optional, Sequence, Set,
                    Tuple)

from avenir_tpu_torch.analysis.engine import (BaselineEntry, Finding,
                                              ModuleContext, Report,
                                              apply_baseline,
                                              collect_findings)
from avenir_tpu_torch.analysis.flow import _body_nodes, default_flow_paths

#: the audit's rule id: a sampled peak outside the model's band is a
#: finding under it (never allowlist one: an oracle that mispredicts
#: admits jobs that run out of memory)
MEM_AUDIT_RULE = "mem-footprint-model"

#: allocator slack of the band (bytes): what a warmed-up process may
#: grow by during one streamed job with the model right (glibc arenas,
#: numpy's and torch's pools)
AUDIT_SLACK_BYTES = 48 << 20
#: non-vacuity: the prediction must stay within this multiple of the
#: measured peak plus the slack
AUDIT_TIGHTNESS = 8.0
#: block sizes (MB) the audit measures at: the model's dominant term
#: (blocks in flight) differs 8x between them on the inflated corpus
DEFAULT_AUDIT_BLOCKS_MB = (0.5, 0.0625)
#: the proxy corpus is replicated up to this size, so the block terms
#: dominate the schema's constants at both sizes
AUDIT_CORPUS_BYTES = 1 << 20

#: iterator factories whose `for` loops are streamed chunk loops for the
#: mem rules: flow's, and the miners' per-k feeds, where corpus-sized
#: state would hide
_MEM_FOLD_TAILS = {
    "double_buffered", "prefetched", "stream_job_inputs",
    "stream_job_lines", "stream_job_byte_blocks", "iter_csv_chunks",
    "iter_byte_blocks", "iter_line_blocks", "scan_encode_blocks",
    "chunks", "packed_chunks", "_dense_chunks", "_row_blocks",
    "_line_blocks", "blocks",
}

_64BIT_DTYPES = {"int64", "float64", "uint64", "complex128", "longdouble"}


class MemAuditError(RuntimeError):
    """A streamed job could not be prepared or run, or the resident bytes
    cannot be sampled (no Linux procfs)."""


# --------------------------------------------------------------------------
# shared AST helpers
# --------------------------------------------------------------------------
def _mem_fold_loops(ctx: ModuleContext) -> Iterator[ast.For]:
    """`for` statements iterating a streamed chunk source (the widened
    tail set above) — the loops whose per-iteration state must stay
    O(block)."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.For, ast.AsyncFor)):
            continue
        for sub in ast.walk(node.iter):
            if isinstance(sub, ast.Call):
                name = ctx.dotted(sub.func)
                if name is not None \
                        and name.rpartition(".")[2] in _MEM_FOLD_TAILS:
                    yield node
                    break


def _bind_key(node: ast.AST) -> Optional[str]:
    """Identifier key of a binding/receiver: plain names as ``name``,
    self-attributes as ``.attr`` (the flow tier's keying)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return "." + node.attr
    return None


def _is_empty_container(value: ast.AST) -> bool:
    if isinstance(value, (ast.List, ast.Dict, ast.Set)) \
            and not getattr(value, "elts", getattr(value, "keys", ())):
        return True
    if isinstance(value, ast.Call) and isinstance(value.func, ast.Name) \
            and value.func.id in ("list", "dict", "set") and not value.args:
        return True
    return False


def _empty_inits_before(owner: ast.AST, loop: ast.For) -> Set[str]:
    """Names bound to an EMPTY container in `owner` (not nested defs) at a
    statement starting before `loop` — the carries the loop could grow."""
    out: Set[str] = set()
    stack = list(ast.iter_child_nodes(owner))
    while stack:
        node = stack.pop()
        if node is loop or isinstance(node, (ast.FunctionDef,
                                             ast.AsyncFunctionDef,
                                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))
        if getattr(node, "lineno", 10 ** 9) >= loop.lineno:
            continue
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        else:
            continue
        if not _is_empty_container(node.value):
            continue
        for t in targets:
            key = _bind_key(t)
            if key is not None:
                out.add(key)
    return out


_GROW_METHODS = {"append", "extend", "update", "add"}
_DRAIN_METHODS = {"clear", "pop", "popitem", "popleft"}


def _loop_growths(loop: ast.For) -> Iterator[Tuple[str, ast.AST]]:
    """(carry key, mutation node) for every growth of a name/self-attr in
    the loop body: ``X.append/extend/update/add``, ``X += ...`` and
    ``X[k] = ...`` (a dict keyed by stream values grows too).
    Subscript receivers fall through to their base name, so
    ``tids[ci].append(...)`` charges ``tids``."""
    for node in _body_nodes(loop):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr in _GROW_METHODS:
            base = node.func.value
            if isinstance(base, ast.Subscript):
                base = base.value
            key = _bind_key(base)
            if key is not None:
                yield key, node
        elif isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Add):
            key = _bind_key(node.target)
            if key is not None:
                yield key, node
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    key = _bind_key(t.value)
                    if key is not None:
                        yield key, node


def _loop_drains(loop: ast.For) -> Set[str]:
    """Carry keys the loop body also RESETS or SHRINKS (reassignment,
    slice-reassignment, clear/pop, del): bounded buffers, not carries —
    the page buffer `buf.extend(rows); buf = buf[block_rows:]` shape."""
    out: Set[str] = set()
    for node in _body_nodes(loop):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                key = _bind_key(t)
                if key is not None:
                    out.add(key)
        elif isinstance(node, ast.Call) and isinstance(node.func,
                                                       ast.Attribute) \
                and node.func.attr in _DRAIN_METHODS:
            key = _bind_key(node.func.value)
            if key is not None:
                out.add(key)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                base = t.value if isinstance(t, ast.Subscript) else t
                key = _bind_key(base)
                if key is not None:
                    out.add(key)
    return out


def _loop_owner(ctx: ModuleContext, loop: ast.For) -> ast.AST:
    owners = ctx.enclosing_functions(loop)
    return owners[0] if owners else ctx.tree


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------
class MemRule:
    rule_id: str = ""
    description: str = ""
    hint: str = ""

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: ModuleContext, node: ast.AST, message: str,
                hint: Optional[str] = None) -> Finding:
        return Finding(ctx.path, getattr(node, "lineno", 1), self.rule_id,
                       message, hint or self.hint, ctx.scope_of(node))


class UnboundedCarryRule(MemRule):
    """A container initialized empty BEFORE a streamed fold loop and
    grown inside it (append/extend/update/``+=``/keyed assignment)
    without ever being drained in the loop. Its size tracks rows SEEN,
    not rows per chunk — the fold's host RSS is O(corpus) and the
    O(block) contract the 1B-row path advertises is silently gone.
    Buffers the loop also reassigns/slices/clears are bounded and stay
    silent."""

    rule_id = "mem-unbounded-carry"
    description = "fold carry grows with rows seen, not with the chunk"
    hint = ("fold a fixed-size sufficient statistic instead (counts, "
            "moments — the NaiveBayesModel.accumulate algebra), write "
            "per-chunk results out as you go, or drain the buffer inside "
            "the loop; allowlist only when the corpus-sized output IS the "
            "job's contract")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for loop in _mem_fold_loops(ctx):
            owner = _loop_owner(ctx, loop)
            carries = _empty_inits_before(owner, loop)
            if not carries:
                continue
            drains = _loop_drains(loop)
            seen: Set[str] = set()
            for key, node in _loop_growths(loop):
                if key not in carries or key in drains or key in seen:
                    continue
                seen.add(key)
                yield self.finding(
                    ctx, node,
                    f"`{key.lstrip('.')}` is grown once per streamed "
                    f"chunk and never drained: the fold carry scales "
                    f"with rows seen, so host RSS is O(corpus), not "
                    f"O(block)")


class CorpusScaledTemporaryRule(MemRule):
    """``np.concatenate``/``vstack``/``hstack``/``stack`` (or
    ``np.array``/``np.asarray``, ``torch.cat``/``tensor``/``as_tensor``)
    over a list that a streamed fold loop appends to: one expression that
    materializes the WHOLE stream as a single array, the corpus-sized
    buffer the streaming layer exists to avoid."""

    rule_id = "mem-corpus-scaled-temporary"
    description = "temporary proportional to the full corpus in a streamed fold"
    hint = ("reduce per chunk instead of collecting (fold the statistic, "
            "write results incrementally); if a whole-stream array is "
            "truly required, the job is not streamable — say so in its "
            "contract and allowlist with that justification")

    _MATERIALIZERS = {"concatenate", "vstack", "hstack", "stack", "array",
                      "asarray", "cat", "tensor", "as_tensor"}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for loop in _mem_fold_loops(ctx):
            owner = _loop_owner(ctx, loop)
            grown = {key for key, _ in _loop_growths(loop)} \
                - _loop_drains(loop)
            if not grown:
                continue
            for node in ast.walk(owner):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                name = ctx.dotted(node.func)
                if name is None:
                    continue
                mod, _, func = name.rpartition(".")
                if mod not in ("numpy", "torch") \
                        or func not in self._MATERIALIZERS:
                    continue
                arg = node.args[0]
                key = _bind_key(arg)
                if key in grown:
                    yield self.finding(
                        ctx, node,
                        f"np.{func}(`{key.lstrip('.')}`) materializes "
                        f"every streamed chunk as one array — a "
                        f"corpus-proportional temporary inside a "
                        f"streamed fold")


class CacheSpillUnbudgetedRule(MemRule):
    """An ``EncodedBlockCache`` constructed without an explicit
    ``byte_budget``. The spill cache writes region-compacted codes for
    EVERY block of the corpus; unbudgeted, a 1B-row scan spills O(corpus)
    bytes to disk (and the job server's cache pool grows without bound).
    The budget is cheap to pass — the cache evicts whole
    least-recently-replayed sources atomically when it is exceeded."""

    rule_id = "mem-cache-spill-unbudgeted"
    description = "EncodedBlockCache spill with no byte budget"
    hint = ("pass byte_budget= (the stream.encoded.cache.budget.mb "
            "config key is the job surface; native.ingest."
            "DEFAULT_CACHE_BUDGET_BYTES is the generous default), so "
            "the spill is bounded and evictable")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = ctx.dotted(node.func)
            if name is None \
                    or name.rpartition(".")[2] != "EncodedBlockCache":
                continue
            if len(node.args) >= 3 or any(kw.arg == "byte_budget"
                                          for kw in node.keywords):
                continue
            yield self.finding(
                ctx, node,
                "EncodedBlockCache(...) without byte_budget: the "
                "encoded-block spill grows with the corpus, unbounded "
                "and unevictable")


class DtypeExpansionAtParseRule(MemRule):
    """A 64-bit widening of an existing array on a hot path (lexically
    inside a loop): ``x.astype(np.int64/np.float64/float/int)`` or
    ``np.asarray/np.array(x, dtype=<64-bit>)``. Between parse and device
    every element is supposed to NARROW (codes int32, measures float32);
    an 8-byte widening of a block-proportional array doubles the very
    buffers the streaming layer exists to keep small. Fresh 64-bit
    ALLOCATIONS (``np.zeros(..., np.int64)`` count tensors) are a
    deliberate exact-algebra choice and stay silent — this rule is about
    conversions."""

    rule_id = "mem-dtype-expansion-at-parse"
    description = "64-bit widening of an array on a streamed hot path"
    hint = ("keep block-proportional arrays narrow end to end (int32 "
            "codes, float32 measures — the csr_region_mask form); widen "
            "only O(model)-sized results, outside the loop, or allowlist "
            "with the bound that makes the widening noise")

    _WRAPPERS = {"numpy.asarray", "numpy.array", "torch.as_tensor",
                 "torch.tensor"}

    def _dtype_is_wide(self, ctx: ModuleContext, node: ast.AST) -> bool:
        name = ctx.dotted(node)
        if name is not None:
            tail = name.rpartition(".")[2]
            return tail in _64BIT_DTYPES or name in ("float", "int")
        return isinstance(node, ast.Constant) \
            and str(node.value) in _64BIT_DTYPES

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not ctx.in_loop(node):
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "astype" and node.args:
                if self._dtype_is_wide(ctx, node.args[0]):
                    yield self.finding(
                        ctx, node,
                        ".astype(<64-bit>) inside a loop doubles a "
                        "block-proportional array on the hot path")
                continue
            name = ctx.dotted(node.func)
            if name not in self._WRAPPERS:
                continue
            dtype = next((kw.value for kw in node.keywords
                          if kw.arg == "dtype"), None)
            if dtype is None and len(node.args) > 1:
                dtype = node.args[1]
            if dtype is not None and self._dtype_is_wide(ctx, dtype):
                yield self.finding(
                    ctx, node,
                    f"{name.rpartition('.')[2]}(..., dtype=<64-bit>) "
                    f"inside a loop widens the array it wraps to 8-byte "
                    f"elements on the hot path")


ALL_MEM_RULES = [UnboundedCarryRule, CorpusScaledTemporaryRule,
                 CacheSpillUnbudgetedRule, DtypeExpansionAtParseRule]


def mem_rule_ids() -> List[str]:
    return [r.rule_id for r in ALL_MEM_RULES] + [MEM_AUDIT_RULE]


# --------------------------------------------------------------------------
# corpus statistics (what the analytic model derives its terms from)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class CorpusStats:
    """Cheap head-sample statistics of a CSV/sequence corpus: everything
    the footprint model needs, gathered without a full scan (the model
    must be usable BEFORE admission — that is its point)."""

    total_bytes: int
    rows: int                 # extrapolated from the sample's avg row
    avg_row_bytes: float
    avg_fields: float         # delimited fields per row (meta included)
    distinct_tokens: int      # non-leading-field vocab estimate (capped)

    def to_json(self) -> dict:
        return {"total_bytes": self.total_bytes, "rows": self.rows,
                "avg_row_bytes": round(self.avg_row_bytes, 2),
                "avg_fields": round(self.avg_fields, 2),
                "distinct_tokens": self.distinct_tokens}


#: corpus_stats of recent corpora, keyed by every path's size and mtime:
#: a streamed job prices its corpus at every run, and the jobs of a
#: fused scan, a server's batch or a pipeline share one
_STATS_CACHE: Dict[tuple, CorpusStats] = {}
_STATS_CACHE_MAX = 64


def corpus_stats(paths: Sequence[str], delim: str = ",",
                 sample_bytes: int = 256 << 10) -> CorpusStats:
    """Sample the head of the first input (whole lines only) and
    extrapolate; token vocabulary estimate excludes each row's leading
    field (ids never dictionary-encode) and caps at 4096. An unchanged
    corpus (every path's size and mtime) is sampled once a process."""
    files = []
    for p in paths:
        st = os.stat(p)
        files.append((os.path.abspath(p), st.st_size, st.st_mtime_ns))
    key = (tuple(files), delim, sample_bytes)
    stats = _STATS_CACHE.get(key)
    if stats is None:
        stats = _sample_stats(paths, delim, sample_bytes)
        if len(_STATS_CACHE) >= _STATS_CACHE_MAX:
            _STATS_CACHE.clear()
        _STATS_CACHE[key] = stats
    return stats


def _sample_stats(paths: Sequence[str], delim: str,
                  sample_bytes: int) -> CorpusStats:
    total = sum(os.path.getsize(p) for p in paths)
    with open(paths[0], "rb") as fh:
        head = fh.read(sample_bytes)
    cut = head.rfind(b"\n")
    if cut > 0:
        head = head[:cut + 1]
    lines = [ln for ln in head.decode("utf-8", "replace").split("\n")
             if ln.strip()]
    n = max(len(lines), 1)
    avg_row = max(len(head) / n, 1.0)
    fields = sum(ln.count(delim) + 1 for ln in lines) / n
    # the distinct trimmed tokens, capped: the raw tokens are gathered a
    # line at a time (one split and one set update, no Python a token),
    # then trimmed; min(distinct, 4096) is what a token-by-token scan
    # that stops at the cap counts
    raw: Set[str] = set()
    for ln in lines:
        raw.update(ln.split(delim)[1:])
    vocab = {tok.strip(" \t\r") for tok in raw}
    return CorpusStats(total_bytes=total, rows=int(total / avg_row),
                       avg_row_bytes=avg_row, avg_fields=max(fields, 1.0),
                       distinct_tokens=max(min(len(vocab), 4096), 1))


def _unbounded_stats(avg_row_bytes: float = 40.0, avg_fields: float = 8.0,
                     distinct_tokens: int = 64) -> CorpusStats:
    """Stats of a nominal corpus of unbounded size, so every
    block-proportional term prices a FULL block — the upper-bound posture
    an admission oracle needs when it has no corpus to sample."""
    return CorpusStats(total_bytes=1 << 62, rows=1 << 40,
                       avg_row_bytes=avg_row_bytes, avg_fields=avg_fields,
                       distinct_tokens=distinct_tokens)


# --------------------------------------------------------------------------
# analytic footprint model
# --------------------------------------------------------------------------
@dataclass
class FootprintEstimate:
    """One job's predicted peak incremental host bytes at one block size,
    decomposed into named terms so a drifted prediction is debuggable
    (which buffer grew?) instead of a bare number."""

    job: str
    block_bytes: int
    terms: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return int(sum(self.terms.values()))

    def to_json(self) -> dict:
        return {"job": self.job, "block_bytes": self.block_bytes,
                "predicted_peak_bytes": self.total_bytes,
                "predicted_peak_mb": round(self.total_bytes / (1 << 20), 2),
                "terms": {k: int(v) for k, v in sorted(self.terms.items())}}


def _pow2ceil(x: float, lo: int) -> int:
    return max(lo, 1 << max(int(x) - 1, 0).bit_length())


def _schema_cols(schema) -> Tuple[int, int, int]:
    """(numeric, categorical, string/id) column counts of a FeatureSchema
    (defaults approximate the churn shape when no schema is known)."""
    if schema is None:
        return 1, 5, 1
    n_num = sum(1 for f in schema if f.is_numeric)
    n_cat = sum(1 for f in schema if f.is_categorical)
    return n_num, n_cat, max(len(list(schema)) - n_num - n_cat, 0)


def _eff_block(stats: CorpusStats, block_bytes: int) -> int:
    """A block never exceeds the corpus: the reader cuts at EOF."""
    return max(1, min(int(block_bytes), stats.total_bytes))


#: default depth of the outer prefetched() job feeds (the
#: `stream.prefetch.depth` conf key; core.stream.DEFAULT_PREFETCH_DEPTH)
DEFAULT_MODEL_PREFETCH_DEPTH = 2


def _dataset_ingest(stats: CorpusStats, block_bytes: int, schema,
                    prefetch_depth: int = DEFAULT_MODEL_PREFETCH_DEPTH
                    ) -> Dict[str, int]:
    """Shared-schema Dataset ingest: CsvBlockReader's inner depth-1 byte
    prefetch (producer copy + queued + parsing = 3 raw blocks), the
    native parse writing float32/int32 column outputs plus the lazy
    string-column raw bytes, and the outer depth-D Dataset prefetch of
    stream_job_inputs (D queued + producing + consuming = D+2 parsed
    chunks; D is the `stream.prefetch.depth` key, default 2)."""
    eff = _eff_block(stats, block_bytes)
    rows = eff / stats.avg_row_bytes
    n_num, n_cat, n_str = _schema_cols(schema)
    depth = max(int(prefetch_depth), 1)
    parsed = rows * 4.0 * (n_num + n_cat) + 0.3 * eff * max(n_str, 1)
    return {
        "raw_blocks_in_flight": int(3 * eff),
        "parse_transient": int(parsed),
        "parsed_chunks_in_flight": int((depth + 2) * parsed),
        # columnar-sidecar transient, one block either way: the cold
        # pass serializes the parsed block before appending it to
        # columns.bin; the warm pass materializes one block's columns
        # from the replay read
        "sidecar_pages": int(eff),
    }


def _bytes_ingest(stats: CorpusStats, block_bytes: int,
                  prefetch_depth: int = DEFAULT_MODEL_PREFETCH_DEPTH
                  ) -> Dict[str, int]:
    """Raw byte-block ingest for the sequence-shaped jobs: depth-D
    outer prefetch (D queued + producing + consuming = D+2 raw blocks
    in flight; D = `stream.prefetch.depth`, default 2) plus the CSR
    encode transients — int32 codes + int32 row_of + bool region per
    token, int64 offsets/starts per row, and one decoded copy on the
    vocabulary-extension path. Without the native encoder every token
    becomes a Python string (~64B each), and the model says so."""
    eff = _eff_block(stats, block_bytes)
    rows = eff / stats.avg_row_bytes
    toks = rows * stats.avg_fields
    depth = max(int(prefetch_depth), 1)
    terms = {
        "raw_blocks_in_flight": int((depth + 2) * eff),
        "csr_transients": int(toks * 9 + rows * 16 + eff),
        # columnar-sidecar transient (write-side serialize / read-side
        # materialize of ONE block's encoded columns)
        "sidecar_pages": int(eff),
    }
    try:
        from avenir_tpu_torch.native.ingest import native_available
        native = native_available()
    except Exception:
        native = False
    if not native:
        terms["python_tokenize"] = int(toks * 64)
    return terms


def _model_nb(stats, block_bytes, schema,
              prefetch_depth=DEFAULT_MODEL_PREFETCH_DEPTH) -> Dict[str, int]:
    t = _dataset_ingest(stats, block_bytes, schema, prefetch_depth)
    rows = _eff_block(stats, block_bytes) / stats.avg_row_bytes
    n_num, n_cat, _ = _schema_cols(schema)
    # deferred-fold code matrix per chunk (host int32 + device copy)
    t["nb_fold_buffers"] = int(rows * 4 * (n_num + n_cat) * 2)
    t["nb_model_state"] = 1 << 20
    return t


def _model_mi(stats, block_bytes, schema,
              prefetch_depth=DEFAULT_MODEL_PREFETCH_DEPTH) -> Dict[str, int]:
    t = _dataset_ingest(stats, block_bytes, schema, prefetch_depth)
    rows = _eff_block(stats, block_bytes) / stats.avg_row_bytes
    # per-pair bincount keys (int64) and their intp cast, per chunk
    t["mi_pair_keys"] = int(rows * 8 * 2)
    t["mi_tables"] = 1 << 20
    return t


def _model_fisher(stats, block_bytes, schema,
                  prefetch_depth=DEFAULT_MODEL_PREFETCH_DEPTH
                  ) -> Dict[str, int]:
    t = _dataset_ingest(stats, block_bytes, schema, prefetch_depth)
    t["fisher_moments"] = 1 << 20
    return t


def _model_markov(stats, block_bytes, schema,
                  prefetch_depth=DEFAULT_MODEL_PREFETCH_DEPTH
                  ) -> Dict[str, int]:
    t = _bytes_ingest(stats, block_bytes, prefetch_depth)
    t["markov_counts"] = 1 << 20
    return t


def _miner_common(stats: CorpusStats, block_bytes: int,
                  prefetch_depth: int = DEFAULT_MODEL_PREFETCH_DEPTH
                  ) -> Dict[str, int]:
    """Pass-1 scan + spill write + per-k replay transients shared by both
    miners: the replay pass re-reads narrow codes + per-row counts and
    re-expands them to int32 working arrays."""
    t = _bytes_ingest(stats, block_bytes, prefetch_depth)
    eff = _eff_block(stats, block_bytes)
    rows = eff / stats.avg_row_bytes
    toks = rows * stats.avg_fields
    t["replay_transients"] = int(toks * (1 + 4 + 4) + rows * 16)
    return t


def _model_apriori(stats, block_bytes, schema,
                   prefetch_depth=DEFAULT_MODEL_PREFETCH_DEPTH
                   ) -> Dict[str, int]:
    t = _miner_common(stats, block_bytes, prefetch_depth)
    v = stats.distinct_tokens
    words = max((v + 31) // 32, 1)
    c_pad = _pow2ceil(min(v * v, 4096), 64)
    # uint8 multi-hot page + packed bitset page, double-buffered + device
    t["apriori_pages"] = int(3 * 8192 * (v + 4 * words))
    t["apriori_candidates"] = int(c_pad * (4 * words + 8))
    return t


def _model_gsp(stats, block_bytes, schema,
               prefetch_depth=DEFAULT_MODEL_PREFETCH_DEPTH) -> Dict[str, int]:
    t = _miner_common(stats, block_bytes, prefetch_depth)
    eff = _eff_block(stats, block_bytes)
    rows_page = _pow2ceil(min(eff / stats.avg_row_bytes, 65536), 1024)
    t_bucket = _pow2ceil(stats.avg_fields, 16)
    c_pad = _pow2ceil(min(stats.distinct_tokens ** 2, 4096), 16)
    # padded int32 pages (double buffer + device) and the scan kernel's
    # [rows, candidates] pointer state + hit temporaries on device
    t["gsp_pages"] = int(3 * rows_page * t_bucket * 4)
    t["gsp_scan_state"] = int(3 * rows_page * c_pad * 4)
    return t


#: canonical runner job name -> term builder(stats, block_bytes, schema)
_JOB_MODELS: Dict[str, Callable] = {
    "bayesianDistr": _model_nb,
    "mutualInformation": _model_mi,
    "fisherDiscriminant": _model_fisher,
    "markovStateTransitionModel": _model_markov,
    "frequentItemsApriori": _model_apriori,
    "candidateGenerationWithSelfJoin": _model_gsp,
}

#: the ingest terms shared by every sink of one fused scan — counted
#: once (max across jobs) when jobs fuse, exactly like the scan itself
_INGEST_TERMS = {"raw_blocks_in_flight", "parse_transient",
                 "parsed_chunks_in_flight", "csr_transients",
                 "python_tokenize", "sidecar_pages"}


def footprint_model(job: str, block_bytes: int, schema=None,
                    stats: Optional[CorpusStats] = None,
                    prefetch_depth: int = DEFAULT_MODEL_PREFETCH_DEPTH
                    ) -> FootprintEstimate:
    """Predicted peak incremental host bytes of one registered streamed
    job at `block_bytes` with `prefetch_depth` queued chunks (the
    `stream.prefetch.depth` key — the in-flight terms scale with it, so
    an autotuned depth re-prices admission honestly). With no `stats`
    the corpus is assumed unbounded (every block term prices a full
    block) — the admission-oracle posture."""
    if job not in _JOB_MODELS:
        raise ValueError(
            f"no footprint model for job {job!r}; modeled jobs: "
            f"{', '.join(sorted(_JOB_MODELS))}")
    st = stats if stats is not None else _unbounded_stats()
    terms = _JOB_MODELS[job](st, int(block_bytes), schema,
                             max(int(prefetch_depth), 1))
    return FootprintEstimate(job, int(block_bytes),
                             {k: int(v) for k, v in terms.items()})


def combined_footprint(jobs: Sequence[str], block_bytes: int, schema=None,
                       stats: Optional[CorpusStats] = None,
                       prefetch_depth: int = DEFAULT_MODEL_PREFETCH_DEPTH
                       ) -> FootprintEstimate:
    """Footprint of N jobs fused on ONE shared scan: ingest terms are
    paid once (the scan-sharing executor's whole point), per-job state
    terms sum, prefixed by job so the decomposition stays readable."""
    ests = [footprint_model(j, block_bytes, schema, stats, prefetch_depth)
            for j in jobs]
    terms: Dict[str, int] = {}
    for est in ests:
        for k, v in est.terms.items():
            if k in _INGEST_TERMS:
                terms[k] = max(terms.get(k, 0), v)
            else:
                terms[f"{est.job}:{k}" if len(ests) > 1 else k] = v
    return FootprintEstimate("+".join(jobs), int(block_bytes), terms)


# --------------------------------------------------------------------------
# the resident bytes of this process
# --------------------------------------------------------------------------
_STATM = "/proc/self/statm"


def _read_rss_bytes() -> int:
    try:
        with open(_STATM) as fh:
            return int(fh.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE")
                                                or 4096)
    except (OSError, IndexError, ValueError) as e:
        raise MemAuditError(
            f"cannot sample RSS from {_STATM}: {e!r} (a Linux procfs "
            f"is needed)") from e


class _RssSampler:
    """Background thread sampling resident bytes (and, every few ticks,
    the bytes torch holds allocated on the card, where CUDA is up) while
    one streamed job runs (the server tripwire's served phase). The peaks
    are worker-private while sampling and exposed through read-only
    properties, read only after ``__exit__`` joined the thread."""

    def __init__(self, interval: float = 0.004):
        self.interval = interval
        self._peak_rss = 0
        self._peak_live = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    @property
    def peak_rss(self) -> int:
        return self._peak_rss

    @property
    def peak_live(self) -> int:
        return self._peak_live

    def _loop(self) -> None:
        tick = 0
        while not self._stop.is_set():
            try:
                self._peak_rss = max(self._peak_rss, _read_rss_bytes())
            except MemAuditError:
                break
            if tick % 16 == 0:
                self._peak_live = max(self._peak_live, _device_live_bytes())
            tick += 1
            self._stop.wait(self.interval)

    def __enter__(self) -> "_RssSampler":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(5.0)


def _device_live_bytes() -> int:
    """Bytes torch holds allocated on the current card; 0 where CUDA was
    never initialised in this process (the sampler must not open a
    context of its own)."""
    import torch

    if not torch.cuda.is_initialized():
        return 0
    return int(torch.cuda.memory_allocated())


# --------------------------------------------------------------------------
# the device half of the manifest: the port's CUDA kernels
# --------------------------------------------------------------------------
def _kernel_cases(device) -> List[Tuple[str, str, str, Callable]]:
    """(kernel, its source, its shape, build() -> (fn, args)) of every
    CUDA kernel of the port, the tensors seeded and on `device`."""
    import torch

    from avenir_tpu_torch.ops import (cluster_kernels, knn_kernels,
                                      matmul_ceiling, sampling_kernels,
                                      sequence_kernels)

    gen = torch.Generator().manual_seed(7)

    def rand(*shape):
        return torch.rand(*shape, generator=gen).to(device)

    def knn(fn, d, **kw):
        def build():
            q, t = rand(256, d), rand(8192, d)
            if fn is knn_kernels.knn_classify_lanes:
                labels = torch.randint(0, 2, (8192,), generator=gen,
                                       dtype=torch.int32).to(device)
                return (lambda: fn(q, t, labels, k=5, **kw)), (q, t, labels)
            return (lambda: fn(q, t, k=5, **kw)), (q, t)
        return build

    def prepass():
        q, t = rand(256, 128), rand(8192, 128)
        return (lambda: knn_kernels.knn_prepass(q, t, bf16=True)), (q, t)

    def ceiling():
        q, t = rand(256, 128), rand(8192, 128)
        return (lambda: matmul_ceiling.matmul_ceiling(q, t)), (q, t)

    def subseq():
        rows = torch.randint(0, 64, (4096, 32), generator=gen,
                             dtype=torch.int32).to(device)
        cands = torch.randint(0, 64, (256, 3), generator=gen,
                              dtype=torch.int32).to(device)
        k_vec = torch.full((256,), 3, dtype=torch.int32, device=device)
        acc = torch.zeros(256, dtype=torch.int32, device=device)
        return (lambda: sequence_kernels.subseq_support_fold(
            acc, rows, cands, k_vec, 64)), (acc, rows, cands, k_vec)

    def centres():
        x = rand(65536, 6)
        assign = torch.randint(0, 3, (65536,), generator=gen,
                               dtype=torch.int32).to(device)
        return (lambda: cluster_kernels.centre_sums(x, assign, 3)), \
            (x, assign)

    def walk():
        z = torch.randn(16384, generator=gen).to(device)
        u = rand(16384)
        target = sampling_kernels.WalkTarget.of(
            [float(i % 17 + 1) for i in range(200)], 0.0, 200.0, 1.0, 3.0,
            device=device)
        return (lambda: sampling_kernels.metropolis_walk(
            z, u, None, target, 100.0)), (z, u, target.bins)

    kk = knn_kernels
    src = "avenir_tpu_torch/ops/csrc/"
    d6 = "q [256, 6], t [8192, 6] float32, k=5"
    d128 = "q [256, 128], t [8192, 128] float32"
    return [
        ("knn_topk", src + "knn_topk.cu", f"{d6}, manhattan",
         knn(kk.knn_topk, 6, metric="manhattan")),
        ("knn_topk_packed", src + "knn_topk.cu", f"{d6}, euclidean",
         knn(kk.knn_topk_packed, 6, metric="euclidean")),
        ("knn_topk_lanes", src + "knn_topk.cu", f"{d6}, manhattan",
         knn(kk.knn_topk_lanes, 6, metric="manhattan")),
        ("knn_classify_lanes", src + "knn_classify.cu",
         f"{d6}, manhattan, 2 classes",
         knn(kk.knn_classify_lanes, 6, metric="manhattan", n_classes=2)),
        ("knn_partial_mma", src + "knn_tile_mma.cuh",
         f"{d128}, k=5, euclidean, bfloat16 lanes",
         knn(kk.knn_topk_lanes, 128, metric="euclidean",
             compute_dtype="bfloat16")),
        ("knn_prepass", src + "knn_prepass.cu", f"{d128}, bfloat16 operands",
         prepass),
        ("matmul_ceiling", src + "matmul_ceiling.cu", d128, ceiling),
        ("subseq_support", src + "subseq_support.cu",
         "rows [4096, 32], 256 candidates of 3 codes, 64 codes", subseq),
        ("centre_sums", src + "centre_sums.cu",
         "x [65536, 6] float32, k=3", centres),
        ("metropolis_walk", src + "metropolis_walk.cu",
         "16,384 steps, 200 bins", walk),
    ]


def _tensor_bytes(obj, exclude=()) -> int:
    """The bytes of the tensors in `obj` (a tensor, or a tuple or list of
    them; anything else counts 0), less those in `exclude`: an output
    that is an argument, written in place, is no new allocation."""
    import torch

    if isinstance(obj, torch.Tensor):
        if any(obj is e for e in exclude):
            return 0
        return int(obj.numel() * obj.element_size())
    if isinstance(obj, (tuple, list)):
        return sum(_tensor_bytes(o, exclude) for o in obj)
    return 0


def kernel_device_entries(device: str = "cuda") -> List[dict]:
    """A row a CUDA kernel of the port: the bytes of its arguments, its
    outputs and its temporaries at the row's stated shape, and their sum.
    On the card (`device` cuda) the call runs once to build and warm,
    then once between `torch.cuda.reset_peak_memory_stats` and
    `max_memory_allocated`: temp is the peak over the arguments less the
    outputs (``source: "cuda_peak"``). On the CPU the wrapper runs its
    plain version, so the arguments and outputs come from the shapes and
    temp is not measured (``source: "shapes"``, temp null)."""
    import torch

    from avenir_tpu_torch.utils.devices import resolve_device

    device = resolve_device(device)
    on_card = device.type == "cuda"
    rows: List[dict] = []
    for name, source, shape, build in _kernel_cases(device):
        fn, args = build()
        arg_b = _tensor_bytes(args)
        temp_b = None
        if on_card:
            fn()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            out_b = _tensor_bytes(out, args)
            temp_b = max(int(peak) - out_b, 0)
        else:
            out_b = _tensor_bytes(fn(), args)
        rows.append({
            "kernel": name, "path": source, "shape": shape,
            "argument_bytes": arg_b, "output_bytes": out_b,
            "temp_bytes": temp_b,
            "peak_live_bytes": arg_b + out_b + (temp_b or 0),
            "source": "cuda_peak" if on_card else "shapes",
        })
    return rows


def memory_manifest(block_sizes_mb: Sequence[float] = (64.0, 8.0),
                    include_kernels: bool = True,
                    device: str = "cuda") -> dict:
    """The memory manifest, the oracle the job server admits by: the
    predicted peak host bytes of every streamed job at each block size
    against a nominal unbounded corpus (the churn schema for the tabular
    jobs), the reference's numbers; and a row a CUDA kernel of the port
    (`kernel_device_entries` on `device`)."""
    from avenir_tpu_torch.data import churn_schema

    schema = churn_schema()
    tabular = {"bayesianDistr", "mutualInformation", "fisherDiscriminant"}
    jobs: Dict[str, dict] = {}
    for job in sorted(_JOB_MODELS):
        jobs[job] = {
            f"{mb:g}MB": footprint_model(
                job, int(mb * (1 << 20)),
                schema if job in tabular else None).to_json()
            for mb in block_sizes_mb}
    out = {
        "version": 1,
        "tolerance": {"slack_bytes": AUDIT_SLACK_BYTES,
                      "tightness": AUDIT_TIGHTNESS,
                      "policy": "measured <= predicted + slack and "
                                "predicted <= tightness * (measured + "
                                "slack), at >= 2 block sizes"},
        "jobs": jobs,
    }
    if include_kernels:
        out["kernels"] = kernel_device_entries(device)
    return out


# --------------------------------------------------------------------------
# the audit: sampled RSS against the model
# --------------------------------------------------------------------------
class _BlockRecorder:
    """The `core.stream._bytes_hook` consumer: the largest raw block any
    prefetch worker produced, held against the model's block term."""

    def __init__(self):
        self.max_bytes = 0
        self._lock = threading.Lock()

    def __call__(self, n: int) -> None:
        if n:
            with self._lock:
                if n > self.max_bytes:
                    self.max_bytes = n


@contextmanager
def _bytes_hook(recorder):
    from avenir_tpu_torch.core import stream

    prev = stream._bytes_hook
    stream._bytes_hook = recorder
    try:
        yield
    finally:
        stream._bytes_hook = prev


def _inflate_corpus(ctx: dict, target_bytes: int) -> dict:
    """The entry's seeded corpus replicated up to `target_bytes` (the
    jobs stream lines, so every row shape is kept), so the block terms
    dominate at the audit's block sizes."""
    src = ctx["csv"]
    with open(src, "rb") as fh:
        blob = fh.read()
    if not blob:
        raise MemAuditError(f"audit corpus {src!r} is empty")
    reps = max(1, -(-target_bytes // len(blob)))
    if reps == 1:
        return ctx
    big = os.path.join(ctx["dir"], "inflated.csv")
    with open(big, "wb") as fh:
        for _ in range(reps):
            fh.write(blob)
    out = dict(ctx)
    out["csv"] = big
    return out


def _warm_device(device: str) -> None:
    """On the card: open the CUDA context and bind every kernel library
    before a sampled window, so the window holds the job's growth and not
    the process's first device use (hundreds of MB of RSS)."""
    if not str(device).startswith("cuda"):
        return
    import torch

    from avenir_tpu_torch.ops import _build

    torch.zeros(1, device=device)
    torch.cuda.synchronize()
    for name in _build.LIBRARIES:
        _build.load(name)


def audit_footprint(spec, block_sizes_mb: Optional[Sequence[float]] = None,
                    model_fn: Optional[Callable] = None,
                    inflate_to: int = AUDIT_CORPUS_BYTES
                    ) -> Tuple[dict, Optional[Finding]]:
    """Run one stream entry at two block sizes or more on its inflated
    corpus, sampling the peak RSS, and judge the model's band at each.
    Each size runs twice: the first absorbs the allocator's growth for
    that layout, the second is measured (the model prices steady-state
    transients, not a one-time warm-up). (audit row, band finding or
    None); a job that fails to run raises :class:`MemAuditError`."""
    sizes = [float(mb) for mb in (block_sizes_mb or DEFAULT_AUDIT_BLOCKS_MB)]
    if len(sizes) < 2:
        raise MemAuditError(
            f"{spec.name}: the footprint audit needs >= 2 block sizes, "
            f"got {sizes}")
    workdir = tempfile.mkdtemp(prefix=f"audit_mem_{spec.name}_")
    per_size: List[dict] = []
    try:
        _warm_device(spec.device)
        ctx = _inflate_corpus(spec.prepare(workdir), inflate_to)
        stats = corpus_stats([ctx["csv"]])
        schema = None
        if "schema" in ctx:
            from avenir_tpu_torch.core.schema import FeatureSchema
            schema = FeatureSchema.from_file(ctx["schema"])
        if model_fn is None:
            jobs = list(spec.jobs)
            if not jobs:
                raise MemAuditError(
                    f"{spec.name}: stream entry names no runner jobs; "
                    f"the footprint model is keyed on them")
            model_fn = lambda bb: combined_footprint(  # noqa: E731
                jobs, bb, schema, stats)
        for mb in sizes:
            bb = int(mb * (1 << 20))
            est = model_fn(bb)
            recorder = _BlockRecorder()
            with _bytes_hook(recorder):
                spec.run(ctx, mb)              # warm-up: arenas, pools
                rss0 = _read_rss_bytes()
                t0 = time.perf_counter()
                with _RssSampler() as sampler:
                    spec.run(ctx, mb)
                dt = time.perf_counter() - t0
            measured = max(0, max(sampler.peak_rss, rss0) - rss0)
            predicted = est.total_bytes
            upper_ok = measured <= predicted + AUDIT_SLACK_BYTES
            lower_ok = predicted <= AUDIT_TIGHTNESS * (
                measured + AUDIT_SLACK_BYTES)
            eff = _eff_block(stats, bb)
            block_ok = (recorder.max_bytes == 0
                        or recorder.max_bytes <= eff + 65536)
            per_size.append({
                "block_mb": mb,
                "predicted_bytes": predicted,
                "predicted_mb": round(predicted / (1 << 20), 2),
                "measured_bytes": measured,
                "measured_mb": round(measured / (1 << 20), 2),
                "peak_live_device_bytes": sampler.peak_live,
                "observed_max_block_bytes": recorder.max_bytes,
                "terms": est.to_json()["terms"],
                "seconds": round(dt, 3),
                "within_band": upper_ok and lower_ok,
                "block_accounting_ok": block_ok,
            })
    except MemAuditError:
        raise
    except Exception as e:
        raise MemAuditError(
            f"{spec.name}: streamed job failed to run: {e!r}") from e
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    ok = all(s["within_band"] and s["block_accounting_ok"]
             for s in per_size)
    row = {
        "kernel": spec.name,
        "jobs": list(getattr(spec, "jobs", ()) or ()),
        "corpus": stats.to_json(),
        "block_sizes_mb": sizes,
        "tolerance": {"slack_bytes": AUDIT_SLACK_BYTES,
                      "tightness": AUDIT_TIGHTNESS},
        "runs": per_size,
        "footprint_model_validated": ok,
    }
    finding = None
    if not ok:
        bad = [s for s in per_size
               if not (s["within_band"] and s["block_accounting_ok"])]
        why = "; ".join(
            (f"{s['block_mb']:g}MB: measured {s['measured_mb']}MB vs "
             f"predicted {s['predicted_mb']}MB"
             + ("" if s["block_accounting_ok"]
                else f", observed block {s['observed_max_block_bytes']}B "
                     f"exceeds the modeled effective block"))
            for s in bad)
        finding = Finding(
            spec.path, spec.line, MEM_AUDIT_RULE,
            f"streamed job `{spec.name}` broke its footprint band: {why}",
            "re-derive the job's terms in analysis/mem.py (which buffer "
            "grew?) or fix the job if a carry went O(corpus); never "
            "allowlist a memory-oracle drift",
            spec.name)
    return row, finding


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------
def run_mem(paths: Optional[Sequence[str]] = None,
            rules: Optional[Sequence[MemRule]] = None,
            baseline: Optional[Sequence[BaselineEntry]] = None,
            root: Optional[str] = None, include_md: bool = True,
            audit: bool = True, entries: Optional[Sequence] = None,
            block_sizes_mb: Optional[Sequence[float]] = None,
            device: str = "cuda") -> Report:
    """Check `paths` (default: the port's surface) with the mem rules,
    run the footprint audit over the stream entries on `device`, and
    split both finding sets by the allowlist."""
    active = list(rules) if rules is not None else \
        [r() for r in ALL_MEM_RULES]
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
            row, finding = audit_footprint(spec,
                                           block_sizes_mb=block_sizes_mb)
            report.footprint_audit.append(row)
            if finding is not None:
                raw.append(finding)
    active_ids = {r.rule_id for r in active}
    if audit:
        active_ids.add(MEM_AUDIT_RULE)
    apply_baseline(report, raw, baseline, active_ids)
    return report
