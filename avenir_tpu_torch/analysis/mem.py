"""The admission oracle: an analytic footprint model of the streamed jobs.

The port of `avenir_tpu/analysis/mem.py`'s `CorpusStats`, `corpus_stats`,
`FootprintEstimate`, the per-job `_model_*` terms, `footprint_model` and
`combined_footprint`, with `_read_rss_bytes` and `_RssSampler`. The job
server prices every dispatch with `combined_footprint` before it runs
(`server.jobserver.price_request_bytes`), so both packages price one
request alike: the terms are the reference's, term for term.

They are the reference's HOST terms: raw blocks in flight times the
prefetch depth, the parse's column outputs, the CSR transients, the fold
buffers, the miners' replay pages. The port's device-resident state (the
fold carries and kernel workspaces on the card) is not priced; the
admission budget is a host RSS budget in both packages.

The graftlint rules, the jaxpr lowering and `audit_footprint` are not
ported.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Set, Tuple


class MemAuditError(RuntimeError):
    """The resident bytes cannot be sampled (no Linux procfs)."""


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


def corpus_stats(paths: Sequence[str], delim: str = ",",
                 sample_bytes: int = 256 << 10) -> CorpusStats:
    """Sample the head of the first input (whole lines only) and
    extrapolate; token vocabulary estimate excludes each row's leading
    field (ids never dictionary-encode) and caps at 4096."""
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
    vocab: Set[str] = set()
    for ln in lines:
        for tok in ln.split(delim)[1:]:
            vocab.add(tok.strip(" \t\r"))
            if len(vocab) >= 4096:
                break
        if len(vocab) >= 4096:
            break
    return CorpusStats(total_bytes=total, rows=int(total / avg_row),
                       avg_row_bytes=avg_row, avg_fields=max(fields, 1.0),
                       distinct_tokens=max(len(vocab), 1))


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
