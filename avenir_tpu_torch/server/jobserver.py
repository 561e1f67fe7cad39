"""In-process multi-tenant job server over the shared scan.

The port of `avenir_tpu/server/jobserver.py`. Every runner call and the
score plane run on the server's `device` (default cuda; "cpu" runs the
plain versions of the kernels), so a served nearestNeighbor request
launches `knn_topk.cu` / `knn_classify.cu` through `run_job`, and a
served GSP request `subseq_support.cu` through `run_shared`, its warm
replay (`run_warm_miner`) and its refresh (`run_incremental_shared`).

Three layers, each consuming machinery earlier PRs proved correct:

- **Batching scheduler** — concurrent submissions land in per-tenant
  FIFO queues; the scheduler picks the highest-priority head (FIFO
  aging guarantees a starving tenant's head eventually outranks every
  newcomer) and folds every other tenant's COMPATIBLE queued prefix
  into the same dispatch: one ``runner.run_shared`` SharedScan pass —
  N tenants, one disk read + one parse per chunk. Compatibility is
  :func:`compat_key` (same corpus, same scan kind, same block size /
  delimiter / schema), the exact preconditions ``run_shared`` enforces;
  identical requests (same job + conf digest + corpus) coalesce into
  one execution whose artifact is copied per requester. Append-refresh
  requests batch the same way through the fused incremental driver
  (``runner.run_incremental_shared``): one delta scan, per-job
  restored carries.
- **Warm state** — the process is resident, so the kernel libraries
  it built and bound stay loaded across requests. The port has no jit
  cache: ``Server:CompileHits`` is 1 for a dispatch that bound no new
  kernel library (``len(ops._build._loaded)`` did not grow), 0 for one
  that built or bound one. The
  :class:`WarmStore` additionally pins the multi-pass miners'
  still-open sources — their committed ``EncodedBlockCache`` spill
  segments — under an explicit byte budget (LRU whole-entry drops:
  the warm gate demands full replay validity), so a repeat mining
  request over an
  unchanged corpus replays encoded blocks with ZERO CSV parses; and it
  manages the per-(job, corpus) incremental checkpoint state dirs as a
  bounded on-disk cache, so refresh requests restore a carry instead
  of re-scanning.
- **Admission controller** — every dispatch is priced in bytes BEFORE
  it runs (:func:`price_request_bytes`: ``analysis.mem``'s
  ``footprint_model``/``combined_footprint`` over the corpus stats, the
  reference's host terms; the port's device-resident state is not
  priced);
  a dispatch whose prediction plus the in-flight predictions would
  breach the configured ceiling (default 3GB, the repo's standing RSS
  budget) is HELD until running work completes, and one that could
  never fit fails fast with :class:`AdmissionError` instead of
  wedging the queue. The gate is the VALIDATED model, not a live RSS
  reading: a resident CPython process's RSS is sticky (freed arenas
  stay resident and get reused, not returned), so gating on live RSS
  would double-count every completed job and eventually hold or
  reject everything. Live RSS is still sampled and reported
  (``stats()["rss_bytes"]``), and ``bench_scaling.server_tripwire``
  asserts the measured served-phase peak stays under budget + slack —
  the empirical check that the model-priced gate actually bounds the
  process.

Thread shape: one scheduler thread + ``workers`` executor threads, all
bound and joined on ``shutdown()`` with liveness verified after a
bounded join; every ``queue.get`` polls with a timeout and re-checks the
shutdown flag; shared stats mutate under one lock.

Results are byte-identical to the solo-job runner by construction —
the server only ever executes through the registered runner paths
(``run_job`` / ``run_shared`` / ``run_incremental`` /
``run_incremental_shared`` / ``run_warm_miner``), whose equivalence
the shared-scan and merge auditors re-prove every round.

Autotune wiring (``tune/``): ``JobServer(autotune_dir=...)`` prices
with the residual-corrected tuned pricer, stops a batch's compatible
prefix at a request whose measured fold cost leaves the batch's band
(``autotune_balance_ratio``), and injects ``stream.autotune.dir`` into
each request conf, so the profiles the runner writes land in the store
the server reads. An autotuned request (``stream.autotune``) is priced
at the knobs the runner will overlay.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from avenir_tpu_torch import obs as _obs
from avenir_tpu_torch.core.atomic import publish_json
from avenir_tpu_torch.obs.histogram import LatencyHistogram
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device

#: default admission ceiling: the repo's standing 3GB RSS budget
#: (tools/stream_scale_check.py asserts it at every 100M-row anchor)
DEFAULT_BUDGET_BYTES = 3 << 30
#: default byte budget of the pinned miner-source caches
DEFAULT_WARM_BUDGET_BYTES = 256 << 20
#: default byte budget of the managed checkpoint state dirs
DEFAULT_CHECKPOINT_BUDGET_BYTES = 1 << 30
#: admission reserve for jobs the footprint model does not cover
DEFAULT_RESERVE_BYTES = 256 << 20
#: a queue head older than this is boosted past every priority — the
#: FIFO aging that keeps one tenant from starving the rest
DEFAULT_STARVATION_MS = 2000.0
#: scheduler/worker poll granularity: bounds how long a loop can block
#: before re-checking the shutdown flag
_POLL_SECS = 0.05
#: shutdown() bound on joining each thread; one alive past this is
#: wedged and is reported, not ignored (the LearnerStream.stop contract)
_JOIN_SECS = 10.0

#: miner jobs the warm-source layer can serve with zero CSV parses
_MINER_JOBS = ("frequentItemsApriori", "candidateGenerationWithSelfJoin")


class AdmissionError(RuntimeError):
    """A request's priced footprint can never fit the byte budget."""


class ServerClosed(RuntimeError):
    """submit() after shutdown(), or shutdown() cancelled the request."""


@dataclass
class JobRequest:
    """One tenant's job submission.

    ``mode``: "run" executes the job cold (shared-scan batched when
    compatible peers are queued); "refresh" serves it through the
    incremental delta-scan driver against the server's managed
    checkpoint store (O(delta) after an append). ``priority``: higher
    dispatches first, FIFO within a tenant, aging-boosted against
    starvation. ``state_dir`` overrides the managed checkpoint dir for
    refresh requests. ``nonce`` is the CLIENT's namespace token: the
    spool transport writes the result to ``<nonce>.<name>`` so two
    clients reusing one filename stem can never overwrite each other's
    results (the server itself never interprets it)."""

    job: str
    conf: object
    inputs: List[str]
    output: str
    tenant: str = "default"
    priority: int = 0
    mode: str = "run"
    state_dir: Optional[str] = None
    nonce: Optional[str] = None
    req_id: str = field(default_factory=lambda: uuid.uuid4().hex[:12])


class Ticket:
    """A submitted request's handle: ``result(timeout)`` blocks until
    the server served (or failed) the request. The served
    :class:`~avenir_tpu_torch.runner.JobResult` carries the ``Server:*``
    counters next to the job's own."""

    def __init__(self, request: JobRequest):
        self.request = request
        self.submitted_at = time.perf_counter()
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        # scheduler bookkeeping (written before dispatch, read after
        # completion — the done event orders the accesses)
        self._held_ms = 0.0
        self._held_since: Optional[float] = None
        self._dispatched_at: Optional[float] = None
        self._completed_at: Optional[float] = None
        self._ckey: Optional[tuple] = None
        self._ekey: Optional[tuple] = None
        self._canonical: Optional[str] = None
        self._price_memo: Optional[tuple] = None

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request.req_id} not served in {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def _complete(self, result=None, error: Optional[BaseException] = None
                  ) -> None:
        self._result = result
        self._error = error
        self._completed_at = time.perf_counter()
        self._done.set()


# --------------------------------------------------------------------------
# compatibility / pricing
# --------------------------------------------------------------------------
def _scoped(job: str, conf):
    """(canonical name, prefix, scoped config) of one request."""
    from avenir_tpu_torch.runner import _job_cfg

    canonical, cfg = _job_cfg(job, conf)
    return canonical, cfg.prefix, cfg


def compat_key(request: JobRequest) -> Optional[tuple]:
    """The batching key: two requests with EQUAL keys can ride one
    SharedScan pass (same mode, same corpus, same scan kind, same
    stream block size, same field delimiter, and — for Dataset folds —
    the same schema file: exactly the preconditions
    ``runner.run_shared`` / ``run_incremental_shared`` enforce). None
    for jobs with no registered stream fold — those never batch."""
    from avenir_tpu_torch.runner import stream_fold_names

    canonical, _prefix, cfg = _scoped(request.job, request.conf)
    if canonical not in stream_fold_names():
        return None
    from avenir_tpu_torch.core.keys import compat_tuple
    from avenir_tpu_torch.runner import stream_fold_ops

    ops = stream_fold_ops(canonical)
    schema = None
    if ops.kind == "dataset":
        schema = cfg.get("feature.schema.file.path")
        if not schema:
            return None               # will fail at run; never batch it
    return compat_tuple(request.mode, request.inputs, ops.kind,
                        cfg.get_float("stream.block.size.mb", 64.0),
                        cfg.field_delim_regex, schema)


def _exec_key(request: JobRequest) -> tuple:
    """Identical-execution key: requests agreeing on it produce (by
    determinism of the runner paths) byte-identical artifacts, so the
    server runs ONE and copies the files per requester.

    key-covered: all — conf_digest folds every non-neutral property.
    """
    from avenir_tpu_torch.core.keys import conf_digest, key_site

    key_site("exec.coalesce")
    canonical, _prefix, cfg = _scoped(request.job, request.conf)
    return (request.mode, canonical, conf_digest(cfg),
            tuple(os.path.abspath(p) for p in request.inputs))


def price_request_bytes(requests: Sequence[JobRequest],
                        reserve_bytes: int = DEFAULT_RESERVE_BYTES) -> int:
    """Predicted peak incremental host bytes of dispatching `requests`
    as one group — the admission oracle. Streamed jobs price through
    ``analysis.mem``'s analytic model (``combined_footprint``: ingest
    terms paid once across the fused group, per-job state terms
    summed); jobs without a model, or a corpus that cannot be sampled,
    price at the flat `reserve_bytes` — admission must always have a
    number, so the fallback is conservative, never an exception. A
    ``stream.autotune`` conf prices at the block size and depth of its
    profile's knobs, which the runner overlays after admission."""
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.runner import stream_fold_names

    streamed: List[Tuple[str, object]] = []       # (canonical, cfg)
    flat = 0
    for req in requests:
        canonical, _prefix, cfg = _scoped(req.job, req.conf)
        if canonical in stream_fold_names():
            streamed.append((canonical, cfg))
        else:
            flat += int(reserve_bytes)
    if not streamed:
        return flat
    try:
        from avenir_tpu_torch.analysis.mem import (combined_footprint,
                                                   corpus_stats)
        from avenir_tpu_torch.core.stream import prefetch_depth

        cfg0 = streamed[0][1]
        block_mb = cfg0.get_float("stream.block.size.mb", 64.0)
        depth = prefetch_depth(cfg0)
        if cfg0.get_bool("stream.autotune", False):
            # price what the runner will run: an autotuned dispatch
            # overlays the profile's knobs after admission, so a tuned-up
            # block must not run at several times its admitted bytes. A
            # bad profile prices at the static values (and the run fails
            # loudly on it)
            try:
                from avenir_tpu_torch import tune

                jobs = sorted(c for c, _cfg in streamed)
                prof = tune.ProfileStore(tune.resolve_dir(
                    cfg0, requests[0].inputs)).load(
                    "+".join(jobs), tune.corpus_digest(requests[0].inputs))
                knobs = dict((prof or {}).get("knobs") or {})
                block_mb = float(knobs.get("stream.block.size.mb",
                                           block_mb))
                depth = int(knobs.get("stream.prefetch.depth", depth))
            except Exception:
                pass
        block = int(block_mb * (1 << 20))
        paths = [p for p in requests[0].inputs if os.path.exists(p)]
        stats = corpus_stats(paths, delim=cfg0.field_delim_regex) \
            if paths else None
        schema = None
        schema_path = cfg0.get("feature.schema.file.path")
        if schema_path:
            schema = FeatureSchema.from_file(schema_path)
        est = combined_footprint([c for c, _cfg in streamed], block,
                                 schema, stats, prefetch_depth=depth)
        return flat + int(est.total_bytes)
    except Exception:
        return flat + int(reserve_bytes) * len(streamed)


def _process_rss_bytes() -> int:
    """Current (not peak) resident bytes of this process, via
    /proc/self/statm; 0 where /proc is unavailable (admission then
    prices against the budget alone)."""
    from avenir_tpu_torch.analysis.mem import MemAuditError, _read_rss_bytes

    try:
        return _read_rss_bytes()
    except MemAuditError:
        return 0


class _Admission:
    """Byte-budget admission bookkeeping. All methods are called with
    the server lock held; the controller itself keeps no lock.

    The gate is the priced predictions alone (module docstring): live
    RSS in a resident CPython process double-counts freed-but-still-
    resident memory, so `rss_probe` (the /proc reading by default) is
    only surfaced through stats as observability, never consulted for
    an admit/hold/reject decision."""

    def __init__(self, budget_bytes: int, reserve_bytes: int,
                 rss_probe: Callable[[], int] = _process_rss_bytes):
        self.budget = int(budget_bytes)
        self.reserve = int(reserve_bytes)
        self.rss_probe = rss_probe
        self.inflight_bytes = 0
        self.inflight_batches = 0
        self.peak_priced_bytes = 0

    def admit(self, priced: int) -> bool:
        """True (and accounted) when the in-flight predictions + this
        dispatch's prediction fit the budget."""
        total = self.inflight_bytes + priced
        if total > self.budget:
            return False
        self.inflight_bytes += priced
        self.inflight_batches += 1
        self.peak_priced_bytes = max(self.peak_priced_bytes, total)
        return True

    def can_ever_fit(self, priced: int) -> bool:
        """False when the dispatch exceeds the budget even with nothing
        else in flight — holding it would wedge the queue forever."""
        return priced <= self.budget

    def release(self, priced: int) -> None:
        self.inflight_bytes -= priced
        self.inflight_batches -= 1


# --------------------------------------------------------------------------
# warm state
# --------------------------------------------------------------------------
class WarmStore:
    """Pinned cross-request state: miner sources (their committed
    encoded-block caches) under a byte budget, and the managed
    per-(job, corpus) incremental checkpoint dirs under another.

    Pinned sources evict least-recently-used first, whole entries only
    — including the newest when it alone exceeds the budget. Partial
    (segment-wise) trimming is deliberately NOT done: the warm gate
    ``cache_ready`` demands every source replay in full, so a trimmed
    entry could never serve warm again and would just pin dead bytes.
    Checkpoint dirs evict oldest-used whole (a dropped dir only costs
    the next refresh a cold scan — the incremental driver's documented
    fallback)."""

    def __init__(self, byte_budget: int = DEFAULT_WARM_BUDGET_BYTES,
                 checkpoint_budget: int = DEFAULT_CHECKPOINT_BUDGET_BYTES,
                 state_root: Optional[str] = None):
        self.byte_budget = int(byte_budget)
        self.checkpoint_budget = int(checkpoint_budget)
        self._lock = threading.Lock()
        self._sources: Dict[tuple, object] = {}
        self._last_used: Dict[tuple, float] = {}
        self._dir_inuse: Dict[str, int] = {}
        self._own_root = state_root is None
        if state_root is None:
            import tempfile

            state_root = tempfile.mkdtemp(prefix="avenir_server_state_")
        self.state_root = state_root
        os.makedirs(state_root, exist_ok=True)
        self.hits = 0
        self.misses = 0

    # ----------------------------------------------------- miner sources
    @staticmethod
    def source_key(canonical: str, inputs: Sequence[str], cfg) -> tuple:
        """Warm identity of a miner source: the scan-shaping config
        (delimiter, skipped meta fields, infrequent-item marker,
        transaction-id ordinal) plus the corpus paths. Mining
        parameters (support threshold, max length) deliberately
        EXCLUDED — pass 1 does not depend on them, so one warm source
        serves any mining request over the corpus. The trans-id ordinal
        IS included: the source bakes it in, and an apriori request
        emitting trans ids from a different column must miss, not
        silently serve ids read from the pinned source's column.

        key-covered: fia.support.threshold fia.item.set.length
        fia.max.item.set.length stream.block.size.mb — mining
        parameters shape pass 2 only, and the block size shapes the
        scan's tiling, never the parsed rows a warm source replays."""
        from avenir_tpu_torch.core.keys import source_tuple

        return source_tuple(canonical, inputs,
                            cfg.field_delim_regex,
                            cfg.get_int("skip.field.count", 1),
                            cfg.get("infreq.item.marker"),
                            cfg.get_int("tans.id.ord", 0))

    def lookup(self, key: tuple):
        """EXCLUSIVE checkout of the pinned, still-content-valid source
        for `key`, or None. The entry is REMOVED from the store while
        checked out — miner sources carry mutable per-request scan
        state (item masks, replay cursors), so two workers must never
        mine one source concurrently, and eviction must never close a
        source mid-mine; the server pins it back when the request
        completes. Validity is the cache's own per-block content gate
        (``cache_ready``): any corpus change drops the entry — a warm
        hit can never serve stale counts."""
        with self._lock:
            src = self._sources.pop(key, None)
            self._last_used.pop(key, None)
            if src is None:
                self.misses += 1
                return None
            if not src.cache_ready():
                src.close()
                self.misses += 1
                return None
            self.hits += 1
            return src

    def pin(self, key: tuple, src) -> None:
        with self._lock:
            old = self._sources.pop(key, None)
            if old is not None and old is not src \
                    and not getattr(old, "cache_durable", False):
                # a durable entry (sidecar handle) shares its on-disk
                # state with the replacement — same key, same directory
                # — so closing it here would rmtree what we are pinning
                old.close()
            if not src.cache_ready():
                src.close()               # nothing replayable to pin
                return
            self._sources[key] = src
            self._last_used[key] = time.perf_counter()
            self._enforce_budget()

    def _enforce_budget(self) -> None:
        # LRU whole-entry drops, including the newest entry when it
        # alone exceeds the budget: a segment-trimmed source can never
        # serve warm again (cache_ready demands EVERY source replay in
        # full), so trimming would just pin dead, unservable bytes
        # against the budget
        total = sum(s.cache_nbytes for s in self._sources.values())
        order = sorted(self._sources, key=lambda k: self._last_used[k])
        while total > self.byte_budget and order:
            key = order.pop(0)
            src = self._sources.pop(key)
            self._last_used.pop(key, None)
            total -= src.cache_nbytes
            src.close()

    # -------------------------------------------------- checkpoint dirs
    def checkpoint_dir(self, canonical: str, inputs: Sequence[str]) -> str:
        """The managed state dir a refresh request's checkpoints live
        in — deterministic per (job, corpus), under the server's state
        root, so repeated refreshes of one corpus restore each other's
        carries (the runner's own digest recipe, different root). The
        dir is marked IN USE until :meth:`release_dir`, so concurrent
        budget enforcement can never rmtree a dir another worker is
        actively checkpointing into."""
        from avenir_tpu_torch.core.keys import state_digest

        digest = state_digest(canonical, inputs)
        path = os.path.join(self.state_root, f"{canonical}_{digest}")
        with self._lock:
            self._dir_inuse[path] = self._dir_inuse.get(path, 0) + 1
            self._touch_dir(path)
        return path

    def release_dir(self, path: str) -> None:
        """End the in-use hold :meth:`checkpoint_dir` took (refcounted:
        concurrent refreshes of one corpus share the dir)."""
        with self._lock:
            n = self._dir_inuse.get(path, 0) - 1
            if n <= 0:
                self._dir_inuse.pop(path, None)
            else:
                self._dir_inuse[path] = n

    def _touch_dir(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        self._dir_used = getattr(self, "_dir_used", {})
        self._dir_used[path] = time.perf_counter()
        total = 0
        sizes: Dict[str, int] = {}
        for d in list(self._dir_used):
            n = _dir_bytes(d)
            sizes[d] = n
            total += n
        order = sorted(self._dir_used, key=lambda d: self._dir_used[d])
        while total > self.checkpoint_budget and len(order) > 1:
            victim = order.pop(0)
            if victim == path or self._dir_inuse.get(victim):
                continue              # never evict a dir being served
            total -= sizes.get(victim, 0)
            self._dir_used.pop(victim, None)
            shutil.rmtree(victim, ignore_errors=True)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "pinned_sources": float(len(self._sources)),
                "pinned_bytes": float(sum(
                    s.cache_nbytes for s in self._sources.values())),
                "hits": float(self.hits),
                "misses": float(self.misses),
            }

    def close(self) -> None:
        with self._lock:
            for src in self._sources.values():
                # durable entries (sidecar handles) outlive the server:
                # shutdown drops the PIN, not the on-disk cache — only
                # budget eviction / staleness deletes a sidecar
                if not getattr(src, "cache_durable", False):
                    src.close()
            self._sources.clear()
            self._last_used.clear()
        if self._own_root:
            shutil.rmtree(self.state_root, ignore_errors=True)


def _dir_bytes(path: str) -> int:
    total = 0
    try:
        for name in os.listdir(path):
            try:
                total += os.path.getsize(os.path.join(path, name))
            except OSError:
                pass
    except OSError:
        pass
    return total


# --------------------------------------------------------------------------
# compile-warmth probe
# --------------------------------------------------------------------------
def _fold_kernel_cache_size() -> int:
    """How many kernel libraries this process has built and bound
    (``ops._build._loaded``): a dispatch that leaves it unchanged ran on
    libraries already loaded, the ``Server:CompileHits`` evidence that
    residency amortizes the build. The port has no jit cache to count."""
    from avenir_tpu_torch.ops import _build

    return len(_build._loaded)


# --------------------------------------------------------------------------
# the server
# --------------------------------------------------------------------------
@dataclass
class _Batch:
    """One admitted dispatch: `primaries` execute (one spec each),
    `dups[i]` receive copies of primary i's artifact. ``batch_id`` is
    the dispatch-clock ordinal — the linkage attr every per-request
    span carries so a trace groups requests back into their batch."""

    tickets: List[Ticket]
    dups: List[List[Ticket]]
    mode: str
    streamable: bool
    priced_bytes: int
    dispatched_at: float
    batch_id: int = 0


class JobServer:
    """The resident multi-tenant analytics server (module docstring has
    the architecture). Construct, ``submit()`` (queues are live
    immediately), ``start()`` the scheduler/workers, ``drain()``,
    ``shutdown()``. Submitting before start() is the deterministic way
    to form a batch from an already-full queue."""

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET_BYTES,
                 workers: int = 2,
                 warm_budget_bytes: int = DEFAULT_WARM_BUDGET_BYTES,
                 checkpoint_budget_bytes: int =
                 DEFAULT_CHECKPOINT_BUDGET_BYTES,
                 reserve_bytes: int = DEFAULT_RESERVE_BYTES,
                 max_batch: int = 6,
                 starvation_ms: float = DEFAULT_STARVATION_MS,
                 state_root: Optional[str] = None,
                 pricer: Optional[Callable] = None,
                 rss_probe: Callable[[], int] = _process_rss_bytes,
                 metrics_path: Optional[str] = None,
                 metrics_interval_s: float = 2.0,
                 autotune_dir: Optional[str] = None,
                 autotune_balance_ratio: float = 4.0,
                 device: DeviceLike = None):
        # every runner call and the score plane run here; resolved now,
        # so a server asked for a missing card fails at construction
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queues: Dict[str, List[Ticket]] = {}
        self._seq = 0
        self._order: Dict[str, int] = {}          # req_id -> arrival seq
        self._dispatchq: "queue.Queue[_Batch]" = queue.Queue(
            maxsize=max(workers, 1) * 2)
        self._shutdown = threading.Event()
        self._started = False
        self._closed = False
        self._threads: List[threading.Thread] = []
        self._admission = _Admission(budget_bytes, reserve_bytes,
                                     rss_probe=rss_probe)
        # the autotune wiring (tune/): an `autotune_dir` is a profile
        # store root; the pricer gains the residual-learned factor
        # (never under 1.0: the model stays the admission floor) and the
        # scheduler reads the per-job measured fold-cost means when it
        # composes batches
        self._autotune_dir = autotune_dir
        self._balance_ratio = float(autotune_balance_ratio)
        self._fold_costs: Dict[tuple, Optional[float]] = {}
        self._fold_costs_at = 0.0
        if pricer is None and autotune_dir:
            from avenir_tpu_torch import tune

            pricer = tune.make_tuned_pricer(autotune_dir,
                                            base=price_request_bytes)
        # the admission oracle: price_request_bytes (analysis.mem's
        # footprint model) unless a test/operator injects its own
        self._pricer = pricer or price_request_bytes
        self.warm = WarmStore(warm_budget_bytes, checkpoint_budget_bytes,
                              state_root)
        self.max_batch = max(int(max_batch), 1)
        self.workers = max(int(workers), 1)
        self.starvation_s = float(starvation_ms) / 1000.0
        self._stats: Dict[str, float] = {
            "submitted": 0, "served": 0, "failed": 0, "batches": 0,
            "batched_requests": 0, "coalesced": 0, "admission_holds": 0,
            "warm_hits": 0, "compile_warm_dispatches": 0,
        }
        self._dispatch_clock = 0
        # streaming latency histograms (avenir_tpu_torch.obs.histogram): the
        # distribution view the old last-value-only scalars could not
        # give — fed per finished request / per dispatched batch,
        # surfaced in stats(), metrics.json and the per-result
        # Server:*P50/P99 counters
        self._hists: Dict[str, LatencyHistogram] = {
            "queue_wait_ms": LatencyHistogram(),
            "admission_held_ms": LatencyHistogram(),
            "dispatch_ms": LatencyHistogram(),
        }
        self._started_at = time.perf_counter()
        # drain state (the network edge's /healthz answer): begin_drain
        # gates NEW submissions while in-flight work finishes
        self._draining = False
        # live metrics surface: when set, the scheduler atomic-renames a
        # metrics.json snapshot here every `metrics_interval_s`
        self.metrics_path = metrics_path
        self.metrics_interval_s = float(metrics_interval_s)
        self._metrics_written_at = 0.0
        # the online scoring half (server/score.py), built on first use:
        # query traffic shares the process, not the batch queues
        self._score_plane = None

    # ------------------------------------------------------------ public
    def __enter__(self) -> "JobServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def submit(self, request: JobRequest) -> Ticket:
        """Queue one request; returns its :class:`Ticket`. Raises
        KeyError for an unknown job name and :class:`ServerClosed`
        after shutdown — validation the tenant gets synchronously."""
        canonical = _scoped(request.job, request.conf)[0]
        if request.mode not in ("run", "refresh"):
            raise ValueError(f"unknown request mode {request.mode!r}")
        ticket = Ticket(request)
        # keys computed once, outside the lock: the scheduler consults
        # them every pass and conf-file parsing must not ride the lock
        ticket._ckey = compat_key(request)
        ticket._ekey = _exec_key(request)
        ticket._canonical = canonical
        with self._work:
            if self._closed:
                raise ServerClosed("server is shut down")
            if self._draining:
                raise ServerClosed("server is draining")
            self._seq += 1
            self._order[request.req_id] = self._seq
            self._queues.setdefault(request.tenant, []).append(ticket)
            self._stats["submitted"] += 1
            self._work.notify_all()
        return ticket

    def start(self) -> "JobServer":
        with self._lock:
            if self._started or self._closed:
                return self
            self._started = True
        # every started thread is appended to _threads and joined (with
        # a liveness check) in shutdown()
        t = threading.Thread(target=self._scheduler_loop,
                             name="avenir-server-scheduler")
        t.start()
        self._threads.append(t)
        for i in range(self.workers):
            t = threading.Thread(target=self._worker_loop,
                                 name=f"avenir-server-worker-{i}")
            t.start()
            self._threads.append(t)
        return self

    def drain(self, timeout: float = 300.0) -> None:
        """Block until every queued request is served (or failed)."""
        deadline = time.perf_counter() + timeout
        with self._work:
            while self._pending_locked():
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    raise TimeoutError(
                        f"server did not drain within {timeout}s "
                        f"({self._pending_locked()} requests pending)")
                self._work.wait(min(remaining, _POLL_SECS * 4))

    def shutdown(self, drain: bool = True, timeout: float = 300.0) -> None:
        """Stop the server: optionally drain, then join every thread
        (bounded; a worker alive past the bound raises — a wedged
        thread must be reported, never leaked silently), cancel any
        still-queued requests with :class:`ServerClosed`, and close
        the warm store. A drain timeout still tears everything down
        (threads signalled + joined, queued tickets cancelled, warm
        store closed) before the TimeoutError surfaces — a timed-out
        shutdown must never leak the server's threads."""
        drain_err: Optional[BaseException] = None
        if drain and self._started and not self._closed:
            try:
                self.drain(timeout)
            except TimeoutError as exc:
                drain_err = exc
        with self._work:
            self._closed = True
            self._work.notify_all()
        self._shutdown.set()
        threads, self._threads = self._threads, []
        wedged: List[str] = []
        for t in threads:
            t.join(_JOIN_SECS)
            if t.is_alive():
                # keep tearing down: queued tickets must still be
                # cancelled and the warm store closed even when one
                # worker is wedged — clients blocked in result() on a
                # never-dispatched request would otherwise hang forever
                wedged.append(t.name)
        leftovers: List[Ticket] = []
        with self._work:
            for q in self._queues.values():
                leftovers.extend(q)
                q.clear()
        while True:                   # batches the workers never pulled
            try:
                batch = self._dispatchq.get_nowait()
            except queue.Empty:
                break
            leftovers.extend(batch.tickets)
            leftovers.extend(d for ds in batch.dups for d in ds)
        for ticket in leftovers:
            ticket._complete(error=ServerClosed(
                "server shut down before the request was served"))
        # the score plane drains before the final snapshot so its last
        # window's latencies make it into metrics.json
        plane, self._score_plane = self._score_plane, None
        if plane is not None:
            plane.close()
        # final snapshot: a short --once spool session must still leave
        # a fresh metrics.json behind even when no interval tick fired
        try:
            self.write_metrics()
        except OSError:
            pass
        self.warm.close()
        if wedged:
            raise RuntimeError(
                f"server thread(s) {', '.join(wedged)} failed to stop "
                f"within {_JOIN_SECS}s")
        if drain_err is not None:
            raise drain_err

    def stats(self) -> Dict:
        with self._lock:
            out = dict(self._stats)
            out["inflight_bytes"] = float(self._admission.inflight_bytes)
            out["peak_priced_bytes"] = float(
                self._admission.peak_priced_bytes)
            out["budget_bytes"] = float(self._admission.budget)
            # advisory observability, never an admission input (the
            # _Admission docstring has the why)
            out["rss_bytes"] = float(self._admission.rss_probe())
            # latency distributions (not scalars): {name: {count, mean,
            # min, max, p50, p95, p99}} per histogram — the tail view
            # the last-value Server:* counters could never give
            out["hists"] = {name: h.summary()
                            for name, h in self._hists.items()}
        out.update({f"warm_{k}": v for k, v in self.warm.stats().items()})
        return out

    # ----------------------------------------------------- score plane
    def score_plane(self, **kwargs):
        """The online scoring half (server/score.py), lazily built so
        job-only servers never pay its dispatcher thread. kwargs
        (budget_bytes / window_ms / batch_max) only apply to the
        first, constructing call; shutdown() drains and joins it. The
        plane predicts on the server's device."""
        with self._lock:
            if self._score_plane is None:
                from avenir_tpu_torch.server.score import ScorePlane
                self._score_plane = ScorePlane(device=self.device,
                                               **kwargs)
            return self._score_plane

    # ------------------------------------------------------- edge hooks
    def price(self, requests: Sequence[JobRequest]) -> int:
        """The admission oracle's prediction for `requests` as one
        group — the number the network edge sheds against BEFORE
        enqueueing (the same pricer the scheduler admits with, so the
        edge and the admission controller can never disagree on what a
        request costs)."""
        return int(self._pricer(list(requests), self._admission.reserve))

    def queue_depth(self, tenant: Optional[str] = None) -> int:
        """Currently queued (not yet dispatched) request count — one
        tenant's, or every tenant's summed. The edge's per-tenant depth
        bound reads this."""
        with self._lock:
            if tenant is not None:
                return len(self._queues.get(tenant, ()))
            return sum(len(q) for q in self._queues.values())

    @property
    def budget_bytes(self) -> int:
        return self._admission.budget

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Stop accepting NEW submissions (submit raises ServerClosed)
        while queued and in-flight work keeps serving — the graceful-
        drain half of SIGTERM handling; ``drain()``/``shutdown()``
        still finish the session."""
        with self._work:
            self._draining = True
            self._work.notify_all()

    # ------------------------------------------------- live metrics surface
    def metrics_snapshot(self) -> Dict:
        """The live operator snapshot (``metrics.json`` schema —
        docs/observability.md pins it): queue depths per tenant,
        in-flight priced bytes vs budget, warm-store occupancy, served/
        batch counters, and the latency histogram summaries (the
        server's queue-wait/held/dispatch hists plus the process-global
        obs hists like ``chunk_latency_ms``)."""
        with self._lock:
            queues = {tenant: len(q)
                      for tenant, q in self._queues.items() if q}
            inflight = {
                "priced_bytes": int(self._admission.inflight_bytes),
                "peak_priced_bytes": int(self._admission.peak_priced_bytes),
                "budget_bytes": int(self._admission.budget),
                "batches": int(self._admission.inflight_batches),
            }
            stats = {k: float(v) for k, v in self._stats.items()}
            hists = {name: h.summary()
                     for name, h in self._hists.items()}
            # the sparse bucket form next to the summaries: summaries
            # cannot be combined after the fact, buckets merge exactly
            # (LatencyHistogram.merge), so the fleet roll-up and
            # `python -m avenir_tpu_torch stats a.json b.json` fold per-host
            # snapshots into one distribution instead of approximating
            raw = {name: h.to_dict() for name, h in self._hists.items()}
        # process-global streaming hists (chunk_latency_ms etc.) ride
        # along; the server's own names win on collision
        for name, summary in _obs.hist_summaries().items():
            hists.setdefault(name, summary)
            if name not in raw:
                h = _obs.hist(name)       # a merged copy, race-free
                if h is not None:
                    raw[name] = h.to_dict()
        # score-plane per-model hists join BOTH forms, so the fleet
        # roll-up (obs.report.merge_snapshots) folds per-host score
        # latency distributions exactly, same as the batch hists
        plane = self._score_plane
        score = None
        if plane is not None:
            hists.update(plane.hist_summaries())
            raw.update(plane.hists_raw())
            score = plane.snapshot()
        return {"ts_unix": time.time(),
                "uptime_s": round(time.perf_counter() - self._started_at,
                                  3),
                "queues": queues,
                "inflight": inflight,
                "warm": self.warm.stats(),
                "stats": stats,
                "hists": hists,
                "hists_raw": raw,
                "score": score,
                "draining": self._draining,
                "trace": {"spans": len(_obs.recorder()),
                          "dropped_spans": _obs.recorder().dropped,
                          "enabled": _obs.enabled()}}

    def write_metrics(self, path: Optional[str] = None) -> Optional[str]:
        """Atomically write the snapshot to `path` (default
        ``self.metrics_path``); tmp + ``os.replace`` so a reader
        (``python -m avenir_tpu_torch stats``) never sees a torn file.
        Returns the path written, or None when no path is configured."""
        path = path or self.metrics_path
        if not path:
            return None
        return publish_json(self.metrics_snapshot(), path)

    def _maybe_write_metrics(self) -> None:
        """Scheduler-loop tick: refresh the snapshot at most every
        ``metrics_interval_s`` seconds. Snapshot errors are swallowed —
        the metrics surface is observability, never a reason to stop
        serving."""
        if not self.metrics_path:
            return
        now = time.perf_counter()
        if now - self._metrics_written_at < self.metrics_interval_s:
            return
        self._metrics_written_at = now
        try:
            self.write_metrics()
        except OSError:
            pass

    # ------------------------------------------------- scheduler internals
    def _pending_locked(self) -> int:
        queued = sum(len(q) for q in self._queues.values())
        return queued + self._admission.inflight_batches \
            + self._dispatchq.qsize()

    def _head_rank(self, ticket: Ticket, now: float) -> tuple:
        """Sort key of a queue head. Fresh heads rank by priority (then
        global FIFO); a head older than the starvation bound ranks
        ABOVE every fresh one and — crucially — by ARRIVAL among the
        starved, not by priority: a tenant flooding high-priority work
        can delay another tenant's request by at most the starvation
        bound plus the queue ahead of it at submit time, never
        indefinitely."""
        starved = (now - ticket.submitted_at) >= self.starvation_s
        seq = self._order[ticket.request.req_id]
        if starved:
            return (0, seq, 0)
        return (1, -ticket.request.priority, seq)

    def _pick_batch_locked(self) -> Optional[_Batch]:
        now = time.perf_counter()
        heads = [q[0] for q in self._queues.values() if q]
        if not heads:
            return None
        seed = min(heads, key=lambda t: self._head_rank(t, now))
        key = seed._ckey
        # assemble: seed first, then every tenant's longest COMPATIBLE
        # queued prefix (stopping a tenant's prefix at the first
        # incompatible or conflicting request preserves its FIFO
        # order); identical executions coalesce — the first of each
        # exec key is the primary, the rest receive artifact copies
        primaries: List[Ticket] = [seed]
        dups: List[List[Ticket]] = [[]]
        seen: Dict[tuple, int] = {seed._ekey: 0}
        jobs_in_batch = {seed._canonical}
        if key is not None:
            for tenant in sorted(self._queues):
                for ticket in self._queues[tenant]:
                    if ticket is seed:
                        continue
                    n = len(primaries) + sum(len(d) for d in dups)
                    if n >= self.max_batch:
                        break
                    if ticket._ckey != key:
                        break
                    if ticket._ekey in seen:
                        dups[seen[ticket._ekey]].append(ticket)
                        continue
                    if ticket._canonical in jobs_in_batch:
                        # same job under a different conf cannot share
                        # one scan; stop the prefix so FIFO holds
                        break
                    if not self._batch_balanced_locked(primaries, ticket):
                        # fold-cost imbalance (autotune profiles): a
                        # shared chunk waits on the sum of its sinks'
                        # folds, so a cheap fold batched behind a far
                        # costlier one loses more latency than the shared
                        # ingest saves; stop the prefix, FIFO holds
                        break
                    jobs_in_batch.add(ticket._canonical)
                    seen[ticket._ekey] = len(primaries)
                    primaries.append(ticket)
                    dups.append([])
        # memoized on the seed per batch composition: a held batch is
        # re-assembled every scheduler pass, and re-sampling the corpus
        # head 20x/sec while holding would be pure waste. The one first
        # pricing of a composition does ride the lock, but corpus_stats
        # is a bounded head sample — submit() stalls are bounded small,
        # not O(corpus)
        memo_key = tuple(t.request.req_id for t in primaries)
        memo = getattr(seed, "_price_memo", None)
        if memo is not None and memo[0] == memo_key:
            priced = memo[1]
        else:
            priced = self._pricer([t.request for t in primaries],
                                  self._admission.reserve)
            seed._price_memo = (memo_key, priced)
        if not self._admission.admit(priced):
            if self._admission.inflight_batches == 0 \
                    and not self._admission.can_ever_fit(priced):
                for ticket in primaries + [d for ds in dups for d in ds]:
                    self._remove_locked(ticket)
                    ticket._complete(error=AdmissionError(
                        f"request priced at {priced} bytes can never fit "
                        f"the {self._admission.budget}-byte budget"))
                self._stats["failed"] += len(primaries) \
                    + sum(len(d) for d in dups)
                return None
            # count the TRANSITION into held, not every 20Hz re-check
            # of a batch that stays held
            if primaries[0]._held_since is None:
                self._stats["admission_holds"] += 1
            for ticket in primaries:
                if ticket._held_since is None:
                    ticket._held_since = now
            return None
        now = time.perf_counter()
        for ticket in primaries + [d for ds in dups for d in ds]:
            self._remove_locked(ticket)
            if ticket._held_since is not None:
                ticket._held_ms += (now - ticket._held_since) * 1000.0
                ticket._held_since = None
            ticket._dispatched_at = now
        self._dispatch_clock += 1
        self._stats["batches"] += 1
        n = len(primaries) + sum(len(d) for d in dups)
        self._stats["batched_requests"] += n if n > 1 else 0
        self._stats["coalesced"] += sum(len(d) for d in dups)
        return _Batch(primaries, dups, seed.request.mode,
                      key is not None, priced, now,
                      batch_id=self._dispatch_clock)

    def _remove_locked(self, ticket: Ticket) -> None:
        q = self._queues.get(ticket.request.tenant)
        if q is not None and ticket in q:
            q.remove(ticket)
        self._order.pop(ticket.request.req_id, None)

    # ------------------------------------------------ autotune composition
    def _fold_cost_locked(self, canonical: Optional[str],
                          inputs: Sequence[str]) -> Optional[float]:
        """The measured mean per-chunk fold cost (ms) of one (job, corpus)
        from the autotune profile store, memoized for 5 s so the
        scheduler does not re-read small JSON files under the lock on
        every pass. None: unmeasured (always batches)."""
        if not self._autotune_dir or canonical is None:
            return None
        now = time.perf_counter()
        if now - self._fold_costs_at > 5.0:
            self._fold_costs.clear()
            self._fold_costs_at = now
        from avenir_tpu_torch.tune import ProfileStore, corpus_digest

        key = (canonical, corpus_digest(inputs))
        if key not in self._fold_costs:
            self._fold_costs[key] = ProfileStore(
                self._autotune_dir).fold_cost_ms(canonical, key[1])
        return self._fold_costs[key]

    def _batch_balanced_locked(self, primaries: List[Ticket],
                               candidate: Ticket) -> bool:
        """True when the candidate's measured fold cost lies inside the
        batch's fold-cost band (tune.batch_balanced); always true without
        an autotune dir or without measurements: the balancer never
        refuses work it has not profiled."""
        if not self._autotune_dir:
            return True
        from avenir_tpu_torch.tune import batch_balanced

        costs = [self._fold_cost_locked(t._canonical, t.request.inputs)
                 for t in primaries]
        return batch_balanced(
            costs,
            self._fold_cost_locked(candidate._canonical,
                                   candidate.request.inputs),
            ratio=self._balance_ratio)

    def _scheduler_loop(self) -> None:
        while not self._shutdown.is_set():
            self._maybe_write_metrics()
            with self._work:
                batch = self._pick_batch_locked()
                if batch is None:
                    self._work.wait(_POLL_SECS)
                    continue
            while True:
                try:
                    self._dispatchq.put(batch, timeout=_POLL_SECS)
                    batch = None
                    break
                except queue.Full:
                    if self._shutdown.is_set():
                        break
            if batch is not None:
                # shutdown fired while the dispatch queue was full: the
                # batch was already admitted and its tickets removed
                # from the per-tenant queues, so the shutdown sweep
                # cannot see them — cancel and release here or clients
                # blocked in result() hang forever
                with self._work:
                    self._admission.release(batch.priced_bytes)
                    self._work.notify_all()
                for t in batch.tickets + [d for ds in batch.dups
                                          for d in ds]:
                    t._complete(error=ServerClosed(
                        "server shut down before the request was served"))

    # --------------------------------------------------- worker internals
    def _worker_loop(self) -> None:
        while True:
            try:
                batch = self._dispatchq.get(timeout=_POLL_SECS)
            except queue.Empty:
                if self._shutdown.is_set():
                    return
                continue
            try:
                self._execute(batch)
            finally:
                with self._work:
                    self._admission.release(batch.priced_bytes)
                    self._work.notify_all()

    def _execute(self, batch: _Batch) -> None:
        compiles_before = _fold_kernel_cache_size()
        try:
            results, warm_hit = self._run_batch(batch)
        except BaseException as exc:  # noqa: BLE001 — reported per ticket
            for ticket in batch.tickets + [d for ds in batch.dups
                                           for d in ds]:
                ticket._complete(error=exc)
            with self._lock:
                self._stats["failed"] += len(batch.tickets) \
                    + sum(len(d) for d in batch.dups)
            return
        compile_hit = 1.0 if _fold_kernel_cache_size() == compiles_before \
            else 0.0
        n = len(batch.tickets) + sum(len(d) for d in batch.dups)
        dispatch_ms = (time.perf_counter() - batch.dispatched_at) * 1000.0
        with self._lock:
            self._hists["dispatch_ms"].add(dispatch_ms)
        _obs.record("server.dispatch", batch.dispatched_at,
                    batch=batch.batch_id, mode=batch.mode, requests=n,
                    jobs=",".join(t._canonical or t.request.job
                                  for t in batch.tickets))
        for i, ticket in enumerate(batch.tickets):
            res = results[i]
            self._finish_ticket(ticket, res, batch, n, compile_hit,
                                warm_hit)
            for dup in batch.dups[i]:
                self._finish_ticket(
                    dup, _copy_result(res, ticket.request, dup.request),
                    batch, n, compile_hit, warm_hit)
        with self._lock:
            self._stats["served"] += n
            if compile_hit:
                self._stats["compile_warm_dispatches"] += 1
            if warm_hit:
                self._stats["warm_hits"] += 1

    def _finish_ticket(self, ticket: Ticket, res, batch: _Batch,
                       batch_n: int, compile_hit: float,
                       warm_hit: float) -> None:
        now = time.perf_counter()
        dispatched = ticket._dispatched_at or now
        wait_ms = (dispatched - ticket.submitted_at) * 1000.0
        held_ms = ticket._held_ms
        # the per-request scalars (unchanged keys/semantics) now ALSO
        # feed the server-level histograms, whose p50/p99 ride along on
        # every result — a tenant sees the fleet-wide tail next to its
        # own sample
        with self._lock:
            qh = self._hists["queue_wait_ms"].add(wait_ms)
            ah = self._hists["admission_held_ms"].add(held_ms)
            q50, q99 = qh.quantile(50), qh.quantile(99)
            h50, h99 = ah.quantile(50), ah.quantile(99)
        res.counters["Server:QueueWaitMs"] = round(wait_ms, 3)
        res.counters["Server:BatchSize"] = float(batch_n)
        res.counters["Server:CompileHits"] = compile_hit
        res.counters["Server:AdmissionHeldMs"] = round(held_ms, 3)
        res.counters["Server:WarmHit"] = warm_hit
        res.counters["Server:QueueWaitP50Ms"] = round(q50, 3)
        res.counters["Server:QueueWaitP99Ms"] = round(q99, 3)
        res.counters["Server:AdmissionHeldP50Ms"] = round(h50, 3)
        res.counters["Server:AdmissionHeldP99Ms"] = round(h99, 3)
        # the request's span trail: queued -> (held) -> dispatched ->
        # finished, all linked to the batch by its dispatch ordinal
        req = ticket.request
        link = dict(req_id=req.req_id, tenant=req.tenant,
                    job=ticket._canonical or req.job,
                    batch=batch.batch_id)
        if _obs.enabled():
            _obs.recorder().record(
                "server.queued", ticket.submitted_at,
                max(dispatched - ticket.submitted_at, 0.0), attrs=link)
        if held_ms > 0:
            self._obs_record_held(dispatched, held_ms, link)
        _obs.record("server.request", ticket.submitted_at, mode=req.mode,
                    batch_size=batch_n, **link)
        ticket._complete(result=res)

    @staticmethod
    def _obs_record_held(dispatched: float, held_ms: float,
                         link: Dict) -> None:
        # a held batch is re-checked until it admits, so the hold ends
        # exactly at dispatch: reconstruct t0 from the accumulated hold
        if _obs.enabled():
            t0 = dispatched - held_ms / 1000.0
            _obs.recorder().record("server.held", t0, held_ms / 1000.0,
                                   attrs=link)

    def _conf_with_tune_dir(self, conf):
        """The request conf with the server's `autotune_dir` as
        `stream.autotune.dir` (unless the tenant set one), so the profiles
        the runner writes land in the store the pricer and the balancer
        read. The conf digest leaves the autotune keys out, so the
        injection never invalidates a tenant's checkpoints. A properties
        file path passes untouched: the file is the tenant's."""
        if not self._autotune_dir:
            return conf
        from avenir_tpu_torch.core.config import JobConfig

        if isinstance(conf, dict):
            if "stream.autotune.dir" in conf:
                return conf
            return {**conf, "stream.autotune.dir": self._autotune_dir}
        if isinstance(conf, JobConfig):
            if conf.get("stream.autotune.dir"):
                return conf
            props = dict(conf.props)
            props["stream.autotune.dir"] = self._autotune_dir
            return JobConfig(props, conf.prefix)
        return conf

    def _run_batch(self, batch: _Batch) -> Tuple[List, float]:
        """Execute primaries through the registered runner paths;
        (one JobResult per primary index-aligned, warm-hit flag)."""
        from avenir_tpu_torch.runner import (run_incremental_shared, run_job,
                                       run_shared)

        reqs = [t.request for t in batch.tickets]
        inputs = reqs[0].inputs
        if batch.mode == "refresh":
            state_dirs = {}
            managed: List[str] = []
            self._checkout_sidecars(reqs)
            try:
                for req in reqs:
                    canonical = _scoped(req.job, req.conf)[0]
                    sd = req.state_dir
                    if not sd:
                        sd = self.warm.checkpoint_dir(canonical,
                                                      req.inputs)
                        managed.append(sd)
                    state_dirs[canonical] = sd
                shared = run_incremental_shared(
                    [(r.job, self._conf_with_tune_dir(r.conf), r.output)
                     for r in reqs], inputs,
                    state_dirs=state_dirs, device=self.device)
            finally:
                for sd in managed:
                    self.warm.release_dir(sd)
                self._pin_sidecars(reqs)
            return [shared[_scoped(r.job, r.conf)[0]] for r in reqs], 0.0
        if not batch.streamable:
            return [run_job(reqs[0].job,
                            self._conf_with_tune_dir(reqs[0].conf),
                            reqs[0].inputs, reqs[0].output,
                            device=self.device)], 0.0
        # warm miner fast path: a lone mining request over a corpus
        # whose pinned source is still content-valid replays encoded
        # blocks — zero CSV parses
        if len(reqs) == 1:
            res = self._try_warm_miner(reqs[0])
            if res is not None:
                return [res], 1.0
        captured: Dict[str, object] = {}

        def fold_hook(canonical: str, fold) -> None:
            if canonical in _MINER_JOBS:
                fold.keep_sources = True
                captured[canonical] = fold

        self._checkout_sidecars(reqs)
        try:
            try:
                shared = run_shared(
                    [(r.job, self._conf_with_tune_dir(r.conf), r.output)
                     for r in reqs],
                    inputs, device=self.device, fold_hook=fold_hook)
            except BaseException:
                # a fold marked keep_sources holds its source (and spill
                # cache) open for pinning; on a failed batch nothing will
                # pin it — close here or a resident server leaks an fd
                # and on-disk cache segments per failed request
                for fold in captured.values():
                    src = getattr(fold, "src", None)
                    if src is not None:
                        try:
                            src.close()
                        except Exception:  # noqa: BLE001 — teardown
                            pass
                raise
            for canonical, fold in captured.items():
                req = next(r for r in reqs
                           if _scoped(r.job, r.conf)[0] == canonical)
                cfg = _scoped(req.job, req.conf)[2]
                self.warm.pin(
                    WarmStore.source_key(canonical, req.inputs, cfg),
                    fold.src)
        finally:
            # checked-out sidecar entries MUST return to the warm
            # store's byte accounting even when the batch raises —
            # mirrors the refresh branch (pin is advisory-safe)
            self._pin_sidecars(reqs)
        return [shared[_scoped(r.job, r.conf)[0]] for r in reqs], 0.0

    def _sidecar_keys(self, reqs):
        """(key, path, dirpath) for every input sidecar a streamed batch
        could touch, resolved from each request's own config — the dir
        name bakes in schema/delimiter/block size, so two jobs over the
        same file with different parse configs pin distinct entries.

        key-covered: all — the dir basename is the sidecar view digest.
        """
        from avenir_tpu_torch.core.keys import key_site
        from avenir_tpu_torch.native import sidecar as sc
        from avenir_tpu_torch.runner import _schema, stream_fold_ops

        key_site("warm.sidecar.pin")
        out = []
        seen = set()
        for req in reqs:
            try:
                canonical, _prefix, cfg = _scoped(req.job, req.conf)
                ops = stream_fold_ops(canonical)
                opts = sc.opts_from_cfg(cfg)
                if opts is None:
                    continue
                block = int(cfg.get_float("stream.block.size.mb",
                                          64.0) * (1 << 20))
                delim = cfg.field_delim_regex
                for path in req.inputs:
                    if ops.kind == "dataset":
                        dirpath = sc.dataset_dir(opts, path, _schema(cfg),
                                                 delim, block)
                    else:
                        dirpath = sc.bytes_dir(
                            opts, path, delim,
                            cfg.get_int("skip.field.count", 1), block)
                    key = ("sidecar", os.path.abspath(path),
                           os.path.basename(dirpath))
                    if key in seen:
                        continue
                    seen.add(key)
                    out.append((key, path, dirpath))
            except Exception:  # noqa: BLE001 — advisory resolution
                continue
        return out

    def _checkout_sidecars(self, reqs) -> None:
        """Exclusively check pinned sidecar entries out of the warm
        store for the duration of a streamed batch so a concurrent
        budget squeeze cannot rmtree a directory the scan is replaying.
        The checked-out handles are deliberately dropped (a handle owns
        no fd); _pin_sidecars() re-registers fresh ones afterwards."""
        try:
            for key, _path, _dirpath in self._sidecar_keys(reqs):
                self.warm.lookup(key)
        except Exception:  # noqa: BLE001 — advisory
            pass

    def _pin_sidecars(self, reqs) -> None:
        """After a streamed batch, pin each input's (now-written)
        sidecar under the warm store's byte budget.  Eviction calls
        SidecarHandle.close(), which deletes the directory — the
        sidecar is a bounded cache, and the server is its landlord."""
        try:
            from avenir_tpu_torch.native import sidecar as sc
            for key, path, dirpath in self._sidecar_keys(reqs):
                handle = sc.SidecarHandle(path, dirpath)
                if handle.cache_ready():
                    self.warm.pin(key, handle)
        except Exception:  # noqa: BLE001 — advisory
            pass

    def _try_warm_miner(self, req: JobRequest):
        from avenir_tpu_torch.runner import run_warm_miner

        canonical, _prefix, cfg = _scoped(req.job, req.conf)
        if canonical not in _MINER_JOBS:
            return None
        key = WarmStore.source_key(canonical, req.inputs, cfg)
        src = self.warm.lookup(key)       # exclusive checkout
        if src is None:
            return None
        try:
            res = run_warm_miner(req.job, req.conf, req.inputs,
                                 req.output, src, device=self.device)
        except BaseException:
            src.close()                   # mid-mine state: never re-pin
            raise
        self.warm.pin(key, src)
        return res


def _copy_result(res, primary: JobRequest, dup: JobRequest):
    """A coalesced requester's JobResult: the primary's artifact files
    copied under the duplicate's output path (byte-identical by
    construction), counters duplicated so the Server:* injection stays
    per-ticket."""
    from avenir_tpu_torch.runner import JobResult

    outputs: List[str] = []
    primary_out = os.path.abspath(primary.output)
    dup_out = os.path.abspath(dup.output)
    for src_path in res.outputs:
        sp = os.path.abspath(src_path)
        if sp == primary_out:
            target = dup_out
        else:
            rel = os.path.relpath(sp, primary_out)
            target = os.path.join(dup_out, rel)
        os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
        shutil.copyfile(sp, target)
        outputs.append(target)
    return JobResult(res.name, dict(res.counters), outputs, res.payload)
