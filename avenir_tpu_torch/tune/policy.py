"""The policy engine: deterministic signal -> knob-move rules.

The port's copy of `avenir_tpu/tune/policy.py`: the same rules, constants
and reason texts, so the port's tuner moves the knobs the reference's
would on the same signals. Every rule is a pure function from a
:class:`~avenir_tpu_torch.tune.signals.RunSignals` row (plus the result
counters where the signal lives there) to one knob's next value and a
one-line reason. Rules only emit values inside the registry's safe range
(:meth:`Knob.clamp`), and the folds are chunk-invariant, so any emitted
value changes speed, never bytes.

The rules:

- **block size**: aim for enough chunks that the producer/consumer
  pipeline overlaps (``TARGET_CHUNKS`` a scan, fewer when the measured
  work is small), then shift by the measured read-vs-fold balance: a
  producer-bound scan wants bigger blocks to amortize per-block
  read/parse overhead, a consumer-bound one smaller blocks. Snapped to
  powers of two so repeated tuning converges.
- **prefetch depth**: deepen when the producer-bound stall share
  dominates; step back toward the default when the stalls say the
  consumer is the bottleneck.
- **checkpoint interval**: double while ``job.checkpoint`` time exceeds
  its wall-clock budget share.
- **encoded cache budget**: grow over the measured spill when the
  miners' cache evicted under pressure.

The spans are host-clock spans (``obs/trace.py`` never synchronizes the
device), so on a card a fold span measures the fold's host work and its
launches, not the device's run; the rules read them as the reference
reads its own spans.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple

from avenir_tpu_torch.tune.knobs import KNOBS, Number
from avenir_tpu_torch.tune.signals import RunSignals

#: chunk-count ceiling per scan: few enough that per-chunk overhead is
#: noise, many enough that the depth-2 pipeline overlaps and the tail
#: (first/last chunk with no overlap partner) is a small fraction
TARGET_CHUNKS = 24
#: floor on the measured scan work one chunk should carry: cutting a
#: corpus finer than this buys no overlap (the per-chunk fold dispatch
#: and parse-call overhead is then comparable to the chunk's work), so
#: small corpora keep big blocks — the chunk target is
#: min(TARGET_CHUNKS, measured work / this)
MIN_CHUNK_WORK_SECS = 0.25
#: read-vs-fold imbalance ratio past which the block size shifts
BALANCE_RATIO = 1.5
#: stall share of wall clock past which prefetch depth moves
STALL_SHARE = 0.10
#: wall-clock share budget for checkpoint serialization
CHECKPOINT_BUDGET_SHARE = 0.05
#: headroom multiplier when re-sizing the cache budget over its spill
CACHE_HEADROOM = 1.5

Move = Tuple[Optional[Number], Optional[str]]


def _pow2_mb(mb: float) -> float:
    """Snap to the nearest power of two (in MB) so successive tuning
    rounds land on the same grid instead of dithering around it."""
    return float(2.0 ** round(math.log2(max(mb, 1e-6))))


def choose_block_mb(sig: RunSignals, current: float) -> Move:
    """(next stream.block.size.mb, reason) — None when the signals
    give no grounds to move."""
    knob = KNOBS["stream.block.size.mb"]
    if sig.bytes_read <= 0 or sig.chunks <= 0:
        return None, None
    # chunk target bounded by the MEASURED work: a scan worth 12s of
    # ingest+fold overlaps nicely at 24 chunks, but a 0.2s one pays
    # more per-chunk overhead than it could ever overlap away — small
    # corpora therefore converge to one whole-corpus block
    work_s = sig.ingest_s + sig.fold_s
    chunk_target = max(1, min(TARGET_CHUNKS,
                              int(work_s / MIN_CHUNK_WORK_SECS)))
    target = sig.bytes_read / float(chunk_target) / (1 << 20)
    why = (f"{sig.chunks} chunks over {sig.bytes_read >> 20}MB, "
           f"targeting {chunk_target}")
    if chunk_target >= 4:
        # the read-vs-fold balance shift only means something when the
        # scan is big enough to pipeline at all
        if sig.fold_s > 0 and sig.ingest_s > BALANCE_RATIO * sig.fold_s:
            target *= 2.0
            why += (f"; producer-bound (ingest {sig.ingest_s:.2f}s vs "
                    f"fold {sig.fold_s:.2f}s): bigger blocks amortize "
                    f"read/parse")
        elif sig.ingest_s > 0 and sig.fold_s > BALANCE_RATIO * sig.ingest_s:
            target *= 0.5
            why += (f"; consumer-bound (fold {sig.fold_s:.2f}s vs ingest "
                    f"{sig.ingest_s:.2f}s): smaller blocks overlap finer")
    chosen = knob.clamp(_pow2_mb(target))
    if chosen == float(current):
        return None, None
    return chosen, f"block {current:g}->{chosen:g}MB ({why})"


def choose_prefetch_depth(sig: RunSignals, current: int) -> Move:
    """(next stream.prefetch.depth, reason): deepen when the consumer
    measurably waited on the producer, shallow back toward the default
    when the producer waited on the consumer (queued depth then buys
    nothing but resident blocks)."""
    knob = KNOBS["stream.prefetch.depth"]
    cur = int(knob.clamp(current))
    if sig.producer_bound_share >= STALL_SHARE:
        chosen = int(knob.clamp(cur * 2))
        if chosen != cur:
            return chosen, (
                f"prefetch {cur}->{chosen}: producer-bound stalls were "
                f"{100 * sig.producer_bound_share:.0f}% of wall")
        return None, None
    if (sig.consumer_bound_share >= STALL_SHARE
            and cur > int(knob.default)):
        chosen = int(knob.clamp(max(cur // 2, int(knob.default))))
        return chosen, (
            f"prefetch {cur}->{chosen}: consumer-bound stalls were "
            f"{100 * sig.consumer_bound_share:.0f}% of wall — extra "
            f"depth only held memory")
    return None, None


def choose_checkpoint_interval_mb(sig: RunSignals, current: float) -> Move:
    """(next stream.checkpoint.interval.mb, reason): double the
    interval while serialization exceeds its wall share budget."""
    knob = KNOBS["stream.checkpoint.interval.mb"]
    if sig.checkpoint_share <= CHECKPOINT_BUDGET_SHARE:
        return None, None
    chosen = knob.clamp(float(current) * 2.0)
    if chosen <= float(current):
        return None, None
    return chosen, (
        f"checkpoint interval {current:g}->{chosen:g}MB: "
        f"serialization was {100 * sig.checkpoint_share:.0f}% of wall "
        f"(budget {100 * CHECKPOINT_BUDGET_SHARE:.0f}%)")


def choose_cache_budget_mb(counters: Mapping[str, float],
                           current: float) -> Move:
    """(next stream.encoded.cache.budget.mb, reason): grow the budget
    over the measured spill when the cache evicted under pressure."""
    knob = KNOBS["stream.encoded.cache.budget.mb"]
    evicted = float(counters.get("Cache:EvictedBytes", 0.0) or 0.0)
    spill = float(counters.get("Cache:SpillBytes", 0.0) or 0.0)
    if evicted <= 0 or spill <= 0:
        return None, None
    want = knob.clamp(_pow2_mb(CACHE_HEADROOM * spill / (1 << 20)))
    if want <= knob.clamp(current):
        return None, None
    return want, (
        f"cache budget {current:g}->{want:g}MB: "
        f"{int(evicted) >> 20}MB evicted under a {int(spill) >> 20}MB "
        f"spill — evicted sources re-parse CSV every pass-k")


def choose_knobs(sig: RunSignals, counters: Mapping[str, float],
                 current: Mapping[str, Number]
                 ) -> Tuple[Dict[str, Number], List[str]]:
    """Run every rule against one run's signals; returns ONLY this
    round's moves (each clamped into its registry range) and their
    human-readable reasons. `current` holds the values the run actually
    used — the rules' reference point, whether those came from the
    profile, an explicit conf key or the defaults. Carrying earlier
    rounds' knobs forward is the SESSION's job (it merges moves over
    the values it applied from the profile): adopting an arbitrary
    conf value here would persist operator conf as a \"tuned\" knob —
    including legal values outside the registry range, which the store
    would then loudly (and wrongly) refuse."""
    chosen: Dict[str, Number] = {}
    reasons: List[str] = []
    defaults = {k: v.default for k, v in KNOBS.items()}
    moves = (
        ("stream.block.size.mb",
         choose_block_mb(sig, float(current.get(
             "stream.block.size.mb", defaults["stream.block.size.mb"])))),
        ("stream.prefetch.depth",
         choose_prefetch_depth(sig, int(current.get(
             "stream.prefetch.depth",
             defaults["stream.prefetch.depth"])))),
        ("stream.checkpoint.interval.mb",
         choose_checkpoint_interval_mb(sig, float(current.get(
             "stream.checkpoint.interval.mb",
             defaults["stream.checkpoint.interval.mb"])))),
        ("stream.encoded.cache.budget.mb",
         choose_cache_budget_mb(counters, float(current.get(
             "stream.encoded.cache.budget.mb",
             defaults["stream.encoded.cache.budget.mb"])))),
    )
    for key, (value, reason) in moves:
        if value is not None:
            chosen[key] = value
            reasons.append(reason)
    return chosen, reasons


# --------------------------------------------------------------------------
# admission-model residual correction
# --------------------------------------------------------------------------
#: ceiling on the learned correction factor — matches the mem auditor's
#: non-vacuity bound (a model needing more than this is broken, and an
#: unbounded factor would let one wild RSS reading price everything out)
RESIDUAL_FACTOR_CAP = 8.0
#: how many newest residual records inform the factor
RESIDUAL_WINDOW = 8


def residual_factor(residuals, cap: float = RESIDUAL_FACTOR_CAP) -> float:
    """Learned per-job correction of the analytic footprint model from
    its recorded predicted-vs-measured residuals: the WORST (largest)
    measured/predicted ratio over the newest window, clamped into
    [1.0, cap].

    The 1.0 floor is the admission-safety clause: a job that measured
    UNDER its prediction never lowers its price below the uncorrected
    model — the validated model stays the admission floor, and the
    correction can only make admission more conservative (a unit test
    pins this). The cap keeps one pathological sample (a sticky-RSS
    reading in a long process) from pricing every future request out of
    the budget."""
    worst = 1.0
    recent = list(residuals)[-RESIDUAL_WINDOW:]
    for rec in recent:
        try:
            predicted = float(rec["predicted"])
            measured = float(rec["measured"])
        except (KeyError, TypeError, ValueError):
            continue
        if predicted > 0 and measured > 0:
            worst = max(worst, measured / predicted)
    return min(max(worst, 1.0), float(cap))


# --------------------------------------------------------------------------
# server batch composition
# --------------------------------------------------------------------------
#: default width of the fold-cost band one batch may span
BATCH_BALANCE_RATIO = 4.0


def batch_balanced(batch_costs_ms, candidate_cost_ms: Optional[float],
                   ratio: float = BATCH_BALANCE_RATIO) -> bool:
    """True when adding a sink with `candidate_cost_ms` mean per-chunk
    fold cost keeps the batch's costs within a `ratio` band (max/min).

    A shared scan's chunk latency is the SUM of its sinks' folds, so a
    batch mixing a microsecond fold with a second-long one makes the
    cheap job's chunks wait on the expensive one for no ingest saving
    it could notice — the scheduler stops the compatible prefix there
    instead. Unknown costs (no profile yet) always balance: the tuner
    must never make the server refuse work it simply hasn't measured."""
    if candidate_cost_ms is None:
        return True
    known = [c for c in batch_costs_ms if c is not None and c > 0]
    if not known or candidate_cost_ms <= 0:
        return True
    lo = min(known + [candidate_cost_ms])
    hi = max(known + [candidate_cost_ms])
    return hi <= ratio * lo
