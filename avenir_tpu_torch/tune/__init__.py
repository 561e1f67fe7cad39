"""The autotune loop: from the span telemetry to the streaming knobs.

The port of `avenir_tpu/tune/`, with the reference's names, knob keys,
profile layout, span name (``tune.decide``) and error texts, so that a
profile written by either package loads in the other:

- **knob registry** (:mod:`~avenir_tpu_torch.tune.knobs`): every tunable
  conf key with its safe range; unknown or out-of-range keys in a tuned
  profile fail loudly (:class:`KnobError`).
- **signals** (:mod:`~avenir_tpu_torch.tune.signals`): captured spans ->
  read/parse/fold totals, stall attribution, per-sink fold-cost means.
- **policy** (:mod:`~avenir_tpu_torch.tune.policy`): deterministic
  signal -> knob-move rules, clamped to the registry; the residual
  admission factor (never under 1.0) and the server's batch-balance
  predicate.
- **profile store** (:mod:`~avenir_tpu_torch.tune.store`): atomic
  per-(job, corpus) JSON profiles, read by ``runner.run_job``,
  ``run_shared`` and ``run_incremental`` behind the ``stream.autotune``
  key (the CLI's ``--autotune``) and by the job server and the fleet
  (``JobServer(autotune_dir=)``, ``Fleet(profile_dir=)``); ``python -m
  avenir_tpu_torch tune <dir>`` renders them.

This module is the runner-facing glue: :func:`begin_run` overlays the
stored knobs onto the job configs and hands back the session that
records the run and chooses the next knobs; :func:`record_residual`
keeps the predicted-vs-measured RSS history; :func:`make_tuned_pricer`
is the residual-corrected admission oracle and :func:`placement_cost_ms`
the fleet's placement weight. Host code only: nothing here imports
torch.

The spans the session reads are host-clock spans: a fold that only
launches device work closes its ``stream.fold`` span before the device
finishes, so on a card the read-vs-fold balance sees the fold's host
side. The rules are the reference's, applied to what the port measures.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Sequence

from avenir_tpu_torch import obs as _obs
from avenir_tpu_torch.tune.knobs import (CONTROL_KEYS, KNOBS, Knob, KnobError,
                                         format_value, knob_defaults,
                                         knob_keys, validate_knobs)
from avenir_tpu_torch.tune.policy import (BATCH_BALANCE_RATIO,
                                          RESIDUAL_FACTOR_CAP, batch_balanced,
                                          choose_knobs, residual_factor)
from avenir_tpu_torch.tune.signals import RunSignals, extract_signals
from avenir_tpu_torch.tune.store import (ProfileStore, corpus_digest,
                                         resolve_dir)

__all__ = [
    "KNOBS", "Knob", "KnobError", "CONTROL_KEYS",
    "knob_keys", "knob_defaults", "validate_knobs", "format_value",
    "RunSignals", "extract_signals",
    "choose_knobs", "residual_factor", "batch_balanced",
    "BATCH_BALANCE_RATIO", "RESIDUAL_FACTOR_CAP",
    "ProfileStore", "corpus_digest", "resolve_dir",
    "begin_run", "record_residual", "make_tuned_pricer",
    "placement_cost_ms",
]


def _effective_knobs(cfg) -> Dict[str, object]:
    """The knob values a run will use, read back through the config after
    the overlay: tuned values, explicit conf keys and defaults alike."""
    out: Dict[str, object] = {}
    for key, knob in KNOBS.items():
        if knob.kind == "int":
            out[key] = int(cfg.get_float(key, knob.default))
        else:
            out[key] = float(cfg.get_float(key, knob.default))
    return out


#: sessions between begin_run and finish. The span ring is process-global,
#: so when two overlap neither window can be attributed to one corpus:
#: every overlapping session is marked contaminated and skips its signal
#: and knob recording (the run, its overlay and the residuals are not
#: affected). The job server's executors and the score plane share it.
_session_lock = threading.Lock()
_active_sessions: set = set()


class RunSession:
    """One autotuned run, made by :func:`begin_run` (which has already
    overlaid the stored knobs onto the configs); ``finish()`` extracts the
    run's spans from the process-global recorder, records the signal row
    and commits the next run's knobs."""

    def __init__(self, store: ProfileStore, profile_job: str, digest: str,
                 canonicals: Sequence[str], knobs_used: Dict,
                 knobs_applied: Dict):
        self.store = store
        self.profile_job = profile_job
        self.digest = digest
        self.canonicals = list(canonicals)
        self.knobs_used = dict(knobs_used)
        self.knobs_applied = dict(knobs_applied)
        self.contaminated = False
        with _session_lock:
            if _active_sessions:
                self.contaminated = True
                for other in _active_sessions:
                    other.contaminated = True
            _active_sessions.add(self)
        self.t0 = _obs.now()

    def close(self) -> None:
        """Abandon the session without recording: the runner's failure
        path. A run that raises must call it, or the session stays in
        ``_active_sessions`` and contaminates every later one."""
        with _session_lock:
            _active_sessions.discard(self)

    def finish(self, results: Dict) -> Optional[Dict]:
        """Record the run and choose the next knobs. Advisory: a failure
        here never fails a job that already ran, so errors are swallowed.
        The knobs committed are the profile values this run applied plus
        this round's clamped moves: an operator's explicit conf value is
        never adopted as a tuned knob, so set_knobs' validation cannot
        trip on legal conf outside the registry range. Returns the
        committed knobs, or None when the session was contaminated or the
        recording failed."""
        with _session_lock:
            _active_sessions.discard(self)
        if self.contaminated:
            return None
        try:
            wall_s = _obs.now() - self.t0
            spans = [sp for sp in _obs.recorder().spans()
                     if sp.t0 >= self.t0]
            # the session guard sees only autotuned sessions; a concurrent
            # untuned streamed job shares the span ring too, and its fold
            # spans carry its canonical name as the sink: a registered
            # stream job folding in this window that is not ours makes
            # the window unattributable
            from avenir_tpu_torch.runner import stream_fold_names

            sinks = {(sp.attrs or {}).get("sink") for sp in spans
                     if sp.name == "stream.fold"}
            if (sinks & set(stream_fold_names())) - set(self.canonicals):
                return None
            sig = extract_signals(spans, wall_s=wall_s)
            counters: Dict[str, float] = {}
            for res in results.values():
                for key, val in getattr(res, "counters", {}).items():
                    counters[key] = max(counters.get(key, 0.0),
                                        float(val))
            moves, reasons = choose_knobs(sig, counters, self.knobs_used)
            chosen = dict(self.knobs_applied)
            chosen.update(moves)
            self.store.record_run(self.profile_job, self.digest,
                                  sig.to_json(), self.knobs_used, wall_s)
            self.store.set_knobs(self.profile_job, self.digest, chosen,
                                 reasons)
            # a fused run's per-sink fold means feed each member job's
            # own profile: the numbers the server's batch balancer reads
            if len(self.canonicals) > 1:
                for canonical in self.canonicals:
                    cost = sig.fold_ms_by_sink.get(canonical)
                    if cost:
                        self.store.note_fold_cost(canonical, self.digest,
                                                  cost)
            _obs.record("tune.decide", _obs.now(), job=self.profile_job,
                        moves=len(reasons))
            return chosen
        except Exception:
            return None


def begin_run(canonicals: Sequence[str], cfgs: Sequence,
              inputs: Sequence[str]) -> RunSession:
    """Start one autotuned run: load the (job, corpus) profile, overlay its
    validated knobs onto every config (fused jobs must agree on the
    scan-shaping keys, so one knob set serves the group), and return the
    session whose ``finish()`` closes the loop.

    Raises :class:`KnobError` when the stored profile names an unknown or
    out-of-range knob; the caller degrades every other storage problem
    to an untuned run."""
    cfg0 = cfgs[0]
    store = ProfileStore(resolve_dir(cfg0, inputs))
    profile_job = "+".join(sorted(canonicals))
    digest = corpus_digest(inputs)
    prof = store.load(profile_job, digest)       # may raise KnobError
    knobs = dict(prof.get("knobs") or {}) if prof else {}
    for cfg in cfgs:
        for key, value in knobs.items():
            pref = f"{cfg.prefix}.{key}" if cfg.prefix else key
            cfg.props[pref] = format_value(key, value)
    return RunSession(store, profile_job, digest, canonicals,
                      _effective_knobs(cfg0), knobs)


def record_residual(canonical: str, cfg, inputs: Sequence[str],
                    predicted: float, measured: float) -> None:
    """Persist one predicted-vs-measured RSS residual into the job's
    profile. ``runner._add_mem_counters`` calls it on every streamed
    result whose run raised the process peak, autotune on or off, so the
    admission correction has history from the first run. A store that
    cannot be written (a read-only input directory, a race) is skipped."""
    try:
        store = ProfileStore(resolve_dir(cfg, inputs))
        store.record_residual(canonical, corpus_digest(inputs),
                              predicted, measured)
    except Exception:
        return


def make_tuned_pricer(profile_dir: str,
                      base: Optional[Callable] = None) -> Callable:
    """The residual-corrected admission oracle: the analytic pricer times
    the per-(job, corpus) learned factor (:func:`residual_factor`, clamped
    into [1.0, cap]), so the correction can raise the price of a job that
    measured over its prediction and never lowers one below the bare
    model's."""
    if base is None:
        from avenir_tpu_torch.server.jobserver import price_request_bytes
        base = price_request_bytes

    store = ProfileStore(profile_dir)

    def pricer(requests, reserve_bytes: int) -> int:
        raw = base(requests, reserve_bytes)
        factor = 1.0
        try:
            from avenir_tpu_torch.runner import _job_cfg

            for req in requests:
                canonical = _job_cfg(req.job, req.conf)[0]
                try:
                    prof = store.load(canonical,
                                      corpus_digest(req.inputs))
                except KnobError:
                    prof = None          # a bad knob entry: the run fails
                if prof is None:         # loudly on it, not the pricing
                    continue
                factor = max(factor, residual_factor(
                    prof.get("residuals") or []))
        except Exception:
            factor = 1.0
        return int(raw * max(factor, 1.0))

    return pricer


def placement_cost_ms(profile_dir: Optional[str], job: str, conf,
                      inputs: Sequence[str]) -> Optional[float]:
    """The measured mean per-chunk fold cost (ms) of one (job, corpus) from
    a profile store: the fleet router's placement weight. None, never an
    exception, when there is no store, profile or measurement: placement
    degrades to bytes only rather than refusing to route."""
    if not profile_dir:
        return None
    try:
        from avenir_tpu_torch.runner import _job_cfg

        canonical = _job_cfg(job, conf)[0]
    except Exception:  # noqa: BLE001 — unresolvable job: bytes-only
        canonical = job
    try:
        return ProfileStore(profile_dir).fold_cost_ms(
            canonical, corpus_digest(inputs))
    except Exception:  # noqa: BLE001 — unreadable store: bytes-only
        return None
