"""The profile store: per-(job, corpus) tuning state on disk.

The port's copy of `avenir_tpu/tune/store.py`, in the reference's layout
(``FORMAT_VERSION`` 1, the same keys, ``indent=1`` JSON), so a profile
either package writes loads in the other. One JSON file per (job, corpus
digest) under the autotune directory (``stream.autotune.dir`` when
configured, else ``.avenir_tune/`` next to the first input), holding the
last runs' signals, the predicted-vs-measured RSS residual history, the
per-chunk fold-cost mean (the job server's batch balancer and the
fleet's placement read it) and the chosen knobs with their reasons.

Writes are tmp file + ``os.replace`` (``core/atomic.publish_json``): a
killed writer leaves the previous profile, never a torn one. Concurrent
writers last-write-win a whole file; a lost run record costs one history
sample, never a wrong knob.

Loading validates the knob mapping against the registry and raises
:class:`~avenir_tpu_torch.tune.knobs.KnobError` on an unknown key or an
out-of-range value. Everything else about a profile is advisory.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from avenir_tpu_torch.core.atomic import publish_json, sweep_stale_tmps
from avenir_tpu_torch.core.keys import corpus_digest  # noqa: F401
from avenir_tpu_torch.tune.knobs import validate_knobs

#: profile-file layout version; a profile stamped with a DIFFERENT
#: version refuses to load (cold start) — old readers must never
#: silently parse a newer layout
FORMAT_VERSION = 1

#: newest run-signal records a profile retains
MAX_RUNS = 16
#: newest residual records a profile retains
MAX_RESIDUALS = 32
#: EWMA blend of a new fold-cost sample into the stored mean
FOLD_COST_BLEND = 0.5

#: default store directory name (next to the first input, like the
#: incremental driver's .avenir_incremental)
DEFAULT_DIR_NAME = ".avenir_tune"


def resolve_dir(cfg, inputs: Sequence[str]) -> str:
    """Where the profile store lives for a job config + input set:
    the ``stream.autotune.dir`` key, else ``.avenir_tune/`` next to the
    first input."""
    explicit = cfg.get("stream.autotune.dir") if cfg is not None else None
    if explicit:
        return explicit
    base = os.path.dirname(os.path.abspath(inputs[0]))
    return os.path.join(base, DEFAULT_DIR_NAME)


def _fresh(job: str, digest: str) -> Dict:
    return {"format": 1, "format_version": FORMAT_VERSION,
            "job": job, "corpus_digest": digest,
            "knobs": {}, "reasons": [], "runs": [], "residuals": [],
            "fold_cost_ms": None}


class ProfileStore:
    """Load/update profiles under one autotune directory.

    Concurrency contract — last-write-wins: profiles are ADVISORY
    measurements (placement weights, knob priors), republished whole
    via atomic tmp+rename. Two hosts recording runs concurrently may
    drop one run's record; the cost is a slightly staler prior, never
    a wrong result, and serializing writers would put a lock on every
    scan's hot path for it."""

    def __init__(self, root: str):
        self.root = root
        # startup GC: tmp files a hard-killed writer left behind (the
        # age gate keeps a concurrent writer's live tmp safe; a root
        # that does not exist yet is a no-op)
        sweep_stale_tmps(root)

    def path(self, job: str, digest: str) -> str:
        return os.path.join(self.root, f"{job}_{digest}.json")

    # --------------------------------------------------------------- io
    def load(self, job: str, digest: str) -> Optional[Dict]:
        """The profile dict, or None when there is none (or what is on
        disk is unparsable — advisory state, cold start over). The knob
        mapping is validated: an unknown/out-of-range knob key raises
        KnobError — loudly, by contract."""
        path = self.path(job, digest)
        try:
            with open(path) as fh:
                prof = json.load(fh)
        except (OSError, ValueError):
            return None
        if not isinstance(prof, dict):
            return None
        if prof.get("format_version", FORMAT_VERSION) != FORMAT_VERSION:
            # version-skewed profile: refuse to serve, go cold (a
            # MISSING stamp is a pre-versioning profile and still
            # loads — upgrading never invalidates on-disk state)
            return None
        prof["knobs"] = validate_knobs(dict(prof.get("knobs") or {}),
                                       source=path)
        return prof

    def _save(self, prof: Dict) -> str:
        os.makedirs(self.root, exist_ok=True)
        path = self.path(prof["job"], prof["corpus_digest"])
        return publish_json(prof, path, site="profile.save", indent=1)

    def _load_or_fresh(self, job: str, digest: str) -> Dict:
        return self.load(job, digest) or _fresh(job, digest)

    # -------------------------------------------------------- mutation
    def record_run(self, job: str, digest: str, signals_json: Dict,
                   knobs_used: Dict, wall_s: float) -> Dict:
        """Append one run's signal record (window-bounded) and fold the
        run's total per-chunk fold cost into the stored mean."""
        prof = self._load_or_fresh(job, digest)
        runs = list(prof.get("runs") or [])
        runs.append({"wall_s": round(float(wall_s), 4),
                     "knobs_used": dict(knobs_used),
                     "signals": dict(signals_json)})
        prof["runs"] = runs[-MAX_RUNS:]
        fold_ms = signals_json.get("fold_ms_by_sink") or {}
        total_ms = sum(float(v) for v in fold_ms.values())
        if total_ms > 0:
            prev = prof.get("fold_cost_ms")
            prof["fold_cost_ms"] = round(
                total_ms if prev is None
                else FOLD_COST_BLEND * total_ms
                + (1.0 - FOLD_COST_BLEND) * float(prev), 3)
        self._save(prof)
        return prof

    def set_knobs(self, job: str, digest: str, knobs: Dict,
                  reasons: List[str]) -> Dict:
        """Commit the knob values the NEXT run over this (job, corpus)
        should use; values are registry-validated before the write so a
        buggy policy can never persist an invalid profile."""
        prof = self._load_or_fresh(job, digest)
        prof["knobs"] = validate_knobs(dict(knobs), source="set_knobs")
        if reasons:
            prof["reasons"] = list(reasons)
        self._save(prof)
        return prof

    def record_residual(self, job: str, digest: str,
                        predicted: float, measured: float) -> Dict:
        """Append one predicted-vs-measured RSS residual record — the
        model-refinement history :func:`~avenir_tpu_torch.tune.policy.
        residual_factor` consumes."""
        prof = self._load_or_fresh(job, digest)
        residuals = list(prof.get("residuals") or [])
        residuals.append({"predicted": int(predicted),
                          "measured": int(measured)})
        prof["residuals"] = residuals[-MAX_RESIDUALS:]
        self._save(prof)
        return prof

    def note_fold_cost(self, job: str, digest: str, cost_ms: float) -> Dict:
        """Blend one per-chunk fold-cost sample into a (solo) job's
        profile — how a fused run's per-sink means reach the profiles
        the server's batch balancer reads."""
        prof = self._load_or_fresh(job, digest)
        prev = prof.get("fold_cost_ms")
        prof["fold_cost_ms"] = round(
            cost_ms if prev is None
            else FOLD_COST_BLEND * float(cost_ms)
            + (1.0 - FOLD_COST_BLEND) * float(prev), 3)
        self._save(prof)
        return prof

    # --------------------------------------------------------- queries
    def profiles(self) -> List[Dict]:
        """Every loadable profile under the root (sorted by file name);
        profiles with invalid knob mappings raise, per the loud-guard
        contract."""
        out: List[Dict] = []
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            job, _, rest = name[:-5].rpartition("_")
            if not job:
                continue
            prof = self.load(job, rest)
            if prof is not None:
                out.append(prof)
        return out

    def fold_cost_ms(self, job: str, digest: str) -> Optional[float]:
        """The stored mean per-chunk fold cost of one (job, corpus), or
        None when unmeasured. Swallows KnobError: the batch balancer
        must not refuse to schedule because an unrelated knob entry in
        the profile is bad — the run itself will fail loudly on it."""
        from avenir_tpu_torch.tune.knobs import KnobError

        try:
            prof = self.load(job, digest)
        except KnobError:
            return None
        if prof is None:
            return None
        cost = prof.get("fold_cost_ms")
        return float(cost) if cost else None
