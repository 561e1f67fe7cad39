"""avenir-score: micro-batched online scoring of trained artifacts.

The port's own copy of `avenir_tpu/server/score.py`: the one path of the
system that answers requests rather than running a job. A request is one
row against one trained artifact (the reference's Storm + Redis real-time
layer), and the plane shares the two expensive things:

- **ModelCache** — a budget-bounded warm cache of loaded scorers with
  EXCLUSIVE CHECKOUT: a checked-out entry is *out of the cache*, so the
  budget sweep can never unload a model a dispatch is using. Cache
  identity is :func:`avenir_tpu_torch.core.keys.model_tuple` (artifact
  content digest, schema digest, stamped format version, kind dims): a
  retrained artifact, an edited schema or a foreign restamp can only
  MISS — stale fits are unreachable, never invalidated in place. Each
  scorer keeps its model resident on the plane's device, so a warm
  window uploads nothing; a scorer's ``nbytes`` counts what it holds
  there, and the budget bounds that.
- **micro-batch coalescer** — arriving scores for one (model, conf)
  group are held at most ``score.batch.window.ms`` (default 2 ms) or
  until ``score.batch.max`` rows, then ONE vectorized predict serves the
  whole window and results demultiplex per request. Every family's
  predict is invariant to batch composition (the Markov score adds one
  float32 column at a time, the bandit selects over the full group set,
  NB gathers and adds elementwise), so the demuxed row equals a solo
  predict bit for bit.

One plane serves on one device: ``ScorePlane(device=None)`` wants
``cuda`` and raises where there is none, ``device="cpu"`` runs the plain
versions. A window's predict is the profiler range ``score::<kind>``;
its read-back to the host lies inside the dispatch's error demux, so an
asynchronous CUDA failure reaches that window's callers and the
dispatcher thread lives on.

Model loads are digest-verified (models/artifact.py): a stamped artifact
whose stamp names a foreign ``format_version`` refuses to load
(:class:`ModelFormatSkew`) and the plane goes cold for that model.

Bandit scoring folds a **reward journal** beside the artifact
(``<artifact>.rewards.json``) of post-serve reward observations. An
append commits by one atomic rename and carries a nonce, so a retried
append applies once. Single writer: one ScorePlane owns the journals
beside the artifacts it serves and serializes appends under its journal
lock. The journal's bytes are the JAX package's, so each package folds
the other's.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from avenir_tpu_torch.core import keys as _keys
from avenir_tpu_torch.core.atomic import publish_json
from avenir_tpu_torch.models.artifact import (ModelFormatSkew, file_digest,
                                              stamp_version, verify_stamp)
from avenir_tpu_torch.obs.histogram import LatencyHistogram
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device

#: coalescing window: how long a dispatch waits for co-travellers
DEFAULT_WINDOW_MS = 2.0
#: rows per dispatch ceiling — a full window never waits out the clock
DEFAULT_BATCH_MAX = 64
#: warm model cache budget
DEFAULT_CACHE_BUDGET = 256 << 20

#: the scoreable families (each maps 1:1 to a batch predictor's row math)
SCORE_KINDS = ("bayes", "discriminant", "markov", "bandit")

REWARD_JOURNAL_VERSION = 1

_JOIN_SECS = 10.0


class ScoreError(RuntimeError):
    """A score request that cannot be served (bad kind/conf/row)."""


class ScoreTimeout(ScoreError):
    """The caller's wait deadline passed before the window dispatched."""


# ======================================================================
# request / result
# ======================================================================

_KNOWN_FIELDS = {"kind", "model", "row", "conf", "action", "req_id"}
_ACTIONS = ("score", "reward")


@dataclass
class ScoreRequest:
    """One query: a row against a trained artifact. ``conf`` carries
    the family's loader/classifier knobs (the same key names the batch
    jobs read, minus their job prefix); ``action="reward"`` is the
    bandit feedback path (row = ``group,item,reward[,count]``)."""

    kind: str
    model: str
    row: str
    conf: Dict[str, str] = field(default_factory=dict)
    action: str = "score"
    req_id: str = ""


@dataclass
class ScoreResult:
    """The demuxed answer plus the stage timings the histograms see."""

    row: str
    req_id: str = ""
    kind: str = ""
    model: str = ""
    window_rows: int = 1
    queue_ms: float = 0.0
    batch_ms: float = 0.0
    predict_ms: float = 0.0
    total_ms: float = 0.0

    def to_json(self) -> Dict:
        return {"row": self.row, "req_id": self.req_id,
                "kind": self.kind, "model": self.model,
                "window_rows": self.window_rows,
                "timings_ms": {"queue": round(self.queue_ms, 3),
                               "batch": round(self.batch_ms, 3),
                               "predict": round(self.predict_ms, 3),
                               "total": round(self.total_ms, 3)}}


def score_request_from_json(obj: Dict) -> ScoreRequest:
    """Strict parse of one score request body — unknown fields are
    rejected, so a client typo can never silently no-op a knob."""
    if not isinstance(obj, dict):
        raise ValueError("score request must be a JSON object")
    unknown = set(obj) - _KNOWN_FIELDS
    if unknown:
        raise ValueError(f"unknown score request fields: {sorted(unknown)}")
    kind = obj.get("kind", "")
    if kind not in SCORE_KINDS:
        raise ValueError(f"unknown score kind {kind!r} "
                         f"(want one of {list(SCORE_KINDS)})")
    action = obj.get("action", "score")
    if action not in _ACTIONS:
        raise ValueError(f"unknown score action {action!r}")
    model = obj.get("model", "")
    if not model:
        raise ValueError("score request needs a model artifact path")
    row = obj.get("row", "")
    if not isinstance(row, str) or not row.strip():
        raise ValueError("score request needs a non-empty row string")
    if "\n" in row or "\r" in row:
        # one request, one row: an embedded newline would parse into
        # extra dataset rows and shift every later slot's positional
        # demux — cross-request leakage, so it is rejected at the edge
        raise ValueError("score row must be a single line "
                         "(embedded newlines break window framing)")
    conf = obj.get("conf", {}) or {}
    if not isinstance(conf, dict):
        raise ValueError("conf must be an object of string knobs")
    conf = {str(k): str(v) for k, v in conf.items()}
    return ScoreRequest(kind=kind, model=model, row=row, conf=conf,
                        action=action, req_id=str(obj.get("req_id", "")))


# ======================================================================
# reward journal (streaming append beside the artifact)
# ======================================================================

def reward_journal_path(artifact: str) -> str:
    return artifact + ".rewards.json"


def load_reward_journal(artifact: str, strict: bool = False) -> List[Dict]:
    """The journal's entries in append order ([] when absent). A
    journal stamped with a foreign format refuses like a model does.

    ``strict`` is the WRITER's mode: a present-but-unparseable journal
    raises instead of reading as [], because the append path republishes
    whatever this returns — shrugging there would overwrite all prior
    reward history with a journal holding only the new entry."""
    path = reward_journal_path(artifact)
    try:
        with open(path) as fh:
            obj = json.load(fh)
    except FileNotFoundError:
        return []
    except (OSError, ValueError) as exc:
        if strict:
            raise ModelFormatSkew(
                f"unreadable reward journal {path}: {exc} — refusing "
                "to publish over history that cannot be read") from exc
        # torn by a racing delete or an external truncation, which every
        # reader treats as absent, never a crash
        return []
    if obj.get("format_version") != REWARD_JOURNAL_VERSION:
        raise ModelFormatSkew(
            f"reward journal beside {artifact}: format_version="
            f"{obj.get('format_version')!r}, this build speaks "
            f"{REWARD_JOURNAL_VERSION}")
    return list(obj.get("entries", []))


def append_reward(artifact: str, group: str, item: str, reward: float,
                  count: int = 1, nonce: Optional[str] = None) -> Dict:
    """Append one reward observation to the artifact's journal.

    Read-extend-publish: the atomic rename either lands the new entry or
    leaves the old journal, so a failure can never tear it. ``nonce``
    makes the append exactly-once (a retry after an ambiguous failure
    re-sends the same nonce and dedupes). Single writer: callers
    serialize through the owning plane's journal lock.
    """
    entries = load_reward_journal(artifact, strict=True)
    if nonce is not None:
        for e in entries:
            if e.get("nonce") == nonce:
                return {"applied": False, "entries": len(entries)}
    entries.append({"group": str(group), "item": str(item),
                    "reward": float(reward), "count": int(count),
                    "nonce": nonce})
    publish_json({"format_version": REWARD_JOURNAL_VERSION,
                  "entries": entries}, reward_journal_path(artifact),
                 site="score.reward")
    return {"applied": True, "entries": len(entries)}


def fold_rewards(data, entries: Sequence[Dict]) -> None:
    """Fold journal entries into a loaded GroupBanditData (host numpy
    stats) in append order: trial counts add, the per-item average
    reward re-weights by the incoming observation count — the running
    average the reference's aggregate loop applies between rounds, so a
    folded journal equals a re-aggregated stats file up to float32
    rounding."""
    index = {(g, it): (gi, ai)
             for gi, g in enumerate(data.group_ids)
             for ai, it in enumerate(data.item_ids[gi])}
    for e in entries:
        pos = index.get((e["group"], e["item"]))
        if pos is None:
            raise ScoreError(
                f"reward journal names unknown arm "
                f"({e['group']!r}, {e['item']!r})")
        gi, ai = pos
        c0 = int(data.counts[gi, ai])
        n = int(e.get("count", 1))
        total = np.float64(data.rewards[gi, ai]) * c0 + e["reward"]
        data.counts[gi, ai] = c0 + n
        data.rewards[gi, ai] = np.float32(total / max(c0 + n, 1))


def reward_journal_digest(artifact: str) -> str:
    """Content digest of the journal ('' when absent) — a model-cache
    key dim for bandits, so a fresh reward observation makes the warm
    folded stats unreachable instead of stale."""
    try:
        return file_digest(reward_journal_path(artifact))
    except FileNotFoundError:
        return ""


# ======================================================================
# family scorers — thin wrappers over the models/ vectorized entry
# points, each returning the BATCH JOB's exact per-row output string
# ======================================================================

def _conf_list(conf: Dict[str, str], key: str, delim: str) -> List[str]:
    raw = conf.get(key, "")
    return [t.strip() for t in raw.split(delim)] if raw else []


def _tensor_bytes(tensors) -> int:
    """Bytes the tensors hold on their device."""
    return sum(int(t.numel()) * t.element_size() for t in tensors)


class _BayesScorer:
    """NB class posterior — bayesianPredictor's row math (runner.py), its
    tables resident on the device."""

    def __init__(self, model_path: str, conf: Dict[str, str],
                 device: torch.device):
        from avenir_tpu_torch.core.schema import FeatureSchema
        from avenir_tpu_torch.models.naive_bayes import (NaiveBayesModel,
                                                         NaiveBayesPredictor)
        from avenir_tpu_torch.utils.metrics import CostBasedArbitrator

        self.delim = conf.get("field.delim", ",")
        schema_path = conf.get("schema.path", "")
        if not schema_path:
            raise ScoreError("bayes scoring needs conf['schema.path']")
        self.schema = FeatureSchema.from_file(schema_path)
        model = NaiveBayesModel.load(model_path, self.schema,
                                     delim=self.delim, device=device)
        arbitrator = None
        costs = _conf_list(conf, "predict.class.cost", self.delim)
        if costs:
            classes = _conf_list(conf, "predict.class", self.delim) \
                or self.schema.class_values()
            arbitrator = CostBasedArbitrator(classes[0], classes[1],
                                             int(costs[0]), int(costs[1]))
        self.pred = NaiveBayesPredictor(model, arbitrator=arbitrator)
        self.cls_vals = self.schema.class_values()
        # the finished tables and the predictor's [F, B, K] copy of the
        # posterior, all on the device
        self.nbytes = _tensor_bytes([*self.pred.tables.values(),
                                     self.pred._log_post_fbk])

    def predict_rows(self, rows: Sequence[str]) -> List[str]:
        from avenir_tpu_torch.core.dataset import Dataset
        ds = Dataset.from_csv("\n".join(rows) + "\n", self.schema,
                              delim=self.delim, keep_raw=True)
        if len(ds.raw_rows) != len(rows):
            # a blank row vanishes (Dataset skips it) and an embedded
            # newline splits in two — either way positional demux
            # would hand later slots the wrong answers, so refuse
            raise ScoreError(
                f"bayes window framing: {len(rows)} request rows "
                f"parsed into {len(ds.raw_rows)} dataset rows "
                "(blank or multi-line row in the batch)")
        codes, post = self.pred.predict(ds)
        out = []
        for raw, c, row_post in zip(ds.raw_rows, codes, post):
            tot = float(np.sum(row_post)) or 1.0
            prob = int(np.rint(100.0 * row_post[int(c)] / tot))
            out.append(self.delim.join(
                raw + [self.cls_vals[int(c)], str(prob)]))
        return out


class _DiscriminantScorer:
    """Fisher boundary side — FisherDiscriminant.predict's math, float64
    numpy on the host as the reference's predict_values is."""

    def __init__(self, model_path: str, conf: Dict[str, str],
                 device: torch.device):
        from avenir_tpu_torch.models.discriminant import FisherDiscriminant
        self.delim = conf.get("field.delim", ",")
        self.fd = FisherDiscriminant.load(model_path, delim=self.delim)
        self.nbytes = 64 * max(len(self.fd.boundaries), 1)

    def predict_rows(self, rows: Sequence[str], conf: Dict[str, str]
                     ) -> List[str]:
        ordinal = int(conf.get("ordinal", "-1"))
        if ordinal < 0:
            raise ScoreError("discriminant scoring needs conf['ordinal']")
        toks = [[t.strip() for t in r.split(self.delim)] for r in rows]
        x = np.asarray([float(t[ordinal]) for t in toks], np.float64)
        side = self.fd.predict_values(ordinal, x)
        return [self.delim.join(t + [str(int(s))])
                for t, s in zip(toks, side)]


class _MarkovScorer:
    """Sequence log-odds class — markovModelClassifier's row math, the
    log-odds table resident on the device."""

    def __init__(self, model_path: str, conf: Dict[str, str],
                 device: torch.device):
        from avenir_tpu_torch.models.markov import (
            MarkovModelClassifier, MarkovStateTransitionModel)
        self.delim = conf.get("field.delim", ",")
        model = MarkovStateTransitionModel.load(model_path,
                                                delim=self.delim,
                                                device=device)
        labels = _conf_list(conf, "class.labels", self.delim)
        if len(labels) != 2:
            raise ScoreError("markov scoring needs conf['class.labels'] "
                             "= 'pos,neg'")
        self.clf = MarkovModelClassifier(
            model, labels[0], labels[1],
            threshold=float(conf.get("log.odds.threshold", "0")))
        self.skip = int(conf.get("skip.field.count", "1"))
        self.nbytes = _tensor_bytes([self.clf._log_odds_d]) \
            + int(model.counts.nbytes)

    def predict_rows(self, rows: Sequence[str]) -> List[str]:
        # token trim matches the runner's sequence parse exactly
        ids, seqs = [], []
        for ln in rows:
            toks = [t.strip(" \t\r") for t in ln.split(self.delim)]
            ids.append(toks[0] if self.skip > 0 else "")
            seqs.append(toks[self.skip:])
        cls, scores = self.clf.predict(seqs)
        return [f"{rid}{self.delim}{c}{self.delim}{s:.6f}"
                for rid, c, s in zip(ids, cls, scores)]


class _BanditScorer:
    """Arm pull — bandit_job's per-group selection rows, with the reward
    journal folded into the loaded stats on the host before they go to
    the device. Every select runs over the FULL group set with the
    round's seeded key (exactly the batch job's execution), then demuxes
    the requested groups — which is what makes a coalesced pull
    bit-identical to a solo one."""

    def __init__(self, model_path: str, conf: Dict[str, str],
                 device: torch.device):
        from avenir_tpu_torch.models.bandits import GroupBanditData
        verify_stamp(model_path)
        self.device = device
        self.delim = conf.get("field.delim", ",")
        with open(model_path) as fh:
            rows = [[t.strip() for t in ln.split(self.delim)]
                    for ln in fh if ln.strip()]
        data = GroupBanditData.from_rows(
            rows,
            count_ord=int(conf.get("count.ordinal", "2")),
            reward_ord=int(conf.get("reward.ordinal", "3")))
        fold_rewards(data, load_reward_journal(model_path))
        self.data = data.to_device(device)
        self.nbytes = _tensor_bytes([self.data.counts, self.data.rewards,
                                     self.data.mask]) + 1024

    def predict_rows(self, rows: Sequence[str], conf: Dict[str, str]
                     ) -> List[str]:
        from avenir_tpu_torch.models.bandits import make_bandit_job
        name = conf.get("algorithm", "greedyRandomBandit")
        batch = int(conf.get("batch.size", "1"))
        kw = {}
        if name == "greedyRandomBandit":
            kw = {
                "random_selection_prob":
                    float(conf.get("random.selection.prob", "0.1")),
                "prob_reduction_algorithm":
                    conf.get("prob.reduction.algorithm", "linear"),
                "prob_reduction_constant":
                    float(conf.get("prob.reduction.constant", "1.0")),
                "auer_greedy_constant":
                    float(conf.get("auer.greedy.constant", "1.0")),
                "selection_unique":
                    conf.get("selection.unique", "false").lower()
                    == "true",
            }
        elif name == "softMaxBandit":
            kw = {"temp_constant": float(conf.get("temp.constant", "1.0"))}
        bj = make_bandit_job(name, batch, device=self.device, **kw)
        sel = np.asarray(bj.select(self.data,
                                   int(conf.get("round", "1"))))
        lines: Dict[str, List[str]] = {}
        for parts in self.data.selections_to_rows(
                sel, conf.get("output.decision.count", "false").lower()
                == "true"):
            lines.setdefault(parts[0], []).append(self.delim.join(parts))
        out = []
        for g in rows:
            g = g.strip()
            if g not in lines:
                raise ScoreError(f"unknown bandit group {g!r}")
            out.append("\n".join(lines[g]))
        return out


_SCORERS = {"bayes": _BayesScorer, "discriminant": _DiscriminantScorer,
            "markov": _MarkovScorer, "bandit": _BanditScorer}

#: scorers whose predict needs the window's conf at call time
_CONF_AT_PREDICT = ("discriminant", "bandit")


def model_cache_key(kind: str, model: str, conf: Dict[str, str]) -> tuple:
    """The warm-cache identity of one served model — the
    :func:`avenir_tpu_torch.core.keys.model_tuple` recipe applied to
    this request's view of the artifact, equal to the JAX package's.
    Recomputed per dispatch: the digest probe is what turns every
    retrain/restamp/reward into a MISS instead of a stale hit."""
    delim = conf.get("field.delim", ",")
    schema_digest = ""
    if kind == "bayes":
        schema_path = conf.get("schema.path", "")
        if schema_path:
            schema_digest = file_digest(schema_path)
    dims: Tuple = (delim,)
    if kind == "bayes":
        dims = (delim, conf.get("predict.class", ""),
                conf.get("predict.class.cost", ""))
    elif kind == "markov":
        dims = (delim, conf.get("class.labels", ""),
                conf.get("log.odds.threshold", "0"),
                conf.get("skip.field.count", "1"))
    elif kind == "bandit":
        dims = (delim, conf.get("count.ordinal", "2"),
                conf.get("reward.ordinal", "3"),
                reward_journal_digest(model))
    return _keys.model_tuple(kind, model, file_digest(model),
                             schema_digest, stamp_version(model), dims)


def load_scorer(kind: str, model: str, conf: Dict[str, str], *,
                device: DeviceLike = None):
    """Digest-verified cold load of one family scorer onto `device`
    (``cuda`` when None; raises :class:`ModelFormatSkew` on foreign or
    torn stamps)."""
    try:
        cls = _SCORERS[kind]
    except KeyError:
        raise ScoreError(f"unknown score kind {kind!r}")
    return cls(model, conf, resolve_device(device))


def score_once(kind: str, model: str, row: str, conf: Dict[str, str], *,
               device: DeviceLike = None) -> str:
    """Cold solo score — load, predict one row, drop the model. The
    reference the plane's coalesced path must match bit for bit."""
    scorer = load_scorer(kind, model, conf, device=device)
    if kind in _CONF_AT_PREDICT:
        return scorer.predict_rows([row], conf)[0]
    return scorer.predict_rows([row])[0]


# ======================================================================
# warm model cache — exclusive checkout
# ======================================================================

@dataclass
class _ModelEntry:
    key: tuple
    scorer: object
    nbytes: int


class ModelCache:
    """Budget-bounded warm cache of loaded scorers with exclusive
    checkout: ``checkout`` POPS the entry, ``checkin`` re-inserts it
    and runs the LRU budget sweep. An entry a dispatch holds is not in
    the cache at all, so eviction can never unload a model mid-use."""

    def __init__(self, budget_bytes: int = DEFAULT_CACHE_BUDGET):
        self.budget_bytes = int(budget_bytes)
        self._entries: "OrderedDict[tuple, _ModelEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def checkout(self, key: tuple) -> Optional[_ModelEntry]:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                self.misses += 1
            else:
                self.hits += 1
            return entry

    def checkin(self, entry: _ModelEntry) -> None:
        with self._lock:
            self._entries[entry.key] = entry
            self._entries.move_to_end(entry.key)
            # LRU sweep; may drop the just-returned entry itself when a
            # single model is over budget — served this window, cold next
            total = sum(e.nbytes for e in self._entries.values())
            while total > self.budget_bytes and self._entries:
                _, victim = self._entries.popitem(last=False)
                total -= victim.nbytes
                self.evictions += 1

    def snapshot(self) -> Dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "nbytes": sum(e.nbytes
                                  for e in self._entries.values()),
                    "budget_bytes": self.budget_bytes,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}


# ======================================================================
# the plane
# ======================================================================

@dataclass
class _Slot:
    request: ScoreRequest
    t0: float
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[ScoreResult] = None
    error: Optional[BaseException] = None


@dataclass
class _Window:
    gkey: tuple
    opened: float
    slots: List[_Slot] = field(default_factory=list)


class ScorePlane:
    """The online scoring plane: a coalescing dispatcher in front of the
    warm model cache (module docstring has the design), serving on
    `device` (``cuda`` when None). One non-daemon dispatcher thread owns
    all predict calls; ``close()`` drains and joins it — a wedged
    dispatcher raises, never leaks."""

    def __init__(self, budget_bytes: int = DEFAULT_CACHE_BUDGET,
                 window_ms: float = DEFAULT_WINDOW_MS,
                 batch_max: int = DEFAULT_BATCH_MAX,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.window_s = max(float(window_ms), 0.0) / 1000.0
        self.batch_max = max(int(batch_max), 1)
        self.cache = ModelCache(budget_bytes)
        self._cv = threading.Condition()
        self._pending: Dict[tuple, _Window] = {}
        self._ready: Deque[_Window] = deque()
        self._closed = False
        self._journal_lock = threading.Lock()
        self._hists: Dict[str, LatencyHistogram] = {}
        self._predicts: Dict[str, int] = {}
        self.stats = {"scores": 0, "rewards": 0, "predict_calls": 0,
                      "window_rows": 0, "model_loads": 0, "errors": 0}
        self._thread = threading.Thread(target=self._run,
                                        name="score-dispatch")
        self._thread.start()

    # ------------------------------------------------------------ public
    def score(self, request: ScoreRequest,
              timeout: float = 30.0) -> ScoreResult:
        """Block until this request's window dispatches; returns the
        demuxed row (bit-identical to a solo predict)."""
        if request.action == "reward":
            raise ScoreError("reward updates go through reward()")
        slot = _Slot(request, time.monotonic())
        gkey = (request.kind, os.path.abspath(request.model),
                tuple(sorted(request.conf.items())))
        with self._cv:
            if self._closed:
                raise ScoreError("score plane is closed")
            w = self._pending.get(gkey)
            if w is None:
                w = _Window(gkey, slot.t0)
                self._pending[gkey] = w
            w.slots.append(slot)
            if len(w.slots) >= self.batch_max:
                del self._pending[gkey]
                self._ready.append(w)
            self._cv.notify_all()
        if not slot.done.wait(timeout):
            slot.error = ScoreTimeout(
                f"score wait exceeded {timeout}s "
                f"(model {request.model})")
        if slot.error is not None:
            raise slot.error
        return slot.result

    def reward(self, request: ScoreRequest) -> Dict:
        """Bandit feedback: append one observation to the artifact's
        journal (row = ``group,item,reward[,count]``). The journal
        digest is a cache-key dim, so the NEXT pull misses the warm
        stats and folds this entry — no in-place invalidation."""
        if request.kind != "bandit":
            raise ScoreError("reward updates are a bandit action")
        delim = request.conf.get("field.delim", ",")
        parts = [t.strip() for t in request.row.split(delim)]
        if len(parts) < 3:
            raise ScoreError("reward row wants group,item,reward[,count]")
        count = int(parts[3]) if len(parts) > 3 else 1
        with self._journal_lock:
            ack = append_reward(request.model, parts[0], parts[1],
                                float(parts[2]), count=count,
                                nonce=request.req_id or None)
        with self._cv:
            self.stats["rewards"] += 1
        return ack

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(_JOIN_SECS)
        if self._thread.is_alive():
            raise RuntimeError(
                "score dispatcher failed to drain within "
                f"{_JOIN_SECS}s — a predict is wedged")

    # ----------------------------------------------------------- metrics
    def hist_summaries(self) -> Dict[str, Dict]:
        with self._cv:
            return {name: h.summary()
                    for name, h in self._hists.items()}

    def hists_raw(self) -> Dict[str, Dict]:
        with self._cv:
            return {name: h.to_dict()
                    for name, h in self._hists.items()}

    def predict_calls(self, model: str) -> int:
        """Vectorized dispatches for one artifact (coalescing proof)."""
        with self._cv:
            return self._predicts.get(self._model_name(model), 0)

    def snapshot(self) -> Dict:
        with self._cv:
            stats = dict(self.stats)
            predicts = dict(self._predicts)
        return {"stats": stats, "per_model_predicts": predicts,
                "cache": self.cache.snapshot()}

    # ---------------------------------------------------------- internals
    @staticmethod
    def _model_name(model: str) -> str:
        base = os.path.basename(model)
        return os.path.splitext(base)[0].replace(".", "_") or "model"

    def _feed(self, name: str, ms: float) -> None:
        # caller holds self._cv
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = LatencyHistogram()
        h.add(ms)

    def _run(self) -> None:
        while True:
            window: Optional[_Window] = None
            with self._cv:
                while window is None:
                    now = time.monotonic()
                    if self._ready:
                        window = self._ready.popleft()
                        break
                    if self._closed and self._pending:
                        # drain: a closing plane dispatches every held
                        # window immediately, no window wait
                        window = self._pending.pop(
                            next(iter(self._pending)))
                        break
                    due = [k for k, w in self._pending.items()
                           if now - w.opened >= self.window_s]
                    if due:
                        window = self._pending.pop(due[0])
                        break
                    if self._closed:
                        return
                    if self._pending:
                        nearest = min(w.opened + self.window_s
                                      for w in self._pending.values())
                        self._cv.wait(max(nearest - now, 0.0002))
                    else:
                        self._cv.wait(0.05)
            if window is not None:
                self._dispatch(window)

    def _dispatch(self, window: _Window) -> None:
        """Serve one window, demuxing ANY failure to its waiters. The
        wrapper is the dispatcher thread's survival guarantee: a bug
        anywhere in the dispatch path must become a per-slot error —
        an escaped exception would kill the sole ``score-dispatch``
        thread, leaving these waiters hung and every later score on
        the plane timing out."""
        try:
            self._dispatch_window(window)
        except BaseException as exc:
            undone = [s for s in window.slots if not s.done.is_set()]
            try:
                with self._cv:
                    self.stats["errors"] += len(undone)
            finally:
                for slot in undone:
                    slot.error = exc
                    slot.done.set()

    def _dispatch_window(self, window: _Window) -> None:
        kind, model, _ = window.gkey
        conf = window.slots[0].request.conf
        rows = [s.request.row for s in window.slots]
        t_start = time.monotonic()
        entry: Optional[_ModelEntry] = None
        results: List[str] = []
        error: Optional[BaseException] = None
        predict_ms = 0.0
        loaded = False
        try:
            key = model_cache_key(kind, model, conf)
            entry = self.cache.checkout(key)
            if entry is None:
                entry = _ModelEntry(
                    key, load_scorer(kind, model, conf, device=self.device),
                    0)
                entry.nbytes = int(entry.scorer.nbytes)
                loaded = True
            t_pred = time.monotonic()
            # the predict reads its answers back to the host, so a device
            # failure of this window raises here and demuxes below
            with record_function(f"score::{kind}"):
                if kind in _CONF_AT_PREDICT:
                    results = entry.scorer.predict_rows(rows, conf)
                else:
                    results = entry.scorer.predict_rows(rows)
            if len(results) != len(window.slots):
                raise ScoreError(
                    f"{kind} predict returned {len(results)} rows for "
                    f"a window of {len(window.slots)} — refusing the "
                    "positional demux (misaligned answers)")
            predict_ms = (time.monotonic() - t_pred) * 1000.0
        except BaseException as exc:   # demuxed to every waiter
            error = exc
            # a scorer that failed to load or predict does not go back
            # warm: the next window re-probes the artifact cold
            entry = None
        finally:
            if entry is not None:
                self.cache.checkin(entry)
        t_done = time.monotonic()
        batch_ms = (t_start - window.opened) * 1000.0
        name = self._model_name(model)
        with self._cv:
            if loaded:
                self.stats["model_loads"] += 1
            if error is None:
                self.stats["predict_calls"] += 1
                self.stats["scores"] += len(window.slots)
                self.stats["window_rows"] += len(window.slots)
                self._predicts[name] = self._predicts.get(name, 0) + 1
                self._feed(f"score_{name}_batch_ms", batch_ms)
                self._feed(f"score_{name}_predict_ms", predict_ms)
            else:
                self.stats["errors"] += len(window.slots)
            for slot in window.slots:
                self._feed(f"score_{name}_queue_ms",
                           (t_start - slot.t0) * 1000.0)
                if error is None:
                    self._feed(f"score_{name}_total_ms",
                               (t_done - slot.t0) * 1000.0)
        for i, slot in enumerate(window.slots):
            if error is not None:
                slot.error = error
            else:
                slot.result = ScoreResult(
                    row=results[i], req_id=slot.request.req_id,
                    kind=kind, model=model,
                    window_rows=len(window.slots),
                    queue_ms=(t_start - slot.t0) * 1000.0,
                    batch_ms=batch_ms, predict_ms=predict_ms,
                    total_ms=(t_done - slot.t0) * 1000.0)
            slot.done.set()
