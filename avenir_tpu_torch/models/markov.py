"""Markov and hidden Markov sequence models.

The port of `avenir_tpu/models/markov.py` (org.avenir.markov and the
spark/markov, spark/sequence ports):

- MarkovStateTransitionModel.java:50 counts (prevState, state) bigrams of
  each row's sequence, one matrix per class label (or, in the Spark
  multi-tenant mode, per entity key), and row-normalizes them into
  scaled-integer matrices;
- MarkovModelClassifier.java:44 sums a sequence's transition log odds under
  two class matrices and thresholds the sum;
- HiddenMarkovModelBuilder.java:50 counts state transitions, state
  emissions and initial states of tagged sequences;
  ViterbiStatePredictor.java:45 decodes hidden states;
- ProbabilisticSuffixTreeGenerator.java:51, StateTransitionRate.scala:30,
  ContTimeStateTransitionStats.scala:34 and EventTimeDistribution.scala:27
  are host code, float64 numpy as in the reference.

The reference's two device programs are XLA programs, not Pallas kernels,
and land here as torch ops on the model's device:

- the bigram count `_bigram_counts` (markov.py:54): one `torch.bincount`
  of the flat key `(label * S + prev) * S + next` over the pairs whose two
  codes are >= 0, the profiler range `markov::bigram_count`; the CSR form
  of a native-encoded block (`fit_csr`) and the HMM builder's counts
  (`add_csr`, `add_many`) count the same way under the same range. The
  counts are int64, added to float64 host counts: exact at any size,
  where the reference's float32 `segment_sum` of ones is exact below
  2^24 a cell a call. The reference pads the class axis to a power of
  two for XLA's compile cache; the port needs no padding;
- the Viterbi scan `_viterbi_kernel` (markov.py:496, `vmap`'d over the
  sequences): `viterbi_paths`, a loop over time of batched [B, S, S]
  float32 adds, the first arg max (`torch.argmax`, as `jnp.argmax`) and a
  max over the previous state, then the emission add, each rounded to
  float32 in the reference's order, so the paths are equal element for
  element; back pointers in the narrowest integer that holds a state;
  the profiler range `markov::viterbi`.

The classifier's score adds one float32 column at a time in sequence
order on the device, never a `sum` over the padded axis: the same
sequence scores the same bits alone or in any batch (markov.py:302-309).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device

_EPS = 1e-12

#: the profiler range of a transition or emission count
BIGRAM_RANGE = "markov::bigram_count"
#: the profiler range of a batch's Viterbi decode
VITERBI_RANGE = "markov::viterbi"

#: rows decoded in one batch are cut so that a step's [B, S, S] float32
#: candidates stay under this many bytes
_VITERBI_CAND_BYTES = 256 << 20


def encode_sequences(
    seqs: Sequence[Sequence[str]], states: Sequence[str]
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad string sequences to int32 [S, L] with a -1 sentinel; returns
    (padded, lengths). An unknown token raises KeyError."""
    index = {s: i for i, s in enumerate(states)}
    lens = np.array([len(s) for s in seqs], np.int32)
    L = int(lens.max()) if len(seqs) else 0
    out = np.full((len(seqs), L), -1, np.int32)
    flat = np.fromiter(map(index.__getitem__,
                           itertools.chain.from_iterable(seqs)), np.int32,
                       count=int(lens.sum()))
    if flat.shape[0]:
        rows = np.repeat(np.arange(len(seqs)), lens)
        cols = np.arange(flat.shape[0]) - np.repeat(
            np.cumsum(lens) - lens, lens)
        out[rows, cols] = flat
    return out, lens


def _tensor(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def bigram_counts(padded: torch.Tensor, labels: torch.Tensor, n_states: int,
                  n_classes: int) -> torch.Tensor:
    """counts int64 [C, S, S]: the transitions i -> j of the class-c rows
    of int32 [N, L] `padded` (-1 pads), `labels` int [N]
    (`_bigram_counts`, markov.py:54)."""
    with record_function(BIGRAM_RANGE):
        prev, nxt = padded[:, :-1].long(), padded[:, 1:].long()
        valid = (prev >= 0) & (nxt >= 0)
        key = (labels.long()[:, None] * n_states + prev) * n_states + nxt
        flat = torch.bincount(key[valid],
                              minlength=n_classes * n_states * n_states)
        return flat.reshape(n_classes, n_states, n_states)


def _csr_layout(codes: torch.Tensor, offsets: torch.Tensor, skip: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(row_of, pos, in_seq) of a CSR block on its device: each token's
    row, its position in the row, and whether that position is >= skip."""
    n = offsets.shape[0] - 1
    row_of = torch.repeat_interleave(
        torch.arange(n, device=codes.device), offsets[1:] - offsets[:-1],
        output_size=codes.shape[0])
    pos = torch.arange(codes.shape[0], device=codes.device) - \
        offsets[:-1][row_of]
    return row_of, pos, pos >= skip


def _first_bad(bad: torch.Tensor, row_of: torch.Tensor, pos: torch.Tensor
               ) -> Optional[Tuple[int, int]]:
    """(row, position) of the first True of `bad`, or None."""
    if not bool(bad.any()):
        return None
    b = int(torch.nonzero(bad)[0, 0])
    return int(row_of[b]), int(pos[b])


class MarkovStateTransitionModel:
    """mst.* job: (per-class) row-normalized transition matrices, counted
    on `device` (default cuda)."""

    def __init__(self, states: Sequence[str], scale: int = 1000,
                 class_labels: Optional[Sequence[str]] = None,
                 device: DeviceLike = None):
        self.states = list(states)
        self.scale = scale
        self.class_labels = list(class_labels) if class_labels else None
        self.device = resolve_device(device)
        n, k = len(self.states), (len(class_labels) if class_labels else 1)
        self.counts = np.zeros((k, n, n), np.float64)

    # ----------------------------------------------------------------- fit
    def fit(self, seqs: Sequence[Sequence[str]],
            labels: Optional[Sequence[str]] = None
            ) -> "MarkovStateTransitionModel":
        padded, _ = encode_sequences(seqs, self.states)
        if self.class_labels:
            lab_idx = {v: i for i, v in enumerate(self.class_labels)}
            y = np.array([lab_idx[v] for v in labels], np.int64)
            k = len(self.class_labels)
        else:
            y = np.zeros(len(seqs), np.int64)
            k = 1
        counts = bigram_counts(_tensor(padded, self.device),
                               _tensor(y, self.device), len(self.states), k)
        self.counts += counts.cpu().numpy()
        return self

    def fit_csr(self, codes: np.ndarray, offsets: np.ndarray,
                skip: int, class_ord: Optional[int] = None,
                label_codes: Optional[np.ndarray] = None,
                y: Optional[np.ndarray] = None
                ) -> "MarkovStateTransitionModel":
        """Fold one CSR-encoded line block (native `seq_encode`: tokens
        coded against a vocabulary whose first len(states) entries are the
        states; `label_codes[k]` is the code of class_labels[k], shared
        with a state of the same name; meta tokens may be -1). Same
        semantics as fit(): an unknown state token in the sequence region
        raises, transitions never cross rows. The token work and the count
        run on the device; the class lookup (a code a row) on the host."""
        s = len(self.states)
        n = offsets.shape[0] - 1
        if n <= 0:
            return self
        dev = self.device
        codes_d = _tensor(codes, dev).long()
        offsets_d = _tensor(offsets, dev)
        row_of, pos, in_seq = _csr_layout(codes_d, offsets_d, skip)
        bad = _first_bad(in_seq & ((codes_d < 0) | (codes_d >= s)), row_of,
                         pos)
        if bad is not None:
            raise ValueError(
                f"unknown state token at row {bad[0]}, position {bad[1]}")
        lens = np.diff(offsets)
        starts = offsets[:-1]
        if y is not None:
            # caller-resolved per-row class or entity indices (the
            # per-entity streaming mode: the counts axis already covers
            # max(y))
            k = self.counts.shape[0]
            if (y.shape[0] != n or (y < 0).any()
                    or int(y.max(initial=-1)) >= k):
                raise ValueError("y must give one index in "
                                 "[0, counts.shape[0]) per CSR row")
            y = y.astype(np.int64)
        elif self.class_labels:
            k = len(self.class_labels)
            if class_ord is None:
                raise ValueError("class_ord required with class_labels")
            if label_codes is None:
                # no safe default exists: a label that IS a state shares
                # the state's code, which only the vocab builder knows
                raise ValueError(
                    "label_codes required with class_labels (vocab code "
                    "of each class label, see the mst runner)")
            if (lens <= class_ord).any():
                r = int(np.argmax(lens <= class_ord))
                raise ValueError(f"row {r} has no class field "
                                 f"(ordinal {class_ord})")
            inv = np.full(int(label_codes.max()) + 2, -1, np.int64)
            inv[label_codes] = np.arange(k)
            raw = codes[starts + class_ord].astype(np.int64)
            ok = (raw >= 0) & (raw < inv.shape[0] - 1)
            y = np.where(ok, inv[np.clip(raw, 0, inv.shape[0] - 1)], -1)
            if (y < 0).any():
                r = int(np.argmax(y < 0))
                raise ValueError(f"unknown class label in row {r}")
        else:
            k = 1
            y = np.zeros(n, np.int64)
        with record_function(BIGRAM_RANGE):
            valid = in_seq[:-1] & (row_of[:-1] == row_of[1:])
            key = (_tensor(y, dev)[row_of[:-1]] * s + codes_d[:-1]) * s \
                + codes_d[1:]
            counts = torch.bincount(key[valid], minlength=k * s * s)
        self.counts += counts.cpu().numpy().reshape(k, s, s)
        return self

    def fit_entities(self, seqs: Sequence[Sequence[str]],
                     entity_keys: Sequence[str]
                     ) -> "MarkovStateTransitionModel":
        """Per-entity accumulate that grows the label axis in place (the
        Spark multi-tenant job's streaming mode,
        MarkovStateTransitionModel.scala:51-52): unseen entity keys extend
        class_labels in first-seen order and zero-pad the counts."""
        if self.class_labels is None:
            if self.counts.any():
                raise ValueError(
                    "fit_entities cannot follow unlabeled fit() counts")
            self.class_labels = []
            self.counts = np.zeros((0,) + self.counts.shape[1:], np.float64)
        if not len(seqs):
            return self
        seen = set(self.class_labels)
        new = []
        for key in entity_keys:
            if key not in seen:
                seen.add(key)
                new.append(key)
        if new:
            self.class_labels.extend(new)
            self.counts = np.pad(self.counts,
                                 ((0, len(new)), (0, 0), (0, 0)))
        return self.fit(seqs, entity_keys)

    def merge(self, other: "MarkovStateTransitionModel"
              ) -> "MarkovStateTransitionModel":
        """Fold another partial fit's counts into this one: bigram counts
        add, so merging shard fits equals fitting the shards' rows in one.
        Both sides must agree on states, scale and class labels."""
        if self.states != other.states or self.scale != other.scale \
                or self.class_labels != other.class_labels:
            raise ValueError(
                "cannot merge markov models with different states, "
                "scale or class labels")
        self.counts += other.counts
        return self

    def matrix(self, class_label: Optional[str] = None,
               scaled: bool = True) -> np.ndarray:
        ki = (self.class_labels.index(class_label)
              if class_label and self.class_labels else 0)
        c = self.counts[ki]
        prob = c / np.maximum(c.sum(axis=1, keepdims=True), _EPS)
        return np.rint(prob * self.scale).astype(np.int64) if scaled else prob

    # ------------------------------------------------------------- file IO
    def save(self, path: str, delim: str = ",",
             marker: str = "classLabel", stamp: bool = True) -> None:
        """The reference's text format: the states line, then each class's
        matrix rows after a `classLabel:<v>` line (`entity:<key>` in the
        per-entity mode), and the format stamp beside it."""
        with open(path, "w") as fh:
            fh.write(delim.join(self.states) + "\n")
            if self.class_labels:
                for cv in self.class_labels:
                    fh.write(f"{marker}:{cv}\n")
                    for row in self.matrix(cv):
                        fh.write(delim.join(str(int(v)) for v in row) + "\n")
            else:
                for row in self.matrix():
                    fh.write(delim.join(str(int(v)) for v in row) + "\n")
        if stamp:
            from avenir_tpu_torch.models.artifact import write_stamp
            write_stamp(path)

    @classmethod
    def load(cls, path: str, delim: str = ",", scale: int = 1000,
             device: DeviceLike = None) -> "MarkovStateTransitionModel":
        from avenir_tpu_torch.models.artifact import verify_stamp
        verify_stamp(path)
        with open(path) as fh:
            lines = [ln.rstrip("\n") for ln in fh if ln.strip()]
        states = lines[0].split(delim)
        sections: Dict[Optional[str], List[List[float]]] = {}
        cur: Optional[str] = None
        for ln in lines[1:]:
            if ln.startswith("classLabel:") or ln.startswith("entity:"):
                cur = ln.split(":", 1)[1]
                sections[cur] = []
            else:
                sections.setdefault(cur, []).append(
                    [float(v) for v in ln.split(delim)])
        class_labels = [c for c in sections if c is not None] or None
        model = cls(states, scale=scale, class_labels=class_labels,
                    device=device)
        for ki, key in enumerate(class_labels or [None]):
            model.counts[ki] = np.asarray(sections[key])  # scaled probs
        return model


class MarkovModelClassifier:
    """mmc.* job: two-class sequence classification by cumulative log odds
    (MarkovModelClassifier.java:127-150), scored on the model's device."""

    def __init__(self, model: MarkovStateTransitionModel,
                 pos_class: str, neg_class: str, threshold: float = 0.0):
        assert model.class_labels, "classifier needs a class-based model"
        self.model = model
        self.pos_class = pos_class
        self.neg_class = neg_class
        self.threshold = threshold
        p_pos = model.matrix(pos_class, scaled=False)
        p_neg = model.matrix(neg_class, scaled=False)
        self.log_odds = (np.log(np.maximum(p_pos, _EPS))
                         - np.log(np.maximum(p_neg, _EPS))).astype(np.float32)
        self._log_odds_d = _tensor(self.log_odds, model.device)

    def scores(self, padded: np.ndarray) -> np.ndarray:
        """float32 [N] log-odds scores of int32 [N, L] padded sequences:
        one float32 column added at a time, in sequence order."""
        dev = self.model.device
        seq = _tensor(padded, dev).long()
        prev, nxt = seq[:, :-1], seq[:, 1:]
        valid = (prev >= 0) & (nxt >= 0)
        lo = self._log_odds_d[prev.clamp(min=0), nxt.clamp(min=0)]
        score = torch.zeros(seq.shape[0], dtype=torch.float32, device=dev)
        for t in range(lo.shape[1]):
            score = torch.where(valid[:, t], score + lo[:, t], score)
        return score.cpu().numpy()

    def predict(self, seqs: Sequence[Sequence[str]]
                ) -> Tuple[np.ndarray, np.ndarray]:
        """(class strings, float32 log-odds scores). A sequence scores the
        same bits alone or in any batch: the score is a column-by-column
        float32 sum in sequence order, never a sum over the padded axis,
        whose grouping would change with the batch's pad width."""
        padded, _ = encode_sequences(seqs, self.model.states)
        score = self.scores(padded)
        pred = np.where(score > self.threshold, self.pos_class,
                        self.neg_class)
        return pred, score


# ---------------------------------------------------------------------------
# hidden Markov model
# ---------------------------------------------------------------------------


@dataclass
class HiddenMarkovModel:
    """HMM parameter container (HiddenMarkovModel.java:31)."""

    states: List[str]
    observations: List[str]
    initial: np.ndarray          # [S]
    transition: np.ndarray       # [S, S]
    emission: np.ndarray         # [S, O]

    def save(self, path: str, delim: str = ",") -> None:
        with open(path, "w") as fh:
            fh.write(delim.join(self.states) + "\n")
            fh.write(delim.join(self.observations) + "\n")
            fh.write(delim.join(f"{v:.6f}" for v in self.initial) + "\n")
            for row in self.transition:
                fh.write(delim.join(f"{v:.6f}" for v in row) + "\n")
            for row in self.emission:
                fh.write(delim.join(f"{v:.6f}" for v in row) + "\n")

    @classmethod
    def load(cls, path: str, delim: str = ",") -> "HiddenMarkovModel":
        with open(path) as fh:
            lines = [ln.rstrip("\n") for ln in fh if ln.strip()]
        states = lines[0].split(delim)
        obs = lines[1].split(delim)
        s = len(states)
        initial = np.array([float(v) for v in lines[2].split(delim)])
        trans = np.array([[float(v) for v in lines[3 + i].split(delim)]
                          for i in range(s)])
        emis = np.array([[float(v) for v in lines[3 + s + i].split(delim)]
                         for i in range(s)])
        return cls(states, obs, initial, trans, emis)


def _tagged_counts(st: torch.Tensor, row_of: torch.Tensor,
                   first: torch.Tensor, pairs: torch.Tensor, s: int, o: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(initial [S], transition [S, S], emission [S, O]) int64 counts of
    the state codes `st` (one a token, rows contiguous, `row_of` their
    rows, `first` marking each row's first state) and the emission pair
    codes `pairs` (state * O + observation)."""
    with record_function(BIGRAM_RANGE):
        init = torch.bincount(st[first], minlength=s)
        same = row_of[:-1] == row_of[1:]
        trans = torch.bincount((st[:-1] * s + st[1:])[same],
                               minlength=s * s)
        emis = torch.bincount(pairs, minlength=s * o)
    return (init.cpu().numpy(), trans.cpu().numpy().reshape(s, s),
            emis.cpu().numpy().reshape(s, o))


class HiddenMarkovModelBuilder:
    """hmmb.* job: counts of (state -> state), (state -> obs) and initial
    states of tagged sequences (HiddenMarkovModelBuilder.java:136-153),
    counted on `device` (default cuda)."""

    def __init__(self, states: Sequence[str], observations: Sequence[str],
                 laplace: float = 1.0, device: DeviceLike = None):
        self.states = list(states)
        self.observations = list(observations)
        self.laplace = laplace
        self.device = resolve_device(device)
        s, o = len(self.states), len(self.observations)
        self.trans_counts = np.zeros((s, s))
        self.emis_counts = np.zeros((s, o))
        self.init_counts = np.zeros(s)

    def _accumulate(self, counts) -> None:
        init, trans, emis = counts
        self.init_counts += init
        self.trans_counts += trans
        self.emis_counts += emis

    def add(self, state_seq: Sequence[str], obs_seq: Sequence[str]) -> None:
        self.add_many([state_seq], [obs_seq])

    def add_many(self, state_seqs: Sequence[Sequence[str]],
                 obs_seqs: Sequence[Sequence[str]]) -> None:
        """add() for each pair of sequences, in one count on the device:
        a sequence's first state, its consecutive states, and its
        (state, observation) pairs up to the shorter of the two."""
        sidx = {v: i for i, v in enumerate(self.states)}
        oidx = {v: i for i, v in enumerate(self.observations)}
        s, o = len(self.states), len(self.observations)
        st: List[int] = []
        pairs: List[int] = []
        lens: List[int] = []
        for state_seq, obs_seq in zip(state_seqs, obs_seqs):
            ss = [sidx[v] for v in state_seq]
            oo = [oidx[v] for v in obs_seq]
            st.extend(ss)
            lens.append(len(ss))
            pairs.extend(a * o + b for a, b in zip(ss, oo))
        if not st:
            return
        dev = self.device
        st_d = _tensor(np.asarray(st, np.int64), dev)
        offsets = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        row_of, pos, _ = _csr_layout(st_d, _tensor(offsets, dev), 0)
        self._accumulate(_tagged_counts(
            st_d, row_of, pos == 0, _tensor(np.asarray(pairs, np.int64), dev),
            s, o))

    def add_csr(self, codes: np.ndarray, offsets: np.ndarray,
                skip: int) -> None:
        """Fold a CSR block of `obs<sub>state` pair tokens coded
        state_index * n_obs + obs_index (native `seq_encode` against the
        state-major pair vocabulary, see the hmmb runner). Count-identical
        to add() a row."""
        s, o = len(self.states), len(self.observations)
        n = offsets.shape[0] - 1
        if n <= 0:
            return
        dev = self.device
        codes_d = _tensor(codes, dev).long()
        row_of, pos, in_seq = _csr_layout(codes_d, _tensor(offsets, dev),
                                          skip)
        bad = _first_bad(in_seq & ((codes_d < 0) | (codes_d >= s * o)),
                         row_of, pos)
        if bad is not None:
            raise ValueError(
                f"unknown obs:state token at row {bad[0]}, "
                f"position {bad[1]}")
        # the sequence region alone: its tokens are valid pair codes
        row_of, pos, codes_d = row_of[in_seq], pos[in_seq], codes_d[in_seq]
        self._accumulate(_tagged_counts(codes_d // o, row_of, pos == skip,
                                        codes_d, s, o))

    def add_partially_tagged(self, tokens: Sequence[str],
                             window_function: Sequence[int]) -> None:
        """Window-function count spreading for partially tagged sequences
        (HiddenMarkovModelBuilder.processPartiallyTagged, :174-259), host
        Python as in the reference: tokens that are model states tag the
        sequence sparsely; each untagged token within the window around a
        state position adds windowFunction[distance-1] (the last weight
        repeating) to that state's emission count. A window reaches
        halfway to the neighbouring state; at the ends the other side's
        width is mirrored (clamped to the sequence), and a lone state
        reaches halfway to both ends. Initial and transition counts come
        from the tagged positions alone.

        Deviation from the reference, documented: its window bounds
        (:197, :205) read `a - b / 2`, which precedence makes `a - (b/2)`
        and which walks past the neighbouring state (and past the end of
        the sequence for long gaps); this takes half the gap,
        `(a - b) // 2`."""
        sidx = {v: i for i, v in enumerate(self.states)}
        oidx = {v: i for i, v in enumerate(self.observations)}
        wf = list(window_function) or [1]
        pos = [i for i, t in enumerate(tokens) if t in sidx]
        if not pos:
            return
        self.init_counts[sidx[tokens[pos[0]]]] += 1
        for a, b in zip(pos[:-1], pos[1:]):
            self.trans_counts[sidx[tokens[a]], sidx[tokens[b]]] += 1
        n = len(tokens)
        for i, p in enumerate(pos):
            left_w = (p - pos[i - 1]) // 2 if i > 0 else None
            right_w = (pos[i + 1] - p) // 2 if i < len(pos) - 1 else None
            if left_w is None and right_w is None:        # only one state
                lb = p // 2
                rb = p + (n - 1 - p) // 2
            elif left_w is None:                          # first state
                lb = max(p - right_w, 0)
                rb = p + right_w
            elif right_w is None:                         # last state
                lb = p - left_w
                rb = min(p + left_w, n - 1)
            else:
                lb, rb = p - left_w, p + right_w
            s = sidx[tokens[p]]
            for k, j in enumerate(range(p - 1, lb - 1, -1)):
                w = wf[k] if k < len(wf) else wf[-1]
                self.emis_counts[s, oidx[tokens[j]]] += w
            for k, j in enumerate(range(p + 1, rb + 1)):
                w = wf[k] if k < len(wf) else wf[-1]
                self.emis_counts[s, oidx[tokens[j]]] += w

    def finish(self) -> HiddenMarkovModel:
        """Laplace smoothing, then float64 row normalization on the host."""
        lp = self.laplace
        t = self.trans_counts + lp
        e = self.emis_counts + lp
        i = self.init_counts + lp
        return HiddenMarkovModel(
            self.states, self.observations,
            i / i.sum(),
            t / t.sum(axis=1, keepdims=True),
            e / e.sum(axis=1, keepdims=True),
        )

    def fit(self, state_seqs, obs_seqs) -> HiddenMarkovModel:
        self.add_many(list(state_seqs), list(obs_seqs))
        return self.finish()

    def fit_partially_tagged(self, token_seqs,
                             window_function: Sequence[int]
                             ) -> HiddenMarkovModel:
        for tokens in token_seqs:
            self.add_partially_tagged(tokens, window_function)
        return self.finish()


def _back_dtype(n_states: int) -> torch.dtype:
    """The narrowest integer type that holds a state index."""
    if n_states <= 127:
        return torch.int8
    if n_states <= 32767:
        return torch.int16
    return torch.int32


def viterbi_paths(obs: torch.Tensor, lengths: torch.Tensor,
                  log_init: torch.Tensor, log_trans: torch.Tensor,
                  log_emis: torch.Tensor) -> torch.Tensor:
    """int64 [B, L]: the best state path of each padded observation row of
    `obs` [B, L] (-1 pads; row b's first lengths[b] entries are real), the
    reference's `_viterbi_kernel` (markov.py:496) over the batch axis.

    Step t < length: cand = delta[:, :, None] + log_trans, the first arg
    max and the max over the previous state, then + the emission's log;
    at t >= length delta holds and the back pointer is the state itself.
    The backtrack follows the pointers where t + 1 < length. A row's path
    depends on that row alone, and past its length it repeats its last
    state. Back pointers are kept in the narrowest integer (int8 up to 127
    states: L x B x S bytes)."""
    with record_function(VITERBI_RANGE):
        B, L = obs.shape
        dev = obs.device
        if B == 0 or L == 0:
            return torch.zeros((B, L), dtype=torch.int64, device=dev)
        S = log_init.shape[0]
        oc = obs.long().clamp(min=0)
        emis_t = log_emis.t()                               # [O, S]
        lengths = lengths.to(dev)
        delta = log_init[None, :] + emis_t[oc[:, 0]]        # [B, S]
        back = torch.empty((L - 1, B, S), dtype=_back_dtype(S), device=dev)
        stay = torch.arange(S, device=dev).expand(B, S)
        for t in range(1, L):
            cand = delta[:, :, None] + log_trans             # [B, S, S]
            best_prev = torch.argmax(cand, dim=1)
            new_delta = cand.amax(dim=1) + emis_t[oc[:, t]]
            keep = (t < lengths)[:, None]
            delta = torch.where(keep, new_delta, delta)
            back[t - 1] = torch.where(keep, best_prev, stay)
        path = torch.empty((B, L), dtype=torch.int64, device=dev)
        nxt = torch.argmax(delta, dim=1)
        path[:, L - 1] = nxt
        for t in range(L - 2, -1, -1):
            prev = back[t].gather(1, nxt[:, None])[:, 0].long()
            nxt = torch.where(t + 1 < lengths, prev, nxt)
            path[:, t] = nxt
        return path


class ViterbiDecoder:
    """vsp.* job: hidden state decoding (ViterbiStatePredictor.java:45) on
    `device` (default cuda).

    Deviation from the reference, documented: its scan raises IndexError
    on a batch whose longest sequence has one observation or none (an
    empty input, too), since `lax.scan` traces the backtrack's body over
    an empty back-pointer table; here such a batch decodes (a sequence of
    one observation to the arg max of its first delta, as the reference
    decodes it inside a longer batch) and an empty one to nothing."""

    def __init__(self, hmm: HiddenMarkovModel, device: DeviceLike = None):
        self.hmm = hmm
        self.device = resolve_device(device)

        def log32(p):
            return _tensor(np.log(np.maximum(p, _EPS)).astype(np.float32),
                           self.device)

        self.log_init = log32(hmm.initial)
        self.log_trans = log32(hmm.transition)
        self.log_emis = log32(hmm.emission)

    def decode_codes(self, obs_seqs: Sequence[Sequence[str]]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(paths int64 [N, L] of state indices, lengths [N]); row i's
        first lengths[i] entries are its path. Decoded in batches of rows
        that keep a step's candidates under 256 MB (a path does not depend
        on its batch)."""
        padded, lens = encode_sequences(obs_seqs, self.hmm.observations)
        s = len(self.hmm.states)
        rows = max(1, _VITERBI_CAND_BYTES // (4 * s * s))
        out = np.zeros(padded.shape, np.int64)
        for a in range(0, padded.shape[0], rows):
            b = min(a + rows, padded.shape[0])
            width = int(lens[a:b].max())
            out[a:b, :width] = viterbi_paths(
                _tensor(padded[a:b, :width], self.device),
                _tensor(lens[a:b], self.device), self.log_init,
                self.log_trans, self.log_emis).cpu().numpy()
        return out, lens

    def decode(self, obs_seqs: Sequence[Sequence[str]]) -> List[List[str]]:
        paths, lens = self.decode_codes(obs_seqs)
        names = self.hmm.states
        return [[names[s] for s in paths[i, :lens[i]].tolist()]
                for i in range(len(obs_seqs))]


# ---------------------------------------------------------------------------
# probabilistic suffix tree
# ---------------------------------------------------------------------------


class ProbabilisticSuffixTree:
    """pstg.* job: sliding-window suffix counts -> conditional next-symbol
    probabilities up to max_depth of history
    (ProbabilisticSuffixTreeGenerator.java:88-123), host Python."""

    def __init__(self, symbols: Sequence[str], max_depth: int = 3):
        self.symbols = list(symbols)
        self.max_depth = max_depth
        self.counts: Dict[Tuple[str, ...], np.ndarray] = {}

    def fit(self, seqs: Sequence[Sequence[str]]) -> "ProbabilisticSuffixTree":
        nsym = len(self.symbols)
        idx = {s: i for i, s in enumerate(self.symbols)}
        for seq in seqs:
            enc = [idx[t] for t in seq]
            for t in range(len(enc)):
                for d in range(0, self.max_depth + 1):
                    if t - d < 0:
                        break
                    ctx = tuple(seq[t - d: t])
                    if ctx not in self.counts:
                        self.counts[ctx] = np.zeros(nsym, np.float64)
                    self.counts[ctx][enc[t]] += 1
        return self

    def cond_prob(self, context: Sequence[str], symbol: str) -> float:
        """P(symbol | the longest tracked suffix of context)."""
        ctx = tuple(context[-self.max_depth:])
        while ctx not in self.counts and ctx:
            ctx = ctx[1:]
        c = self.counts.get(ctx)
        if c is None or c.sum() == 0:
            return 1.0 / len(self.symbols)
        return float(c[self.symbols.index(symbol)] / c.sum())

    def sequence_log_prob(self, seq: Sequence[str]) -> float:
        lp = 0.0
        for t, sym in enumerate(seq):
            lp += math.log(max(self.cond_prob(seq[:t], sym), _EPS))
        return lp


# ---------------------------------------------------------------------------
# continuous-time Markov chain (spark/markov)
# ---------------------------------------------------------------------------


class StateTransitionRate:
    """CTMC transition rates from timestamped state visits
    (spark/markov/StateTransitionRate.scala:30): rate(i -> j) =
    count(i -> j) / total dwell time in i."""

    def __init__(self, states: Sequence[str]):
        self.states = list(states)
        n = len(self.states)
        self.trans_counts = np.zeros((n, n))
        self.dwell_time = np.zeros(n)

    def fit(self, seqs: Sequence[Sequence[Tuple[str, float]]]
            ) -> "StateTransitionRate":
        """seqs: per entity, (state, timestamp) pairs in time order."""
        idx = {s: i for i, s in enumerate(self.states)}
        for seq in seqs:
            for (s0, t0), (s1, t1) in zip(seq[:-1], seq[1:]):
                i, j = idx[s0], idx[s1]
                self.dwell_time[i] += max(t1 - t0, 0.0)
                if i != j:
                    self.trans_counts[i, j] += 1
        return self

    def rates(self) -> np.ndarray:
        return self.trans_counts / np.maximum(self.dwell_time[:, None], _EPS)

    def dwell_stats(self) -> Dict[str, Tuple[float, float]]:
        """Mean dwell time and exit rate a state
        (ContTimeStateTransitionStats.scala:34)."""
        exits = self.trans_counts.sum(axis=1)
        mean_dwell = self.dwell_time / np.maximum(exits, 1.0)
        return {
            s: (float(mean_dwell[i]),
                float(exits[i] / max(self.dwell_time[i], _EPS)))
            for i, s in enumerate(self.states)
        }


class ContTimeStateTransitionStats:
    """CTMC statistics by uniformization
    (spark/markov/ContTimeStateTransitionStats.scala:34).

    Given a rate matrix Q (off-diagonal transition rates, diagonal
    -sum(row)), uniformize with maxRate = -min diag: P = I + Q/maxRate,
    count = maxRate * horizon, Poisson(count)-weighted sums over matrix
    powers truncated at 4 + 6*sqrt(count) + count (the reference's limit).
    The power table and the Poisson weights are host float64, as in the
    reference, which keeps them off the device on purpose: the limit grows
    with maxRate * horizon and float32 products compound over long power
    chains, while S is small. The reference's double sums over powers are
    convolutions of a_j = P^j[init, target] and b_j = P^j[target, end]."""

    def __init__(self, rates: np.ndarray, states: Sequence[str],
                 time_horizon: float):
        self.states = list(states)
        self.horizon = float(time_horizon)
        n = len(self.states)
        q = np.asarray(rates, np.float64).copy()
        np.fill_diagonal(q, 0.0)
        np.fill_diagonal(q, -q.sum(axis=1))
        self.max_rate = float(-q.diagonal().min())
        if self.max_rate <= 0:
            raise ValueError("rate matrix has no transitions")
        p = np.eye(n) + q / self.max_rate
        self.count = self.max_rate * self.horizon
        self.limit = int(4 + 6 * math.sqrt(self.count) + self.count)
        self.powers = np.empty((self.limit + 1, n, n), np.float64)
        acc = np.eye(n)
        for i in range(self.limit + 1):
            self.powers[i] = acc
            acc = acc @ p
        # Poisson(count) pmf over 0..limit, built in log space
        i = np.arange(self.limit + 1, dtype=np.float64)
        logpmf = -self.count + i * math.log(max(self.count, _EPS)) - (
            np.cumsum(np.concatenate([[0.0], np.log(np.maximum(i[1:], 1.0))])))
        self.pois = np.exp(logpmf)

    def _sindex(self, state: str) -> int:
        return self.states.index(state)

    def _ab(self, init: str, target: str, end: Optional[str]
            ) -> Tuple[np.ndarray, np.ndarray]:
        a = self.powers[:, self._sindex(init), self._sindex(target)]
        b = (self.powers[:, self._sindex(target), self._sindex(end)]
             if end is not None else np.ones(self.limit + 1))
        return a, b

    def _end_prob(self, init_state: str, end_state: str) -> float:
        """P(X_T = end | X_0 = init): the conditioning normalizer."""
        path = self.powers[:, self._sindex(init_state),
                           self._sindex(end_state)]
        return float(np.maximum(np.sum(path * self.pois), _EPS))

    def dwell_time(self, init_state: str, target_state: str,
                   end_state: Optional[str] = None) -> float:
        """Expected time in target_state over the horizon from init_state;
        with end_state, the expectation conditioned on ending there (the
        "stateDwellTime" statistic, :161-192).

        Deviation from the reference, documented: it returns the
        unnormalized joint E[dwell * 1{X_T=end}]; this divides by
        P(X_T=end | init), the conditional expectation it names."""
        a, b = self._ab(init_state, target_state, end_state)
        inner = np.convolve(a, b)[: self.limit + 1]
        i = np.arange(self.limit + 1, dtype=np.float64)
        raw = float(np.sum(self.horizon / (i + 1.0) * inner * self.pois))
        if end_state is not None:
            raw /= self._end_prob(init_state, end_state)
        return raw

    def transition_count(self, init_state: str, from_state: str,
                         to_state: str, end_state: Optional[str] = None
                         ) -> float:
        """Expected number of from -> to transitions over the horizon (the
        "StateTransitionCount" statistic, :194-215).

        Deviation from the reference, documented: its inner loop runs j in
        0..i inclusive (N+1 terms for N uniformized events), overcounting
        by E[P^N[init, from]]; the uniformization identity E[#trans] =
        rate(from, to) * E[dwell(from)] needs j in 0..N-1, which this
        sums."""
        a = self.powers[:, self._sindex(init_state), self._sindex(from_state)]
        b = (self.powers[:, self._sindex(to_state), self._sindex(end_state)]
             if end_state is not None else np.ones(self.limit + 1))
        step_pr = self.powers[1, self._sindex(from_state),
                              self._sindex(to_state)]
        conv = np.convolve(a, b)
        # inner[i] = sum_{j<=i-1} a_j b_{i-1-j}: one uniformized step spent
        # on the from -> to jump itself
        inner = np.concatenate([[0.0], conv[: self.limit]]) * step_pr
        raw = float(np.sum(inner * self.pois))
        if end_state is not None:
            raw /= self._end_prob(init_state, end_state)
        return raw


def generate_markov_sequences(
    trans: np.ndarray,
    init: np.ndarray,
    states: Sequence[str],
    n_seqs: int,
    length: int,
    seed: int = 0,
) -> List[List[str]]:
    """Synthetic sequences (spark/sequence/SequenceGenerator.scala:31): the
    reference's draws, one `rng.choice` a token."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_seqs):
        s = rng.choice(len(states), p=init)
        seq = [states[s]]
        for _ in range(length - 1):
            s = rng.choice(len(states), p=trans[s])
            seq.append(states[s])
        out.append(seq)
    return out


def event_time_distribution(
    seqs: Sequence[Sequence[float]], num_buckets: int = 24,
    bucket_width: float = 3600.0,
) -> np.ndarray:
    """Inter-arrival time histogram
    (spark/sequence/EventTimeDistribution.scala:27)."""
    gaps = []
    for seq in seqs:
        ts = np.asarray(seq)
        gaps.append(np.diff(ts))
    if not gaps:
        return np.zeros(num_buckets)
    all_gaps = np.concatenate(gaps)
    bucket = np.clip((all_gaps // bucket_width).astype(int), 0,
                     num_buckets - 1)
    return np.bincount(bucket, minlength=num_buckets)
