"""Feature exploration: mutual information, correlations, relevance, samplers.

The port of `avenir_tpu/models/explore.py` (org.avenir.explore). Most jobs
are a contingency-table or moment reduction over records:

- mutual information and its selection scores (MutualInformation.java,
  MutualInformationScore.java): the chunk's count tables are
  `torch.bincount`s on the device (`_mi_chunk_counts`), drained to
  float64 host arrays per chunk; the scores are computed from those
  tables on the host, in float32 as the JAX package computes them
  (`ops/infotheory.py`), so a card run and its CPU twin print the same
  bytes;
- the class partition stats of every candidate split
  (`ClassPartitionGenerator`): the tree's level histogram with one leaf,
  counted on the device; the stats on the host;
- Cramér and heterogeneity-reduction correlation: [B, K] contingency
  tables counted on the device; the Cramér index in float64 numpy, the
  impurities in float32 on the host;
- numerical correlation: float64 moments on the host, `m.T @ m` in
  numpy, as the reference has them;
- class affinity and supervised encoding: float64 host arithmetic over
  the same contingency tables;
- Relief: each sampled record's nearest hit and miss by a per-class
  blocked manhattan top-k on the device, the weights on the host;
- top matches by class: `NeighborIndex` a class (on the card the EXACT
  top-k kernel);
- the samplers and the rule evaluator: host numpy, the samplers drawing
  from the reference's `default_rng` in its order.

Counts are integers, so every table is exact and the same on the CPU and
the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.core.schema import FeatureField
from avenir_tpu_torch.ops.infotheory import (bits_entropy, entropy, gini,
                                             weighted_split_score,
                                             mutual_information)
from avenir_tpu_torch.ops.reduce import cross_count
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device

_EPS = 1e-12
#: bytes a chunk's fused count may take: its int64 tables (P bmax^2 (k + 1)
#: + F bmax k cells, padded to the widest vocabulary) and its two [n, P]
#: int64 key tensors. Past it add() counts pair by pair, each table in the
#: keyspace of the pair's own bins.
_FUSED_BYTES_LIMIT = 256 << 20


def _fused_bytes(n: int, nf: int, bmax: int, k: int) -> int:
    """Bytes of `_mi_chunk_counts`'s tables and key tensors on n rows."""
    npair = nf * (nf - 1) // 2
    return 8 * (npair * bmax * bmax * (k + 1) + nf * bmax * k
                + 2 * n * npair)


def _padded_add(acc: Optional[np.ndarray], new: np.ndarray) -> np.ndarray:
    """acc + new where either may be smaller along any axis (a growing
    data-discovered vocabulary); missing cells are zero counts."""
    if acc is None:
        return new
    if acc.shape == new.shape:
        return acc + new
    shape = tuple(max(a, b) for a, b in zip(acc.shape, new.shape))
    out = np.zeros(shape, np.float64)
    out[tuple(slice(0, s) for s in acc.shape)] += acc
    out[tuple(slice(0, s) for s in new.shape)] += new
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


# ---------------------------------------------------------------------------
# mutual information + feature selection scores
# ---------------------------------------------------------------------------
def _mi_chunk_counts(codes: torch.Tensor, y: torch.Tensor, bmax: int, k: int,
                     nf: int) -> Tuple[torch.Tensor, ...]:
    """One chunk's MI count tables on the codes' device, one int64 key
    tensor and one `torch.bincount` a table family: fc [F, bmax, k], pair
    [P, bmax, bmax] and pairc [P, bmax, bmax, k], P = F(F-1)/2 pairs in
    upper-triangle (`triu`) order. Exact. The caller keeps its bytes
    (`_fused_bytes`) under `_FUSED_BYTES_LIMIT`."""
    dev = codes.device
    codes = codes.long()
    y = y.long()[:, None]
    f_idx = torch.arange(nf, device=dev)[None, :]
    fc = torch.bincount(((f_idx * bmax + codes) * k + y).reshape(-1),
                        minlength=nf * bmax * k).reshape(nf, bmax, k)
    ii, jj = np.triu_indices(nf, 1)
    npair = len(ii)
    if npair == 0:
        return (fc, torch.zeros((0, bmax, bmax), dtype=torch.int64, device=dev),
                torch.zeros((0, bmax, bmax, k), dtype=torch.int64, device=dev))
    ci = codes[:, torch.as_tensor(ii, device=dev)]
    cj = codes[:, torch.as_tensor(jj, device=dev)]
    p_idx = torch.arange(npair, device=dev)[None, :]
    key_p = (p_idx * bmax + ci) * bmax + cj                      # [n, P]
    pair = torch.bincount(key_p.reshape(-1), minlength=npair * bmax * bmax
                          ).reshape(npair, bmax, bmax)
    pairc = torch.bincount((key_p * k + y).reshape(-1),
                           minlength=npair * bmax * bmax * k
                           ).reshape(npair, bmax, bmax, k)
    return fc, pair, pairc


def _mi_chunk_counts_host(codes, y, bmax: int, k: int, nf: int
                          ) -> Tuple[np.ndarray, ...]:
    """_mi_chunk_counts in host numpy, the path of a CPU run: one
    `np.bincount` a table over a per-pair keyspace (no [n, P] key tensor,
    whose temporaries would dominate host time), the class-marginal pair
    table the integer sum of pairc over classes. The same integer tables
    as the device path."""
    codes = np.ascontiguousarray(codes, np.int64)
    y = np.asarray(y, np.int64)
    cy = codes * k + y[:, None]                                 # [n, F]
    fc = np.empty((nf, bmax, k), np.int64)
    for f in range(nf):
        fc[f] = np.bincount(cy[:, f], minlength=bmax * k).reshape(bmax, k)
    npair = nf * (nf - 1) // 2
    pair = np.empty((npair, bmax, bmax), np.int64)
    pairc = np.empty((npair, bmax, bmax, k), np.int64)
    p = 0
    for i in range(nf):
        ci_bk = codes[:, i] * (bmax * k)
        for j in range(i + 1, nf):
            pairc[p] = np.bincount(ci_bk + cy[:, j],
                                   minlength=bmax * bmax * k
                                   ).reshape(bmax, bmax, k)
            pair[p] = pairc[p].sum(axis=2)
            p += 1
    return fc, pair, pairc


class MutualInformationAnalyzer:
    """The MutualInformation job's tables and scores
    (MutualInformation.java:62): the class, feature, feature-pair,
    feature-class and feature-pair-class distributions the reducer held
    (:138-216), counted a chunk at a time on `device` (default cuda), and
    the greedy selection loops of MutualInformationScore.java over them:
      mutual.info.maximization (MIM)         :98
      mutual.info.selection (MIFS, beta)     :116-140
      joint.mutual.info (JMI)                :177
      double.input.symmetric.relevance(DISR) :185-229
      min.redundancy.max.relevance (mRMR)    :265-288
    MI values are in nats."""

    def __init__(self, ds: Optional[Dataset] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.fields: Optional[List[FeatureField]] = None
        self.bins: List[int] = []
        self.k = 0
        self.n = 0
        self._fc: List[np.ndarray] = []                       # f: [Bf, K]
        self._pair: Dict[Tuple[int, int], np.ndarray] = {}    # [Bi, Bj]
        self._pairc: Dict[Tuple[int, int], np.ndarray] = {}   # [Bi, Bj, K]
        if ds is not None:
            self.add(ds)
            self.finalize()

    @classmethod
    def from_chunks(cls, chunks, device: DeviceLike = None
                    ) -> "MutualInformationAnalyzer":
        """Fold streamed Dataset chunks and finalize: every table is an
        additive count, so the chunking cannot change it."""
        self = cls(device=device)
        for ds in chunks:
            self.add(ds)
        if self.fields is None:
            raise ValueError("no input chunks")
        self.finalize()
        return self

    def add(self, ds: Dataset) -> None:
        """Fold one chunk's counts into the running tables. A
        data-discovered categorical vocabulary may grow between chunks:
        the tables zero-pad along the grown bin axes."""
        if self.fields is None:
            self.fields = ds.encodable_feature_fields()
            self.k = ds.num_classes()
            self.bins = [0] * len(self.fields)
            self._fc = [np.zeros((0, self.k), np.float64)
                        for _ in self.fields]
        codes, bins = ds.feature_codes(self.fields)
        nf = len(self.fields)
        self.bins = [max(a, b) for a, b in zip(self.bins, bins)]
        bmax = max(bins) if bins else 1
        if _fused_bytes(len(ds), nf, bmax, self.k) <= _FUSED_BYTES_LIMIT:
            if self.device.type == "cpu":
                tables = _mi_chunk_counts_host(codes, ds.labels(), bmax,
                                               self.k, nf)
            else:
                # the codes cross as the parse left them; the counts
                # widen them on the card
                tables = _mi_chunk_counts(
                    torch.as_tensor(codes, device=self.device),
                    torch.as_tensor(ds.labels(), device=self.device),
                    bmax, self.k, nf)
            fc, pair, pairc = (np.asarray(t, np.float64)
                               if isinstance(t, np.ndarray) else _host(t)
                               for t in tables)
            p = 0
            for i in range(nf):
                self._fc[i] = _padded_add(self._fc[i], fc[i, :bins[i]])
                for j in range(i + 1, nf):
                    bi, bj = bins[i], bins[j]
                    self._pair[(i, j)] = _padded_add(
                        self._pair.get((i, j)), pair[p, :bi, :bj])
                    self._pairc[(i, j)] = _padded_add(
                        self._pairc.get((i, j)), pairc[p, :bi, :bj])
                    p += 1
        else:
            # pair by pair, each table in its own keyspace
            codes_d = torch.as_tensor(np.asarray(codes, np.int64),
                                      device=self.device)
            y = torch.as_tensor(ds.labels(), device=self.device)
            for f in range(nf):
                self._fc[f] = _padded_add(self._fc[f], _host(
                    cross_count(codes_d[:, f], y, bins[f], self.k)))
            for i in range(nf):
                for j in range(i + 1, nf):
                    bi, bj = bins[i], bins[j]
                    self._pair[(i, j)] = _padded_add(
                        self._pair.get((i, j)), _host(
                            cross_count(codes_d[:, i], codes_d[:, j], bi, bj)))
                    comb = codes_d[:, i].long() * bj + codes_d[:, j]
                    self._pairc[(i, j)] = _padded_add(
                        self._pairc.get((i, j)), _host(
                            cross_count(comb, y, bi * bj, self.k)
                        ).reshape(bi, bj, self.k))
        self.n += len(ds)

    def merge(self, other: "MutualInformationAnalyzer"
              ) -> "MutualInformationAnalyzer":
        """Fold another analyzer's tables into this one: every table is an
        additive integer count, so merge(add(A), add(B)) equals
        add(A ++ B) exactly. Both are un-finalized fits over the same
        feature set; an empty `other` is a no-op, an empty `self` adopts
        `other`'s tables. Grown vocabularies zero-pad, as in add()."""
        if other.fields is None:
            return self
        if self.fields is None:
            self.fields = other.fields
            self.k = other.k
            self.bins = [0] * len(other.fields)
            self._fc = [np.zeros((0, self.k), np.float64)
                        for _ in other.fields]
        if self.k != other.k or [f.ordinal for f in self.fields] != \
                [f.ordinal for f in other.fields]:
            raise ValueError(
                "cannot merge MI analyzers over different feature sets "
                "or class counts")
        self.bins = [max(a, b) for a, b in zip(self.bins, other.bins)]
        for i in range(len(self.fields)):
            self._fc[i] = _padded_add(self._fc[i], other._fc[i])
        for key, tbl in other._pair.items():
            self._pair[key] = _padded_add(self._pair.get(key), tbl)
        for key, tbl in other._pairc.items():
            self._pairc[key] = _padded_add(self._pairc.get(key), tbl)
        self.n += other.n
        return self

    def finalize(self) -> None:
        """Every MI statistic from the tables, in float32 on the host."""
        nf = len(self.bins)
        self.feature_class_mi = np.zeros(nf)
        self.pair_mi = np.zeros((nf, nf))
        self.pair_class_mi = np.zeros((nf, nf))
        self.pair_class_entropy = np.zeros((nf, nf))
        for f in range(nf):
            self.feature_class_mi[f] = float(mutual_information(self._fc[f]))
        for (i, j), joint_ij in self._pair.items():
            mi_ij = float(mutual_information(joint_ij))
            self.pair_mi[i, j] = self.pair_mi[j, i] = mi_ij
        for (i, j), joint_ijc in self._pairc.items():
            flat = joint_ijc.reshape(-1, self.k)
            mic = float(mutual_information(flat))
            self.pair_class_mi[i, j] = self.pair_class_mi[j, i] = mic
            h = float(entropy(flat.reshape(-1), axis=-1))
            self.pair_class_entropy[i, j] = self.pair_class_entropy[j, i] = h

    # ------------------------------------------------------------- scores
    def _ordinals(self) -> List[int]:
        return [f.ordinal for f in self.fields]

    def mim(self) -> List[Tuple[int, float]]:
        """Max relevance: features sorted by I(Xf; C) descending."""
        order = np.argsort(-self.feature_class_mi)
        ords = self._ordinals()
        return [(ords[i], float(self.feature_class_mi[i])) for i in order]

    def mifs(self, redundancy_factor: float = 1.0) -> List[Tuple[int, float]]:
        """Greedy: score = I(Xf;C) - beta * sum_{s in selected} I(Xf;Xs)."""
        nf = len(self.bins)
        selected: List[int] = []
        out = []
        while len(selected) < nf:
            best, best_score = -1, -np.inf
            for f in range(nf):
                if f in selected:
                    continue
                red = sum(self.pair_mi[f, s] for s in selected)
                score = self.feature_class_mi[f] - redundancy_factor * red
                if score > best_score:
                    best, best_score = f, score
            selected.append(best)
            out.append((self._ordinals()[best], float(best_score)))
        return out

    def _jmi_helper(self, joint: bool) -> List[Tuple[int, float]]:
        nf = len(self.bins)
        first = int(np.argmax(self.feature_class_mi))
        selected = [first]
        out = [(self._ordinals()[first], float(self.feature_class_mi[first]))]
        while len(selected) < nf:
            best, best_score = -1, -np.inf
            for f in range(nf):
                if f in selected:
                    continue
                if joint:
                    s_sum = sum(self.pair_class_mi[f, s] for s in selected)
                else:
                    s_sum = sum(
                        self.pair_class_mi[f, s]
                        / max(self.pair_class_entropy[f, s], _EPS)
                        for s in selected)
                if s_sum > best_score:
                    best, best_score = f, s_sum
            selected.append(best)
            out.append((self._ordinals()[best], float(best_score)))
        return out

    def jmi(self) -> List[Tuple[int, float]]:
        """Joint mutual information selection."""
        return self._jmi_helper(True)

    def disr(self) -> List[Tuple[int, float]]:
        """Double-input symmetric relevance (JMI over the pair entropy)."""
        return self._jmi_helper(False)

    def mrmr(self) -> List[Tuple[int, float]]:
        """Greedy: score = I(Xf;C) - mean_{s in selected} I(Xf;Xs)."""
        nf = len(self.bins)
        selected: List[int] = []
        out = []
        while len(selected) < nf:
            best, best_score = -1, -np.inf
            for f in range(nf):
                if f in selected:
                    continue
                red = sum(self.pair_mi[f, s] for s in selected)
                score = (self.feature_class_mi[f] - red / len(selected)
                         if selected else self.feature_class_mi[f])
                if score > best_score:
                    best, best_score = f, score
            selected.append(best)
            out.append((self._ordinals()[best], float(best_score)))
        return out

    def score(self, algorithm: str, redundancy_factor: float = 1.0):
        """Dispatch by the reference's mut.* algorithm names."""
        return {
            "mutual.info.maximization": self.mim,
            "mutual.info.selection": lambda: self.mifs(redundancy_factor),
            "joint.mutual.info": self.jmi,
            "double.input.symmetric.relevance": self.disr,
            "min.redundancy.max.relevance": self.mrmr,
        }[algorithm]()


# ---------------------------------------------------------------------------
# candidate-split class partition stats
# ---------------------------------------------------------------------------
class ClassPartitionGenerator:
    """Candidate-split class-histogram stats — the older two-job tree flow's
    first stage (explore/ClassPartitionGenerator.java:61, cpg.* keys).

    For every candidate split of the requested attributes, the tree's
    level histogram with a single root leaf (`tree._level_histogram`, one
    keyed count on `device`, default cuda) gives the [segment, class]
    counts; the split stat is computed on the host per
    cpg.split.algorithm: `entropy` / `giniIndex` (weighted child info
    content in float32, `ops.infotheory.weighted_split_score`, lower =
    better) or `hellingerDistance` (AttributeSplitStat.java:228-283,
    float64 numpy, higher = better, binary class only)."""

    def __init__(self, ds: Dataset, attributes: Optional[Sequence[int]] = None,
                 algorithm: str = "giniIndex", cat_partition_cap: int = 128,
                 device: DeviceLike = None):
        from avenir_tpu_torch.models.tree import enumerate_splits

        self.ds = ds
        self.algorithm = algorithm
        self.device = resolve_device(device)
        splits = enumerate_splits(ds.schema, cat_partition_cap)
        if attributes is not None:
            attrs = set(attributes)
            splits = [s for s in splits if s.attribute in attrs]
        self.splits = splits
        self.k = ds.schema.num_classes()
        self.histograms = self._histograms()

    def _histograms(self) -> List[np.ndarray]:
        """Per split: float32 [n_segments, k] class counts."""
        from avenir_tpu_torch.models.tree import (_level_histogram,
                                                  segment_matrix)

        if not self.splits:
            return []
        n = len(self.ds)
        dev = self.device
        smax = max(s.n_segments for s in self.splits)
        seg = segment_matrix(self.splits, self.ds)            # [n, NS]
        hists = _level_histogram(
            torch.zeros(n, dtype=torch.int32, device=dev),
            torch.from_numpy(seg).to(dev),
            torch.from_numpy(self.ds.labels()).to(dev),
            torch.ones(n, dtype=torch.float32, device=dev),
            1, len(self.splits), smax, self.k,
        ).cpu().numpy()[0]                                     # [NS, smax, k]
        return [hists[i, : s.n_segments] for i, s in enumerate(self.splits)]

    def split_stats(self) -> List[Tuple[object, float]]:
        """(CandidateSplit, stat) per candidate, computed per algorithm."""
        out = []
        for s, h in zip(self.splits, self.histograms):
            if self.algorithm == "hellingerDistance":
                if self.k != 2:
                    raise ValueError("Hellinger distance algorithm is only "
                                     "valid for binary valued class attributes")
                tot = np.maximum(h.sum(axis=0), _EPS)        # per-class totals
                d = np.sqrt(h[:, 0] / tot[0]) - np.sqrt(h[:, 1] / tot[1])
                stat = float(np.sqrt((d * d).sum()))
            else:
                stat = float(weighted_split_score(h, self.algorithm))
            out.append((s, stat))
        return out

    def best_split(self):
        """(CandidateSplit, stat): max stat for Hellinger, min info content
        for entropy/gini."""
        stats = self.split_stats()
        pick = max if self.algorithm == "hellingerDistance" else min
        return pick(stats, key=lambda t: t[1])


# ---------------------------------------------------------------------------
# correlations
# ---------------------------------------------------------------------------
def contingency(ds: Dataset, fld: FeatureField,
                device: DeviceLike = None) -> np.ndarray:
    """int64 [Bf, K] feature-value x class count table, counted on
    `device` (default cuda)."""
    dev = resolve_device(device)
    codes, _ = ds.feature_codes([fld])
    return cross_count(torch.as_tensor(codes[:, 0].astype(np.int64),
                                       device=dev),
                       torch.as_tensor(ds.labels(), device=dev),
                       ds.num_bins(fld), ds.num_classes()).cpu().numpy()


def cramer_index(table: np.ndarray) -> float:
    """Cramér index V^2 = chi2 / (n * min(r-1, c-1)) in float64
    (CramerCorrelation.java via chombo ContingencyMatrix)."""
    n = table.sum()
    if n == 0:
        return 0.0
    row = table.sum(axis=1, keepdims=True)
    col = table.sum(axis=0, keepdims=True)
    expected = row @ col / n
    chi2 = float(np.where(expected > 0,
                          (table - expected) ** 2 / np.maximum(expected, _EPS),
                          0.0).sum())
    r, c = table.shape
    denom = n * max(min(r - 1, c - 1), 1)
    return chi2 / denom


class ContingencyAccumulator:
    """Streaming per-field feature-value x class contingency tables, the
    whole correlation family's input (Cramér, categorical, heterogeneity
    reduction; CramerCorrelation.java:54). Tables are counted on `device`
    (default cuda) a chunk at a time and kept as float64 host arrays; the
    bin axis grows as a data-discovered vocabulary does."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.fields: Optional[List[FeatureField]] = None
        self.tables: Dict[int, np.ndarray] = {}      # ordinal -> [B, K]
        self.class_counts: Optional[np.ndarray] = None
        self.k = 0
        self.n = 0

    def add(self, ds: Dataset) -> None:
        if self.fields is None:
            self.fields = ds.encodable_feature_fields()
            self.k = ds.num_classes()
            self.class_counts = np.zeros(self.k, np.float64)
        y = ds.labels()
        self.class_counts += np.bincount(y, minlength=self.k)
        if self.fields:
            codes, bins = ds.feature_codes(self.fields)
            codes_d = torch.as_tensor(np.asarray(codes, np.int64),
                                      device=self.device)
            yd = torch.as_tensor(y, device=self.device)
            for i, f in enumerate(self.fields):
                tab = _host(cross_count(codes_d[:, i], yd, bins[i], self.k))
                self.tables[f.ordinal] = _padded_add(
                    self.tables.get(f.ordinal), tab)
        self.n += len(ds)

    def cramer(self) -> Dict[int, float]:
        return {o: cramer_index(t) for o, t in sorted(self.tables.items())}

    def heterogeneity(self, algo: str = "entropy") -> Dict[int, float]:
        """(imp(C) - sum_b p(b) imp(C|b)) / imp(C) a field, the
        impurities in float32 on the host, the weighting in float64."""
        imp_fn = bits_entropy if algo == "entropy" else gini
        base = float(imp_fn(self.class_counts))
        out = {}
        for o, tab in sorted(self.tables.items()):
            seg_tot = tab.sum(axis=1)
            seg_imp = imp_fn(tab, axis=-1).numpy()
            cond = float((seg_tot / max(seg_tot.sum(), _EPS) * seg_imp).sum())
            out[o] = (base - cond) / max(base, _EPS)
        return out


class NumericMomentAccumulator:
    """Streaming Pearson moments (n, sum, cross-products) over the
    numeric features and the numeric-coded class
    (NumericalCorrelation.java:48), float64 on the host."""

    def __init__(self):
        self.n = 0
        self.s: Optional[np.ndarray] = None
        self.ss: Optional[np.ndarray] = None

    def add(self, ds: Dataset) -> None:
        x = ds.feature_matrix()
        y = ds.labels().astype(np.float32)[:, None]
        m = np.concatenate([x, y], axis=1).astype(np.float64)
        if self.s is None:
            d = m.shape[1]
            self.s = np.zeros(d, np.float64)
            self.ss = np.zeros((d, d), np.float64)
        self.n += m.shape[0]
        self.s += m.sum(axis=0)
        self.ss += m.T @ m

    def correlation(self) -> np.ndarray:
        mean = self.s / max(self.n, 1)
        cov = self.ss / max(self.n, 1) - np.outer(mean, mean)
        sd = np.sqrt(np.clip(np.diag(cov), _EPS, None))
        return cov / np.outer(sd, sd)


def cramer_correlation(ds: Dataset, device: DeviceLike = None
                       ) -> Dict[int, float]:
    """Per-categorical-feature Cramér index against the class."""
    acc = ContingencyAccumulator(device)
    acc.add(ds)
    return acc.cramer()


def heterogeneity_reduction(ds: Dataset, algo: str = "entropy",
                            device: DeviceLike = None) -> Dict[int, float]:
    """Proportional impurity reduction of the class by each feature
    (HeterogeneityReductionCorrelation.java:38)."""
    acc = ContingencyAccumulator(device)
    acc.add(ds)
    return acc.heterogeneity(algo)


def numerical_correlation(ds: Dataset) -> np.ndarray:
    """Pearson correlation matrix over the numeric features and the
    numeric-coded class, from one moment pass
    (NumericalCorrelation.java:48)."""
    acc = NumericMomentAccumulator()
    acc.add(ds)
    return acc.correlation()


# ---------------------------------------------------------------------------
# Relief feature relevance
# ---------------------------------------------------------------------------
def relief_relevance(ds: Dataset, sample_size: Optional[int] = None,
                     seed: int = 0, block: int = 8192,
                     query_block: int = 8192,
                     device: DeviceLike = None) -> Dict[int, float]:
    """Relief: w_f += diff_f(x, nearest miss) - diff_f(x, nearest hit),
    averaged over the sampled records (ReliefFeatureRelevance.java:49).

    Each record's nearest row of every class comes from a per-class
    blocked manhattan top-k (`ops.distance.blocked_topk_neighbors`, k at
    most 2) on `device` (default cuda), `query_block` queries at a time;
    the weights are host numpy over the chosen pairs. An in-class query
    takes the runner-up (itself, or a duplicate row before it, comes
    first); a singleton class has no hit. Ranges are the schema's
    max - min, else the sample's own, at least 1e-12."""
    from avenir_tpu_torch.ops.distance import (blocked_topk_neighbors,
                                               pad_train)

    dev = resolve_device(device)
    n = len(ds)
    rng = np.random.default_rng(seed)
    idx = (np.arange(n) if sample_size is None or sample_size >= n
           else rng.choice(n, sample_size, replace=False))
    sub = ds.take(idx)
    y = sub.labels()
    m = len(sub)
    k_classes = ds.schema.num_classes()

    num_fields = [f for f in ds.schema.feature_fields if f.is_numeric]
    cat_fields = [f for f in ds.schema.feature_fields if f.is_categorical]
    num_cols, ranges = [], []
    for f in num_fields:
        col = sub.column(f.ordinal).astype(np.float32)
        rngf = (f.max - f.min) if f.max is not None and f.min is not None \
            else (float(col.max() - col.min()) or 1.0)
        num_cols.append(col)
        ranges.append(max(rngf, _EPS))
    x_num = (np.stack(num_cols, axis=1) if num_cols
             else np.zeros((m, 0), np.float32))
    ranges_arr = np.asarray(ranges, np.float32)
    if cat_fields:
        x_cat = np.stack([sub.column(f.ordinal).astype(np.int32)
                          for f in cat_fields], axis=1)
        bins = tuple(len(f.cardinality) for f in cat_fields)
    else:
        x_cat, bins = None, None

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    best_d = np.full((m, k_classes), np.inf, np.float32)
    best_i = np.zeros((m, k_classes), np.int64)
    q_num = on_dev(x_num) if x_num.shape[1] else None
    q_cat = on_dev(x_cat) if x_cat is not None else None
    rng_d = on_dev(ranges_arr) if ranges_arr.size else None
    for ki in range(k_classes):
        rows_c = np.flatnonzero(y == ki)
        if len(rows_c) == 0:
            continue
        blk = min(block, len(rows_c))
        t_num, t_cat, n_valid = pad_train(
            x_num[rows_c] if x_num.shape[1] else None,
            x_cat[rows_c] if x_cat is not None else None, blk)
        kk = min(2, len(rows_c))
        t_num_d = on_dev(t_num) if t_num is not None else None
        t_cat_d = on_dev(t_cat) if t_cat is not None else None
        for qs in range(0, m, query_block):
            qe = min(qs + query_block, m)
            dist, nidx = blocked_topk_neighbors(
                q_num[qs:qe] if q_num is not None else None, t_num_d,
                q_cat[qs:qe] if q_cat is not None else None, t_cat_d,
                cat_bins=bins, num_ranges=rng_d, k=kk, block=blk,
                metric="manhattan", n_valid=n_valid)
            dist, nidx = dist.cpu().numpy(), nidx.cpu().numpy()
            in_c = y[qs:qe] == ki
            sel = np.where(in_c, kk - 1, 0)
            r = np.arange(qe - qs)
            d = dist[r, sel]
            j = nidx[r, sel]
            if kk == 1:
                d = np.where(in_c, np.inf, d)
            best_d[qs:qe, ki] = d
            best_i[qs:qe, ki] = rows_c[np.clip(j, 0, len(rows_c) - 1)]

    rows = np.arange(m)
    hit_i = best_i[rows, y]
    hit_ok = np.isfinite(best_d[rows, y])
    miss_view = best_d.copy()
    miss_view[rows, y] = np.inf
    miss_cls = miss_view.argmin(axis=1)
    miss_i = best_i[rows, miss_cls]
    miss_ok = np.isfinite(miss_view[rows, miss_cls])
    valid = hit_ok & miss_ok
    if not valid.any():
        return {f.ordinal: 0.0 for f in num_fields + cat_fields}
    weights = {}
    for fi, f in enumerate(num_fields):
        col = x_num[:, fi]
        d_hit = np.abs(col - col[hit_i]) / ranges_arr[fi]
        d_miss = np.abs(col - col[miss_i]) / ranges_arr[fi]
        weights[f.ordinal] = float((d_miss - d_hit)[valid].mean())
    for fi, f in enumerate(cat_fields):
        col = x_cat[:, fi]
        d_hit = (col != col[hit_i]).astype(np.float32)
        d_miss = (col != col[miss_i]).astype(np.float32)
        weights[f.ordinal] = float((d_miss - d_hit)[valid].mean())
    return weights


# ---------------------------------------------------------------------------
# class affinity + supervised encoding
# ---------------------------------------------------------------------------
def class_affinity_from_table(tab: np.ndarray, fld: FeatureField,
                              class_values: Sequence[str], top_n: int = 3
                              ) -> Dict[str, List[Tuple[str, float]]]:
    """Per class, the top-n values of a [B, K] contingency table by
    P(value | class), float64; ties in numpy's default argsort order."""
    cls_tot = tab.sum(axis=0)
    out = {}
    for ki, cv in enumerate(class_values):
        p = tab[:, ki] / max(cls_tot[ki], _EPS)
        order = np.argsort(-p)[:top_n]
        out[cv] = [(fld.cardinality[b], float(p[b])) for b in order
                   if b < len(fld.cardinality)]
    return out


def class_affinity(ds: Dataset, fld: FeatureField, top_n: int = 3,
                   device: DeviceLike = None
                   ) -> Dict[str, List[Tuple[str, float]]]:
    """Per class: top-n categorical values by P(value | class)
    (CategoricalClassAffinity.java:51), counted on `device`. The table is
    float32 here, as the reference's single-dataset form divides its
    int32 table in float32 (the jobs fold float64 tables)."""
    return class_affinity_from_table(
        contingency(ds, fld, device).astype(np.float32), fld,
        ds.schema.class_values(), top_n)


def supervised_encoding_from_table(tab: np.ndarray, fld: FeatureField,
                                   classes: Sequence[str],
                                   strategy: str = "supervisedRatio",
                                   pos_class: Optional[str] = None
                                   ) -> Dict[str, float]:
    """Categorical value -> continuous code from a [B, K] contingency
    table (CategoricalContinuousEncoding.java:47): supervisedRatio is
    count(value, pos) / count(value); weightOfEvidence is
    ln((count(value, pos) / total_pos) / (count(value, neg) / total_neg))
    with a 0.5 continuity correction. The positive class is
    `pos_class`, else the class at index 1."""
    pi = classes.index(pos_class) if pos_class else 1
    pos = tab[:, pi]
    neg = tab.sum(axis=1) - pos
    total_pos = max(pos.sum(), _EPS)
    total_neg = max(neg.sum(), _EPS)
    out = {}
    for b, value in enumerate(fld.cardinality[:tab.shape[0]]):
        if strategy == "weightOfEvidence":
            num = max(pos[b], 0.5) / total_pos
            den = max(neg[b], 0.5) / total_neg
            out[value] = math.log(num / den)
        else:
            out[value] = float(pos[b] / max(pos[b] + neg[b], _EPS))
    return out


def supervised_encoding(ds: Dataset, fld: FeatureField,
                        strategy: str = "supervisedRatio",
                        pos_class: Optional[str] = None,
                        device: DeviceLike = None) -> Dict[str, float]:
    """supervised_encoding_from_table of one dataset's table, float32 as
    in `class_affinity`."""
    return supervised_encoding_from_table(
        contingency(ds, fld, device).astype(np.float32), fld,
        ds.schema.class_values(), strategy, pos_class)


# ---------------------------------------------------------------------------
# samplers: host numpy draws, the reference's generator in its order
# ---------------------------------------------------------------------------
def undersample_balance(ds: Dataset, seed: int = 0) -> Dataset:
    """Undersample every class to the smallest present class's count, rows
    kept in file order (UnderSamplingBalancer.java:45)."""
    y = ds.labels()
    rng = np.random.default_rng(seed)
    counts = np.bincount(y, minlength=ds.schema.num_classes())
    target = counts[counts > 0].min()
    keep = []
    for c in range(len(counts)):
        rows = np.flatnonzero(y == c)
        if len(rows) > target:
            rows = rng.choice(rows, target, replace=False)
        keep.append(rows)
    return ds.take(np.sort(np.concatenate(keep)))


def bagging_sample(ds: Dataset, rate: float = 1.0, seed: int = 0) -> Dataset:
    """Bootstrap sample of int(n * rate) rows (BaggingSampler.java:47)."""
    rng = np.random.default_rng(seed)
    n = len(ds)
    return ds.take(rng.integers(0, n, int(n * rate)))


# ---------------------------------------------------------------------------
# top matches by class + rule evaluation
# ---------------------------------------------------------------------------
def top_matches_by_class(ds: Dataset, k: int = 3, block: int = 4096,
                         query_block: int = 16384, device: DeviceLike = None
                         ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Per class with at least two rows: each of its records' k nearest
    same-class rows (TopMatchesByClass.java:47), as (dist [m, k], dataset
    row index [m, k]); row r is the class's r-th record in file order.
    The search is `NeighborIndex` over the class (manhattan, k + 1 capped
    at the class size; on the card the EXACT top-k kernel), queries
    `query_block` at a time; the first neighbour, taken to be the record
    itself, is dropped."""
    from avenir_tpu_torch.models.knn import NeighborIndex

    dev = resolve_device(device)
    y = ds.labels()
    out = {}
    for ki, cv in enumerate(ds.schema.class_values()):
        rows = np.flatnonzero(y == ki)
        if len(rows) < 2:
            continue
        sub = ds.take(rows)
        index = NeighborIndex(sub, k=min(k + 1, len(rows)), block=block,
                              device=dev)
        dists, idxs = [], []
        for qs in range(0, len(rows), query_block):
            d, i = index.neighbors(sub.take(np.arange(
                qs, min(qs + query_block, len(rows)), dtype=np.int32)))
            dists.append(d.cpu().numpy())
            idxs.append(i.cpu().numpy())
        dist = np.concatenate(dists)
        idx = np.concatenate(idxs)
        out[cv] = (dist[:, 1:], rows[idx[:, 1:]])
    return out


@dataclass
class Rule:
    """condition => consequence, each a conjunction of "attr op value"
    predicates, op one of eq, ne, gt, ge, lt, le, in (RuleEvaluator.java:48,
    util/RuleExpression.java). Evaluated on the host: a categorical eq/ne
    raises KeyError on a value outside the vocabulary, `in` skips it;
    numeric compares are float64."""

    condition: List[str]
    consequence: List[str]

    @staticmethod
    def _eval_one(ds: Dataset, expr: str) -> np.ndarray:
        toks = expr.strip().split(None, 2)
        attr, op, val = int(toks[0]), toks[1], toks[2]
        fld = ds.schema.field_by_ordinal(attr)
        col = ds.column(attr)
        if fld.is_categorical:
            index = fld.cardinality_index()
            if op == "in":
                codes = [index[v] for v in val.split(":") if v in index]
                return np.isin(col.astype(np.int64), codes)
            m = col.astype(np.int64) == index[val]
            return m if op == "eq" else ~m
        x = col.astype(np.float64)
        v = float(val)
        return {"eq": x == v, "ne": x != v, "gt": x > v, "ge": x >= v,
                "lt": x < v, "le": x <= v}[op]

    def counts(self, ds: Dataset) -> Tuple[int, int, int]:
        """(rows, conditionCount, bothCount) of one chunk: additive."""
        cond = np.ones(len(ds), bool)
        for e in self.condition:
            cond &= self._eval_one(ds, e)
        cons = np.ones(len(ds), bool)
        for e in self.consequence:
            cons &= self._eval_one(ds, e)
        return len(ds), int(cond.sum()), int((cond & cons).sum())

    @staticmethod
    def finalize(n: int, cond: int, both: int) -> Dict[str, float]:
        return {"support": float(both / n if n else 0.0),
                "confidence": float(both / max(cond, 1)),
                "conditionCount": cond, "bothCount": both}

    def evaluate(self, ds: Dataset) -> Dict[str, float]:
        return self.finalize(*self.counts(ds))
