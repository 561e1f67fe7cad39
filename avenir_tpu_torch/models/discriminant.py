"""Fisher discriminant analysis per feature.

The port of `avenir_tpu/models/discriminant.py`: the moments and the
boundary are float64 numpy on the host, as in the JAX package since its
move off a float32 device einsum, whose rounding depended on how many
rows a chunk held. So the boundary file is the same bytes on the CPU and
the card, at any chunking.

Reference (discriminant/FisherDiscriminant.java:42): reuses chombo's
NumericalAttrStats mapper/combiner to get per-(feature, class) mean and
variance; the reducer computes the pooled variance and a per-feature class
boundary shifted by the log prior odds (:83-96):

    boundary = (m0 + m1)/2 + pooledVar * ln(p(c0)/p(c1)) / (m1 - m0)

One pass of per-class moments gives all features' stats at once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from avenir_tpu_torch.core.dataset import Dataset

_EPS = 1e-12


class FisherDiscriminant:
    """Per-numeric-feature two-class linear boundary."""

    def __init__(self):
        self.boundaries: Dict[int, float] = {}
        self.means: Dict[int, Tuple[float, float]] = {}
        self.fields: List = []
        self._cnt = None

    def accumulate(self, ds: Dataset) -> "FisherDiscriminant":
        """Fold one chunk's per-class moments (count, sum, sum-sq),
        float64 on the host: additive, so the discriminant streams like
        every count job, and float64 keeps the chunk layout's effect
        about nine orders below the file's %.6f."""
        if self._cnt is None:
            self.fields = [f for f in ds.schema.feature_fields
                           if f.is_numeric]
            assert ds.num_classes() == 2, \
                "Fisher discriminant is two-class"
            self._cnt = np.zeros(2, np.float64)
            self._s1 = np.zeros((2, len(self.fields)), np.float64)
            self._s2 = np.zeros((2, len(self.fields)), np.float64)
        x = np.asarray(ds.feature_matrix(self.fields), np.float64)  # [n, F]
        y = np.asarray(ds.labels())
        for k in (0, 1):
            xk = x[y == k]
            self._cnt[k] += xk.shape[0]
            self._s1[k] += xk.sum(axis=0)
            self._s2[k] += (xk * xk).sum(axis=0)
        return self

    def merge(self, other: "FisherDiscriminant") -> "FisherDiscriminant":
        """Fold another partial fit's per-class moments into this one —
        the NaiveBayesModel.merge algebra for the discriminant: (count,
        sum, sum-sq) are additive, so merging shard fits equals fitting
        the concatenated shards. Both sides must be un-finalized partial
        accumulations over the same numeric feature set; an empty
        `other` merges as a no-op and an empty `self` adopts `other`."""
        if other._cnt is None:
            return self
        if self._cnt is None:
            self.fields = other.fields
            self._cnt, self._s1, self._s2 = other._cnt, other._s1, other._s2
            return self
        if [f.ordinal for f in self.fields] != \
                [f.ordinal for f in other.fields]:
            raise ValueError(
                "cannot merge discriminants over different feature sets")
        self._cnt += other._cnt
        self._s1 += other._s1
        self._s2 += other._s2
        return self

    def finalize(self) -> "FisherDiscriminant":
        cnt_np, s1_np, s2_np = self._cnt, self._s1, self._s2
        mean = s1_np / np.maximum(cnt_np[:, None], _EPS)
        var = s2_np / np.maximum(cnt_np[:, None], _EPS) - mean ** 2
        pooled = (
            (cnt_np[0] * var[0] + cnt_np[1] * var[1])
            / max(cnt_np.sum(), _EPS)
        )
        prior = cnt_np / cnt_np.sum()
        log_odds = np.log(max(prior[0], _EPS) / max(prior[1], _EPS))
        for fi, fld in enumerate(self.fields):
            m0, m1 = mean[0, fi], mean[1, fi]
            sep = m1 - m0
            b = (m0 + m1) / 2.0
            if abs(sep) > _EPS:
                b += pooled[fi] * log_odds / sep
            self.boundaries[fld.ordinal] = float(b)
            self.means[fld.ordinal] = (float(m0), float(m1))
        return self

    def fit(self, ds: Dataset) -> "FisherDiscriminant":
        # refit from scratch (fit has always been idempotent); streaming
        # callers use accumulate()/finalize() directly
        self._cnt = None
        self.boundaries, self.means = {}, {}
        return self.accumulate(ds).finalize()

    def predict(self, ds: Dataset, ordinal: int) -> np.ndarray:
        """Classify by the single-feature boundary: class 1 iff the value is
        on class 1's mean side of the boundary."""
        return self.predict_values(ordinal,
                                   ds.column(ordinal).astype(np.float64))

    def predict_values(self, ordinal: int, x: np.ndarray) -> np.ndarray:
        """Vectorized entry point over raw float64 values — the math
        :meth:`predict` applies to a Dataset column, shared with the
        online scoring path so batch and per-request classifications
        can never drift (each comparison is per-row, so the result is
        invariant to batch composition by construction)."""
        x = np.asarray(x, np.float64)
        b = self.boundaries[ordinal]
        m0, m1 = self.means[ordinal]
        side = x >= b if m1 >= m0 else x < b
        return side.astype(np.int32)

    def save(self, path: str, delim: str = ",", stamp: bool = True) -> None:
        """``stamp`` publishes the format/digest sidecar the serving
        path verifies at load (models/artifact.py)."""
        with open(path, "w") as fh:
            for ordn, b in self.boundaries.items():
                m0, m1 = self.means[ordn]
                fh.write(f"{ordn}{delim}{b:.6f}{delim}{m0:.6f}{delim}{m1:.6f}\n")
        if stamp:
            from avenir_tpu_torch.models.artifact import write_stamp
            write_stamp(path)

    @classmethod
    def load(cls, path: str, delim: str = ",") -> "FisherDiscriminant":
        """Read a saved boundary table back into a servable
        discriminant (digest-verified when a stamp sidecar exists; the
        train-side moments are not persisted, so a loaded model only
        predicts)."""
        from avenir_tpu_torch.models.artifact import verify_stamp
        verify_stamp(path)
        fd = cls()
        with open(path) as fh:
            for ln in fh:
                if not ln.strip():
                    continue
                ordn, b, m0, m1 = ln.rstrip("\n").split(delim)[:4]
                fd.boundaries[int(ordn)] = float(b)
                fd.means[int(ordn)] = (float(m0), float(m1))
        return fd
