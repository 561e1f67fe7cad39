"""MCMC convergence diagnostics: Geweke and Raftery-Lewis, the port's own
copy of `avenir_tpu/utils/mcmc.py` (float64 numpy on the host).

Reference (python/lib/mcconverge.py, SURVEY §2.10): GewekeConvergence
computes a modified z-score comparing an early window (first 10% after
burn-in) against the last 50% for each candidate burn-in size
(mcconverge.py:13-37); RafteryLewisConvergence derives burn-in and sample
size from the 2-state (below/above a quantile threshold) chain's transition
matrix (:40-87 — the reference implementation has several typos; the
formulas here follow Raftery & Lewis 1992, which that code clearly
intends).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from math import erf, log, sqrt
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _norm_ppf(p: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation)."""
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = sqrt(-2 * log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
                + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > phigh:
        return -_norm_ppf(1 - p)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
            + a[5]) * q / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r
                            + b[4]) * r + 1)


def _norm_cdf(x: float) -> float:
    return 0.5 * (1.0 + erf(x / sqrt(2.0)))


@dataclass
class GewekeConvergence:
    """Geweke z-scores for a list of candidate burn-in sizes.

    z = (mean(A) - mean(B)) / sqrt(var(A)/|A| + var(B)/|B|) with A the
    first `window_a` fraction after burn-in and B the last `window_b`
    fraction; |z| < ~2 indicates convergence."""

    burn_in_sizes: Sequence[int]
    window_a: float = 0.1
    window_b: float = 0.5
    zscores: List[Tuple[int, int, float]] = field(default_factory=list)

    def calculate_zscores(self, data: Sequence[float]
                          ) -> List[Tuple[int, int, float]]:
        self.zscores = []
        x = np.asarray(data, np.float64)
        n = len(x)
        for bi in self.burn_in_sizes:
            rem = n - bi
            if rem < 4:
                continue
            a = x[bi: bi + max(int(rem * self.window_a), 2)]
            b = x[n - max(int(rem * self.window_b), 2):]
            se = sqrt(a.var() / len(a) + b.var() / len(b))
            z = float((a.mean() - b.mean()) / se) if se > 0 else 0.0
            self.zscores.append((n, int(bi), z))
        return self.zscores

    def converged(self, threshold: float = 2.0) -> bool:
        return bool(self.zscores) and abs(self.zscores[-1][2]) < threshold


@dataclass
class RafteryLewisConvergence:
    """Raftery-Lewis burn-in / sample-size estimate.

    Parameters mirror the reference's (k, s, r, e): `thinning_interval` k,
    `quantile` the probability q whose estimate is wanted, accuracy `r`
    (half-width of the tolerated interval), confidence `s`, and
    `trans_prob_conf_limit` e for the burn-in criterion.
    """

    thinning_interval: int = 1
    quantile: float = 0.025
    accuracy: float = 0.005
    confidence: float = 0.95
    trans_prob_conf_limit: float = 0.001

    def find_sample_size(self, data: Sequence[float],
                         threshold: Optional[float] = None
                         ) -> Tuple[int, int]:
        """Returns (burn_in_size, sample_size) in original (unthinned)
        iterations. `threshold` defaults to the `quantile`-quantile of the
        chain (the reference picks a random chain value)."""
        x = np.asarray(data, np.float64)[::self.thinning_interval]
        u = (np.quantile(x, self.quantile) if threshold is None
             else float(threshold))
        z = (x < u).astype(np.int64)
        # 2-state transition counts
        tr = np.zeros((2, 2), np.float64)
        np.add.at(tr, (z[:-1], z[1:]), 1.0)
        row = tr.sum(axis=1)
        if row[0] == 0 or row[1] == 0:
            return 0, len(x) * self.thinning_interval
        alpha = tr[0, 1] / row[0]                 # P(0 -> 1)
        beta = tr[1, 0] / row[1]                  # P(1 -> 0)
        ab = alpha + beta
        if ab <= 0 or ab >= 2:
            return 0, len(x) * self.thinning_interval
        lam = 1.0 - ab
        # burn-in: m with lam^m * max(alpha,beta)/ab <= e
        if abs(lam) < 1e-12:
            burn_in = 0.0
        else:
            burn_in = (log(self.trans_prob_conf_limit * ab / max(alpha, beta))
                       / log(abs(lam)))
        burn_in = max(burn_in, 0.0) * self.thinning_interval
        # sample size: n = alpha*beta*(2-ab)/ab^3 * (phi/r)^2
        phi = _norm_ppf(0.5 * (1.0 + self.confidence))
        n = (alpha * beta * (2.0 - ab) / ab ** 3) * (phi / self.accuracy) ** 2
        n *= self.thinning_interval
        return int(np.ceil(burn_in)), int(np.ceil(n))

    def n_min(self) -> int:
        """Minimum sample size assuming independence."""
        phi = _norm_ppf(0.5 * (1.0 + self.confidence))
        q = self.quantile
        return int(np.ceil(q * (1 - q) * (phi / self.accuracy) ** 2))
