"""Logistic regression: full-batch gradient epochs on the device.

The port of `avenir_tpu/models/regress.py` (regress/
LogisticRegressionJob.java:51). The reference's outer loop, an MR job an
iteration with the CONVERGED (100) / NOT_CONVERGED (101) exit codes
(:95-119), runs in-process: each epoch is one gradient over the whole
design matrix on `device` (default cuda), under the profiler range
`regress::lr_grad`; the coefficient history is kept and written one row
an iteration (`coeff.file.path`).

The gradient is taken in float64 and rounded to float32 once: x @ coeff,
the sigmoid and x.T @ r as three torch ops. XLA's float32 order (eight
running lanes of FMAs over the rows) has no parallel form, so the
coefficients sit within the tolerance `tests/test_torch_regress_cluster.py`
states; the float64 sums keep the card's gradient equal to the CPU's but
on a rounding tie.

`fit(mesh=)` shards the rows over the ranks of a `parallel.data_mesh`:
each rank's float64 gradient half is summed across them before the one
rounding to float32 (`parallel.distributed`'s lr_step family).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device
from avenir_tpu_torch.utils.metrics import ConfusionMatrix

CONVERGED = 100
NOT_CONVERGED = 101
#: the profiler range of each gradient
GRAD_RANGE = "regress::lr_grad"


def _lr_grad64(coeff: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unnormalized log-likelihood gradient x^T ((y - sigmoid(x c)) * w) in
    float64: the core of the single-device and the sharded step."""
    with torch.profiler.record_function(GRAD_RANGE):
        x64 = x.double()
        r = y.double() - torch.sigmoid(x64 @ coeff.double())
        if w is not None:
            r = r * w.double()
        return x64.T @ r


def _lr_grad(coeff: torch.Tensor, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    """`_lr_grad64` rounded to float32 once."""
    return _lr_grad64(coeff, x, y).float()


def _lr_step(coeff: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             lr: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full-batch gradient ascent step. The division by the row count
    is a true float32 division (a tensor, not a scalar, which CUDA would
    take as a multiply by its reciprocal)."""
    g = _lr_grad(coeff, x, y)
    grad = g / torch.full_like(g, float(x.shape[0]))
    return coeff + lr * grad, grad


class LogisticRegression:
    """Binary logistic regression over the numeric features plus an
    intercept."""

    def __init__(self, learning_rate: float = 1.0, iteration_limit: int = 10,
                 convergence_criteria: str = "iterLimit",
                 convergence_threshold: float = 5.0,
                 pos_class: Optional[str] = None, device: DeviceLike = None):
        self.lr = learning_rate
        self.iter_limit = iteration_limit
        self.criteria = convergence_criteria
        self.threshold = convergence_threshold
        self.pos_class = pos_class
        self.device = resolve_device(device)
        self.coeff_history: List[np.ndarray] = []

    def _design_host(self, ds: Dataset) -> Tuple[np.ndarray, np.ndarray]:
        """(x float32 [n, 1 + D], y float32 [n]) on the host: the features
        standardized in float64 by the first call's mean and deviation
        (the reference's deviation from the Java job, which leaves scaling
        to the user), an intercept column first."""
        x = ds.feature_matrix().astype(np.float64)
        if not hasattr(self, "_mu"):
            self._mu = x.mean(axis=0)
            self._sigma = np.maximum(x.std(axis=0), 1e-9)
        x = (x - self._mu) / self._sigma
        x = np.concatenate([np.ones((len(ds), 1)), x], axis=1).astype(np.float32)
        y = ds.labels().astype(np.float32)
        if self.pos_class is not None:
            pi = ds.schema.class_values().index(self.pos_class)
            y = (ds.labels() == pi).astype(np.float32)
        return x, y

    def _design(self, ds: Dataset) -> Tuple[torch.Tensor, torch.Tensor]:
        """`_design_host` on the device."""
        x, y = self._design_host(ds)
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(y).to(self.device))

    def fit(self, ds: Dataset, mesh=None) -> "LogisticRegression":
        """Full-batch gradient epochs until the criterion says CONVERGED or
        the iteration limit. With `mesh` (on `mesh.device`), every rank
        calls fit on the whole dataset and keeps its shard of the rows over
        the data axis; pad rows weigh 0 and the normalizer is the weight
        total, the real row count."""
        if mesh is None:
            x, y = self._design(ds)
            dev = self.device

            def step(c):
                return _lr_step(c, x, y, self.lr)[0]
        else:
            from avenir_tpu_torch.parallel.distributed import \
                distributed_lr_step_fn
            from avenir_tpu_torch.parallel.mesh import (DATA_AXIS, row_mask,
                                                        shard_rows)
            xh, yh = self._design_host(ds)
            dev = mesh.device
            x, y = shard_rows(mesh, xh), shard_rows(mesh, yh)
            w = row_mask(mesh, len(xh), x.shape[0] * mesh.shape[DATA_AXIS])
            mesh_step = distributed_lr_step_fn(mesh, self.lr, axes=(DATA_AXIS,))

            def step(c):
                return mesh_step(c, x, y, w)
        coeff = torch.zeros(x.shape[1], dtype=torch.float32, device=dev)
        self.coeff_history = [coeff.cpu().numpy()]
        for _ in range(self.iter_limit):
            coeff = step(coeff)
            self.coeff_history.append(coeff.cpu().numpy())
            if self.check_convergence() == CONVERGED:
                break
        self.coeff = self.coeff_history[-1]
        return self

    def check_convergence(self) -> int:
        """The reference's exit code (LogisticRegressionJob.java:95-119);
        the threshold criteria compare the last two rows' change in
        percent."""
        lines = self.coeff_history
        if self.criteria == "iterLimit":
            return NOT_CONVERGED if len(lines) - 1 < self.iter_limit else CONVERGED
        if len(lines) < 2:
            return NOT_CONVERGED
        prev, cur = lines[-2], lines[-1]
        denom = np.maximum(np.abs(prev), 1e-9)
        diff_pct = np.abs(cur - prev) / denom * 100.0
        if self.criteria == "allBelowThreshold":
            ok = bool((diff_pct < self.threshold).all())
        elif self.criteria == "averageBelowThreshold":
            ok = bool(diff_pct.mean() < self.threshold)
        else:
            raise ValueError(f"invalid convergence criteria {self.criteria}")
        return CONVERGED if ok else NOT_CONVERGED

    def save_coeff_history(self, path: str, delim: str = ",") -> None:
        """coeff.file.path: one coefficient row an iteration, `:.6f`."""
        with open(path, "w") as fh:
            for row in self.coeff_history:
                fh.write(delim.join(f"{v:.6f}" for v in row) + "\n")

    @classmethod
    def load_coeff(cls, path: str, delim: str = ",") -> np.ndarray:
        """The last row of a coefficient file."""
        with open(path) as fh:
            lines = [ln for ln in fh.read().splitlines() if ln.strip()]
        return np.array([float(v) for v in lines[-1].split(delim)])

    def predict_proba(self, ds: Dataset) -> np.ndarray:
        x, _ = self._design(ds)
        coeff = torch.from_numpy(np.asarray(self.coeff, np.float32)).to(
            self.device)
        return torch.sigmoid(x @ coeff).cpu().numpy()

    def predict(self, ds: Dataset, threshold: float = 0.5) -> np.ndarray:
        return (self.predict_proba(ds) >= threshold).astype(np.int32)

    def validate(self, ds: Dataset, pos_class_idx: int = 1) -> ConfusionMatrix:
        y = ds.labels()
        if self.pos_class is not None:
            pi = ds.schema.class_values().index(self.pos_class)
            y = (y == pi).astype(np.int32)
            pos_class_idx = 1
        cm = ConfusionMatrix(["neg", "pos"], pos_class=pos_class_idx)
        cm.add(y, self.predict(ds))
        return cm
