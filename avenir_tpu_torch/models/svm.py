"""Support vector machine classifier: kernel-primal training as torch ops,
the port of `avenir_tpu/models/svm.py`.

The reference (python/supv/svm.py, SURVEY §2.10) drives scikit-learn's
SVC with linear / rbf / poly kernels, sequential k-fold and random-split
validation, bagging, a per-fold false-positive / false-negative report
and majority-vote ensemble prediction. Like the JAX package, the port
trains the kernelized primal with a squared-hinge loss by full-batch
gradient descent: every step is a product with the [n, n] Gram matrix
and elementwise loss terms.

On the device: the Gram matrix is one `torch.matmul` of x1 @ x2.T (a
plain product outside any Pallas kernel, in float32: TF32 must stay off,
as `torch.backends.cuda.matmul.allow_tf32` is by default) and the
kernel's elementwise terms; `poly` raises to its integer degree by
repeated multiplication, as XLA's `integer_pow` does. `_train_kernel_primal`
is written once with a leading mask axis [E, n], what the reference's
`jax.vmap` makes of it for the folds (`_folds_validate`) and the
estimators (`BaggedSVM`); a single fit is E = 1. All of them share one
Gram matrix. Its 16 power iterations and `epochs` steps are loops of
torch ops: each step reads the Gram matrix twice (a [E, n] x [n, n]
product for the decision values and one for the gradient), so a fit is
bound by the Gram matrix's bytes.

Every entry point runs on the card unless `device="cpu"`; the results
are numpy arrays and Python floats, as the reference returns them, and
`save` / `load` use the reference's `.npz` keys, so that each package
loads the other's file.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device

KERNELS = ("linear", "rbf", "poly")
#: the power iterations of the step-size estimate
POWER_ITERATIONS = 16
F32 = np.float32


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x ** y for an int y by XLA's `integer_pow` order: binary
    exponentiation, acc times the running square."""
    if y == 0:
        return torch.ones_like(x)
    recip, y = y < 0, abs(y)
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return 1.0 / acc if recip else acc


def _kernel_matrix(x1: torch.Tensor, x2: torch.Tensor, kernel: str,
                   gamma: float, degree: int, coef0: float) -> torch.Tensor:
    """Gram matrix [n1, n2]; all three kernels ride one x1 @ x2.T matmul."""
    inner = torch.matmul(x1, x2.T)
    if kernel == "linear":
        return inner
    if kernel == "poly":
        inner.mul_(float(F32(gamma))).add_(float(F32(coef0)))
        return _integer_pow(inner, int(degree))
    # rbf: ||a-b||^2 = |a|^2 + |b|^2 - 2ab, built in place of one [n1, n2]
    # buffer beside the product
    sq1 = torch.sum(x1 * x1, dim=1)[:, None]
    sq2 = torch.sum(x2 * x2, dim=1)[None, :]
    gram = sq1 + sq2
    gram.sub_(inner.mul_(2.0))
    del inner
    return gram.mul_(float(F32(-gamma))).exp_()


def _norm(v: torch.Tensor) -> torch.Tensor:
    """The float32 2-norm of the last axis, sqrt(sum(v * v))."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _train_kernel_primal(gram: torch.Tensor, y: torch.Tensor,
                         masks: torch.Tensor, c: float, lr: float,
                         epochs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared-hinge kernel-primal descent for E sample masks at once.

    Decision f = gram @ (alpha * y) + b; minimizes
    0.5 * alpha K alpha + C * sum(max(0, 1 - y f)^2) over masked samples.
    masks [E, n] zero (or weight) the rows of a fold or a bootstrap draw.
    Returns (alpha * y [E, n], b [E])."""
    n = gram.shape[0]
    e = masks.shape[0]
    gt = gram.T
    # curvature-aware step: the squared-hinge Hessian in alpha space is
    # ~ 2C/n * K^2 + I, so the stable step is 2/(2C*lam^2/n + 1) with lam
    # the Gram spectral norm (power iteration); `lr` is a fraction of it.
    # The masks do not enter it: one estimate serves every estimator
    v = torch.ones(n, dtype=gram.dtype, device=gram.device) / float(
        np.sqrt(F32(n)))
    for _ in range(POWER_ITERATIONS):
        w = torch.mv(gram, v)
        v = w / torch.clamp(_norm(w), min=float(F32(1e-30)))
    lam = _norm(torch.mv(gram, v))
    c32 = torch.tensor(F32(c), device=gram.device)
    step = (torch.tensor(F32(lr), device=gram.device) * 2.0
            / (2.0 * c32 * lam * lam / float(n) + 1.0))
    ay = torch.zeros((e, n), dtype=gram.dtype, device=gram.device)
    b = torch.zeros(e, dtype=gram.dtype, device=gram.device)
    neg2c = -2.0 * c32
    for _ in range(epochs):
        f = torch.matmul(ay, gt) + b[:, None]
        margin = 1.0 - y * f
        viol = torch.clamp(margin, min=0.0) * masks
        # d/d f of C*viol^2 = -2C*y*viol ; primal reg pulls ay toward 0
        grad_f = neg2c * y * viol
        grad_ay = torch.matmul(grad_f, gt) / float(n) + ay
        grad_b = torch.sum(grad_f, dim=1) / float(n)
        ay = ay - step * grad_ay
        b = b - step * grad_b
    return ay, b


def _tensor(a, device) -> torch.Tensor:
    """float32 copy of an array on `device` (the array may be read-only)."""
    return torch.from_numpy(np.array(a, F32)).to(device)


def _signed(y: np.ndarray, device) -> torch.Tensor:
    return _tensor(np.where(np.asarray(y) > 0, 1.0, -1.0), device)


@dataclass
class SVMClassifier:
    """Binary SVM over numeric feature matrices, labels in {0, 1}.

    Config keys mirror the reference properties (svm.py build_model):
    kernel linear/rbf/poly, penalty C, rbf gamma, poly degree/coef0.
    Runs on the card unless `device="cpu"`.
    """

    kernel: str = "rbf"
    c: float = 1.0
    gamma: float = 0.5
    degree: int = 3
    coef0: float = 1.0
    learning_rate: float = 0.1
    epochs: int = 200

    x_train: Optional[np.ndarray] = None
    dual_coef: Optional[np.ndarray] = None       # alpha_i * y_i
    intercept: float = 0.0
    device: DeviceLike = None

    def __post_init__(self):
        if self.kernel not in KERNELS:
            raise ValueError(f"unknown kernel {self.kernel!r}")

    def gram(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return _kernel_matrix(x1, x2, self.kernel, self.gamma, self.degree,
                              self.coef0)

    def train(self, gram: torch.Tensor, y: torch.Tensor,
              masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return _train_kernel_primal(gram, y, masks, self.c,
                                    self.learning_rate, self.epochs)

    # -- core fit/predict ---------------------------------------------------
    def fit(self, x: np.ndarray, y: np.ndarray,
            sample_mask: Optional[np.ndarray] = None) -> "SVMClassifier":
        dev = resolve_device(self.device)
        xt = _tensor(x, dev)
        ypm = _signed(y, dev)
        mask = (torch.ones_like(ypm) if sample_mask is None
                else _tensor(sample_mask, dev))
        ay, b = self.train(self.gram(xt, xt), ypm, mask[None])
        self.x_train = xt.cpu().numpy()
        self.dual_coef = ay[0].cpu().numpy()
        self.intercept = float(b[0])
        return self

    def decision_function(self, x: np.ndarray) -> np.ndarray:
        if self.dual_coef is None:
            raise RuntimeError("model not fitted")
        dev = resolve_device(self.device)
        k = self.gram(_tensor(x, dev), _tensor(self.x_train, dev))
        ay = _tensor(self.dual_coef, dev)
        return (torch.mv(k, ay) + float(F32(self.intercept))).cpu().numpy()

    def predict(self, x: np.ndarray) -> np.ndarray:
        return (self.decision_function(x) > 0.0).astype(np.int64)

    def score(self, x: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(x) == np.asarray(y)))

    @property
    def support_indices(self) -> np.ndarray:
        """Indices with non-negligible dual coefficient (support vectors)."""
        ay = np.abs(self.dual_coef)
        return np.flatnonzero(ay > 1e-6 * max(ay.max(), 1e-30))

    # -- persistence (joblib.dump analog, svm.py:30-35) ---------------------
    def save(self, path: str) -> None:
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 kernel=self.kernel, c=self.c, gamma=self.gamma,
                 degree=self.degree, coef0=self.coef0,
                 learning_rate=self.learning_rate, epochs=self.epochs,
                 x_train=self.x_train, dual_coef=self.dual_coef,
                 intercept=self.intercept)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "SVMClassifier":
        z = np.load(path if path.endswith(".npz") else path + ".npz",
                    allow_pickle=False)
        m = cls(kernel=str(z["kernel"]), c=float(z["c"]),
                gamma=float(z["gamma"]), degree=int(z["degree"]),
                coef0=float(z["coef0"]),
                learning_rate=float(z["learning_rate"]),
                epochs=int(z["epochs"]), device=device)
        m.x_train = z["x_train"]
        m.dual_coef = z["dual_coef"]
        m.intercept = float(z["intercept"])
        return m


def _fold_errors(y_true: np.ndarray, y_pred: np.ndarray
                 ) -> Tuple[float, float, float]:
    """(error, false-positive error, false-negative error) as fractions of
    the validation size — the reference's validate() report."""
    n = len(y_true)
    err = float(np.mean(y_pred != y_true))
    fp = float(np.sum((y_pred == 1) & (y_true == 0))) / n
    fn = float(np.sum((y_pred == 0) & (y_true == 1))) / n
    return err, fp, fn


@dataclass
class ValidationReport:
    fold_errors: List[Tuple[float, float, float]] = field(default_factory=list)

    @property
    def avg_error(self) -> float:
        return float(np.mean([e[0] for e in self.fold_errors]))

    @property
    def avg_fp_error(self) -> float:
        return float(np.mean([e[1] for e in self.fold_errors]))

    @property
    def avg_fn_error(self) -> float:
        return float(np.mean([e[2] for e in self.fold_errors]))

    def cost(self, fp_cost: float = 1.0, fn_cost: float = 1.0) -> float:
        """Misclassification-cost-weighted error (cost-based validation)."""
        return fp_cost * self.avg_fp_error + fn_cost * self.avg_fn_error


def fold_decisions(model: SVMClassifier, x: np.ndarray, y: np.ndarray,
                   vmasks: np.ndarray) -> np.ndarray:
    """float32 [n, folds]: each fold's decision values on every row, all
    folds trained at once on one Gram matrix (masks [folds, n] of the
    rows each fold holds out)."""
    dev = resolve_device(model.device)
    xt = _tensor(x, dev)
    gram = model.gram(xt, xt)
    train = _tensor(~vmasks, dev)
    ays, bs = model.train(gram, _signed(y, dev), train)
    return (torch.matmul(gram, ays.T) + bs).cpu().numpy()


def _folds_validate(model: SVMClassifier, x: np.ndarray, y: np.ndarray,
                    vmasks: np.ndarray) -> ValidationReport:
    f = fold_decisions(model, x, y, vmasks)
    yb = (np.asarray(y) > 0).astype(np.int64)
    report = ValidationReport()
    for i, vm in enumerate(vmasks):
        pred = (f[vm, i] > 0.0).astype(np.int64)
        report.fold_errors.append(_fold_errors(yb[vm], pred))
    return report


def kfold_masks(n: int, nfold: int) -> np.ndarray:
    """Sequential k-fold windows: fold i holds out [i*len, (i+1)*len),
    the last fold to the end."""
    length = n // nfold
    vmasks = np.zeros((nfold, n), bool)
    for i in range(nfold):
        lo, hi = i * length, (i + 1) * length if i < nfold - 1 else n
        vmasks[i, lo:hi] = True
    return vmasks


def rfold_masks(n: int, nfold: int, niter: int, seed: int = 0) -> np.ndarray:
    """Random repeated windows: each iteration holds out a random
    contiguous 1/nfold window, drawn from numpy's generator."""
    rng = np.random.default_rng(seed)
    length = n // nfold
    vmasks = np.zeros((niter, n), bool)
    for i in range(niter):
        lo = int(rng.integers(0, n - length + 1))
        vmasks[i, lo:lo + length] = True
    return vmasks


def kfold_validate(model: SVMClassifier, x: np.ndarray, y: np.ndarray,
                   nfold: int) -> ValidationReport:
    """Sequential k-fold (train_kfold_validation_ext, svm.py:53-99):
    validation window slides by len/nfold each fold."""
    return _folds_validate(model, x, y, kfold_masks(len(x), nfold))


def rfold_validate(model: SVMClassifier, x: np.ndarray, y: np.ndarray,
                   nfold: int, niter: int, seed: int = 0) -> ValidationReport:
    """Random repeated validation (train_rfold_validation_ext): each
    iteration holds out a random contiguous 1/nfold window."""
    return _folds_validate(model, x, y,
                           rfold_masks(len(x), nfold, niter, seed))


@dataclass
class BaggedSVM:
    """Bootstrap-aggregated SVM ensemble (train_bagging, svm.py:22-38).

    All estimators train at once, a mask a row of the trainer's leading
    axis, on one Gram matrix; the device is the base classifier's.
    """

    base: SVMClassifier
    num_estimators: int = 10
    sample_fraction: float = 0.67
    use_oob: bool = False

    x_train: Optional[np.ndarray] = None
    dual_coefs: Optional[np.ndarray] = None      # [E, n]
    intercepts: Optional[np.ndarray] = None      # [E]
    oob_score_: Optional[float] = None

    def fit(self, x: np.ndarray, y: np.ndarray, seed: int = 0) -> "BaggedSVM":
        b = self.base
        dev = resolve_device(b.device)
        rng = np.random.default_rng(seed)
        n = len(x)
        draw = max(1, int(round(self.sample_fraction * n)))
        # bootstrap with replacement -> per-estimator multiplicity masks
        masks = np.zeros((self.num_estimators, n), F32)
        for e in range(self.num_estimators):
            idx, cnt = np.unique(rng.integers(0, n, draw), return_counts=True)
            masks[e, idx] = cnt
        xt = _tensor(x, dev)
        gram = b.gram(xt, xt)
        ays, bs = b.train(gram, _signed(y, dev), _tensor(masks, dev))
        self.x_train = np.asarray(x)
        self.dual_coefs = ays.cpu().numpy()
        self.intercepts = bs.cpu().numpy()
        if self.use_oob:
            # the train Gram matrix again
            f = torch.matmul(gram, ays.T) + bs
            votes = (f.T > 0.0).cpu().numpy().astype(np.int64)   # [E, n]
            oob = masks == 0                                     # [E, n]
            num = np.where(oob, votes, 0).sum(axis=0)
            den = np.maximum(oob.sum(axis=0), 1)
            pred = (num / den) > 0.5
            covered = oob.any(axis=0)
            self.oob_score_ = float(
                np.mean(pred[covered] == (np.asarray(y)[covered] > 0)))
        return self

    def _votes(self, x: np.ndarray) -> np.ndarray:
        b = self.base
        dev = resolve_device(b.device)
        k = b.gram(_tensor(x, dev), _tensor(self.x_train, dev))
        f = (torch.matmul(k, _tensor(self.dual_coefs, dev).T)
             + _tensor(self.intercepts, dev))
        return (f.T > 0.0).cpu().numpy().astype(np.int64)     # [E, nq]

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Majority vote across estimators (predict(), svm.py:167-210)."""
        votes = self._votes(x)
        return (votes.mean(axis=0) > 0.5).astype(np.int64)

    def score(self, x: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(x) == np.asarray(y)))
