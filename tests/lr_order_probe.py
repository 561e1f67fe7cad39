"""How far the port's logistic-regression coefficients lie from the JAX
package's, for two ways of taking the gradient, on the CPU.

    JAX_PLATFORMS=cpu python tests/lr_order_probe.py [rows ...]
        [--twin-rows N]

For each row count (default 2000 5000 20000 200000; the e-learning
fixture of `tests/test_torch_regress_cluster.py`, seed 31) and each
convergence criterion (iterLimit at 10 iterations, allBelowThreshold and
averageBelowThreshold at 50, threshold 5.0), it fits the reference and
the port twice: with the port's gradient (`models/regress._lr_grad`,
float64 rounded to float32 once) and with a float32 one (`torch.sigmoid`
and two float32 matrix products). It prints whether the exit status agrees, the
coefficient rows, the printed (`:.6f`) cells that differ from the
reference's and the largest coefficient difference.

Then, at --twin-rows (default 1,000,000; the e-learning rows of
`chip_smoke.py`'s phase 16, seed 41, without the reference), the two
port gradients against each other: how far a float32 gradient taken in
another order would sit from the float64 one, as a card twin would.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from avenir_tpu.core.dataset import Dataset as JaxDataset
from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.models import regress as jrg
from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.data import elearn_schema, generate_elearn
from avenir_tpu_torch.models import regress as rg

CRITERIA = (("iterLimit", 10), ("allBelowThreshold", 50),
            ("averageBelowThreshold", 50))


def float32_grad(coeff, x, y):
    """x^T (y - sigmoid(x c)) in float32 torch ops."""
    return x.T @ (y - torch.sigmoid(x @ coeff))


GRADS = (("float64 (the port)", rg._lr_grad), ("float32", float32_grad))


def fit(ds, grad, criterion, limit, threshold=5.0):
    """The port's fit with `grad` for `_lr_grad`: (history, exit status)."""
    shipped = rg._lr_grad
    rg._lr_grad = grad
    try:
        m = rg.LogisticRegression(iteration_limit=limit,
                                  convergence_criteria=criterion,
                                  convergence_threshold=threshold,
                                  device="cpu").fit(ds)
    finally:
        rg._lr_grad = shipped
    return np.array(m.coeff_history), m.check_convergence()


def apart(a: np.ndarray, b: np.ndarray):
    """(printed cells that differ, largest difference)."""
    cells = sum(f"{u:.6f}" != f"{v:.6f}" for u, v in zip(a.ravel(),
                                                          b.ravel()))
    return cells, float(np.abs(a - b).max())


def against_reference(rows: int) -> None:
    text = generate_elearn(rows, seed=31, as_csv=True)
    obj = elearn_schema().to_json()
    ds = Dataset.from_csv(text, FeatureSchema.from_json(obj))
    jds = JaxDataset.from_csv(text, JaxSchema.from_json(obj),
                              engine="python")
    for criterion, limit in CRITERIA:
        ref = jrg.LogisticRegression(iteration_limit=limit,
                                     convergence_criteria=criterion).fit(jds)
        rh = np.array(ref.coeff_history)
        for name, grad in GRADS:
            gh, status = fit(ds, grad, criterion, limit)
            same = status == ref.check_convergence()
            if gh.shape != rh.shape:
                print(f"{rows} {criterion} {name}: status {same}, rows "
                      f"{gh.shape[0]} against {rh.shape[0]}", flush=True)
                continue
            cells, most = apart(gh, rh)
            print(f"{rows} {criterion} {name}: status {same}, rows "
                  f"{rh.shape[0]}, cells {cells} of {rh.size}, max "
                  f"{most:.3g}", flush=True)


def twins(rows: int) -> None:
    text = generate_elearn(rows, seed=41, as_csv=True)
    ds = Dataset.from_csv(text, FeatureSchema.from_json(
        elearn_schema().to_json()))
    for criterion, limit in CRITERIA[:2]:
        # phase 16's settings: threshold 1.0
        (a, sa), (b, sb) = (fit(ds, grad, criterion, limit, 1.0)
                            for _, grad in GRADS)
        if a.shape != b.shape:
            print(f"{rows} {criterion}: rows {a.shape[0]} against "
                  f"{b.shape[0]}", flush=True)
            continue
        cells, most = apart(a, b)
        print(f"{rows} {criterion}: float32 against float64, status "
              f"{sa == sb}, cells {cells} of {a.size}, max {most:.3g}",
              flush=True)


def main(argv) -> None:
    twin_rows = 1_000_000
    if "--twin-rows" in argv:
        i = argv.index("--twin-rows")
        twin_rows = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    for rows in [int(a) for a in argv] or [2000, 5000, 20000, 200000]:
        against_reference(rows)
    twins(twin_rows)


if __name__ == "__main__":
    main(sys.argv[1:])
