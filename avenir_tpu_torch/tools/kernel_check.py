"""Check of every KNN kernel of the port against a float64 NumPy oracle.

    python -m avenir_tpu_torch.tools.kernel_check [--device cpu]

The port's counterpart of the JAX package's compiled-kernel check, with
the same cases, drawn from the same seeded generator in the same order,
and the same bars but one:

- exact, packed, lanes (and lanes-bf16 for euclidean) top-k over the
  cases basic, pad, multiblock, tiny_train, k1 and manhattan, held to the
  oracle's distances (rtol 1e-3 exact, 3e-3 packed and lanes, 2e-2 bf16;
  atol 1e-5) with a tie-tolerant recall >= 0.999: a returned row counts
  if its true distance is within 2*rtol of the k-th best. Slots past a
  corpus smaller than k must be (+inf, -1); indices must be real rows.
- the fused vote against the composed lane top-k + `models.knn._vote`
  (none, gaussian, linearAdditive; C=3): arg-max agreement >= 0.99 and
  scores within 2.0;
- the vote with 3 train rows for k=5 in float32 and bfloat16: scores
  stay finite;
- mixed one-hot data through `models.knn._expand_mixed` against
  `ops.distance.blocked_topk_neighbors` (rtol 3e-3, atol 5e-4: the
  queries are train rows, and a zero distance comes back from either
  side's dot form as the square root of its own fp32 cancellation
  residual, up to 3.1e-4 here; the JAX package's test of this comparison
  takes atol 5e-4 too, where its TPU check took 1e-4);
- the k nearest rows planted in one 128-column lane: all surface.

It runs on `cuda` unless given `--device cpu` (the wrappers' plain
versions); with no CUDA device and no `--device` it raises RuntimeError.
It prints one line per case and a summary JSON line, and exits 0 only if
every case passes.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.models.knn import _expand_mixed, _vote
from avenir_tpu_torch.ops import knn_kernels as kk
from avenir_tpu_torch.ops.distance import blocked_topk_neighbors, pad_train
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device

#: one generator, drawn in the order of the JAX package's check, so every
#: case sees the same data there and here
SEED = 7
MIXED_BINS = (4, 3)
#: (label, queries, real train rows, features, k, padding block, metric)
TOPK_CASES = (
    ("basic", 256, 4096, 16, 5, 512, "euclidean"),
    ("pad", 256, 3000, 16, 5, 512, "euclidean"),
    ("multiblock", 256, 16384, 32, 5, 2048, "euclidean"),
    ("tiny_train", 128, 3, 8, 5, 256, "euclidean"),
    ("k1", 128, 2048, 8, 1, 512, "euclidean"),
    ("manhattan", 128, 1024, 8, 4, 512, "manhattan"),
)
#: (variant, wrapper, compute dtype, rtol against the oracle)
TOPK_VARIANTS = (
    ("exact", kk.knn_topk, "float32", 1e-3),
    ("packed", kk.knn_topk_packed, "float32", 3e-3),
    ("lanes", kk.knn_topk_lanes, "float32", 3e-3),
    ("lanes-bf16", kk.knn_topk_lanes, "bfloat16", 2e-2),
)
VOTE_CASES = (("none", "euclidean"), ("gaussian", "euclidean"),
              ("linearAdditive", "manhattan"))

Check = Callable[[torch.device], List[str]]


@functools.lru_cache(maxsize=1)
def case_data() -> Dict[str, object]:
    """Every case's inputs (numpy), drawn from one seeded generator."""
    rng = np.random.default_rng(SEED)
    data: Dict[str, object] = {}
    for label, nq, nt, d, *_ in TOPK_CASES:
        data[label] = (rng.normal(size=(nq, d)).astype(np.float32),
                       rng.normal(size=(nt, d)).astype(np.float32))
    for kernel_fn, _ in VOTE_CASES:
        data[f"vote/{kernel_fn}"] = (
            rng.normal(size=(256, 8)).astype(np.float32),
            rng.normal(size=(3000, 8)).astype(np.float32),
            rng.integers(0, 3, 3000).astype(np.int32))
    for dtype in kk.COMPUTE_DTYPES:
        data[f"exhausted/{dtype}"] = (
            rng.normal(size=(256, 4)).astype(np.float32),
            rng.normal(size=(3, 4)).astype(np.float32),
            np.array([0, 1, 1], np.int32))
    x_num = rng.normal(size=(2000, 3)).astype(np.float32) * 5
    x_cat = np.stack([rng.integers(0, b, 2000) for b in MIXED_BINS],
                     1).astype(np.int32)
    data["mixed"] = (x_num, x_cat)
    data["collision"] = rng.normal(size=(2048, 4)).astype(np.float32) * 10
    return data


def _dev(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def oracle(q: np.ndarray, t: np.ndarray, metric: str) -> np.ndarray:
    """[nq, nt] float64 attribute-averaged distances, 8 queries at a time."""
    out = np.empty((q.shape[0], t.shape[0]))
    t64 = t.astype(np.float64)
    for s in range(0, q.shape[0], 8):
        diff = q[s:s + 8, None, :].astype(np.float64) - t64[None]
        out[s:s + 8] = (np.sqrt((diff ** 2).mean(-1)) if metric == "euclidean"
                        else np.abs(diff).mean(-1))
    return out


def topk_faults(got_d: np.ndarray, got_i: np.ndarray, full: np.ndarray,
                k: int, rtol: float) -> List[str]:
    """What is wrong with a top-k result against the oracle's distances."""
    nq, nt = full.shape
    kk_ = min(k, nt)
    ref_d = np.sort(full, axis=1)[:, :kk_]
    faults = []
    err = np.abs(got_d[:, :kk_] - ref_d)
    if not (err <= 1e-5 + rtol * np.abs(ref_d)).all():
        faults.append(f"max |dist err| {err.max():.2e}")
    idx = got_i[:, :kk_]
    real = (idx >= 0) & (idx < nt)
    if not real.all():
        faults.append("index out of range")
    true = np.take_along_axis(full, np.clip(idx, 0, nt - 1), axis=1)
    bar = ref_d[:, -1:] * (1.0 + 2 * rtol) + 1e-6
    recall = float((real & (true <= bar)).mean())
    if recall < 0.999:
        faults.append(f"tie-tolerant recall {recall:.4f}")
    if kk_ < k and not (np.isinf(got_d[:, kk_:]).all()
                        and (got_i[:, kk_:] == -1).all()):
        faults.append("bad empty slots")
    return faults


def _topk_check(i: int, wrapper, compute_dtype: str, rtol: float) -> Check:
    label, _, _, _, k, block, metric = TOPK_CASES[i]

    def check(dev: torch.device) -> List[str]:
        q, t = case_data()[label]
        t_pad, _, n_valid = pad_train(t, None, block)
        got_d, got_i = wrapper(_dev(q, dev), _dev(t_pad, dev), k, metric,
                               n_valid, compute_dtype=compute_dtype)
        return topk_faults(got_d.cpu().numpy(), got_i.cpu().numpy(),
                           oracle(q, t, metric), k, rtol)
    return check


def _vote_data(key: str):
    """(q, train rows and labels padded to 512-row blocks, n_valid)."""
    q, t, labels = case_data()[key]
    t_pad, _, n_valid = pad_train(t, None, 512)
    lab_pad = np.zeros(t_pad.shape[0], np.int32)
    lab_pad[:len(labels)] = labels
    return q, t_pad, lab_pad, n_valid


def _fused_vote_check(i: int) -> Check:
    kernel_fn, metric = VOTE_CASES[i]

    def check(dev: torch.device) -> List[str]:
        k, c = 5, 3
        q, t_pad, lab_pad, n_valid = _vote_data(f"vote/{kernel_fn}")
        qd, td, ld = _dev(q, dev), _dev(t_pad, dev), _dev(lab_pad, dev)
        scores = kk.knn_classify_lanes(qd, td, ld, k, c, None, kernel_fn,
                                       30.0, metric, n_valid)
        dist, idx = kk.knn_topk_lanes(qd, td, k, metric, n_valid)
        ref = _vote(dist, ld[idx.long().clamp(min=0)], torch.ones_like(dist),
                    kernel_fn, 30.0, c)
        scores, ref = scores.cpu().numpy(), ref.cpu().numpy()
        agree = float((scores.argmax(1) == ref.argmax(1)).mean())
        err = float(np.abs(scores - ref).max())
        return ([] if agree >= 0.99 and err <= 2.0
                else [f"arg-max agreement {agree:.4f}, max |err| {err}"])
    return check


def _exhausted_vote_check(compute_dtype: str) -> Check:
    def check(dev: torch.device) -> List[str]:
        q, t_pad, lab_pad, n_valid = _vote_data(f"exhausted/{compute_dtype}")
        scores = kk.knn_classify_lanes(
            _dev(q, dev), _dev(t_pad, dev), _dev(lab_pad, dev), 5, 2, None,
            "gaussian", 30.0, "euclidean", n_valid, compute_dtype)
        return ([] if bool(torch.isfinite(scores).all())
                else ["non-finite scores"])
    return check


def _mixed_check(metric: str) -> Check:
    def check(dev: torch.device) -> List[str]:
        bins = MIXED_BINS
        x_num, x_cat = case_data()["mixed"]
        ranges = np.full(3, 10.0, np.float32)
        q_num, q_cat = x_num[:256], x_cat[:256]
        ref_d, _ = blocked_topk_neighbors(
            _dev(q_num, dev), _dev(x_num, dev), _dev(q_cat, dev),
            _dev(x_cat, dev), cat_bins=bins, num_ranges=_dev(ranges, dev),
            k=4, block=2000, metric=metric)
        xe, n_attrs = _expand_mixed(x_num, ranges, x_cat, bins, metric)
        qe, _ = _expand_mixed(q_num, ranges, q_cat, bins, metric)
        t_pad, _, n_valid = pad_train(xe, None, 512)
        got_d, _ = kk.knn_topk_lanes(_dev(qe, dev), _dev(t_pad, dev), 4,
                                     metric, n_valid, n_attrs)
        got, ref = got_d.cpu().numpy(), ref_d.cpu().numpy()
        return ([] if np.allclose(got, ref, rtol=3e-3, atol=5e-4)
                else [f"max |dist err| {np.abs(got - ref).max():.2e}"])
    return check


def _same_lane_check(dev: torch.device) -> List[str]:
    q = np.zeros((128, 4), np.float32)
    t = case_data()["collision"].copy()
    cols = [3, 131, 259, 515, 899]
    for rank, c in enumerate(cols):
        t[c] = 0.01 * (rank + 1)
    _, idx = kk.knn_topk_lanes(_dev(q, dev), _dev(t, dev), 5, "euclidean")
    got = sorted(idx[0].cpu().tolist())
    return [] if got == cols else [f"row 0 neighbours {got}, want {cols}"]


def cases() -> List[Tuple[str, Check]]:
    """Every check, by name, in the order the tool runs them."""
    out = []
    for i, (label, *_, metric) in enumerate(TOPK_CASES):
        for variant, wrapper, dtype, rtol in TOPK_VARIANTS:
            if dtype == "bfloat16" and metric != "euclidean":
                continue
            out.append((f"{variant}/{label}",
                        _topk_check(i, wrapper, dtype, rtol)))
    for i, (kernel_fn, metric) in enumerate(VOTE_CASES):
        out.append((f"fused-vote/{kernel_fn}-{metric}", _fused_vote_check(i)))
    for dtype in kk.COMPUTE_DTYPES:
        out.append((f"fused-vote-exhausted/{dtype}",
                    _exhausted_vote_check(dtype)))
    for metric in ("euclidean", "manhattan"):
        out.append((f"mixed-onehot/{metric}", _mixed_check(metric)))
    out.append(("lanes/same-lane-collision", _same_lane_check))
    return out


CASE_NAMES = tuple(name for name, _ in cases())


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run(device: DeviceLike = None, names: Optional[List[str]] = None,
        out=print) -> Dict[str, List[str]]:
    """{case: faults} of the named cases (all by default) on `device`
    (cuda unless "cpu"); prints a line per case and a summary JSON line."""
    dev = resolve_device(device)
    results = {}
    for name, check in cases():
        if names is not None and name not in names:
            continue
        faults = check(dev)
        results[name] = faults
        out(f"{'FAIL' if faults else 'PASS'} {name}"
            + (": " + "; ".join(faults) if faults else ""))
    out(json.dumps({"metric": "kernel_check", "device": device_name(dev),
                    "passed": sum(not f for f in results.values()),
                    "total": len(results)}))
    return results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m avenir_tpu_torch.tools.kernel_check",
        description="Check every KNN kernel against a float64 NumPy oracle.")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    results = run(args.device)
    return 0 if not any(results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
