"""Speed sweep of the port's KNN top-k kernels, and the fused-vote A/B.

    python -m avenir_tpu_torch.tools.knn_sweep [d] [--queries N] [--train N]
                                               [--reps N] [--device cpu]

At the JAX package's sweep width by default: 8192 queries x 131072 train
rows, k=5, D=128, euclidean, data seeded with numpy (seed 2). For each
kernel (exact, packed, lanes) in float32 and bfloat16 it prints one row:
the median time, queries/s and TF/s (2 * nq * nt * D operations of the
cross term over that time). Then the fused-vs-composed classify A/B
(gaussian 30, C=2, bfloat16): the lane top-k followed by
`models.knn._vote`, against the fused `knn_classify_lanes`, in classify
queries/s each, with their arg-max agreement.

The TPU sweep's block sizes (block_q, block_t) have no meaning here: the
port's kernels fix their tile in `knn_tile.cuh` and split the train axis
by the card's SM count, so there is one row per (kernel, dtype).

Runs on `cuda` unless given `--device cpu`, and raises RuntimeError with
no CUDA device and no `--device`. Times are medians of CUDA-event times on
a GPU and of the host clock on the CPU; every row names the device.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from avenir_tpu_torch.models.knn import _vote
from avenir_tpu_torch.ops import knn_kernels as kk
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device

QUERIES, TRAIN, DIM, K, SEED = 8192, 131072, 128, 5, 2
#: (kernel, wrapper, compute dtype): every kernel in both dtypes
CONFIGS = tuple((name, fn, dtype)
                for name, fn in (("exact", kk.knn_topk),
                                 ("packed", kk.knn_topk_packed),
                                 ("lanes", kk.knn_topk_lanes))
                for dtype in kk.COMPUTE_DTYPES)


def time_ms(fn: Callable[[], object], dev: torch.device, reps: int) -> float:
    """Median milliseconds of fn() over reps runs, after one warm-up:
    CUDA events on a GPU, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def classify_arms(q: torch.Tensor, t: torch.Tensor, labels: torch.Tensor
                  ) -> Dict[str, Callable[[], torch.Tensor]]:
    """The two classify arms (gaussian 30, C=2, bfloat16, euclidean), each
    a call giving class scores [nq, 2]: "composed", the lane top-k then
    `models.knn._vote`; "fused", `knn_classify_lanes`."""
    def composed():
        dist, idx = kk.knn_topk_lanes(q, t, K, "euclidean",
                                      compute_dtype="bfloat16")
        return _vote(dist, labels[idx.long().clamp(min=0)],
                     torch.ones_like(dist), "gaussian", 30.0, 2)

    def fused():
        return kk.knn_classify_lanes(q, t, labels, K, 2, None, "gaussian",
                                     30.0, "euclidean",
                                     compute_dtype="bfloat16")

    return {"composed": composed, "fused": fused}


def run(dim: int = DIM, queries: int = QUERIES, train: int = TRAIN,
        device: DeviceLike = None, reps: int = 5, out=print
        ) -> List[Dict[str, object]]:
    """One row per (kernel, dtype) and per classify arm; prints each."""
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rng = np.random.default_rng(SEED)
    q, t = (torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32))
            .to(dev) for n in (queries, train))
    labels = torch.from_numpy(rng.integers(0, 2, train).astype(np.int32))
    labels = labels.to(dev)
    out(f"knn_sweep on {name}: {queries} queries x {train} train rows, "
        f"D={dim}, k={K}, euclidean")
    rows = []
    for kernel, fn, dtype in CONFIGS:
        ms = time_ms(lambda: fn(q, t, K, "euclidean", compute_dtype=dtype),
                     dev, reps)
        row = dict(kernel=kernel, dtype=dtype, ms=ms,
                   qps=queries / ms * 1e3,
                   tflops=2.0 * queries * train * dim / ms / 1e9)
        rows.append(row)
        out(f"{kernel} {dtype}: {ms:.3f} ms  {row['qps']:.3e} q/s  "
            f"{row['tflops']:.2f} TF/s  ({name})")

    arms = classify_arms(q, t, labels)
    agree = float((arms["composed"]().argmax(1) == arms["fused"]().argmax(1))
                  .float().mean())
    for arm, fn in arms.items():
        ms = time_ms(fn, dev, reps)
        rows.append(dict(classify=arm, ms=ms, qps=queries / ms * 1e3,
                         agreement=agree))
        out(f"{arm} classify bfloat16: {ms:.3f} ms  "
            f"{queries / ms * 1e3:.3e} classify q/s  ({name})")
    out(f"fused vs composed arg-max agreement {agree:.5f}")
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m avenir_tpu_torch.tools.knn_sweep",
        description="Time every KNN top-k kernel in both compute dtypes.")
    ap.add_argument("d", nargs="?", type=int, default=DIM,
                    help=f"features (default {DIM})")
    ap.add_argument("--queries", type=int, default=QUERIES)
    ap.add_argument("--train", type=int, default=TRAIN)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    run(args.d, args.queries, args.train, args.device, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
