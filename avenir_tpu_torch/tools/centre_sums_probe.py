"""Where k-means' centre-sum kernel spends its time, on the card.

    python -m avenir_tpu_torch.tools.centre_sums_probe [--reps N]

First `ops/cluster_kernels.centre_sums` against its plain version at a
few shapes (bit-equal, or the probe fails), with its CUDA-event time.
Then, at the k-means job's shape (1,000,000 x 6, k=3, labels drawn
uniformly from numpy's generator seeded 0), the CUDA-event medians of the
kernel's parts, each a C entry of `ops/csrc/centre_sums.cu`:

- `shipped`: the wrapper's call, both launches (bit-equal or the probe
  fails);
- `partition`: the first launch alone (the rows grouped by cluster);
- `chains`: the second launch alone, on the partition's workspace;
- `fadd_chain`: one thread adding `FADD_ADDS` times, each add waiting on
  the last: the latency of a dependent FADD, in ns (events) and cycles
  (`clock64()`), which sets the floor of any bit-exact form: the largest
  cluster's rows times that latency (`chain_floor_ms`);

beside `index_add_` on the same inputs (float atomics, no fixed order).
Prints the card's name, power limit and top SM clock first and one JSON
line last; exits 1 if a shape is not bit-equal. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops import _build
from avenir_tpu_torch.ops import cluster_kernels as ck

SHAPES = ((1, 1, 1), (5000, 6, 3), (3000, 11, 7), (700, 2, 40),
          (100_000, 130, 5), (20_000, 600, 3), (1_000_000, 6, 3))
#: the dependent adds of the latency chain: about 8 ms at 4 cycles an add
FADD_ADDS = 1 << 22


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() over reps runs, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _inputs(n: int, d: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1, (n, d))
         * 10.0 ** rng.integers(-4, 5, (n, d))).astype(np.float32)
    a = rng.integers(-1, k + 1, n).astype(np.int32)
    return (torch.from_numpy(x).cuda(), torch.from_numpy(a).cuda())


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def fadd_latency(adds: int = FADD_ADDS, reps: int = 3) -> Tuple[float, float]:
    """(ns, cycles) a dependent float32 add takes on the current card: one
    thread's chain of `adds` adds, timed by CUDA events (the median of
    reps) and by the kernel's own clock64()."""
    lib = _build.load("centre_sums")
    out = torch.zeros(1, device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")

    def call():
        _check(lib.centre_sums_fadd_chain_launch(
            adds, 1e-30, out.data_ptr(), cycles.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "fadd chain")

    ms = cuda_ms(call, reps)
    return ms * 1e6 / adds, int(cycles.item()) / adds


def chain_floor_ms(assign: torch.Tensor, k: int, ns_per_add: float) -> float:
    """The least time of any bit-exact form on these labels: the largest
    cluster's rows, one dependent add each."""
    valid = assign[(assign >= 0) & (assign < k)].long()
    rows = int(torch.bincount(valid, minlength=k).max()) if len(valid) else 0
    return rows * ns_per_add * 1e-6


def parts(x: torch.Tensor, a: torch.Tensor, k: int, reps: int) -> dict:
    """CUDA-event ms of each launch of the kernel alone on (x, a, k)."""
    lib = _build.load("centre_sums")
    n, d = x.shape
    ws = ck.workspace(lib, n, d, k, x.device)
    out = torch.empty((k, d), device=x.device)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def partition():
        _check(lib.centre_sums_partition_launch(
            x.data_ptr(), n, d, a.data_ptr(), k, ws.data_ptr(), ws.numel(),
            stream()), "partition")

    def chains():
        _check(lib.centre_sums_chains_launch(
            n, d, k, ws.data_ptr(), ws.numel(), out.data_ptr(), stream()),
            "chains")

    times = {"partition": cuda_ms(partition, reps)}
    times["chains"] = cuda_ms(chains, reps)
    return times


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("centre_sums_probe needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    result = {"shapes": [], "parts": {}}
    ok = True
    for n, d, k in SHAPES:
        x, a = _inputs(n, d, k, n + d + k)
        equal = torch.equal(ck.centre_sums(x, a, k),
                            ck.centre_sums_plain(x, a, k))
        ok &= equal
        ms = cuda_ms(lambda: ck.centre_sums(x, a, k), args.reps)
        result["shapes"].append({"n": n, "d": d, "k": k, "ms": ms,
                                 "bit_equal": equal})
        print(f"{n} x {d}, k={k}: {ms:.4f} ms, bit-equal {equal}",
              flush=True)
    n, d, k = SHAPES[-1]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (n, d)).astype(np.float32)).cuda()
    a = torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).cuda()
    equal = torch.equal(ck.centre_sums(x, a, k), ck.centre_sums_plain(x, a, k))
    ok &= equal
    found = {"shipped": {"ms": cuda_ms(lambda: ck.centre_sums(x, a, k),
                                       args.reps), "bit_equal": equal}}
    found.update({p: {"ms": ms} for p, ms in parts(x, a, k, args.reps).items()})
    ns, cycles = fadd_latency()
    found["fadd_chain"] = {"adds": FADD_ADDS, "ns_per_add": ns,
                           "cycles_per_add": cycles}
    found["chain_floor_ms"] = chain_floor_ms(a, k, ns)
    found["index_add_ms"] = cuda_ms(lambda: torch.zeros(
        (k, d), device="cuda").index_add_(0, a, x), args.reps)
    result["parts"] = found
    for name, row in found.items():
        print(f"{name}: {json.dumps(row)}", flush=True)
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
