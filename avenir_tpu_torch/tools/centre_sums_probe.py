"""Where k-means' centre-sum kernel spends its time, on the card.

    python -m avenir_tpu_torch.tools.centre_sums_probe [--reps N]

First `ops/cluster_kernels.centre_sums` against its plain version at a
few shapes (bit-equal, or the probe fails), with its CUDA-event time.
Then, at the k-means job's shape (1,000,000 x 6, k=3, labels drawn
uniformly from numpy's generator seeded 0), the CUDA-event medians of
variants of `ops/csrc/centre_sums.cu`, each made from the source by one
text substitution and built with the same nvcc flags into a git-ignored
directory of its own:

- `shipped`: the source as it is;
- `unroll8`: 8 rows a register set instead of 16;
- `stage_only`: no chain (the staging alone);
- `chain_only`: no staging (the chains over whatever shared memory
  holds);
- `no_select`: the chains add every row's value (no compare and select);
- `alu_only`: the chains' loads replaced by values made from the row
  index (the compare, select and add alone).

Only `shipped` and `unroll8` give the sums; the others time a part. Prints
the card's name and power limit first and one JSON line last; exits 1 if
a shape is not bit-equal. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from avenir_tpu_torch.ops import _build
from avenir_tpu_torch.ops import cluster_kernels as ck

SHAPES = ((1, 1, 1), (5000, 6, 3), (3000, 11, 7), (700, 2, 40),
          (100_000, 130, 5), (20_000, 600, 3), (1_000_000, 6, 3))
_CHAIN = "acc += l[u] == cluster ? v[u] : 0.0f;"
_LOADS = "    l[u] = lab[r + u];\n    v[u] = xs[(r + u) * width];"
VARIANTS = {
    "shipped": (None, None),
    "unroll8": ("constexpr int UNROLL = 16;", "constexpr int UNROLL = 8;"),
    "stage_only": ("const bool chain = (int)threadIdx.x < nq;",
                   "const bool chain = false;"),
    "chain_only": ("    if ((int)threadIdx.x >= lo) {", "    if (false) {"),
    "no_select": (_CHAIN, "acc += v[u];"),
    "alu_only": (_LOADS, "    l[u] = r + u;\n    v[u] = (float)(r + u);"),
}
OUT = Path(__file__).resolve().parents[2] / "build" / "centre_sums_probe"


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


def _build_variants() -> dict:
    """{variant: bound C entry}, every variant built at once."""
    src = (_build.CSRC / "centre_sums.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (old, new) in VARIANTS.items():
        if old is not None and old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not in the source")
        text = src if old is None else src.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(OUT / f"lib{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(OUT / f"lib{name}.so")).centre_sums_launch
        fn.argtypes = _build.LIBRARIES["centre_sums"][2]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


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
    result = {"shapes": [], "variants": {}}
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
    ref = ck.centre_sums_plain(x, a, k)
    for name, fn in _build_variants().items():
        out = torch.zeros((k, d), device="cuda")

        def call():
            err = fn(x.data_ptr(), n, d, a.data_ptr(), k, out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        ms = cuda_ms(call, args.reps)
        result["variants"][name] = {"ms": ms,
                                    "bit_equal": torch.equal(out, ref)}
        print(f"{name}: {ms:.4f} ms", flush=True)
    ok &= all(result["variants"][v]["bit_equal"]
              for v in ("shipped", "unroll8"))
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
