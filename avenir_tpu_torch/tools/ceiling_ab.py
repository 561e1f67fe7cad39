"""Same-call A/B of the matmul ceiling against an earlier version of its sources.

    python -m avenir_tpu_torch.tools.ceiling_ab --parent DIR [--reps N]

DIR holds an earlier `matmul_ceiling.cu` and the headers it includes,
written out into a git-ignored directory: either the bf16 `mma.sync`
ceiling with its own C interface (9 arguments: q, t, nq, nt, d,
rows_per_split, partial, out, stream; 4096 train rows a split), for
example 637fd96's, or a `wgmma` ceiling with this checkout's interface
(it has `matmul_ceiling_info`), whose output must then also equal this
checkout's bit for bit. It builds with the same nvcc flags
(`ops/_build.py`) into a build directory of its own; this checkout's
ceiling builds as the wrapper builds it.

The inputs are `chip_smoke.py` phase 7's: q [8192, 128] and t [131072,
128] float32, normal, from numpy's generator seeded 3. Each version's rows
are held to the plain version within 2^-16 sum_j |q̂_i . t̂_j| (the bf16
products are exact; only the fp32 order differs), and a rerun of each must
be bit-equal. Times are CUDA-event medians of `--reps` calls, taken in
turns (earlier, current, current, earlier) and averaged per side, with
TF/s and the share of the bound (2 nq nt D operations at the 989 TFLOP/s
bf16 dense peak).

For each version it prints the main kernel's registers, stack and local
bytes (`cuobjdump -res-usage`), ptxas's spill bytes over the library, and
the library's SASS counts of HGMMA (wgmma), HMMA (mma.sync) and UTMALDG
(TMA loads) (`cuobjdump -sass`). Prints the card's name and power limit
first and one JSON line last; exits 1 if a row is out of tolerance, a
rerun differs or a wgmma parent's output differs. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops import _build
from avenir_tpu_torch.ops import matmul_ceiling as mc
from avenir_tpu_torch.tools.bench import BF16_PEAK_FLOPS
from avenir_tpu_torch.tools.knn_ab import card, cuda_ms

NQ, NT, D, SEED = 8192, 131072, 128, 3
#: the earlier (mma.sync) version's C interface and its train rows a split
PARENT_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p]
PARENT_ROWS_PER_SPLIT = 4096
#: mangled-name part of each version's D=128 main-kernel instance (a
#: wgmma parent's is the current one's)
MAIN_KERNEL = {"earlier": "ceiling_partial_kernelILi8E",
               "current": "ceiling_wgmma_kernelILi2E"}
OPCODES = ("HGMMA", "HMMA", "UTMALDG")


def _cuobjdump(flag: str, lib: Path) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, flag, str(lib)], capture_output=True,
                          text=True, timeout=300).stdout


def sass_counts(sass: str) -> Dict[str, int]:
    """How many instructions of `cuobjdump -sass` output have each opcode
    of OPCODES (predicated ones included, any suffix)."""
    ops = Counter(re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", sass))
    return {op: ops[op] for op in OPCODES}


def res_usage(text: str, kernel: str) -> Optional[Tuple[int, int, int]]:
    """(registers, stack bytes, local bytes) of the first function of
    `cuobjdump -res-usage` output whose name contains `kernel`."""
    for name, reg, stack, local in re.findall(
            r"Function (\S+?):?\s+REG:(\d+) STACK:(\d+) SHARED:\d+ "
            r"LOCAL:(\d+)", text):
        if kernel in name:
            return int(reg), int(stack), int(local)
    return None


def ptxas_spills(log: str) -> Dict[str, int]:
    """{function: spill store + load bytes} from an `nvcc -Xptxas -v` log."""
    return {fn: int(st) + int(ld) for fn, st, ld in re.findall(
        r"Function properties for (\S+)\s+\d+ bytes stack frame, (\d+) bytes "
        r"spill stores, (\d+) bytes spill loads", log)}


def load_parent(parent: Path) -> ctypes.CDLL:
    """The earlier library built from `parent`'s sources, bound with this
    checkout's interface if it is a wgmma build (it has
    matmul_ceiling_info), else with its own 9-argument interface."""
    _build.build_all(csrc=parent, names=("matmul_ceiling",))
    lib = ctypes.CDLL(str(_build.build_dir(parent) / "libmatmul_ceiling.so"))
    if wgmma_build(lib):
        return _build.bind(lib, "matmul_ceiling")
    lib.matmul_ceiling_launch.argtypes = PARENT_ARGS
    lib.matmul_ceiling_launch.restype = ctypes.c_int
    return lib


def wgmma_build(lib) -> bool:
    return hasattr(lib, "matmul_ceiling_info")


def parent_call(lib, q: torch.Tensor, t: torch.Tensor
                ) -> Callable[[], torch.Tensor]:
    """A call of the earlier kernel on q and t, out [nq, 1]."""
    if wgmma_build(lib):
        return lambda: mc.launch(q, t, lib)
    (nq, d), nt = q.shape, t.shape[0]
    splits = -(-nt // PARENT_ROWS_PER_SPLIT)

    def run():
        partial = torch.empty((splits, nq), dtype=torch.float32,
                              device=q.device)
        out = torch.empty((nq, 1), dtype=torch.float32, device=q.device)
        err = lib.matmul_ceiling_launch(
            q.data_ptr(), t.data_ptr(), nq, nt, d, PARENT_ROWS_PER_SPLIT,
            partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"earlier matmul_ceiling: CUDA error {err}")
        return out
    return run


def version_lines(kernel: str, build: Path) -> dict:
    """The version's main-kernel resources, spills and SASS counts."""
    lib = build / "libmatmul_ceiling.so"
    log = build / "matmul_ceiling.log"
    usage = res_usage(_cuobjdump("-res-usage", lib), kernel)
    spills = sum(ptxas_spills(log.read_text()).values()) \
        if log.exists() else None
    return {"registers": usage and usage[0], "stack": usage and usage[1],
            "local": usage and usage[2], "spill_bytes": spills,
            **sass_counts(_cuobjdump("-sass", lib))}


def run(parent: Path, reps: int = 20, out=print) -> List[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("ceiling_ab compares CUDA kernels and needs a CUDA "
                           "device")
    dev = torch.device("cuda")
    earlier = load_parent(parent)
    _build.load("matmul_ceiling")
    out(card())
    rows = []
    same_interface = wgmma_build(earlier)
    for name, build, kernel in (
            ("earlier", _build.build_dir(parent),
             MAIN_KERNEL["current" if same_interface else "earlier"]),
            ("current", _build.build_dir(), MAIN_KERNEL["current"])):
        row = {"version": name, **version_lines(kernel, build)}
        rows.append(row)
        out(f"{name} D=128 main kernel: {row['registers']} registers, stack "
            f"{row['stack']} B, local {row['local']} B; library spills "
            f"{row['spill_bytes']} B; SASS " + ", ".join(
                f"{op} {row[op]}" for op in OPCODES))
    rng = np.random.default_rng(SEED)
    q, t = (torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32))
            .to(dev) for n in (NQ, NT))
    calls = {"earlier": parent_call(earlier, q, t),
             "current": lambda: mc.matmul_ceiling(q, t)}
    ref = mc.matmul_ceiling_plain(q, t)
    tol = 2.0 ** -16 * mc.row_abs_sums_plain(q, t)
    outs = {}
    for row in rows:
        fn = calls[row["version"]]
        got = fn().clone()
        again = fn()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        outs[row["version"]] = got
        row.update(within=bool((err <= tol).all()),
                   rerun_equal=torch.equal(got, again),
                   max_err_over_tol=(err / tol).max().item())
    # a wgmma parent computes the same function the same way: bit for bit
    rows[1]["equal_to_earlier"] = (torch.equal(outs["earlier"],
                                               outs["current"])
                                   if same_interface else None)
    p1, n1, n2, p2 = (cuda_ms(calls[v], reps) for v in
                      ("earlier", "current", "current", "earlier"))
    flops = 2.0 * NQ * NT * D
    bound = flops / BF16_PEAK_FLOPS * 1e3
    for row, pair in zip(rows, ((p1, p2), (n1, n2))):
        ms = sum(pair) / 2
        row.update(ms=ms, runs=list(pair), tflops=flops / ms / 1e9,
                   bound_ms=bound, bound_share=bound / ms)
        out(f"{row['version']} {NQ}x{NT}x{D}: {ms:.4f} ms ({pair[0]:.4f}, "
            f"{pair[1]:.4f}), {row['tflops']:.1f} TF/s, "
            f"{row['bound_share']:.1%} of the {bound:.3f} ms bound; within "
            f"2^-16 sum|q.t| {row['within']} (at most "
            f"{row['max_err_over_tol']:.3g} of it), rerun bit-equal "
            f"{row['rerun_equal']}")
    out(f"earlier over current: x{rows[0]['ms'] / rows[1]['ms']:.2f}"
        + ("" if not same_interface else
           f"; outputs bit-equal {rows[1]['equal_to_earlier']}"))
    out(json.dumps({"metric": "ceiling_ab",
                    "device": torch.cuda.get_device_name(0), "card": card(),
                    "rows": rows}))
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory of the earlier matmul_ceiling.cu and "
                         "the headers it includes")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    rows = run(args.parent, args.reps)
    return 0 if all(r["within"] and r["rerun_equal"]
                    and r.get("equal_to_earlier") is not False
                    for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
