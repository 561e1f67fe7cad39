"""The bf16 matmul-ceiling kernel: its wrapper, plan, plain versions and launch count.

Ports the last TPU kernel of the repo, `kern` of `bench.py:797`
(`bench_knn_matmul_ceiling`, called at `bench.py:812`): the bf16 product
q . t^T with fp32 accumulation, reduced over the train axis into one row
sum per query, out [nq, 1]. The TPU bench reads it as the ceiling a
distance + top-k kernel of the same shape can reach; the port's bench
(`tools/bench.py`) does the same on the card.

| wrapper          | CUDA source                                 | TPU kernel          |
|------------------|---------------------------------------------|---------------------|
| `matmul_ceiling` | `csrc/matmul_ceiling.cu` (`wgmma_bf16.cuh`) | `bench.py:797 kern` |

Given CPU tensors the wrapper computes the plain version; given CUDA
tensors it launches the kernels (a cast pass to zero-padded bf16 rows,
the wgmma product fed by TMA, the reduce of the partials) or raises —
there is no fallback. Each call on the card adds one to
`matmul_ceiling.launches`.

The plan (`plan`) is the host side of the kernel, in Python so that the
CPU tests reach it: the padded width, the query and train tiles, and the
contiguous ranges of (query tile, train tile) pairs that the blocks walk,
query-tile major. A block writes one partial row sum per query for each
query tile its range meets (a segment); the reduce adds, for each query,
the segments of its tile in block order, which is train order. The C
entry recomputes the plan from the same numbers and refuses a launch
whose `max_segs` differs.
"""

from __future__ import annotations

import ctypes
import functools
from types import MappingProxyType
from typing import Dict, List, Mapping, Tuple

import torch

from avenir_tpu_torch.ops import _build

#: the wrapper's domain: nq and nt multiples of ROWS, D a multiple of 16
#: up to MAX_D
ROWS = 128
MAX_D = 128
#: the kernel's tiles: queries a block tile (two consumer warpgroups of
#: 128 rows), train rows a stage, features a 128-byte swizzled chunk
BM = 256
BN = 128
CHUNK = 64
#: train rows per product in the plain version (never the whole [nq, nt])
PLAIN_CHUNK = 4096


def _check(q: torch.Tensor, t: torch.Tensor) -> None:
    for name, x in (("q", q), ("t", t)):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 \
                or x.dim() != 2:
            raise TypeError(f"{name} must be a 2-D float32 tensor")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if q.device != t.device:
        raise ValueError(f"q on {q.device} but t on {t.device}")
    nq, d = q.shape
    nt, dt = t.shape
    if d != dt:
        raise ValueError(f"q has {d} features, t {dt}")
    if nq == 0 or nq % ROWS or nt == 0 or nt % ROWS:
        raise ValueError(f"q has {nq} rows, t {nt}; the kernel takes positive "
                         f"multiples of {ROWS}")
    if d == 0 or d % 16 or d > MAX_D:
        raise ValueError(f"{d} features; the kernel takes a multiple of 16 "
                         f"up to {MAX_D}")


def padded_width(d: int) -> int:
    """Features of the bf16 copies: d rounded up to whole 64-feature
    chunks, so one 128-byte swizzle serves every D."""
    return -(-d // CHUNK) * CHUNK


def _range_start(b: int, pairs: int, blocks: int) -> int:
    return b * pairs // blocks


@functools.lru_cache(maxsize=64)
def plan(nq: int, nt: int, d: int, sms: int) -> Mapping[str, object]:
    """The launch of an nq x nt x d ceiling on a card of `sms` SMs: one
    block an SM (fewer if there are fewer pairs), each on a contiguous
    range of (query tile, train tile) pairs. Returns the padded width
    `dp`, `q_tiles`, `t_tiles`, `pairs`, `blocks`, each block's pair
    `ranges`, `max_segs` (the most query tiles one range meets), and the
    scratch shapes: `qb` and `tb` (bf16 copies) and `partial` (floats).
    Cached, so that a call does not pay for it in host time, and so
    read-only."""
    q_tiles, t_tiles = -(-nq // BM), nt // BN
    pairs = q_tiles * t_tiles
    blocks = min(sms, pairs)
    ranges = tuple((_range_start(b, pairs, blocks),
                    _range_start(b + 1, pairs, blocks)) for b in range(blocks))
    max_segs = max((p1 - 1) // t_tiles - p0 // t_tiles + 1
                   for p0, p1 in ranges)
    dp = padded_width(d)
    return MappingProxyType({
        "dp": dp, "q_tiles": q_tiles, "t_tiles": t_tiles, "pairs": pairs,
        "blocks": blocks, "ranges": ranges, "max_segs": max_segs,
        "qb": (nq, dp), "tb": (nt, dp), "partial": blocks * max_segs * BM})


def segments(p: Mapping[str, object]
             ) -> List[Tuple[int, int, int, int, int]]:
    """(block, segment, query tile, first train tile, end train tile) of
    every segment, in block order: what each block multiplies and where
    its partial goes (row block * max_segs + segment of `partial`)."""
    t_tiles, out = p["t_tiles"], []
    for b, (p0, p1) in enumerate(p["ranges"]):
        qt0 = p0 // t_tiles
        for qt in range(qt0, (p1 - 1) // t_tiles + 1):
            lo, hi = max(p0, qt * t_tiles), min(p1, (qt + 1) * t_tiles)
            out.append((b, qt - qt0, qt, lo - qt * t_tiles,
                        hi - qt * t_tiles))
    return out


def reduce_order(p: Mapping[str, object], qt: int) -> List[Tuple[int, int]]:
    """(block, segment) of the partials the reduce adds for a query of
    tile qt, in the order it adds them (the reduce kernel's walk)."""
    t_tiles, ranges = p["t_tiles"], p["ranges"]
    lo, hi = qt * t_tiles, (qt + 1) * t_tiles
    return [(b, qt - p0 // t_tiles) for b, (p0, p1) in enumerate(ranges)
            if p0 < hi and p1 > lo]


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 round to nearest even, back in float32 (exact products)."""
    return x.to(torch.bfloat16).to(torch.float32)


def cast_plain(x: torch.Tensor, dp: int) -> torch.Tensor:
    """The cast pass's output: x's rows rounded to bfloat16 (nearest
    even) and zero-padded to dp features."""
    out = torch.zeros((x.shape[0], dp), dtype=torch.bfloat16, device=x.device)
    out[:, :x.shape[1]] = x.to(torch.bfloat16)
    return out


def matmul_ceiling_plain(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """out [nq, 1] = sum_j bf16(q_i) . bf16(t_j), fp32 products of the
    rounded operands summed PLAIN_CHUNK train rows at a time."""
    _check(q, t)
    qb = _round_bf16(q)
    out = torch.zeros((q.shape[0], 1), dtype=torch.float32, device=q.device)
    for start in range(0, t.shape[0], PLAIN_CHUNK):
        tb = _round_bf16(t[start:start + PLAIN_CHUNK])
        out += (qb @ tb.T).sum(1, keepdim=True)
    return out


def row_abs_sums_plain(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[nq, 1] sum_j |bf16(q_i) . bf16(t_j)|: the scale of the fp32
    accumulation error of a row sum, whatever order it is taken in."""
    _check(q, t)
    qb = _round_bf16(q)
    out = torch.zeros((q.shape[0], 1), dtype=torch.float32, device=q.device)
    for start in range(0, t.shape[0], PLAIN_CHUNK):
        tb = _round_bf16(t[start:start + PLAIN_CHUNK])
        out += (qb @ tb.T).abs().sum(1, keepdim=True)
    return out


def matmul_ceiling(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """out [nq, 1] float32: each query's bf16 products with every train
    row, fp32-accumulated and summed. q [nq, D], t [nt, D] float32
    contiguous on one device; nq and nt multiples of 128, D a multiple of
    16 up to MAX_D."""
    if not q.is_cuda:
        return matmul_ceiling_plain(q, t)
    out = launch(q, t, _build.load("matmul_ceiling"))
    matmul_ceiling.launches += 1
    return out


def launch(q: torch.Tensor, t: torch.Tensor, lib) -> torch.Tensor:
    """One launch of `lib`'s matmul_ceiling_launch (this checkout's
    library, or another build with its interface) on CUDA tensors q and t,
    on the plan of `plan`; out [nq, 1]. Raises on a CUDA error."""
    _check(q, t)
    (nq, d), nt = q.shape, t.shape[0]
    with torch.cuda.device(q.device):
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        p = plan(nq, nt, d, sms)
        qb = torch.empty(p["qb"], dtype=torch.bfloat16, device=q.device)
        tb = torch.empty(p["tb"], dtype=torch.bfloat16, device=q.device)
        partial = torch.empty(p["partial"], dtype=torch.float32,
                              device=q.device)
        out = torch.empty((nq, 1), dtype=torch.float32, device=q.device)
        err = lib.matmul_ceiling_launch(
            q.data_ptr(), t.data_ptr(), nq, nt, d, qb.data_ptr(),
            tb.data_ptr(), p["blocks"], p["max_segs"], partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_ceiling launch failed: CUDA error {err}")
    return out


def ceiling_info(d: int) -> Dict[str, int]:
    """The built main-kernel instance for d features (CUDA only):
    registers, local (spilled) bytes, dynamic shared bytes, threads,
    blocks per SM and its tile (bm queries, bn train rows, stages)."""
    vals = (ctypes.c_int * 8)()
    err = _build.load("matmul_ceiling").matmul_ceiling_info(d, vals)
    if err != 0:
        raise RuntimeError(f"matmul_ceiling_info failed: CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "threads",
                     "blocks_per_sm", "bm", "bn", "stages"), vals))


KERNEL_WRAPPERS = (matmul_ceiling,)


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


reset_launches()
