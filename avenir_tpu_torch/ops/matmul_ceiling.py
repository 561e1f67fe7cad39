"""The bf16 matmul-ceiling kernel: its wrapper, plain version and launch count.

Ports the last TPU kernel of the repo, `kern` of `bench.py:797`
(`bench_knn_matmul_ceiling`, called at `bench.py:812`): the bf16 product
q . t^T with fp32 accumulation, reduced over the train axis into one row
sum per query, out [nq, 1]. The TPU bench reads it as the ceiling a
distance + top-k kernel of the same shape can reach; the port's bench
(`tools/bench.py`) does the same on the card.

| wrapper          | CUDA source                | TPU kernel          |
|------------------|----------------------------|---------------------|
| `matmul_ceiling` | `csrc/matmul_ceiling.cu`   | `bench.py:797 kern` |

Given CPU tensors the wrapper computes the plain version; given CUDA
tensors it launches the tensor-core kernel (mma.sync bf16) or raises —
there is no fallback. Each launch adds one to `matmul_ceiling.launches`.
"""

from __future__ import annotations

import torch

from avenir_tpu_torch.ops import _build

#: the kernel's output tile: queries per block and train rows per tile
BM = BN = 128
#: train rows per split: each block reduces one such slice (the TPU's bt)
ROWS_PER_SPLIT = 4096
#: most features: a warp keeps its 32 query rows' bf16 fragments of all D
#: features in registers (the kernel's template KS = D / 16 <= 8)
MAX_D = 128
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
    if nq == 0 or nq % BM or nt == 0 or nt % BN:
        raise ValueError(f"q has {nq} rows, t {nt}; the kernel takes positive "
                         f"multiples of {BM}")
    if d == 0 or d % 16 or d > MAX_D:
        raise ValueError(f"{d} features; the kernel takes a multiple of 16 "
                         f"up to {MAX_D}")


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 round to nearest even, back in float32 (exact products)."""
    return x.to(torch.bfloat16).to(torch.float32)


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
    _check(q, t)
    nq, nt = q.shape[0], t.shape[0]
    splits = -(-nt // ROWS_PER_SPLIT)
    with torch.cuda.device(q.device):
        partial = torch.empty((splits, nq), dtype=torch.float32,
                              device=q.device)
        out = torch.empty((nq, 1), dtype=torch.float32, device=q.device)
        err = _build.load("matmul_ceiling").matmul_ceiling_launch(
            q.data_ptr(), t.data_ptr(), nq, nt, q.shape[1], ROWS_PER_SPLIT,
            partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_ceiling launch failed: CUDA error {err}")
    matmul_ceiling.launches += 1
    return out


KERNEL_WRAPPERS = (matmul_ceiling,)


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


reset_launches()
