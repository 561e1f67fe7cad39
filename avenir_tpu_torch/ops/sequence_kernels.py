"""The GSP subsequence support count: its CUDA kernel's wrapper, its plain
version, its launch count.

The port of the XLA programs `_subseq_support_kernel` and
`_subseq_fold_kernel` of `avenir_tpu/models/sequence.py:84-122`, which
count, for every candidate sequence, the rows holding it as an
order-preserving (not necessarily contiguous) subsequence:

- rows int32 [N, T], pad -1 (a negative token matches nothing);
- cands int32 [C, K], pad -2 (a negative code matches nothing);
- k_vec int32 [C], each candidate's length; a candidate of length 0 or
  less counts nowhere.

A pointer a (row, candidate) walks the row's tokens and advances on the
candidate's next code, leftmost first; the row supports the candidate
when the pointer reaches its length. Counts are int32 and exact.

`subseq_support_fold(acc, rows, cands, k_vec)` adds the counts into the
int32 accumulator `acc` [C] in place (the reference's donated fold
carry). Given CUDA tensors it launches `csrc/subseq_support.cu` (a
register pointer a thread and candidate, rows staged in shared memory,
one integer atomicAdd a thread) and counts the launch in its `launches`
attribute; given CPU tensors it runs `subseq_support_plain`. There is no
fallback: a kernel that does not build or launch raises.

`subseq_support_plain` is the reference's T-step loop in torch ops: the
rows ordered by their length (1 + the index of their last non-negative
token), so that step s touches only the rows that still have a token
there, and the candidate axis cut into tiles of at most PLAIN_CELLS
(row, candidate) cells. Both change no count: a count is a sum over rows,
one candidate at a time.
"""

from __future__ import annotations

import torch

from avenir_tpu_torch.ops import _build

#: (row, candidate) cells one tile of the plain version holds at most
PLAIN_CELLS = 1 << 26


def _check(rows: torch.Tensor, cands: torch.Tensor, k_vec: torch.Tensor
           ) -> None:
    if rows.dim() != 2 or cands.dim() != 2 or k_vec.dim() != 1:
        raise ValueError("rows [N, T], cands [C, K] and k_vec [C] expected")
    if cands.shape[0] != k_vec.shape[0]:
        raise ValueError(f"{cands.shape[0]} candidates but "
                         f"{k_vec.shape[0]} lengths")
    for name, x in (("rows", rows), ("cands", cands), ("k_vec", k_vec)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, not {x.dtype}")
    if not (rows.device == cands.device == k_vec.device):
        raise ValueError("rows, cands and k_vec must share a device")


def row_lengths(rows: torch.Tensor) -> torch.Tensor:
    """int64 [N]: 1 + the index of each row's last non-negative token (0
    for a row of pads); the tokens past it can match nothing."""
    pos = torch.arange(1, rows.shape[1] + 1, device=rows.device)
    return ((rows >= 0) * pos).amax(dim=1) if rows.shape[1] else \
        torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)


def _walk(rows: torch.Tensor, cands: torch.Tensor, k_vec: torch.Tensor,
          max_cells: int, count_steps: bool):
    """(counts int32 [C], compares): the reference's scan in torch ops;
    with count_steps, the compares are the (token, candidate) compares
    the kernel's walks make on these inputs, else 0."""
    _check(rows, cands, k_vec)
    n = rows.shape[0]
    c, kmax = cands.shape
    out = torch.zeros(c, dtype=torch.int32, device=rows.device)
    compares = torch.zeros((), dtype=torch.int64, device=rows.device)
    if n == 0 or c == 0 or kmax == 0:
        return out, 0
    lengths = row_lengths(rows)
    order = torch.argsort(lengths, descending=True, stable=True)
    # a negative token never equals a negative code: -1 against -2
    tok = torch.where(rows >= 0, rows, -1)[order].to(torch.int64)
    # live[s]: the rows still holding a token at step s, a prefix of tok
    asc = lengths.sort().values
    steps = torch.arange(int(asc[-1]), device=rows.device)
    live = (n - torch.searchsorted(asc, steps, right=True)).tolist()
    codes = torch.where(cands >= 0, cands, -2).to(torch.int64)
    tile = max(1, max_cells // n)
    for c0 in range(0, c, tile):
        cc = codes[c0:c0 + tile]
        kv = k_vec[c0:c0 + tile].to(torch.int64)
        ptr = torch.zeros((cc.shape[0], n), dtype=torch.int64,
                          device=rows.device)
        for s, m in enumerate(live):
            p = ptr[:, :m]
            expect = cc.gather(1, p.clamp(max=kmax - 1))
            if count_steps:
                # a walk compares while short of k and its code is a token
                compares += ((p < kv[:, None]) & (expect >= 0)).sum()
            p += expect == tok[None, :m, s]
        out[c0:c0 + tile] = ((ptr >= kv[:, None]) & (kv > 0)[:, None]).sum(
            dim=1, dtype=torch.int32)
    return out, int(compares)


def subseq_support_plain(rows: torch.Tensor, cands: torch.Tensor,
                         k_vec: torch.Tensor,
                         max_cells: int = PLAIN_CELLS) -> torch.Tensor:
    """counts int32 [C] of the reference's scan, in torch ops on the
    tensors' device."""
    return _walk(rows, cands, k_vec, max_cells, False)[0]


def walk_steps(rows: torch.Tensor, cands: torch.Tensor,
               k_vec: torch.Tensor, max_cells: int = PLAIN_CELLS) -> int:
    """The (token, candidate) compares the kernel makes on these inputs:
    a walk reads its row's tokens up to the row's last one and stops at
    k or at a negative code; a candidate of length 0 walks nowhere. The
    work this call's data needs, for the kernel's bound."""
    return _walk(rows, cands, k_vec, max_cells, True)[1]


def subseq_support_info():
    """(registers, local bytes) a thread of the staged kernel."""
    import ctypes

    out = (ctypes.c_int * 2)()
    err = _build.load("subseq_support").subseq_support_info(out)
    if err:
        raise RuntimeError(f"subseq_support_info failed: CUDA error {err}")
    return int(out[0]), int(out[1])


def subseq_support_fold(acc: torch.Tensor, rows: torch.Tensor,
                        cands: torch.Tensor, k_vec: torch.Tensor
                        ) -> torch.Tensor:
    """acc += the support counts of `cands` over `rows`, in place; returns
    acc. One launch of csrc/subseq_support.cu for CUDA tensors (counted
    in `launches`), the plain version for CPU tensors."""
    _check(rows, cands, k_vec)
    if acc.dtype != torch.int32 or acc.shape != k_vec.shape \
            or acc.device != rows.device:
        raise ValueError("acc must be int32 [C] on the rows' device")
    if not rows.is_cuda:
        return acc.add_(subseq_support_plain(rows, cands, k_vec))
    if not acc.is_contiguous():
        raise ValueError("acc must be contiguous")
    rows, cands, k_vec = (x.contiguous() for x in (rows, cands, k_vec))
    (n, t), (c, kmax) = rows.shape, cands.shape
    with torch.cuda.device(rows.device):
        lib = _build.load("subseq_support")
        err = lib.subseq_support_launch(
            rows.data_ptr(), n, t, cands.data_ptr(), c, kmax,
            k_vec.data_ptr(), acc.data_ptr(),
            torch.cuda.current_stream(rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"subseq_support launch failed: CUDA error {err}")
    subseq_support_fold.launches += 1
    return acc


#: every wrapper that counts launches
KERNEL_WRAPPERS = (subseq_support_fold,)


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


reset_launches()
