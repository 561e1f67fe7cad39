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

`subseq_support_fold(acc, rows, cands, k_vec, n_codes)` adds the counts
into the int32 accumulator `acc` [C] in place (the reference's donated
fold carry). `n_codes` is the code range, 1 + the largest code in
`cands` (or more), which the caller knows on the host; it sizes the
kernel's tables and picks its route, so the wrapper reads nothing back
from the card. Given CUDA tensors it launches `csrc/subseq_support.cu`
and counts the launch in its `launches` attribute: on the mask route
(T <= 64 and tables of `n_codes` codes that fit shared memory) a table
of each row's token positions and k lookups a (row, candidate); else the
walk route, a register pointer a thread and candidate over rows staged
in shared memory (`route` says which a shape takes). Both end with one
integer atomicAdd a thread. Given CPU tensors it runs
`subseq_support_plain`, after checking that no code reaches `n_codes`;
on the card a code the test reads at or above it traps. There is no
fallback: a kernel that does not build or launch raises.

The work each route makes on the data, for the kernel's bounds:
`lookup_steps` (the mask route's lookups) and `walk_steps` (the walk
route's compares).

`subseq_support_plain` is the reference's T-step loop in torch ops: the
rows ordered by their length (1 + the index of their last non-negative
token), so that step s touches only the rows that still have a token
there, and the candidate axis cut into tiles of at most PLAIN_CELLS
(row, candidate) cells. Both change no count: a count is a sum over rows,
one candidate at a time.
"""

from __future__ import annotations

import operator

import torch

from avenir_tpu_torch.ops import _build

#: (row, candidate) cells one tile of the plain version holds at most
PLAIN_CELLS = 1 << 26
#: the largest code range a call may name
MAX_CODES = 1 << 24
#: the kernel's routes by the number subseq_support_route returns
ROUTES = ("walk", "mask32", "mask64")


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
    """The (token, candidate) compares the walk route makes on these
    inputs (the route of every call before the mask route, and its
    second route now): a walk reads its row's tokens up to the row's
    last one and stops at k or at a negative code; a candidate of length
    0 walks nowhere. The work this call's data needs on that route, for
    its bound."""
    return _walk(rows, cands, k_vec, max_cells, True)[1]


def lookup_steps(rows: torch.Tensor, cands: torch.Tensor,
                 k_vec: torch.Tensor) -> int:
    """The table lookups the mask route makes on these inputs: k a (row,
    live candidate) pair, every row of the call, with no early stop. A
    candidate is live when 1 <= k <= T and none of the codes its k steps
    read (code min(j, K - 1) at step j) is negative; the others make
    none. The work this call's data needs on that route, for its bound."""
    _check(rows, cands, k_vec)
    n, t = rows.shape
    kmax = cands.shape[1]
    if n == 0 or t == 0 or kmax == 0:
        return 0
    kv = k_vec.to(torch.int64)
    steps = torch.arange(t, device=rows.device)
    read = cands[:, steps.clamp(max=kmax - 1)]
    dead = ((read < 0) & (steps[None, :] < kv[:, None])).any(dim=1)
    live = (kv >= 1) & (kv <= t) & ~dead
    return n * int(kv[live].sum())


def _check_codes(cands: torch.Tensor, n_codes) -> int:
    """n_codes as an int in [0, MAX_CODES]; for CPU tensors, also above
    every code of cands."""
    try:
        n_codes = operator.index(n_codes)
    except TypeError:
        raise TypeError(f"n_codes must be an integer, not "
                        f"{type(n_codes).__name__}") from None
    if not 0 <= n_codes <= MAX_CODES:
        raise ValueError(f"n_codes must lie in [0, {MAX_CODES}], not "
                         f"{n_codes}")
    if not cands.is_cuda and cands.numel() \
            and int(cands.max()) >= n_codes:
        raise ValueError(f"n_codes {n_codes} is not above the largest code "
                         f"{int(cands.max())}")
    return n_codes


def route(t: int, kmax: int, n_codes: int) -> str:
    """The kernel's route for rows of width t, kmax codes a candidate and
    the code range n_codes: "walk", "mask32" or "mask64"."""
    return ROUTES[_build.load("subseq_support").subseq_support_route(
        t, kmax, n_codes)]


def subseq_support_info() -> dict:
    """{kernel: (registers, local bytes) a thread}: the walk route's
    staged and global forms, the mask route's uint32 and uint64 forms."""
    import ctypes

    lib = _build.load("subseq_support")
    info = {}
    for which, name in enumerate(("walk", "walk_global", "mask32",
                                  "mask64")):
        out = (ctypes.c_int * 2)()
        err = lib.subseq_support_info(which, out)
        if err:
            raise RuntimeError(f"subseq_support_info failed: CUDA error {err}")
        info[name] = (int(out[0]), int(out[1]))
    return info


def subseq_support_fold(acc: torch.Tensor, rows: torch.Tensor,
                        cands: torch.Tensor, k_vec: torch.Tensor,
                        n_codes: int) -> torch.Tensor:
    """acc += the support counts of `cands` over `rows`, in place; returns
    acc. `n_codes`: 1 + the largest code of `cands`, or more. One launch
    of csrc/subseq_support.cu for CUDA tensors (counted in `launches`),
    the plain version for CPU tensors."""
    _check(rows, cands, k_vec)
    n_codes = _check_codes(cands, n_codes)
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
            k_vec.data_ptr(), n_codes, acc.data_ptr(),
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
