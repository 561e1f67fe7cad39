"""The port's copies of XLA's CPU float32 arithmetic, for k-means.

The reference's k-means is a jitted XLA program. Its float32 distances
feed an argmin and its inertia a stop rule, so the port follows the
order and rounding XLA's CPU build takes there, as `ops/reduce.py`
follows NB's moment order and `ops/prng.py` copies threefry:

- `inner_dot`: XLA's CPU dot of [n, d] and [k, d] over their contiguous
  last axis, x @ y.T (its runtime's Eigen contraction): below 4 columns a
  fused multiply-add chain; from 4, four lanes of fused multiply-adds
  over the columns' packets of four, added (l0 + l1) + (l2 + l3), then the
  last d % 4 columns' products added to that as p, p0 + p1, or
  (p0 + p1) + p2;
- `fma`: a float32 fused multiply-add as a float64 product (exact) plus
  the addend, rounded to float32;
- `tree_sum`: a sum over rows by halves (zero rows pad to a power of two).
  XLA sums a long reduction in eight running lanes, one chain of n/8
  steps each, which has no parallel form; this order is not XLA's, so
  k-means' inertia sits within the tolerance the tests state.

All of it is elementwise float32 and float64 arithmetic, correctly
rounded on the CPU and the card, so a card run and its CPU twin give the
same bits, and no matrix product whose precision a setting could change.
"""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding: the float64 product of two
    float32 values is exact, and the float64 sum rounds to float32 as a
    fused multiply-add does but on a double-rounding tie (about one in
    2^29)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def inner_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x [n, d] @ y [k, d].T -> [n, k] in the order of XLA's CPU dot over
    a contiguous depth (module docstring)."""
    n, d = x.shape

    def prod(j):
        return x[:, j, None] * y[None, :, j]

    if d < 4:
        acc = torch.zeros((n, y.shape[0]), dtype=torch.float32,
                          device=x.device)
        for j in range(d):
            acc = fma(x[:, j, None], y[None, :, j], acc)
        return acc
    lanes = [torch.zeros((n, y.shape[0]), dtype=torch.float32,
                         device=x.device) for _ in range(4)]
    for j in range(d // 4 * 4):
        lanes[j % 4] = fma(x[:, j, None], y[None, :, j], lanes[j % 4])
    out = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
    tail = list(range(d // 4 * 4, d))
    if len(tail) == 1:
        out = out + prod(tail[0])
    elif len(tail) >= 2:
        t = prod(tail[0]) + prod(tail[1])
        if len(tail) == 3:
            t = t + prod(tail[2])
        out = out + t
    return out


def tree_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the first axis of t [n, ...] by halves: rows i and
    i + h added, h halving from the power of two at or above n (zero
    rows pad; x + 0 is x). log2(n) elementwise steps."""
    n = t.shape[0]
    if n == 0:
        return torch.zeros(t.shape[1:], dtype=t.dtype, device=t.device)
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        t = torch.cat([t, t.new_zeros((p - n,) + t.shape[1:])])
    while t.shape[0] > 1:
        h = t.shape[0] // 2
        t = t[:h] + t[h:]
    return t[0]
