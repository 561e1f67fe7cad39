"""Keyed reductions: the Hadoop shuffle, combiner and reducer as one op.

The port of `avenir_tpu/ops/reduce.py`. Every counting job of the
reference (Bayesian distributions, mutual information, contingency
tables) is "emit (key tuple) -> 1 or (1, x, x^2); shuffle; sum"; with
schema-declared cardinalities every key is a dense integer, so the
shuffle is one keyed sum. Here:

- counts are `torch.bincount` in int64 on the keys' device: exact, and
  the same on the CPU and the card whatever order the device adds in;
- the moments of `moment_reduce` are float32, summed in the order of
  XLA's CPU dot for the JAX package's Naive Bayes count einsum
  (`_dot_block`), with elementwise adds only: the same bits on the CPU
  and the card, and no atomics.

Not ported, having no caller in the port: the reference's float
`values` and `weights` options of the counting functions, and `rowmap`
(its per-record `vmap`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def keyed_reduce(keys: torch.Tensor, num_keys: int) -> torch.Tensor:
    """int64 [num_keys] count of each integer key of keys [n]."""
    return torch.bincount(keys.long(), minlength=num_keys)


def combine_codes(codes: Sequence[torch.Tensor],
                  bins: Sequence[int]) -> torch.Tensor:
    """One mixed-radix int64 key of a tuple of dense codes:
    ((c0 * b1) + c1) * b2 + c2 ..., a keyspace of size prod(bins)."""
    assert len(codes) == len(bins) and len(codes) >= 1
    key = codes[0].long()
    for c, b in zip(codes[1:], bins[1:]):
        key = key * b + c.long()
    return key


def one_hot_count(codes: torch.Tensor, num_bins: int) -> torch.Tensor:
    """int64 histogram of codes [n] -> [num_bins], or of each column of
    codes [n, F] -> [F, num_bins]."""
    codes = codes.long()
    if codes.ndim == 1:
        return keyed_reduce(codes, num_bins)
    f = codes.shape[1]
    key = (torch.arange(f, device=codes.device)[None, :] * num_bins
           + codes).reshape(-1)
    return keyed_reduce(key, f * num_bins).reshape(f, num_bins)


def cross_count(row_codes: torch.Tensor, col_codes: torch.Tensor,
                num_rows: int, num_cols: int) -> torch.Tensor:
    """int64 contingency table count[i, j] = #(row_codes == i &
    col_codes == j), [num_rows, num_cols]. The workhorse of Cramér
    correlation and mutual information."""
    key = row_codes.long() * num_cols + col_codes.long()
    return keyed_reduce(key, num_rows * num_cols).reshape(num_rows, num_cols)


def moment_reduce(keys: torch.Tensor, x: torch.Tensor, num_keys: int
                  ) -> torch.Tensor:
    """Per-key (count, sum, sum of squares), the continuous-feature triple
    the reference's mappers emit, (1, x, x^2) a record: float32
    [num_keys, 3] of x [n], or [Fc, num_keys, 3] of x [n, Fc].

    Each cell is summed over every row, zeros in the other keys' rows,
    in the order of XLA's CPU dot for a one-hot [n, num_keys] x
    [n, 3 Fc] product (`_dot_block`): the order of the JAX package's
    Naive Bayes count kernel. Rows in order are summed on the host, one
    float32 add a row (a sequential sum has no parallel form with the
    same bits); blocks on `x`'s device."""
    x = x.to(torch.float32)
    flat = x.ndim == 1
    x2 = x[:, None] if flat else x
    keys = keys.long()
    n, fc = x2.shape
    block = _dot_block(num_keys, fc, n)
    if block is None:
        mom = _row_order_sum(keys, x2, num_keys).to(x.device)
    else:
        trip = torch.stack([torch.ones_like(x2), x2, x2 * x2], dim=-1)
        onehot = (keys[:, None] == torch.arange(num_keys, device=x.device)
                  [None, :]).to(torch.float32)
        terms = onehot[:, :, None, None] * trip[:, None]     # [n, K, Fc, 3]
        mom = _xla_cpu_row_sum(terms, block)
    mom = mom.permute(1, 0, 2)                                # [Fc, K, 3]
    return mom[0] if flat else mom


def _dot_block(k: int, fc: int, n: int) -> Optional[int]:
    """Rows a block of XLA's CPU dot for the moment einsum of the JAX
    package's `_count_batch_kernel` ("nk,nfm->fkm", a [3 Fc, n] x [n, K]
    product) of n rows, k classes and fc continuous fields; None where it
    sums the rows in order. Read off the reference on the CPU, one +M/-M
    pair of rows at a time (`tests/nb_moment_probe.py`), at 1-5 fields,
    2-17 classes and up to 2,200,000 rows: rows in order with one field
    and at most three classes; below 8 rows also with one or two fields
    and at most seven classes, at 5 rows from five classes and at 6 rows
    from nine; else blocks of 8192 rows up to four classes, 4096 up to
    eight, 2728 up to twelve and 2048 up to sixteen (below 4 rows every
    order gives the same sum). From 17 classes XLA sums another tree,
    not followed here: those take 2048-row blocks and differ from the
    reference in some bits (ROADMAP §3.1)."""
    if fc == 1 and k <= 3:
        return None
    if n < 8 and ((fc <= 2 and k <= 7) or (n == 5 and k >= 5)
                  or (n == 6 and k >= 9)):
        return None
    return 8192 if k <= 4 else 4096 if k <= 8 else 2728 if k <= 12 else 2048


def _row_order_sum(keys: torch.Tensor, x: torch.Tensor, k: int
                   ) -> torch.Tensor:
    """float32 [K, Fc, 3] moments of x [n, Fc] by key, each cell the rows
    of its key added in row order from 0 on the host (`np.cumsum` is one
    float32 add a row, in order; the other keys' zero rows leave a
    running sum as it is)."""
    kk = keys.cpu().numpy()
    xx = x.cpu().numpy()
    out = np.zeros((k, xx.shape[1], 3), np.float32)
    for c in range(k):
        v = xx[kk == c]
        if len(v):
            trip = np.stack([np.ones_like(v), v, v * v], axis=-1)
            # + 0: a sum from 0 is +0.0 where the cumsum of -0.0s is not
            out[c] = np.cumsum(trip, axis=0, dtype=np.float32)[-1] \
                + np.float32(0)
    return torch.from_numpy(out)


def _xla_cpu_row_sum(terms: torch.Tensor, block: int) -> torch.Tensor:
    """Sum over the rows of `terms` [n, ...] in float32, in the order
    XLA's CPU dot takes for a long contraction: blocks of `block` rows,
    added in order, each the sum of four running sums over its rows
    i % 4 = 0..3, combined as (s0 + s1) + (s2 + s3); then the last n % 4
    rows, summed in order, added. Only elementwise adds, so the bits are
    the same on the CPU and the card, and no matrix product whose
    precision a setting could change. One add a step over block / 4
    steps (all blocks at once)."""
    n = terms.shape[0]
    rest = terms.shape[1:]
    n_blocks = max(1, -(-n // block))
    last = n - (n_blocks - 1) * block
    main = (n_blocks - 1) * block + last // 4 * 4
    # zero rows pad the lanes of the last block: x + 0 is x
    lanes = torch.zeros((n_blocks * block,) + rest, dtype=terms.dtype,
                        device=terms.device)
    lanes[:main] = terms[:main]
    lanes = lanes.reshape((n_blocks, block // 4, 4) + rest)
    steps = block // 4 if n_blocks > 1 else main // 4
    acc = torch.zeros((n_blocks, 4) + rest, dtype=terms.dtype,
                      device=terms.device)
    for j in range(steps):
        acc = acc + lanes[:, j]
    sums = (acc[:, 0] + acc[:, 1]) + (acc[:, 2] + acc[:, 3])
    tail = torch.zeros(rest, dtype=terms.dtype, device=terms.device)
    for i in range(main, n):
        tail = tail + terms[i]
    total = sums[0]
    for b in range(1, n_blocks):
        total = total + sums[b]
    return total + tail
