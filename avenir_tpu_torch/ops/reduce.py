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

from typing import Optional, Sequence, Tuple

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
    order = _dot_block(num_keys, fc, n)
    if order is None:
        mom = _row_order_sum(keys, x2, num_keys).to(x.device)
    else:
        trip = torch.stack([torch.ones_like(x2), x2, x2 * x2], dim=-1)
        form, block = order
        if form == "inorder":
            mom = torch.cat([_block_order_sum(keys, trip, c0, c1, b)
                             for c0, c1, b in block])
        else:
            onehot = (keys[:, None] == torch.arange(num_keys, device=x.device)
                      [None, :]).to(torch.float32)
            terms = onehot[:, :, None, None] * trip[:, None]  # [n, K, Fc, 3]
            mom = _xla_cpu_row_sum(terms, block)
    mom = mom.permute(1, 0, 2)                                # [Fc, K, 3]
    return mom[0] if flat else mom


def _dot_block(k: int, fc: int, n: int):
    """The order of XLA's CPU dot for the moment einsum of the JAX
    package's `_count_batch_kernel` ("nk,nfm->fkm", a [3 Fc, n] x [n, K]
    product) of n rows, k classes and fc continuous fields: None where it
    sums the rows in order; ("lanes", B) where four running lanes sum
    each block of B rows and the blocks add in order; ("inorder",
    panels) where the class axis splits into panels (first class, last
    class + 1, B) of at most 64 classes, and one running sum adds each
    block of B = 32768 // (the panel's classes) rows in order, the
    blocks in order. Read off the reference on the CPU, one +M/-M pair
    of rows at a time (`tests/nb_moment_probe.py`), at 1-5 fields, 2-256
    classes and up to 2,200,000 rows: rows in order with one field and
    at most three classes; below 8 rows also with one or two fields and
    at most seven classes, at 5 rows from five classes and at 6 rows from
    nine; lanes over blocks of 8192 rows up to four classes, 4096 up to
    eight, 2728 up to twelve and 2048 up to sixteen; panels from 17
    classes (below 4 rows every order gives the same sum)."""
    if fc == 1 and k <= 3:
        return None
    if n < 8 and ((fc <= 2 and k <= 7) or (n == 5 and k >= 5)
                  or (n == 6 and k >= 9)):
        return None
    if k > 16:
        return ("inorder", tuple((c, min(c + 64, k),
                                  32768 // (min(c + 64, k) - c))
                                 for c in range(0, k, 64)))
    return ("lanes",
            8192 if k <= 4 else 4096 if k <= 8 else 2728 if k <= 12 else 2048)


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


def _block_order_sum(keys: torch.Tensor, trip: torch.Tensor, c0: int,
                     c1: int, block: int) -> torch.Tensor:
    """float32 [c1 - c0, Fc, 3] sums by key of trip [n, Fc, 3] for the
    keys c0..c1-1, in the order XLA's CPU dot takes for a panel of
    classes from 17: each block of `block` rows summed by one running sum
    a key in row order, all blocks at once (one elementwise add a row of
    each block: `block` steps, and no two rows of a step share a cell),
    then the blocks' sums added in order. A row adds to its own key's
    cell only (the rows of other keys to a spare cell): XLA's one-hot
    product adds a zero to the others, which leaves a sum from +0 as it
    is."""
    n = trip.shape[0]
    w = c1 - c0
    n_blocks = max(1, -(-n // block))
    pad = n_blocks * block - n
    # zero rows pad the last block: x + 0 is x
    trip = torch.cat([trip, trip.new_zeros((pad,) + trip.shape[1:])])
    cell = torch.where((keys >= c0) & (keys < c1), keys - c0, w)
    cell = torch.cat([cell, cell.new_full((pad,), w)])
    trip = trip.reshape((n_blocks, block) + trip.shape[1:])
    cell = cell.reshape(n_blocks, block)
    acc = trip.new_zeros((n_blocks, w + 1) + trip.shape[2:])
    rows = torch.arange(n_blocks, device=trip.device)
    for j in range(min(block, n)):
        at = (rows, cell[:, j])
        acc[at] = acc[at] + trip[:, j]
    total = acc[0]
    for b in range(1, n_blocks):
        total = total + acc[b]
    return total[:w]
