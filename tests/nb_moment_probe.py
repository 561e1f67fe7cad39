"""Probe the order in which the JAX package's Naive Bayes count kernel sums
its moments on the CPU, and the port's moment bits against it.

    JAX_PLATFORMS=cpu python tests/nb_moment_probe.py [n ...]
        [--classes 17,20,...] [--fields 1,2,...]

`_count_batch_kernel`'s moment einsum is a [3 Fc, n] x [n, K] dot; XLA's
CPU backend sums its n rows in an order that depends on K, Fc and n. The
order is read off the reference one pair of rows at a time: with every
row's value 1 but rows i and j, set to +M and -M (M = 2^48, so a partial
sum holding M absorbs any count of ones), the sum comes out as n less the
size of the smallest subtree of the addition tree that holds both rows.
From these subtree sizes `row_block` tells row order from blocks summed
by four running lanes and from blocks summed in row order, and finds the
block. For each (classes, continuous fields) the script prints the
reference's order at each n (`order` for rows in order, `lanes B` and
`inorder B` for the two block forms, `other` for a tree of no such form)
beside the port's `ops.reduce._dot_block`, at the first, a middle and the last class of
each panel of 64 classes (XLA's dot sums each such panel of the class
axis in an order of its own), and the moment cells in which the port's
`_count_batch` differs from the reference's on seeded uniform rows.
`tests/test_torch_naive_bayes.py` runs the same probes on a few shapes.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Union

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

M = np.float32(2.0 ** 48)


def subtree(n: int, k: int, fc: int, i: int, j: int, cls: int = 0) -> int:
    """Rows under the smallest subtree of the reference's sum over n rows
    (k classes, fc continuous fields, every row of class `cls`) that
    holds rows i and j."""
    import jax.numpy as jnp

    from avenir_tpu.models.naive_bayes import _count_batch_kernel

    x = np.ones((n, fc), np.float32)
    x[i, 0], x[j, 0] = M, -M
    mom = _count_batch_kernel(jnp.zeros((n, 1), jnp.int32),
                              jnp.full((n,), cls, jnp.int32), jnp.asarray(x),
                              jnp.ones((n,), jnp.float32), k, 3)[1]
    return n - int(np.asarray(mom)[0, cls, 1])


def row_block(n: int, k: int, fc: int, cls: int = 0
              ) -> Union[None, tuple, str]:
    """The reference's order of class `cls`'s moment cells at n >= 8
    rows: None for the rows in order; ("lanes", B) where four running
    lanes (rows i % 4) sum each block of B rows and the blocks add in
    order; ("inorder", B) where one running sum adds each block's rows
    in order and the blocks add in order; "other" for neither."""
    def probe(j: int) -> int:
        return subtree(n, k, fc, 0, j, cls)

    if all(probe(j) == j + 1 for j in (1, 2, 3, 4, 7, n // 2, n - 2, n - 1)):
        return None
    if all(probe(j) == j + 1 for j in (1, 2, 3, 4, 7)):
        # rows in order at first. The first power of two j past the first
        # block lies in the second (j < 2 B), so the rows in (j / 2, j]
        # meet row 0 under j + 1 rows up to the block's end, and under
        # more past it: a binary search finds the block
        j = 8
        while j < n and probe(j) == j + 1:
            j *= 2
        lo, hi = j // 2, min(j, n - 1)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if probe(mid) == mid + 1:
                lo = mid
            else:
                hi = mid
        block = hi
        if probe(block - 1) == block and probe(block) == min(2 * block, n) \
                and (2 * block >= n
                     or probe(2 * block) == min(3 * block, n)):
            return ("inorder", block)
        return "other"
    block = 2 * probe(1)            # rows 0 and 1 meet when two lanes do
    if probe(4) == 2 and probe(2) == block \
            and (2 * block > n or probe(block) == 2 * block):
        return ("lanes", block)
    return "other"


def order_holds(n: int, k: int, fc: int, order, cls: int = 0) -> bool:
    """Whether the reference's subtrees at a few rows are those of
    `order` (in `row_block`'s terms): a check of a known order at a
    handful of probes, where `row_block` searches for one."""
    def probe(j: int) -> int:
        return subtree(n, k, fc, 0, j, cls)

    if order is None:
        return all(probe(j) == j + 1 for j in (1, 7, n // 2, n - 2, n - 1))
    form, block = order
    if form == "lanes":
        return probe(1) == block // 2 and probe(4) == 2 \
            and probe(2) == block \
            and (2 * block > n or probe(block) == 2 * block)
    return probe(1) == 2 and probe(block - 1) == block \
        and probe(block) == min(2 * block, n) \
        and (2 * block >= n or probe(2 * block) == min(3 * block, n)) \
        and probe(n - 1) == n


def class_orders(n: int, k: int, fc: int, classes) -> list:
    """[(first class, last class + 1, order)]: `row_block` of each of
    `classes` in turn, runs of one order merged."""
    return _runs(classes, lambda c: row_block(n, k, fc, c))


def _runs(classes, order_of) -> list:
    runs: list = []
    for c in classes:
        order = order_of(c)
        if runs and runs[-1][2] == order:
            runs[-1] = (runs[-1][0], c + 1, order)
        else:
            runs.append((c, c + 1, order))
    return runs


def port_order(k: int, fc: int, n: int, cls: int = 0):
    """The port's order of class `cls`'s cells (`ops.reduce._dot_block`)
    in `row_block`'s terms: a block of the rows in order that holds
    every row is the rows in order."""
    from avenir_tpu_torch.ops.reduce import _dot_block

    order = _dot_block(k, fc, n)
    if order is None or order[0] == "lanes":
        return order
    block = next(b for c0, c1, b in order[1] if c0 <= cls < c1)
    return None if block >= n else ("inorder", block)


def in_row_order(n: int, k: int, fc: int) -> bool:
    """Whether the reference sums all n rows in order (every pair)."""
    return all(subtree(n, k, fc, i, j) == j + 1
               for i in range(n) for j in range(i + 1, n))


def differing_cells(n: int, k: int, fc: int, seed: int = 0) -> int:
    """Moment cells whose bits differ between the port's `_count_batch`
    and the reference's kernel, on seeded rows uniform in [0, 120)."""
    import jax.numpy as jnp
    import torch

    from avenir_tpu.models.naive_bayes import _count_batch_kernel
    from avenir_tpu_torch.models.naive_bayes import _count_batch

    rng = np.random.default_rng(seed + 1000 * k + 10 * fc + n)
    x = (rng.random((n, fc)) * 120).astype(np.float32)
    y = rng.integers(0, k, n).astype(np.int32)
    codes = np.zeros((n, 1), np.int32)
    ref = _count_batch_kernel(jnp.asarray(codes), jnp.asarray(y),
                              jnp.asarray(x), jnp.ones((n,), jnp.float32),
                              k, 3)[1]
    got = _count_batch(codes, y, x, k, 3, torch.device("cpu"))[1]
    return int((got.numpy() != np.asarray(ref)).sum())


def _text(order) -> str:
    return ("order" if order is None else order if isinstance(order, str)
            else f"{order[0]} {order[1]}")


def main(ns, classes, fields) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    print("classes fields rows | reference order | port order | "
          "cells differing / cells")
    for k in classes:
        for fc in fields:
            for n in ns:
                # the first, a middle and the last class of each panel
                # of 64 classes (every class of a panel sums in one order)
                probed = sorted({c for p in range(0, k, 64)
                                 for c in (p, min(p + 31, k - 1),
                                           min(p + 63, k - 1))})
                ref = [(c0, c1, _text(o)) for c0, c1, o in
                       class_orders(n, k, fc, probed)]
                port = [(c0, c1, _text(o)) for c0, c1, o in
                        _runs(probed, lambda c: port_order(k, fc, n, c))]
                diff = differing_cells(n + 3, k, fc)
                print(f"{k:7d} {fc:6d} {n:7d} | {ref} | {port} | "
                      f"{diff} / {k * fc * 3}", flush=True)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("rows", nargs="*", type=int, default=[20000, 100000])
    ap.add_argument("--classes", default="2,3,4,5,6,8,9,12,16,17,20,24,32,"
                    "33,48,64,65,80,100,128,200,256")
    ap.add_argument("--fields", default="1,2,3,5")
    args = ap.parse_args()
    main(args.rows, [int(v) for v in args.classes.split(",")],
         [int(v) for v in args.fields.split(",")])
