"""Probe the order in which the JAX package's Naive Bayes count kernel sums
its moments on the CPU, and the port's moment bits against it.

    JAX_PLATFORMS=cpu python tests/nb_moment_probe.py [n ...]

`_count_batch_kernel`'s moment einsum is a [3 Fc, n] x [n, K] dot; XLA's
CPU backend sums its n rows in an order that depends on K, Fc and n. The
order is read off the reference one pair of rows at a time: with every
row's value 1 but rows i and j, set to +M and -M (M = 2^48, so a partial
sum holding M absorbs any count of ones), the sum comes out as n less the
size of the smallest subtree of the addition tree that holds both rows.
From these subtree sizes `row_block` tells row order from blocks of four
running lanes and finds the block. For each (classes, continuous fields)
the script prints the reference's block at each n (`order` for rows in
order, `other` for a tree of neither form) beside the port's
`ops.reduce._dot_block`, and the moment cells in which the port's
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


def subtree(n: int, k: int, fc: int, i: int, j: int) -> int:
    """Rows under the smallest subtree of the reference's sum over n rows
    (k classes, fc continuous fields) that holds rows i and j."""
    import jax.numpy as jnp

    from avenir_tpu.models.naive_bayes import _count_batch_kernel

    x = np.ones((n, fc), np.float32)
    x[i, 0], x[j, 0] = M, -M
    mom = _count_batch_kernel(jnp.zeros((n, 1), jnp.int32),
                              jnp.zeros((n,), jnp.int32), jnp.asarray(x),
                              jnp.ones((n,), jnp.float32), k, 3)[1]
    return n - int(np.asarray(mom)[0, 0, 1])


def row_block(n: int, k: int, fc: int) -> Union[None, int, str]:
    """The reference's order at n >= 8 rows: None for the rows in order,
    the block of rows where four running lanes (rows i % 4) sum each
    block and the blocks add in order, "other" for neither."""
    def probe(j: int) -> int:
        return subtree(n, k, fc, 0, j)

    if all(probe(j) == j + 1 for j in (1, 2, 3, 4, 7, n // 2, n - 1)):
        return None
    block = 2 * probe(1)            # rows 0 and 1 meet when two lanes do
    if probe(4) == 2 and probe(2) == block \
            and (2 * block > n or probe(block) == 2 * block):
        return block
    return "other"


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


def _port_block(k: int, fc: int, n: int) -> Optional[int]:
    from avenir_tpu_torch.ops.reduce import _dot_block

    return _dot_block(k, fc, n)


def main(ns) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    print("classes fields rows | reference block | port block | "
          "cells differing / cells")
    for k in (2, 3, 4, 5, 6, 8, 9, 12, 16, 17):
        for fc in (1, 2, 3, 5):
            for n in ns:
                ref = row_block(n, k, fc)
                port = _port_block(k, fc, n)
                diff = differing_cells(n + 3, k, fc)
                print(f"{k:7d} {fc:6d} {n:7d} | "
                      f"{'order' if ref is None else ref!s:>15} | "
                      f"{'order' if port is None else port!s:>10} | "
                      f"{diff} / {k * fc * 3}", flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [20000, 100000])
