"""Information-theory algebra over count tensors.

The port of `avenir_tpu/ops/infotheory.py`: entropy, Gini index,
population-weighted split impurity and mutual information as vectorized
functions over count tensors, in float32 as the JAX package computes
them (it runs with 64-bit types off). The tables they score are small
(a few hundred cells), so every function runs on the host in numpy,
each step one rounded float32 operation, the sums in XLA's CPU reduce
order (`xla_math.sum_axis`, `xla_math.sum_last2`) and the log XLA's
(`xla_math.log`): the values are the reference's bit for bit on its CPU
build, and a card run and its CPU twin print the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from avenir_tpu_torch.ops import xla_math

_EPS = 1e-12


def _f32(counts) -> np.ndarray:
    """A count table as a float32 host array (a device tensor is read
    back; a float64 table rounds as `jnp.asarray` rounds it)."""
    if isinstance(counts, torch.Tensor):
        counts = counts.detach().cpu().numpy()
    return np.asarray(counts, np.float32)


def _norm(counts: np.ndarray, axis: int = -1) -> np.ndarray:
    tot = xla_math.sum_axis(counts, axis)
    return counts / np.maximum(tot, np.float32(_EPS))


def _entropy(counts: np.ndarray, axis: int) -> np.ndarray:
    p = _norm(counts, axis)
    terms = np.where(p > 0, p * xla_math.log(np.maximum(p, np.float32(_EPS))),
                     np.float32(0.0))
    return -np.squeeze(xla_math.sum_axis(terms, axis), axis)


def _bits_entropy(counts: np.ndarray, axis: int) -> np.ndarray:
    return _entropy(counts, axis) / xla_math.log(np.float32(2.0))


def _gini(counts: np.ndarray, axis: int) -> np.ndarray:
    p = _norm(counts, axis)
    return np.float32(1.0) - np.squeeze(xla_math.sum_axis(p * p, axis), axis)


def _tensor(values: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(values, np.float32))


def entropy(counts, axis: int = -1) -> torch.Tensor:
    """Shannon entropy (nats) of count vectors along `axis`."""
    return _tensor(_entropy(_f32(counts), axis))


def bits_entropy(counts, axis: int = -1) -> torch.Tensor:
    """Entropy in bits (log2), as the reference's InfoContentStat."""
    return _tensor(_bits_entropy(_f32(counts), axis))


def gini(counts, axis: int = -1) -> torch.Tensor:
    """Gini index 1 - sum p^2 of count vectors along `axis`."""
    return _tensor(_gini(_f32(counts), axis))


def weighted_split_score(seg_class_counts, algo: str = "entropy"
                         ) -> torch.Tensor:
    """Population-weighted impurity of a split: seg_class_counts
    [..., S, K] counts a segment a class -> [...], sum_s (n_s / n)
    impurity(segment s), what the tree reducer minimizes over candidate
    splits (tree/DecisionTreeBuilder.java:495-532)."""
    counts = _f32(seg_class_counts)
    score_fn = _bits_entropy if algo in ("entropy", "infoGain") else _gini
    seg_tot = np.squeeze(xla_math.sum_axis(counts, -1), -1)     # [..., S]
    tot = np.maximum(xla_math.sum_axis(seg_tot, -1), np.float32(_EPS))
    imp = score_fn(counts, -1)                                   # [..., S]
    return _tensor(np.squeeze(xla_math.sum_axis(seg_tot / tot * imp, -1),
                              -1))


def mutual_information(joint_counts) -> torch.Tensor:
    """MI (nats) of a joint count table [..., A, B] between its last two
    axes, bit for bit the reference's on its CPU build: the sums run in
    XLA's CPU reduce order (`xla_math.sum_last2`, `xla_math.sum_axis`)
    and the log is XLA's (`xla_math.log`), each other step one rounded
    float32 operation, on the host; so a value on a 6th-decimal
    rounding edge prints as the reference's."""
    joint = _f32(joint_counts)
    f32 = np.float32
    pj = joint / np.maximum(xla_math.sum_last2(joint)[..., None, None],
                            f32(_EPS))
    pa = xla_math.sum_axis(pj, -1)
    pb = xla_math.sum_axis(pj, -2)
    ratio = pj / np.maximum(pa * pb, f32(_EPS))
    terms = np.where(pj > 0,
                     pj * xla_math.log(np.maximum(ratio, f32(_EPS))),
                     f32(0.0))
    return torch.from_numpy(np.asarray(xla_math.sum_last2(terms)))
