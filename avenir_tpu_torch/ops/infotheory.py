"""Information-theory algebra over count tensors.

The port of `avenir_tpu/ops/infotheory.py`: entropy, Gini index,
population-weighted split impurity and mutual information as vectorized
functions over count tensors, in float32 as the JAX package computes
them (it runs with 64-bit types off). The tables they score are small
(a few hundred cells), so the callers run them on the host: a card run
and its CPU twin then print the same bytes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from avenir_tpu_torch.ops import xla_math

_EPS = 1e-12


def _f32(counts) -> torch.Tensor:
    return torch.as_tensor(counts).to(torch.float32)


def _norm(counts: torch.Tensor, axis: int = -1) -> torch.Tensor:
    tot = counts.sum(dim=axis, keepdim=True)
    return counts / torch.clamp(tot, min=_EPS)


def entropy(counts, axis: int = -1) -> torch.Tensor:
    """Shannon entropy (nats) of count vectors along `axis`."""
    p = _norm(_f32(counts), axis)
    terms = torch.where(p > 0, p * torch.log(torch.clamp(p, min=_EPS)),
                        torch.zeros_like(p))
    return -terms.sum(dim=axis)


def bits_entropy(counts, axis: int = -1) -> torch.Tensor:
    """Entropy in bits (log2), as the reference's InfoContentStat."""
    return entropy(counts, axis) / torch.tensor(math.log(2.0),
                                                dtype=torch.float32)


def gini(counts, axis: int = -1) -> torch.Tensor:
    """Gini index 1 - sum p^2 of count vectors along `axis`."""
    p = _norm(_f32(counts), axis)
    return 1.0 - (p * p).sum(dim=axis)


def weighted_split_score(seg_class_counts, algo: str = "entropy"
                         ) -> torch.Tensor:
    """Population-weighted impurity of a split: seg_class_counts
    [..., S, K] counts a segment a class -> [...], sum_s (n_s / n)
    impurity(segment s), what the tree reducer minimizes over candidate
    splits (tree/DecisionTreeBuilder.java:495-532)."""
    counts = _f32(seg_class_counts)
    score_fn = bits_entropy if algo in ("entropy", "infoGain") else gini
    seg_tot = counts.sum(dim=-1)                                 # [..., S]
    tot = torch.clamp(seg_tot.sum(dim=-1, keepdim=True), min=_EPS)
    imp = score_fn(counts, axis=-1)                              # [..., S]
    return (seg_tot / tot * imp).sum(dim=-1)


def mutual_information(joint_counts) -> torch.Tensor:
    """MI (nats) of a joint count table [..., A, B] between its last two
    axes, bit for bit the reference's on its CPU build: the sums run in
    XLA's CPU reduce order (`xla_math.sum_last2`, `xla_math.sum_axis`)
    and the log is XLA's (`xla_math.log`), each other step one rounded
    float32 operation, on the host; so a value on a 6th-decimal
    rounding edge prints as the reference's."""
    joint = _f32(joint_counts).cpu().numpy()
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
