"""All-pairs mixed-attribute distances + blocked top-k, in plain PyTorch.

The port of `avenir_tpu/ops/distance.py`. This is the route for the
configurations the CUDA top-k kernels do not take (a metric other than
euclidean/manhattan, or a schema with no features), as in the JAX
`models/knn.py`; it is also an independent oracle for the kernels in the
tests. Semantics follow the reference's sifarish SameTypeSimilarity:
range-normalized numeric distance plus categorical mismatch, averaged
over attributes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def pairwise_distance(q_num: Optional[torch.Tensor], t_num: Optional[torch.Tensor],
                      q_cat: Optional[torch.Tensor] = None,
                      t_cat: Optional[torch.Tensor] = None,
                      cat_bins: Optional[Tuple[int, ...]] = None,
                      num_ranges: Optional[torch.Tensor] = None,
                      metric: str = "manhattan") -> torch.Tensor:
    """Dense [nq, nt] attribute-averaged distance block.

    Numeric columns are divided by their range (max - min); 'euclidean'
    is the sqrt of the mean squared per-attribute distance, anything else
    the mean absolute one. A categorical attribute contributes 0 on a
    match and 1 on a mismatch under both metrics."""
    has_num = q_num is not None and q_num.shape[-1] > 0
    ref = q_num if has_num else q_cat
    nq = ref.shape[0]
    nt = (t_num if has_num else t_cat).shape[0]
    d_total = torch.zeros((nq, nt), dtype=torch.float32, device=ref.device)
    w_total = 0.0
    if has_num:
        dn = q_num.shape[-1]
        rng = (num_ranges if num_ranges is not None
               else torch.ones(dn, dtype=torch.float32, device=ref.device))
        scale = 1.0 / torch.clamp(rng, min=1e-9)
        qs = q_num * scale
        ts = t_num * scale
        if metric == "euclidean":
            sq = (qs * qs).sum(1)[:, None] + (ts * ts).sum(1)[None, :]
            d_total = d_total + torch.clamp(sq - 2.0 * (qs @ ts.T), min=0.0)
        else:
            d_total = d_total + (qs[:, None, :] - ts[None, :, :]).abs().sum(-1)
        w_total += dn
    if q_cat is not None and q_cat.shape[-1] > 0:
        dc = q_cat.shape[-1]
        if cat_bins is None or len(cat_bins) != dc:
            raise ValueError("cat_bins must give one cardinality per categorical column")
        matches = torch.zeros((nq, nt), dtype=torch.float32, device=ref.device)
        for f in range(dc):
            matches = matches + (q_cat[:, f][:, None] == t_cat[:, f][None, :]).float()
        d_total = d_total + (dc - matches)
        w_total += dc
    # times the reciprocal of the constant weight total, as XLA compiles
    # the reference's division
    inv = 1.0 / max(w_total, 1e-9)
    if metric == "euclidean":
        return torch.sqrt(d_total * inv)
    return d_total * inv


def pad_train(t_num: Optional[np.ndarray], t_cat: Optional[np.ndarray],
              block: int) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], int]:
    """Pad train arrays up to a multiple of `block` rows with zeros.

    Returns (t_num, t_cat, n_valid); rows at index >= n_valid are masked
    by the top-k routines, so the pad values themselves are inert."""
    n = t_num.shape[0] if t_num is not None else t_cat.shape[0]
    rem = (-n) % block
    if rem:
        if t_num is not None:
            t_num = np.concatenate(
                [t_num, np.zeros((rem, t_num.shape[1]), t_num.dtype)])
        if t_cat is not None:
            t_cat = np.concatenate(
                [t_cat, np.zeros((rem, t_cat.shape[1]), t_cat.dtype)])
    return t_num, t_cat, n


def blocked_topk_neighbors(q_num, t_num, q_cat=None, t_cat=None,
                           cat_bins=None, num_ranges=None, k: int = 8,
                           block: int = 32768, metric: str = "manhattan",
                           n_valid: Optional[int] = None,
                           approx: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist [nq, k] ascending, index [nq, k]) of the k nearest train rows,
    scanning the train set `block` rows at a time so no [nq, nt] matrix is
    built. Ties go to the lower train index. Rows at index >= n_valid are
    padding and never enter; unfillable slots are (+inf, -1)."""
    if approx:
        raise NotImplementedError(
            "approx=True (approximate top-k) is not ported yet")
    nt = t_num.shape[0] if t_num is not None else t_cat.shape[0]
    if nt % block:
        raise ValueError("pad train rows to a multiple of block (pad_train)")
    if k > block:
        raise ValueError(f"k ({k}) must be <= block ({block})")
    ref = q_num if q_num is not None else q_cat
    nq, dev = ref.shape[0], ref.device
    nv = nt if n_valid is None else n_valid
    best_d = torch.full((nq, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, nt, block):
        sl = slice(start, start + block)
        d = pairwise_distance(
            q_num, t_num[sl] if t_num is not None else None,
            q_cat, t_cat[sl] if t_cat is not None else None,
            cat_bins, num_ranges, metric)
        idx = torch.arange(start, start + block, dtype=torch.int32, device=dev)
        d = torch.where(idx[None, :] < nv, d, float("inf"))
        all_d = torch.cat([best_d, d], 1)
        all_i = torch.cat([best_i, idx.expand(nq, -1)], 1)
        order = torch.sort(all_d, dim=1, stable=True).indices[:, :k]
        best_d = all_d.gather(1, order)
        best_i = all_i.gather(1, order)
    best_i = torch.where(torch.isinf(best_d), -1, best_i)
    return best_d, best_i
