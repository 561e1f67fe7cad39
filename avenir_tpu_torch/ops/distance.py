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

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch


def _column_sum(cols) -> torch.Tensor:
    """Sum of the columns of a 2-D tensor (or of the tensors an iterable
    yields) from the first to the last, the order XLA's CPU reduction
    takes. torch's own `sum` splits the terms among accumulators; the
    same elementwise adds give the same bits on the CPU and the card."""
    if isinstance(cols, torch.Tensor):
        cols = cols.unbind(1)
    total = None
    for col in cols:
        total = col if total is None else total + col
    return total


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA's and the card's
    are (torch's CPU kernel is off by an ulp on about 0.5% of inputs): a
    float64 root rounded to float32 is correctly rounded."""
    return torch.sqrt(x.double()).float()


def pairwise_distance(q_num: Optional[torch.Tensor], t_num: Optional[torch.Tensor],
                      q_cat: Optional[torch.Tensor] = None,
                      t_cat: Optional[torch.Tensor] = None,
                      cat_bins: Optional[Tuple[int, ...]] = None,
                      num_ranges: Optional[torch.Tensor] = None,
                      metric: str = "manhattan",
                      num_weights: Optional[torch.Tensor] = None,
                      cat_weights: Optional[Sequence[float]] = None,
                      divide: bool = False,
                      cross: Optional[Callable] = None) -> torch.Tensor:
    """Dense [nq, nt] weight-averaged distance block.

    Numeric columns are divided by their range (max - min); 'euclidean'
    is the sqrt of the weighted mean squared per-attribute distance,
    anything else the weighted mean absolute one. A categorical attribute
    contributes 0 on a match and 1 on a mismatch under both metrics.
    num_weights (float32 [Dn]) and cat_weights ([Dc]) weight the
    attributes (chombo InterRecordDistance's distance-schema weights),
    1 each by default; the total is sum(num_weights) + sum(cat_weights).

    divide=True divides by the total, as the reference's eager call
    (RecordSimilarity) does; by default the block is multiplied by the
    total's fp32 reciprocal, as XLA compiles the reference's jitted call
    (the KNN route), where the total is a constant. The two differ in
    the last bit on about a fifth of the pairs.

    cross(a, b) gives the euclidean cross term a @ b.T; by default the
    matrix product, whose order differs between the CPU and the card.
    `ops/xla_math.inner_dot` gives the same bits on both."""
    has_num = q_num is not None and q_num.shape[-1] > 0
    ref = q_num if has_num else q_cat
    dev = ref.device
    nq = ref.shape[0]
    nt = (t_num if has_num else t_cat).shape[0]
    d_total = torch.zeros((nq, nt), dtype=torch.float32, device=dev)
    w_total = torch.zeros((), dtype=torch.float32, device=dev)
    if has_num:
        dn = q_num.shape[-1]
        rng = (num_ranges if num_ranges is not None
               else torch.ones(dn, dtype=torch.float32, device=dev))
        w = (num_weights if num_weights is not None
             else torch.ones(dn, dtype=torch.float32, device=dev))
        # the weight folds into the feature scale: w|q-t| for L1, and a
        # sqrt(w) factor for w(q-t)^2
        scale = ((_sqrt(w) if metric == "euclidean" else w)
                 / torch.clamp(rng, min=1e-9))
        qs = q_num * scale
        ts = t_num * scale
        if metric == "euclidean":
            sq = (_column_sum(qs * qs)[:, None]
                  + _column_sum(ts * ts)[None, :])
            qt = qs @ ts.T if cross is None else cross(qs, ts)
            d_total = d_total + torch.clamp(sq - 2.0 * qt, min=0.0)
        else:
            d_total = d_total + _column_sum(
                (qs[:, c, None] - ts[None, :, c]).abs() for c in range(dn))
        w_total = w_total + w.sum()
    if q_cat is not None and q_cat.shape[-1] > 0:
        dc = q_cat.shape[-1]
        if cat_bins is None or len(cat_bins) != dc:
            raise ValueError("cat_bins must give one cardinality per categorical column")
        cw = tuple(cat_weights) if cat_weights is not None else (1.0,) * dc
        # weighted mismatch = sum_f w_f - sum_f w_f [q_f == t_f], summed
        # feature by feature in float32
        matches = torch.zeros((nq, nt), dtype=torch.float32, device=dev)
        for f in range(dc):
            eq = (q_cat[:, f][:, None] == t_cat[:, f][None, :]).float()
            matches = matches + cw[f] * eq
        d_total = d_total + (sum(cw) - matches)
        w_total = w_total + sum(cw)
    w_total = torch.clamp(w_total, min=1e-9)
    if divide:
        d_total = d_total / w_total
    else:
        # with no weights given the total is the attribute count: known on
        # the host, no device read
        n_attrs = ((q_num.shape[-1] if has_num else 0)
                   + (q_cat.shape[-1] if q_cat is not None else 0))
        plain = num_weights is None and cat_weights is None
        d_total = d_total * (1.0 / (max(n_attrs, 1e-9) if plain
                                    else float(w_total)))
    return _sqrt(d_total) if metric == "euclidean" else d_total


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


def _block_topk(d: torch.Tensor, idx: torch.Tensor, k: int, metric: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest of distances d [nq, m] with their indices idx (the
    reference's `lax.top_k(-d, k)`): ascending, ties to the earlier
    column. A NaN distance goes where that call puts it. `top_k` orders
    by XLA's total order, in which a NaN with the sign bit lies below
    -inf and one without it above +inf, so the sign of -d's NaN decides.
    Under manhattan XLA folds the negation into the divide by the
    constant weight total (d_total * -(1/w)), which leaves the NaN
    positive: it is taken first. Under euclidean the negation of the
    square root flips the sign: a NaN is taken last, after +inf."""
    key = torch.where(d.isnan(), float("-inf"), d) if metric != "euclidean" else d
    order = torch.sort(key, dim=1, stable=True).indices[:, :k]
    return d.gather(1, order), idx.gather(1, order)


def blocked_topk_neighbors(q_num, t_num, q_cat=None, t_cat=None,
                           cat_bins=None, num_ranges=None, k: int = 8,
                           block: int = 32768, metric: str = "manhattan",
                           n_valid: Optional[int] = None,
                           approx: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist [nq, k] ascending, index [nq, k]) of the k nearest train rows,
    scanning the train set `block` rows at a time so no [nq, nt] matrix is
    built. Ties go to the lower train index. Rows at index >= n_valid are
    padding and never enter; unfillable slots are (+inf, -1). A NaN
    distance is taken first under manhattan and after +inf under
    euclidean (_block_topk); so under euclidean a query whose every
    distance is NaN keeps its NaNs from a single block but loses them to
    the empty carry when there are more, as in the reference.

    approx=True selects exactly, as the reference's `lax.approx_min_k`
    does off a TPU: on the CPU its values and indices are `lax.top_k`'s.
    So the answer is the one the reference gives there."""
    nt = t_num.shape[0] if t_num is not None else t_cat.shape[0]
    if nt % block:
        raise ValueError("pad train rows to a multiple of block (pad_train)")
    if k > block:
        raise ValueError(f"k ({k}) must be <= block ({block})")
    ref = q_num if q_num is not None else q_cat
    nq, dev = ref.shape[0], ref.device
    nv = nt if n_valid is None else n_valid

    def block_topk(start):
        sl = slice(start, start + block)
        d = pairwise_distance(
            q_num, t_num[sl] if t_num is not None else None,
            q_cat, t_cat[sl] if t_cat is not None else None,
            cat_bins, num_ranges, metric)
        idx = torch.arange(start, start + block, dtype=torch.int32, device=dev)
        d = torch.where(idx[None, :] < nv, d, float("inf"))
        return _block_topk(d, idx.expand(nq, -1), k, metric)

    if nt == block:
        best_d, best_i = block_topk(0)
    else:
        best_d = torch.full((nq, k), float("inf"), dtype=torch.float32,
                            device=dev)
        best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
        for start in range(0, nt, block):
            bd, bi = block_topk(start)
            best_d, best_i = _block_topk(torch.cat([best_d, bd], 1),
                                         torch.cat([best_i, bi], 1), k, metric)
    best_i = torch.where(torch.isinf(best_d), -1, best_i)
    return best_d, best_i
