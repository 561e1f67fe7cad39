"""The distributed families over a (data x model) mesh of ranks.

The port of `avenir_tpu/parallel/distributed.py`. Each `*_fn` returns a
function of this rank's shard that every rank of the mesh calls at once
(SPMD, as the reference's `shard_map` body runs on every device). Each
runs the port's single-device core on its shard, then the reference's
collective:

- `knn_topk`: queries shard over 'data' and train rows over 'model'; a
  top-k against the local train block, then an `all_gather` over 'model'
  of the [nq_loc, k] distances and labels and a second top-k: k * M
  candidates a query cross the network, never n_train;
- `nb_train`, `tree_level`, `markov_counts`, `apriori_support` and
  `crosscount`: an `all_reduce` of int64 counts. The reference sums
  float32, exact below 2^24 a cell, so both agree there; the row weights
  are integers (ones, bootstrap counts, 0 for a pad row);
- `lr_step`: an `all_reduce` of the float64 gradient halves and of the
  weight total, then the update;
- `bandit_select`: no collective; a group's selection reads only its own
  arms, so the output stays group-sharded.

Rows shard over every axis of the mesh jointly (`shard_rows(mesh, a,
axes=mesh.axis_names)`), as the reference's P(axes). Ties keep
`lax.top_k`'s lower index first (`ops.distance._block_topk`), which
`torch.topk` on the card does not promise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from avenir_tpu_torch.ops.distance import _block_topk, pairwise_distance
from avenir_tpu_torch.parallel.mesh import (MODEL_AXIS, Mesh, all_reduce_sum)

#: the rows of a tile in the sharded support count: bounds the [rows, C]
#: overlap a tile makes on the device
APRIORI_TILE_ROWS = 8192


def _axes(mesh: Mesh, axes: Optional[Sequence[str]]) -> tuple:
    return tuple(axes) if axes is not None else mesh.axis_names


def _weighted_bincount(key: torch.Tensor, w: torch.Tensor, n: int
                       ) -> torch.Tensor:
    """int64 [n]: the integer weights `w` summed by `key`, exact in
    float64 below 2^53."""
    return torch.bincount(key, weights=w.to(torch.float64),
                          minlength=n).to(torch.int64)


def distributed_topk_fn(mesh: Mesh, k: int, metric: str = "manhattan"):
    """fn(q_num, t_num, t_labels) -> (dist float32 [nq_loc, k], labels
    [nq_loc, k]): this rank's query rows (sharded over 'data') against its
    train rows (sharded over 'model', or all of them on a mesh without a
    model axis). Numeric features only, as in the reference."""
    has_model = MODEL_AXIS in mesh.axis_names

    def kernel(q_num, t_num, t_labels):
        d = pairwise_distance(q_num, t_num, metric=metric)
        cols = torch.arange(d.shape[1], device=d.device).expand_as(d)
        loc_d, loc_i = _block_topk(d, cols, k, metric)
        loc_lab = t_labels[loc_i]                               # [nq_loc, k]
        if not has_model:
            return loc_d, loc_lab
        group = mesh.group((MODEL_AXIS,))
        m = mesh.shape[MODEL_AXIS]
        parts_d = [torch.empty_like(loc_d) for _ in range(m)]
        parts_lab = [torch.empty_like(loc_lab) for _ in range(m)]
        dist.all_gather(parts_d, loc_d.contiguous(), group=group)
        dist.all_gather(parts_lab, loc_lab.contiguous(), group=group)
        all_d = torch.cat(parts_d, dim=1)                       # [nq_loc, M k]
        all_lab = torch.cat(parts_lab, dim=1)
        pos = torch.arange(all_d.shape[1], device=d.device).expand_as(all_d)
        top_d, top_pos = _block_topk(all_d, pos, k, metric)
        return top_d, all_lab.gather(1, top_pos)

    return kernel


def distributed_nb_train_fn(mesh: Mesh, num_classes: int, bmax: int):
    """fn(codes [n, F], labels [n], w [n]) -> (post int64 [F, K, B], cls
    int64 [K]): Naive Bayes' sufficient counts of this rank's rows, summed
    over the mesh. A code or label out of range counts nowhere, as the
    reference's one-hot rows of zeros."""
    axes = mesh.axis_names

    def kernel(codes, labels, w):
        n, f = codes.shape
        lab, c = labels.long(), codes.long()
        ok_lab = (lab >= 0) & (lab < num_classes)
        ok = ok_lab[:, None] & (c >= 0) & (c < bmax)
        feat = torch.arange(f, device=codes.device)[None, :]
        key = (feat * num_classes + lab[:, None]) * bmax + c
        post = _weighted_bincount(key[ok], w[:, None].expand(n, f)[ok],
                                  f * num_classes * bmax)
        cls = _weighted_bincount(lab[ok_lab], w[ok_lab], num_classes)
        return (all_reduce_sum(post.reshape(f, num_classes, bmax), mesh, axes),
                all_reduce_sum(cls, mesh, axes))

    return kernel


def distributed_tree_level_fn(mesh: Mesh, n_leaves: int, n_splits: int,
                              smax: int, num_classes: int,
                              axes: Optional[Sequence[str]] = None):
    """fn(leaf_id [n], seg_matrix [n, NS], labels [n], weights [n]) ->
    int64 [L, NS, S, K]: this rank's level histogram (the tree's
    `_level_histogram`), summed over the mesh, so the host picks splits
    from a tensor that is small whatever the row count."""
    from avenir_tpu_torch.models.tree import _level_histogram

    axes = _axes(mesh, axes)

    def kernel(leaf_id, seg_matrix, labels, weights):
        h = _level_histogram(leaf_id, seg_matrix, labels, weights, n_leaves,
                             n_splits, smax, num_classes, dtype=torch.int64)
        return all_reduce_sum(h, mesh, axes)

    return kernel


def distributed_lr_step_fn(mesh: Mesh, learning_rate: float = 1.0,
                           axes: Optional[Sequence[str]] = None):
    """fn(coeff [D], x [n, D], y [n], w [n]) -> the next coefficients: the
    float64 gradient halves of this rank's rows (`regress._lr_grad64`, the
    single-device core) and their weight total, summed over the mesh, then
    rounded to float32 once and divided by the total, so a pad row of
    weight 0 drops out exactly and every rank makes the same update."""
    from avenir_tpu_torch.models.regress import _lr_grad64

    axes = _axes(mesh, axes)

    def kernel(coeff, x, y, w):
        grad = all_reduce_sum(_lr_grad64(coeff, x, y, w), mesh, axes).float()
        n = all_reduce_sum(w.to(torch.float64).sum().reshape(1), mesh, axes)
        n = torch.clamp(n, min=1.0).float().expand_as(grad)
        return coeff + learning_rate * (grad / n)

    return kernel


def distributed_markov_counts_fn(mesh: Mesh, n_states: int,
                                 n_classes: int = 1):
    """fn(padded int [N, L] (-1 pads), labels [N]) -> int64 [C, S, S]: the
    bigram counts of this rank's sequences (`markov.bigram_counts`),
    summed over the mesh."""
    from avenir_tpu_torch.models.markov import bigram_counts

    axes = mesh.axis_names

    def kernel(padded, labels):
        return all_reduce_sum(bigram_counts(padded, labels, n_states,
                                            n_classes), mesh, axes)

    return kernel


def distributed_apriori_support_fn(mesh: Mesh, k: int):
    """fn(trans [n, V] multi-hot, cand float32 [C, V] multi-hot) -> int64
    [C]: the rows of this rank's transactions that hold every item of a
    candidate (the in-RAM miner's containment count), summed over the
    mesh: the per-k MR job as one all-reduce."""
    from avenir_tpu_torch.models.association import _contain_counts_resident

    axes = mesh.axis_names

    def kernel(trans, cand):
        counts = _contain_counts_resident(trans, cand, k, APRIORI_TILE_ROWS)
        return all_reduce_sum(counts.to(torch.int64), mesh, axes)

    return kernel


def distributed_bandit_select_fn(mesh: Mesh, batch_size: int,
                                 max_reward: float = 100.0):
    """fn(counts [G, A], rewards [G, A], mask [G, A], round_num) -> int64
    [G, B]: UCB1's batch (`bandits._ucb1`) for this rank's groups. No
    collective: a selection reads only its own group's arms."""
    from avenir_tpu_torch.models.bandits import _ucb1

    def kernel(counts, rewards, mask, round_num):
        return _ucb1(counts, rewards, mask, float(round_num), max_reward,
                     batch_size)

    return kernel


def distributed_crosscount_fn(mesh: Mesh, bins_a: int, bins_b: int):
    """fn(a [n], b [n], w [n]) -> int64 [A, B]: the weighted contingency
    counts of this rank's rows, summed over the mesh (the primitive
    behind mutual information and the correlations). A code out of range
    counts nowhere."""
    axes = mesh.axis_names

    def kernel(a, b, w):
        a, b = a.long(), b.long()
        ok = (a >= 0) & (a < bins_a) & (b >= 0) & (b < bins_b)
        h = _weighted_bincount((a * bins_b + b)[ok], w[ok], bins_a * bins_b)
        return all_reduce_sum(h.reshape(bins_a, bins_b), mesh, axes)

    return kernel


#: every distributed family, keyed by the reference's short names
FAMILIES = {
    "knn_topk": distributed_topk_fn,
    "nb_train": distributed_nb_train_fn,
    "tree_level": distributed_tree_level_fn,
    "lr_step": distributed_lr_step_fn,
    "markov_counts": distributed_markov_counts_fn,
    "apriori_support": distributed_apriori_support_fn,
    "bandit_select": distributed_bandit_select_fn,
    "crosscount": distributed_crosscount_fn,
}
