"""Weak-scaling measurement of the mesh families, and their payload model.

The port of `avenir_tpu/parallel/scaling.py`. Weak scaling: fix the rows a
rank holds, grow the ranks, and report how close the world's rate stays to
linear; the collectives of `parallel/distributed.py` stand where the
reference's Hadoop shuffle stood, so what is lost is their cost.

:func:`collective_payload_model` is the bytes each family's collectives
return on one rank in one step, in the port's types: the count families
all-reduce int64 cells and LR float64 ones (8 bytes, where the
reference's float32 psums hold 4), and KNN all-gathers float32 distances
and the labels' own dtype. The reference checks its model against the
compiled HLO (`hlo_collective_payloads`), which has no counterpart here:
the port's families record each collective they run inside
`distributed.recorded_payloads()`, and the tests hold that record to the
model, family by family.

:func:`measure_scaling` runs on the world the caller brought up
(`multihost.initialize`): ranks of a gloo world on the CPU, or a NCCL
world on cards (one rank a card). Every rank calls it at once.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np

from avenir_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

# the NB weak-scaling workload: classes, features, bins
_NB_CLASSES, _NB_FEAT, _NB_BMAX = 2, 8, 10

#: bytes of one cell of the count and gradient all-reduces (int64, float64)
_CELL = 8


def collective_payload_model(family: str, mesh_shape: Dict[str, int],
                             **dims: int) -> int:
    """The bytes the collectives of ONE step of a `distributed.FAMILIES`
    family return on one rank of a mesh of shape `mesh_shape` (the
    `payload_bytes` that `distributed.recorded_payloads()` sums):

    - ``nb_train``: all_reduce of the int64 [F, K, B] counts and [K] class
      counts
    - ``knn_topk``: two all_gathers over 'model' of [nq/data, model*k]
      float32 distances and labels of `label_bytes` (default 4, int32); 0
      on a mesh without a model axis
    - ``tree_level``: all_reduce of the int64 [L, NS, S, K] histogram
    - ``lr_step``: all_reduce of the float64 [D] gradient and the float64
      weight total
    - ``markov_counts``: all_reduce of the int64 [C, S, S] bigram counts
    - ``apriori_support``: all_reduce of the int64 [C] supports
    - ``bandit_select``: 0, no collective
    - ``crosscount``: all_reduce of the int64 [A, B] table
    """
    data_n = mesh_shape.get(DATA_AXIS, 1)
    model_n = mesh_shape.get(MODEL_AXIS, 1)
    if family == "nb_train":
        return (dims["n_feat"] * dims["num_classes"] * dims["bmax"]
                + dims["num_classes"]) * _CELL
    if family == "knn_topk":
        if model_n <= 1:
            return 0
        return ((dims["nq"] // data_n) * model_n * dims["k"]
                * (4 + dims.get("label_bytes", 4)))
    if family == "tree_level":
        return (dims["n_leaves"] * dims["n_splits"] * dims["smax"]
                * dims["num_classes"]) * _CELL
    if family == "lr_step":
        return (dims["d"] + 1) * _CELL
    if family == "markov_counts":
        return dims["n_classes"] * dims["n_states"] * dims["n_states"] * _CELL
    if family == "apriori_support":
        return dims["n_cand"] * _CELL
    if family == "bandit_select":
        return 0
    if family == "crosscount":
        return dims["bins_a"] * dims["bins_b"] * _CELL
    raise KeyError(f"no analytic payload model for family {family!r}")


def nb_payload_bytes() -> int:
    """The all_reduce payload of the weak-scaling NB step."""
    return collective_payload_model(
        "nb_train", {}, n_feat=_NB_FEAT, num_classes=_NB_CLASSES,
        bmax=_NB_BMAX)


def project_efficiency(per_rank_step_seconds: float,
                       allreduce_payload_bytes: float,
                       counts: Sequence[int] = (2, 4, 8),
                       link_bytes_per_sec: float = 4.5e11,
                       step_latency_s: float = 5.0e-6) -> List[Dict]:
    """Weak-scaling efficiency of P ranks from a measured step time and a
    payload, for a ring all-reduce: efficiency(P) = t_step / (t_step +
    t_comm(P)), t_comm = 2(P-1)/P x payload / bandwidth + 2(P-1) x the
    latency of a ring step. The defaults are datasheet assumptions for
    H100 NVLink (450 GB/s a direction) and a few microseconds a step, not
    measurements: a model, to be replaced by a measured multi-card run."""
    rows = []
    for p in counts:
        steps = 2 * (p - 1)
        t_comm = (steps / p * allreduce_payload_bytes / link_bytes_per_sec
                  + steps * step_latency_s)
        eff = per_rank_step_seconds / (per_rank_step_seconds + t_comm)
        rows.append({"ranks": int(p), "projected_efficiency": round(eff, 4),
                     "t_step_us": round(per_rank_step_seconds * 1e6, 1),
                     "t_collective_us": round(t_comm * 1e6, 2)})
    return rows


def _self_mesh(device):
    """A one-rank mesh of this rank alone: `dist.new_group` of each rank,
    made by every rank in the same order."""
    import torch.distributed as dist

    from avenir_tpu_torch.parallel.mesh import Mesh

    n, rank = dist.get_world_size(), dist.get_rank()
    groups = [dist.new_group([r]) for r in range(n)]
    return Mesh((DATA_AXIS,), {DATA_AXIS: 1}, {DATA_AXIS: 0}, device,
                {DATA_AXIS: groups[rank], "world": groups[rank]})


def _timed(step, args, iters: int, device) -> float:
    """Best of two timings of `iters` steps, a warm-up step first; on cuda
    synchronized before each clock read."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    step(*args)
    sync()
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(iters):
            step(*args)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _world_max(x: float, mesh) -> float:
    """The largest of every rank's `x` (the slowest rank sets a step)."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([x], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def measure_scaling(nb_rows_per_rank: int = 65_536,
                    knn_queries_per_rank: int = 256,
                    knn_train: int = 8_192, iters: int = 4,
                    device=None) -> dict:
    """Weak scaling of the NB and KNN families on the current world: each
    rank times `iters` steps on its own rows through the world's mesh, and
    again alone (a one-rank mesh of itself), both at once on every rank;
    efficiency = rate(world) / (P x rate(alone)). The NB step's logged
    all_reduce payload is held to the model (`payload_model_validated`)."""
    import torch

    from avenir_tpu_torch.parallel import distributed as dd
    from avenir_tpu_torch.parallel.mesh import data_mesh

    mesh = data_mesh(device=device)
    alone = _self_mesh(mesh.device)
    p = mesh.shape[DATA_AXIS]
    rank = mesh.index[DATA_AXIS]
    rng = np.random.default_rng(1000 + rank)
    dev = mesh.device
    codes = torch.from_numpy(rng.integers(
        0, _NB_BMAX, (nb_rows_per_rank, _NB_FEAT)).astype(np.int32)).to(dev)
    labels = torch.from_numpy(rng.integers(
        0, _NB_CLASSES, nb_rows_per_rank).astype(np.int32)).to(dev)
    w = torch.ones(nb_rows_per_rank, dtype=torch.float32, device=dev)
    q = torch.from_numpy(rng.normal(size=(knn_queries_per_rank, 8))
                         .astype(np.float32)).to(dev)
    t = torch.from_numpy(np.random.default_rng(1).normal(
        size=(knn_train, 8)).astype(np.float32)).to(dev)
    t_lab = torch.from_numpy(np.random.default_rng(2).integers(
        0, 2, knn_train).astype(np.int32)).to(dev)

    out: Dict[str, object] = {"ranks": p, "device": str(dev)}
    for name, world_step, alone_step, args, per_rank in (
            ("nb", dd.distributed_nb_train_fn(mesh, _NB_CLASSES, _NB_BMAX),
             dd.distributed_nb_train_fn(alone, _NB_CLASSES, _NB_BMAX),
             (codes, labels, w), nb_rows_per_rank),
            ("knn", dd.distributed_topk_fn(mesh, k=5, metric="euclidean"),
             dd.distributed_topk_fn(alone, k=5, metric="euclidean"),
             (q, t, t_lab), knn_queries_per_rank)):
        t_world = _world_max(_timed(world_step, args, iters, dev), mesh)
        t_alone = _world_max(_timed(alone_step, args, iters, dev), mesh)
        rate_world = per_rank * p * iters / t_world
        rate_alone = per_rank * iters / t_alone
        out[f"{name}_per_sec"] = rate_world
        out[f"{name}_alone_per_sec"] = rate_alone
        out[f"{name}_efficiency"] = rate_world / (p * rate_alone)
        out[f"{name}_step_s"] = t_world / iters
    with dd.recorded_payloads() as payloads:
        dd.distributed_nb_train_fn(mesh, _NB_CLASSES, _NB_BMAX)(codes,
                                                                labels, w)
    logged = sum(c["payload_bytes"] for c in payloads
                 if c["op"] == "all_reduce")
    out["nb_logged_allreduce_payload_bytes"] = logged
    out["nb_model_payload_bytes"] = nb_payload_bytes()
    out["payload_model_validated"] = logged == nb_payload_bytes()
    out["projection"] = project_efficiency(out["nb_step_s"], logged)
    out["projection_note"] = (
        "projection is a model, not a measurement: the payload is logged "
        "and the step time measured, the link rate and latency are "
        "datasheet assumptions")
    return out
