"""A gloo world of CPU ranks running every `avenir_tpu_torch.parallel`
family and both `fit(mesh=)` calls, for `tests/test_torch_parallel.py`.

`spawn_world` starts `WORLD` processes (spawn pickles `rank_main` by
name, so it lives in this importable module), each of which brings up
the process group, builds the 4x1 and the 2x2 mesh, runs everything on
its shard and pickles its outputs to `<outdir>/rank<r>.pkl`. `inputs()`
makes the same arrays, from seeds, in every process. Nothing here
imports `jax`: the ranks run the port alone.
"""

from __future__ import annotations

import os
import pickle
import socket
import traceback
from typing import Dict

import numpy as np

WORLD = 4
#: mesh name -> model_parallel: a 4x1 and a 2x2 grid of the four ranks
MESHES = {"4x1": 1, "2x2": 2}
K_NN = 5
NB = dict(num_classes=3, bmax=6)
TREE = dict(n_leaves=4, n_splits=5, smax=3, num_classes=2)
MARKOV = dict(n_states=4, n_classes=2)
APRIORI_K = 2
BANDIT = dict(batch_size=3, max_reward=100.0)
CROSS = dict(bins_a=4, bins_b=5)
LR_RATE = 0.5
TREE_ROWS, TREE_SEED, TREE_DEPTH = 301, 21, 3
LR_ROWS, LR_SEED, LR_ITERS = 333, 22, 5


def inputs() -> Dict[str, Dict[str, np.ndarray]]:
    """Every family's global inputs, from fixed seeds. Row counts are not
    multiples of the shard counts, so padding is exercised; the KNN
    features are multiples of 1/4, so distances tie and are exact."""
    rng = np.random.default_rng(2026)
    n = 203
    lab3 = rng.integers(0, 3, n).astype(np.int32)
    out = {
        "knn_topk": dict(
            q=(rng.integers(0, 9, (40, 5)) / 4).astype(np.float32),
            t=(rng.integers(0, 9, (48, 5)) / 4).astype(np.float32),
            t_labels=rng.integers(0, 3, 48).astype(np.int32)),
        "nb_train": dict(codes=rng.integers(0, 6, (n, 3)).astype(np.int32),
                         labels=lab3, w=np.ones(n, np.float32)),
        "tree_level": dict(
            leaf_id=rng.integers(0, 4, n).astype(np.int32),
            seg=rng.integers(0, 3, (n, 5)).astype(np.int8),
            labels=rng.integers(0, 2, n).astype(np.int32),
            w=rng.integers(0, 4, n).astype(np.float32)),
        "lr_step": dict(
            coeff=rng.normal(0, 0.3, 4).astype(np.float32),
            x=np.concatenate([np.ones((n, 1)), rng.normal(0, 1, (n, 3))],
                             axis=1).astype(np.float32),
            y=rng.integers(0, 2, n).astype(np.float32),
            w=np.ones(n, np.float32)),
        "markov_counts": dict(padded=_padded(rng, 61, 9, 4),
                              labels=rng.integers(0, 2, 61).astype(np.int32)),
        "apriori_support": dict(
            trans=(rng.random((97, 8)) < 0.4).astype(np.float32),
            cand=_candidates(8, APRIORI_K, 6)),
        "bandit_select": dict(
            counts=rng.integers(0, 40, (24, 5)).astype(np.int32),
            rewards=(rng.random((24, 5)) * 100).astype(np.float32),
            mask=np.arange(5)[None, :].repeat(24, 0) < rng.integers(
                2, 6, 24)[:, None],
            round_num=np.float32(7.0)),
        "crosscount": dict(a=rng.integers(0, 4, n).astype(np.int32),
                           b=rng.integers(0, 5, n).astype(np.int32),
                           w=np.ones(n, np.float32)),
    }
    out["bandit_select"]["counts"][::5, 0] = 0        # untried arms first
    return out


def _padded(rng, n, length, states):
    seq = rng.integers(0, states, (n, length)).astype(np.int32)
    lens = rng.integers(0, length + 1, n)
    seq[np.arange(length)[None, :] >= lens[:, None]] = -1
    return seq


def _candidates(v, k, c):
    rows = np.zeros((c, v), np.float32)
    for i in range(c):
        rows[i, [i % v, (i + 1 + i // v) % v][:k]] = 1.0
    return rows


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _collect(mesh, data) -> Dict[str, object]:
    """This rank's output of every family on `mesh`."""
    import torch

    from avenir_tpu_torch.parallel import (FAMILIES, shard_rows,
                                           sharded_keyed_count)
    from avenir_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

    joint = mesh.axis_names

    def rows(a, pad=0, axes=joint):
        return shard_rows(mesh, a, pad, axes)

    out = {}
    d = data["knn_topk"]
    t_axes = (MODEL_AXIS,) if MODEL_AXIS in joint else None
    t = rows(d["t"], axes=t_axes) if t_axes else torch.from_numpy(d["t"])
    tl = (rows(d["t_labels"], axes=t_axes) if t_axes
          else torch.from_numpy(d["t_labels"]))
    out["knn_topk"] = FAMILIES["knn_topk"](mesh, K_NN)(
        rows(d["q"], axes=(DATA_AXIS,)), t, tl)
    d = data["nb_train"]
    out["nb_train"] = FAMILIES["nb_train"](mesh, **NB)(
        rows(d["codes"]), rows(d["labels"]), rows(d["w"]))
    d = data["tree_level"]
    out["tree_level"] = FAMILIES["tree_level"](mesh, **TREE)(
        rows(d["leaf_id"]), rows(d["seg"]), rows(d["labels"]), rows(d["w"]))
    d = data["lr_step"]
    out["lr_step"] = FAMILIES["lr_step"](mesh, LR_RATE)(
        torch.from_numpy(d["coeff"]), rows(d["x"]), rows(d["y"]),
        rows(d["w"]))
    d = data["markov_counts"]
    out["markov_counts"] = FAMILIES["markov_counts"](mesh, **MARKOV)(
        rows(d["padded"], -1), rows(d["labels"]))
    d = data["apriori_support"]
    out["apriori_support"] = FAMILIES["apriori_support"](mesh, APRIORI_K)(
        rows(d["trans"]), torch.from_numpy(d["cand"]))
    d = data["bandit_select"]
    out["bandit_select"] = FAMILIES["bandit_select"](mesh, **BANDIT)(
        rows(d["counts"]), rows(d["rewards"]), rows(d["mask"], False),
        d["round_num"])
    d = data["crosscount"]
    out["crosscount"] = FAMILIES["crosscount"](mesh, **CROSS)(
        rows(d["a"]), rows(d["b"]), rows(d["w"]))

    def keyed(a):
        a = a[a >= 0].long()
        return {"bins": torch.bincount(a, minlength=CROSS["bins_a"]),
                "rows": (a.new_tensor([a.numel()]),)}
    out["keyed_count"] = sharded_keyed_count(mesh, keyed)(
        rows(data["crosscount"]["a"], -1, (DATA_AXIS,)))

    from avenir_tpu_torch.data import generate_churn, generate_elearn
    from avenir_tpu_torch.models.regress import LogisticRegression
    from avenir_tpu_torch.models.tree import DecisionTreeBuilder
    ds = generate_churn(TREE_ROWS, seed=TREE_SEED)
    out["tree_fit"] = DecisionTreeBuilder(
        ds.schema, max_depth=TREE_DEPTH, device="cpu").fit(ds, mesh=mesh)
    ds = generate_elearn(LR_ROWS, seed=LR_SEED)
    out["lr_fit"] = LogisticRegression(
        iteration_limit=LR_ITERS, device="cpu").fit(ds, mesh=mesh).coeff
    return {k: _to_numpy(v) for k, v in out.items()}


def _to_numpy(v):
    import torch
    if isinstance(v, torch.Tensor):
        return v.numpy()
    if isinstance(v, tuple):
        return tuple(_to_numpy(x) for x in v)
    if isinstance(v, dict):
        return {k: _to_numpy(x) for k, x in v.items()}
    if hasattr(v, "to_json"):
        return v.to_json()
    return v


def rank_main(rank: int, port: int, outdir: str) -> None:
    """One rank of the world: every family and fit on both meshes."""
    try:
        import torch
        torch.set_num_threads(1)
        from avenir_tpu_torch.parallel import data_mesh
        from avenir_tpu_torch.parallel.multihost import (
            host_shard_bounds, initialize, shutdown)
        assert initialize(f"tcp://127.0.0.1:{port}", WORLD, rank,
                          device="cpu") == WORLD
        data = inputs()
        res = {"bounds": host_shard_bounds(10)}
        for name, mp in MESHES.items():
            mesh = data_mesh(model_parallel=mp, device="cpu")
            res[name] = {"index": dict(mesh.index), **_collect(mesh, data)}
        try:
            data_mesh(model_parallel=3, device="cpu")
        except ValueError as e:
            res["indivisible"] = str(e)
        shutdown()
        with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(res, fh)
    except BaseException:
        with open(os.path.join(outdir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def spawn_world(outdir: str, timeout: float) -> Dict[int, dict]:
    """Run `rank_main` on WORLD spawned processes; every rank's outputs
    by rank. Raises if a rank fails or the world outlives `timeout`
    seconds (a hung collective), and kills what is left."""
    import multiprocessing as mp
    import time

    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, port, outdir))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} still running after "
                               f"{timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errs = []
    for r, p in enumerate(procs):
        err = os.path.join(outdir, f"rank{r}.err")
        if p.exitcode != 0 or os.path.exists(err):
            text = open(err).read() if os.path.exists(err) else ""
            errs.append(f"rank {r} exit {p.exitcode}\n{text}")
    if errs:
        raise RuntimeError("\n".join(errs))
    out = {}
    for r in range(WORLD):
        with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as fh:
            out[r] = pickle.load(fh)
    return out
