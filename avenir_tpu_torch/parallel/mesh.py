"""Meshes over the ranks of a `torch.distributed` process group, and
sharded aggregation helpers.

The port of `avenir_tpu/parallel/mesh.py`. There a mesh is the devices of
one process, and a `psum` inside `shard_map` sums over them. Here a mesh
is the ranks of a process group (`multihost.initialize`), one device a
rank: NCCL on cuda, gloo when the caller asks for the CPU. The two axes
are the reference's: independent rows shard over 'data', and the train
side of the all-pairs distance grid of KNN over an optional 'model' axis.
The world of W ranks is the grid [W / model_parallel, model_parallel] in
rank order, as the reference reshapes its device list: rank r sits at
data index r // M and model index r % M.

Every rank holds its own shard of the rows and calls the same function on
it (SPMD, as `shard_map` runs its body); a reduction the reference's
shuffle performed is an `all_reduce` over the axes the rows are sharded
over, and its result, small and the same on every rank, replicates.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a (data[, model]) grid of ranks.

    `shape` maps each axis to its size, `index` to this rank's coordinate
    on it, and `groups` to the process group of the ranks that differ from
    this one only along it (a collective "over 'model'" runs there).
    `device` is where this rank's tensors live."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    index: Dict[str, int]
    device: torch.device
    groups: Dict[str, Any] = field(repr=False)

    def group(self, axes: Sequence[str]):
        """The process group over `axes`: one axis's group, or the whole
        world for all of them."""
        axes = tuple(axes)
        if len(axes) == 1:
            return self.groups[axes[0]]
        if set(axes) == set(self.axis_names):
            return self.groups["world"]
        raise ValueError(f"no group over axes {axes} of {self.axis_names}")

    def shard_index(self, axes: Sequence[str]) -> Tuple[int, int]:
        """(this rank's shard, the shard count) when rows shard over `axes`
        jointly, the first axis major (the reference's P(axes))."""
        idx, n = 0, 1
        for a in axes:
            idx = idx * self.shape[a] + self.index[a]
            n *= self.shape[a]
        return idx, n


def _backend_device(device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def data_mesh(model_parallel: int = 1, device: DeviceLike = None) -> Mesh:
    """The (data[, model]) mesh over every rank of the default process
    group (`multihost.initialize` brings it up; its backend must suit
    `device`: NCCL for cuda, gloo for the CPU).

    model_parallel > 1 carves a second axis, which shards the train side
    of the all-pairs distance work; everything else is data parallel. The
    sub-groups are made with `dist.new_group`, which every rank must
    call in the same order: build a mesh on every rank at once."""
    if not dist.is_initialized():
        raise RuntimeError(
            "data_mesh needs a torch.distributed process group; call "
            "avenir_tpu_torch.parallel.multihost.initialize() first")
    dev = _backend_device(device)
    n, rank = dist.get_world_size(), dist.get_rank()
    if model_parallel > 1:
        if n % model_parallel != 0:
            raise ValueError(
                f"device count {n} is not divisible by "
                f"model_parallel={model_parallel}; run a world whose size "
                "is a multiple of the model axis (or model_parallel=1)"
            )
        m = model_parallel
        grid = np.arange(n).reshape(n // m, m)
        data_groups = [dist.new_group(grid[:, j].tolist()) for j in range(m)]
        model_groups = [dist.new_group(grid[i].tolist())
                        for i in range(n // m)]
        di, mi = divmod(rank, m)
        return Mesh((DATA_AXIS, MODEL_AXIS), {DATA_AXIS: n // m, MODEL_AXIS: m},
                    {DATA_AXIS: di, MODEL_AXIS: mi}, dev,
                    {DATA_AXIS: data_groups[mi], MODEL_AXIS: model_groups[di],
                     "world": dist.group.WORLD})
    return Mesh((DATA_AXIS,), {DATA_AXIS: n}, {DATA_AXIS: rank}, dev,
                {DATA_AXIS: dist.group.WORLD, "world": dist.group.WORLD})


def _shard_of(arr: np.ndarray, n_shards: int, shard: int,
              pad_value) -> np.ndarray:
    arr = np.asarray(arr)
    rem = (-arr.shape[0]) % n_shards
    if rem:
        pad_rows = np.full((rem,) + arr.shape[1:], pad_value, dtype=arr.dtype)
        arr = np.concatenate([arr, pad_rows], axis=0)
    per = arr.shape[0] // n_shards
    return arr[shard * per:(shard + 1) * per]


def shard_rows(mesh: Mesh, arr, pad_value=0,
               axes: Sequence[str] = (DATA_AXIS,)) -> torch.Tensor:
    """This rank's rows of a host array sharded over `axes` (the data
    axis by default, replicated along the others; `mesh.axis_names`
    shards over every rank), on the mesh's device. The row count is
    padded up to shard divisibility with `pad_value` rows first, as the
    reference pads, so every rank holds the same number of rows."""
    shard, n_shards = mesh.shard_index(axes)
    local = _shard_of(arr, n_shards, shard, pad_value)
    return torch.from_numpy(np.ascontiguousarray(local)).to(mesh.device)


def row_mask(mesh: Mesh, n_valid: int, n_padded: int) -> torch.Tensor:
    """This rank's shard (over the data axis) of the float32 row mask: 1.0
    for real rows, 0.0 for divisibility padding."""
    mask = (np.arange(n_padded) < n_valid).astype(np.float32)
    return shard_rows(mesh, mask, 0.0)


def replicated(mesh: Mesh, arr) -> torch.Tensor:
    """`arr` as a tensor on the mesh's device: every rank holds all of it."""
    return torch.as_tensor(np.asarray(arr)).to(mesh.device)


def all_reduce_sum(t: torch.Tensor, mesh: Mesh,
                   axes: Sequence[str]) -> torch.Tensor:
    """The sum of `t` over the ranks along `axes`, on every one of them
    (the reference's `lax.psum`), in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group(axes))
    return t


def _tree_map(fn: Callable, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    raise TypeError(f"not a tensor pytree: {type(tree).__name__}")


def sharded_keyed_count(mesh: Mesh, count_fn: Callable[..., Any]):
    """Wrap a counting function of this rank's rows into a mesh program.

    count_fn(*local_args) -> a count tensor (or a tuple, list or dict of
    them) of the local rows. The returned function gives the global
    counts, summed over the data axis, the same on every rank: the
    mapper, shuffle and reducer of a Hadoop count as one all-reduce.
    """
    def wrapped(*args):
        return _tree_map(lambda t: all_reduce_sum(t, mesh, (DATA_AXIS,)),
                         count_fn(*args))

    return wrapped
