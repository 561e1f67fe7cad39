"""Multi-process scale-out: the process group and each rank's input split.

The port of `avenir_tpu/parallel/multihost.py`. The reference scales
ingest by HDFS input splits, each mapper reading its own block; here one
process a rank (one a GPU, as `torchrun` starts them) reads its own split
of the input and holds only its rows. `initialize()` brings up the
`torch.distributed` process group: NCCL for cuda (the default), gloo when
the caller asks for the CPU. Its address, world size and rank come from
the arguments or from the environment that `torchrun` sets (`WORLD_SIZE`,
`RANK`, `MASTER_ADDR`, `MASTER_PORT`); with one process and no address it
does nothing.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from avenir_tpu_torch.parallel.mesh import Mesh, data_mesh
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               device: DeviceLike = None) -> int:
    """Bring up the default process group and return the world size.
    `init_method` is an address such as ``tcp://localhost:29500`` (default
    ``env://``: `MASTER_ADDR` and `MASTER_PORT`); `world_size` and `rank`
    default to `WORLD_SIZE` and `RANK`. The backend follows `device`:
    NCCL on cuda, gloo on the CPU. On cuda a rank takes the GPU
    `LOCAL_RANK` (default its rank) modulo the GPUs it sees. A no-op with
    one process and no address, or when the group is up already."""
    if dist.is_initialized():
        return dist.get_world_size()
    n = world_size if world_size is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    if n <= 1 and init_method is None:
        return 1
    r = rank if rank is not None else int(os.environ.get("RANK", "0"))
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", r))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method or "env://",
                            world_size=n, rank=r)
    return dist.get_world_size()


def shutdown() -> None:
    """Tear the default process group down (a no-op when none is up)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _world() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_mesh(model_parallel: int = 1, device: DeviceLike = None) -> Mesh:
    """The (data[, model]) mesh over every rank of the process group."""
    return data_mesh(model_parallel=model_parallel, device=device)


def host_shard_bounds(n_rows_global: int) -> Tuple[int, int]:
    """[lo, hi) of the rows this rank should read: its input split,
    contiguous a rank, from the one copy of the split arithmetic
    (`core.stream.split_byte_ranges`), so a corpus smaller than the world
    leaves the last ranks empty splits that still tile."""
    from avenir_tpu_torch.core.stream import split_byte_ranges

    n, r = _world()
    return split_byte_ranges(n_rows_global, n)[r]


def host_csv_byte_range(path: str) -> Tuple[int, int]:
    """This rank's split of one big input file: a byte range for
    `CsvBlockReader(byte_range=...)` or `iter_byte_blocks(byte_range=...)`,
    whose LineRecordReader contract makes the ranks' splits partition the
    lines exactly."""
    return host_shard_bounds(os.path.getsize(path))


def global_rows(mesh: Mesh, local_rows: np.ndarray) -> torch.Tensor:
    """This rank's rows of a globally row-sharded array, on the mesh's
    device: each rank passes only its own shard (shapes agree across the
    ranks but for the row count), and a collective over the mesh reads
    every rank's part."""
    return torch.from_numpy(np.ascontiguousarray(local_rows)).to(mesh.device)
