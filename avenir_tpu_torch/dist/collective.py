"""Cross-process collective merge of fold carries, behind a gate.

The port of `avenir_tpu/dist/collective.py`. The sharded driver merges in
the coordinator: it restores every block's serialized carry and chains the
registered `merge_states`, correct on any backend. Where the ranks of a
`torch.distributed` group each hold a merged carry, the same sum is one
collective: :func:`allsum_carry` flattens a rank's carry arrays into one
float64 vector, sums it over the group with `all_reduce` and hands every
rank the group's totals.

:func:`collective_ready` gates it: true only inside an initialized group
of more than one rank (`parallel.multihost.initialize`: NCCL on cuda, gloo
on the CPU). Unlike jaxlib's CPU backend, which refuses compiled
multi-process computation, gloo sums across CPU processes, so the port's
gate opens on the CPU too: a difference of the backend, not a new route.
As in the reference, the driver never calls it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class CollectiveUnavailable(RuntimeError):
    """The collective merge cannot run: no process group, or one of a
    single rank with nothing to merge across."""


def collective_ready() -> bool:
    """True inside an initialized `torch.distributed` group of more than
    one rank."""
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def allsum_carry(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Sum each carry array over every rank of the default process group,
    in float64: this rank's arrays flattened into one vector (keys in
    sorted order), one `all_reduce`, unflattened. For additive carries
    (counts, moments); the caller merges `meta` by its own rules. On NCCL
    the vector travels on this rank's current cuda device. Raises
    :class:`CollectiveUnavailable` when collective_ready() is false."""
    if not collective_ready():
        raise CollectiveUnavailable(
            "the collective merge needs an initialized torch.distributed "
            "group of more than one rank; a single process merges through "
            "StreamFoldOps.merge_states")
    import torch
    import torch.distributed as dist

    keys = sorted(arrays)
    shapes = {k: np.shape(arrays[k]) for k in keys}
    flat = (np.concatenate([np.ravel(arrays[k]) for k in keys])
            .astype(np.float64) if keys else np.zeros(0, np.float64))
    vec = torch.from_numpy(flat)
    if dist.get_backend() == "nccl":
        vec = vec.to(torch.device("cuda", torch.cuda.current_device()))
    dist.all_reduce(vec, op=dist.ReduceOp.SUM)
    total = vec.cpu().numpy()
    out: Dict[str, np.ndarray] = {}
    off = 0
    for k in keys:
        n = int(np.prod(shapes[k])) if shapes[k] else 1
        out[k] = total[off:off + n].reshape(shapes[k])
        off += n
    return out
