"""Builders and snippets for `tests/test_torch_audit_ir.py`.

A family's builder runs in the spawned ranks of the IR tier's world, which
import it by name, so the drifted family lives in this importable module
(it imports the port alone, never `jax`). The snippets are the rule
twins: each bad one runs an op the IR rules flag, its good twin the same
op where they must stay silent. None spells a read that the AST rules
see (an `.item()` lexically inside a loop): the IR tier sees what a
helper or a `bool()` does at run time.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from avenir_tpu_torch.analysis import manifest


def cross_extra_build(mesh):
    """crosscount's step, then one int64 all-reduce it never records:
    8 bytes its process group is handed past the model."""
    fn, args = manifest.cross_build(mesh)

    def step(*a):
        out = fn(*a)
        dist.all_reduce(torch.zeros(1, dtype=torch.int64))
        return out

    return step, args


def failing_build(mesh):
    raise ValueError("no such family")


# ---------------------------------------------------------------- twins
def read_in_loop(x):
    hits = 0
    for i in range(3):
        hits += bool(x[i] > 2)
    return hits


def read_after_loop(x):
    acc = x[0] * 0
    for i in range(3):
        acc = acc + x[i]
    return bool(acc > 2)


def _peek(x):
    return x.sum().item()


def read_in_helper_in_loop(x):
    return [_peek(x[i]) for i in range(3)]


def read_in_helper_once(x):
    return _peek(x)


def size_read_in_loop(x):
    return [torch.nonzero(x > i) for i in range(3)]


def size_read_once(x):
    return torch.nonzero(x > 1)


def mask_index_in_loop(x):
    out = []
    for i in range(3):
        out.append(x[x > i])
    return out


def mask_index_once(x):
    return x[x > 1]


def lift_in_loop(x):
    acc = x.clone()
    for i in range(3):
        acc = acc + torch.tensor([float(i)])
    return acc


def lift_once(x):
    step = torch.tensor([1.0])
    acc = x.clone()
    for _ in range(3):
        acc = acc + step
    return acc


def place_in_loop(x):
    return [x[i:i + 1].to("meta") for i in range(3)]


def place_once(x):
    return x.to("meta")


def widen(x):
    return x.double().sum()


def stay_narrow(x):
    return x.float().sum()


def count_int64(x):
    return torch.bincount(x.long(), minlength=4)


def count_int32(x):
    return (x[:, None] == torch.arange(4, dtype=x.dtype)).sum(
        0, dtype=torch.int32)
