"""k-means' centre sums: the CUDA kernel's wrapper, its plain version, its
launch count.

The port of `jax.ops.segment_sum(x, assign, num_segments=k)` in the XLA
program `_kmeans_step` (`avenir_tpu/models/cluster.py:43`). XLA's CPU
build adds each cluster's rows in row order, one float32 add a row from
+0; the sums here are those bits, so the centres and every later
step's labels are the reference's.

`centre_sums(x, assign, k)`: float32 [k, d] sums of the rows of x
[n, d] by their int32 label in [0, k) (a label outside adds nowhere).
Given CUDA tensors it launches `csrc/centre_sums.cu` (a partition of the
rows by cluster, stable, over the whole card; then a block a (cluster,
32 columns) whose one warp adds that cluster's rows in order) and counts
the call in its `launches` attribute; given CPU tensors it runs
`centre_sums_plain`. The two launches share a workspace from torch's
caching allocator and read nothing back. A shape the partition cannot
stage (k above about 58,000) raises ValueError on the card. There is no fallback: a kernel that does
not build or launch raises.

`centre_sums_plain` adds each cluster's rows with numpy's float32
`cumsum`, one add a row, on the host: a sequential sum has no parallel
form with its bits, and torch's CPU `cumsum` carries float32 in float64.

One call of a single row is XLA's copy of that row, not a sum from +0
(its scatter of one update keeps a -0; from two rows on, a lone -0 row
sums to +0); both versions do the same.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from avenir_tpu_torch.ops import _build


def _check(x: torch.Tensor, assign: torch.Tensor, k: int) -> None:
    if x.dim() != 2 or assign.dim() != 1 or assign.shape[0] != x.shape[0]:
        raise ValueError("x [n, d] and assign [n] expected")
    if x.dtype != torch.float32 or assign.dtype != torch.int32:
        raise TypeError(f"x must be float32 and assign int32, not {x.dtype} "
                        f"and {assign.dtype}")
    if x.device != assign.device:
        raise ValueError("x and assign must share a device")
    if k < 1:
        raise ValueError(f"k must be at least 1, not {k}")


def centre_sums_plain(x: torch.Tensor, assign: torch.Tensor, k: int
                      ) -> torch.Tensor:
    """float32 [k, d] row-ordered sums of each cluster's rows, on the
    host, returned on x's device."""
    _check(x, assign, k)
    xh, ah = x.cpu().numpy(), assign.cpu().numpy()
    out = np.zeros((k, x.shape[1]), np.float32)
    for c in range(k):
        rows = xh[ah == c]
        if len(rows):
            out[c] = np.cumsum(rows, axis=0, dtype=np.float32)[-1]
            if len(xh) > 1:
                # the chain's +0 start turns a lone -0 row into +0
                out[c] += np.float32(0)
    return torch.from_numpy(out).to(x.device)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte-aligned address (the kernel copies the
    labels 16 bytes at a time), copied only when it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def workspace(lib, n: int, d: int, k: int, device) -> torch.Tensor:
    """The kernel's workspace for (n, d, k) from torch's caching allocator
    (uint8, 256-byte aligned): the rows grouped by cluster and the table
    of each tile's runs. Raises ValueError for a shape the partition
    cannot stage."""
    need = ctypes.c_longlong()
    if lib.centre_sums_workspace(n, d, k, ctypes.byref(need)) != 0:
        raise ValueError(f"centre_sums cannot stage n={n}, d={d}, k={k} "
                         "(k too large for a warp's shared memory)")
    return torch.empty(need.value, dtype=torch.uint8, device=device)


def centre_sums(x: torch.Tensor, assign: torch.Tensor, k: int
                ) -> torch.Tensor:
    """float32 [k, d] row-ordered sums of each cluster's rows: the two
    launches of csrc/centre_sums.cu for CUDA tensors (one call counted in
    `launches`), the plain version for CPU tensors."""
    _check(x, assign, k)
    if not x.is_cuda:
        return centre_sums_plain(x, assign, k)
    x, assign = x.contiguous(), _aligned(assign)
    n, d = x.shape
    out = torch.empty((k, d), dtype=torch.float32, device=x.device)
    if d == 0:
        return out
    with torch.cuda.device(x.device):
        lib = _build.load("centre_sums")
        ws = workspace(lib, n, d, k, x.device)
        err = lib.centre_sums_launch(
            x.data_ptr(), n, d, assign.data_ptr(), k, out.data_ptr(),
            ws.data_ptr(), ws.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"centre_sums launch failed: CUDA error {err}")
    centre_sums.launches += 1
    return out


#: every wrapper that counts launches
KERNEL_WRAPPERS = (centre_sums,)


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


reset_launches()
