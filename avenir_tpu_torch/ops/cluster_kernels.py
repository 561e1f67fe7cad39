"""k-means' centre sums: the CUDA kernel's wrapper, its plain version, its
launch count.

The port of `jax.ops.segment_sum(x, assign, num_segments=k)` in the XLA
program `_kmeans_step` (`avenir_tpu/models/cluster.py:43`). XLA's CPU
build adds each cluster's rows in row order, one float32 add a row from
+0; the sums here are those bits, so the centres and every later
step's labels are the reference's.

`centre_sums(x, assign, k)`: float32 [k, d] sums of the rows of x
[n, d] by their int32 label in [0, k) (a label outside adds nowhere).
Given CUDA tensors it launches `csrc/centre_sums.cu` (one thread a
(cluster, column) chain, tiles staged in shared memory) and counts the
launch in its `launches` attribute; given CPU tensors it runs
`centre_sums_plain`. There is no fallback: a kernel that does not build
or launch raises.

`centre_sums_plain` adds each cluster's rows with numpy's float32
`cumsum`, one add a row, on the host: a sequential sum has no parallel
form with its bits, and torch's CPU `cumsum` carries float32 in float64.
"""

from __future__ import annotations

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
            # + 0 turns a lone -0 row into the chain's +0 start
            out[c] = np.cumsum(rows, axis=0, dtype=np.float32)[-1] \
                + np.float32(0)
    return torch.from_numpy(out).to(x.device)


def centre_sums(x: torch.Tensor, assign: torch.Tensor, k: int
                ) -> torch.Tensor:
    """float32 [k, d] row-ordered sums of each cluster's rows: one launch
    of csrc/centre_sums.cu for CUDA tensors (counted in `launches`), the
    plain version for CPU tensors."""
    _check(x, assign, k)
    if not x.is_cuda:
        return centre_sums_plain(x, assign, k)
    x, assign = x.contiguous(), assign.contiguous()
    n, d = x.shape
    out = torch.empty((k, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.load("centre_sums").centre_sums_launch(
            x.data_ptr(), n, d, assign.data_ptr(), k, out.data_ptr(),
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
