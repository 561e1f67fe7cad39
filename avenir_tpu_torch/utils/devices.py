"""Device resolution for every entry point of the port.

The port's contract is the opposite of a graceful fallback: it runs on the
GPU unless the caller asks for the CPU. A missing GPU is an error, never a
silent switch to the CPU, so a run can never report CPU numbers as the
card's.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` by default; ``cpu`` only when asked. Raises RuntimeError
    when a CUDA device is wanted and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "avenir_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions on the "
            "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
