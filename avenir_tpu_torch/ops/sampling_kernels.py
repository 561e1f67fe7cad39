"""The Metropolis walk: its CUDA kernel's wrapper, its plain version, its
launch count.

The port of the XLA scan of `MetropolisSampler.sample`
(`avenir_tpu/utils/sampling.py:184`, the `lax.scan` of `one_step`),
which is not a Pallas kernel. The draws come first (the sampler makes
them on the device from `ops/prng.py`); the walk then runs over them, a
step at a time from (x, fx):

    std  = pstd, or in mixture mode pstd where mix[i] < thr, else gstd
    nxt  = clip(fma(std, z[i], x), xmin, xmax)
    fn   = bins[bin_index(nxt)]
    take = uniforms[i] < fn / max(fx, 1e-30)
    x, fx = (nxt, fn) if take else (x, fx)

in float32 throughout (the reference runs with x64 off: the bins,
`xmin`, `xmax`, the bin width, the stds, the threshold and 1e-30 are all
float32), from x0 and fx0 = max(bins[bin_index(x0)], 1e-30). The
proposal is one fused multiply-add, as XLA's CPU build compiles the
reference's `x + std * jax.random.normal(key)`: in mixture mode z is
the normal and std the selected one; in plain mode XLA folds the
constant pstd into normal's sqrt(2), so z is erf_inv(u) and pstd the
float32 product pstd * sqrt(2) (`utils/sampling.py` draws them so; held
bit for bit against the reference's own chain on its own draws in
`tests/test_torch_sampling.py`). `bin_index` is JAX's float floor
division (`_float_divmod`): fmod, (a - mod) / bw, the sign fix, round
half away from zero; then the int32 convert and the clip to the bins.

`metropolis_walk(z, uniforms, mix, walk, x0)` returns the chain
(float32 [steps], x after each step) and the number of proposals taken
(an int64 tensor). Given CUDA tensors it launches
`csrc/metropolis_walk.cu` (one thread walks the chain) and counts the
call in its `launches` attribute; given CPU tensors it runs
`metropolis_walk_plain`, a float32 loop on the host with the same
operations in the same order. There is no fallback: a kernel that does
not build or launch raises.

`chain_latency_ns(walk)` times one step's dependent chain on the card
(`clock64()` and CUDA events): the walk's least time is its steps times
that latency.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops import _build

F32 = np.float32
#: the ratio's floor, float32 as the reference's x64-off constant
FLOOR = F32(1e-30)


@dataclass(frozen=True)
class WalkTarget:
    """The walk's constants, each a float32 value: the target's bins
    (float32 [nb]), its range and bin width, and the stds multiplied onto
    the draws z and the mixture threshold (gstd None: the plain
    proposal)."""

    bins: torch.Tensor
    xmin: float
    xmax: float
    bin_width: float
    pstd: float
    gstd: Optional[float] = None
    thr: float = 0.5

    @classmethod
    def of(cls, bins, xmin, xmax, bin_width, pstd, gstd=None, thr=0.5,
           device=None) -> "WalkTarget":
        """Every constant rounded once to float32, the bins on `device`."""
        b = torch.as_tensor(np.asarray(bins, np.float64).astype(F32),
                            device=device)
        return cls(b, float(F32(xmin)), float(F32(xmax)),
                   float(F32(bin_width)), float(F32(pstd)),
                   None if gstd is None else float(F32(gstd)),
                   float(F32(thr)))


def _sgn(v):
    return v if v != v or v == 0 else (F32(1.0) if v > 0 else F32(-1.0))


def bin_index_scalar(x, xmin, bw, nb: int) -> int:
    """JAX's float `(x - xmin) // bw` as int32, clipped to [0, nb - 1], on
    float32 scalars."""
    a = F32(x) - F32(xmin)
    bw = F32(bw)
    mod = np.fmod(a, bw)
    div = (a - mod) / bw
    if mod != 0 and _sgn(bw) != _sgn(mod):
        mod = mod + bw
        div = div - F32(1.0)
    if div != div:
        i = 0
    else:
        # round half away from zero, then the saturating int32 convert
        r = math.copysign(math.floor(abs(float(div)) + 0.5), float(div))
        i = int(max(min(r, 2.0 ** 31 - 1), -2.0 ** 31))
    return min(max(i, 0), nb - 1)


def bin_index(x: torch.Tensor, xmin: float, bw: float, nb: int
              ) -> torch.Tensor:
    """int64 [..]: `bin_index_scalar` of each float32 value of x."""
    a = x - F32(xmin)
    bw_t = torch.tensor(F32(bw), device=x.device)
    mod = torch.fmod(a, bw_t)
    div = (a - mod) / bw_t
    fix = (mod != 0) & (torch.sign(bw_t) != torch.sign(mod))
    div = torch.where(fix, div - 1.0, div)
    r = torch.sign(div) * torch.floor(div.abs().double() + 0.5).float()
    r = torch.nan_to_num(r, nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31 - 1)
    return r.long().clamp(0, nb - 1)


def fma32(a, b, c) -> np.float32:
    """float32 a * b + c rounded once (a fused multiply-add) on scalars:
    the product is exact in float64, the float64 sum is rounded to odd,
    then to float32."""
    p = float(a) * float(b)
    c = float(c)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    if err != 0 and math.isfinite(s) and \
            (int(np.float64(s).view(np.int64)) & 1) == 0:
        s = math.nextafter(s, math.inf if err > 0 else -math.inf)
    return F32(s)


def _check(z: torch.Tensor, uniforms: torch.Tensor,
           mix: Optional[torch.Tensor], walk: WalkTarget) -> None:
    draws = [z, uniforms] + ([] if mix is None else [mix])
    for t in draws + [walk.bins]:
        if t.dtype != torch.float32 or t.dim() != 1:
            raise TypeError("the draws and the bins are float32 vectors")
        if t.device != z.device:
            raise ValueError("the draws and the bins must share a device")
    if any(t.shape != z.shape for t in draws):
        raise ValueError("the draws must have one value a step")
    if walk.bins.numel() < 1:
        raise ValueError("the target needs at least one bin")
    if (mix is None) != (walk.gstd is None):
        raise ValueError("mixture uniforms go with a global std, and only "
                         "with one")


def metropolis_walk_plain(z: torch.Tensor, uniforms: torch.Tensor,
                          mix: Optional[torch.Tensor], walk: WalkTarget,
                          x0: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(chain float32 [steps], taken int64 []): the walk as a float32 loop
    on the host, returned on the draws' device."""
    _check(z, uniforms, mix, walk)
    zs = z.cpu().numpy()
    un = uniforms.cpu().numpy()
    mx = None if mix is None else mix.cpu().numpy()
    bins = walk.bins.cpu().numpy()
    nb = len(bins)
    xmin, xmax, bw = F32(walk.xmin), F32(walk.xmax), F32(walk.bin_width)
    pstd = F32(walk.pstd)
    gstd = None if walk.gstd is None else F32(walk.gstd)
    thr = F32(walk.thr)
    x = F32(x0)
    fx = max(bins[bin_index_scalar(x, xmin, bw, nb)], FLOOR)
    chain = np.empty(len(zs), F32)
    taken = 0
    for i in range(len(zs)):
        std = pstd if mx is None or mx[i] < thr else gstd
        nxt = min(max(fma32(std, zs[i], x), xmin), xmax)
        fn = bins[bin_index_scalar(nxt, xmin, bw, nb)]
        if un[i] < fn / max(fx, FLOOR):
            x, fx = nxt, fn
            taken += 1
        chain[i] = x
    return (torch.from_numpy(chain).to(z.device),
            torch.tensor(taken, dtype=torch.int64, device=z.device))


def metropolis_walk(z: torch.Tensor, uniforms: torch.Tensor,
                    mix: Optional[torch.Tensor], walk: WalkTarget,
                    x0: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(chain float32 [steps], taken int64 []): one launch of
    csrc/metropolis_walk.cu for CUDA tensors (counted in `launches`), the
    plain version for CPU tensors."""
    _check(z, uniforms, mix, walk)
    if not z.is_cuda:
        return metropolis_walk_plain(z, uniforms, mix, walk, x0)
    z, uniforms = z.contiguous(), uniforms.contiguous()
    mix = None if mix is None else mix.contiguous()
    steps = z.numel()
    chain = torch.empty(steps, dtype=torch.float32, device=z.device)
    taken = torch.empty((), dtype=torch.int64, device=z.device)
    bins = walk.bins.contiguous()
    gstd = walk.pstd if walk.gstd is None else walk.gstd
    with torch.cuda.device(z.device):
        lib = _build.load("metropolis_walk")
        err = lib.metropolis_walk_launch(
            z.data_ptr(), uniforms.data_ptr(),
            None if mix is None else mix.data_ptr(), steps,
            bins.data_ptr(), bins.numel(), walk.xmin, walk.xmax,
            walk.bin_width, walk.pstd, gstd, walk.thr, float(F32(x0)),
            chain.data_ptr(), taken.data_ptr(),
            torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"metropolis_walk launch failed: CUDA error {err}")
    metropolis_walk.launches += 1
    return chain, taken


def chain_latency_ns(walk: WalkTarget, x0: float, steps: int = 1 << 20,
                     reps: int = 3) -> Tuple[float, float]:
    """(ns, cycles) one step's dependent chain takes on the current card:
    the walk's step on eight draws held in registers, `steps` of them
    (a multiple of 8), timed by CUDA events (the median of reps) and by
    the kernel's own clock64(). The draws are fixed ones that take about
    half the proposals."""
    dev = walk.bins.device
    z = torch.tensor([0.3, -1.1, 0.7, -0.2, 1.9, -0.6, 0.05, -1.4],
                           dtype=torch.float32, device=dev)
    uniforms = torch.tensor([0.1, 0.9, 0.4, 0.6, 0.2, 0.8, 0.5, 0.3],
                            dtype=torch.float32, device=dev)
    out = torch.zeros(2, dtype=torch.float32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = _build.load("metropolis_walk")
    times = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = lib.metropolis_chain_latency_launch(
            z.data_ptr(), uniforms.data_ptr(), steps,
            walk.bins.data_ptr(), walk.bins.numel(), walk.xmin, walk.xmax,
            walk.bin_width, walk.pstd, float(F32(x0)), out.data_ptr(),
            cycles.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        end.record()
        if err != 0:
            raise RuntimeError(f"metropolis chain latency launch failed: "
                               f"CUDA error {err}")
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times = sorted(times[1:])
    return times[len(times) // 2] * 1e6 / steps, int(cycles.item()) / steps


#: every wrapper that counts launches
KERNEL_WRAPPERS = (metropolis_walk,)


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


reset_launches()
