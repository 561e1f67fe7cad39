"""Distribution samplers and a histogram for synthetic data, the port of
`avenir_tpu/utils/sampling.py`.

`Histogram`, `GaussianSampler` and `NonParamSampler` are numpy on the
host, the port's own copies of the reference's: the same draws from the
same generator. `MetropolisSampler` walks a Metropolis chain over a
histogram target with a Gaussian random-walk proposal (optionally a
local/global mixture) on the device: one `sample(n, skip)` draws all its
randomness at once from the port's copy of JAX's threefry (`ops/prng.py`:
the n * skip + 1 keys, each step's split into (kp, ka), in mixture mode
kp's split into (ku, kn), the normals and the uniforms), then walks the
chain in one launch of `ops/sampling_kernels.metropolis_walk`, the
counterpart of the reference's `lax.scan`. The uniforms are JAX's bits;
the normals are within the log1p's rounding of JAX's (`ops/prng.py`), so
a chain may leave the reference's where two proposals fall on either
side of a bin edge or of the clamp (`tools/sampling_check.py`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops import prng
from avenir_tpu_torch.ops.sampling_kernels import WalkTarget, metropolis_walk
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device


class Histogram:
    """Binned distribution over [xmin, xmin + bin_width*(n-1)]
    (stats.py Histogram)."""

    def __init__(self, xmin: float, bin_width: float,
                 values: Optional[Sequence[float]] = None,
                 xmax: Optional[float] = None):
        self.xmin = float(xmin)
        self.bin_width = float(bin_width)
        if values is not None:
            self.bins = np.asarray(values, np.float64)
            self.xmax = self.xmin + self.bin_width * (len(self.bins) - 1)
        else:
            self.xmax = float(xmax)
            n = int((self.xmax - self.xmin) / self.bin_width) + 1
            self.bins = np.zeros(n, np.float64)

    @classmethod
    def initialized(cls, xmin, bin_width, values) -> "Histogram":
        return cls(xmin, bin_width, values=values)

    @classmethod
    def uninitialized(cls, xmin, xmax, bin_width) -> "Histogram":
        return cls(xmin, bin_width, xmax=xmax)

    def _bin_index(self, x) -> np.ndarray:
        return np.clip(((np.asarray(x) - self.xmin) // self.bin_width)
                       .astype(np.int64), 0, len(self.bins) - 1)

    def add(self, x: np.ndarray) -> None:
        np.add.at(self.bins, self._bin_index(x), 1.0)

    def value(self, x) -> np.ndarray:
        return self.bins[self._bin_index(x)]

    def bounded(self, x):
        return np.clip(x, self.xmin, self.xmax)

    def min_max(self) -> Tuple[float, float]:
        return self.xmin, self.xmax

    def normalized(self) -> np.ndarray:
        s = self.bins.sum()
        return self.bins / s if s > 0 else self.bins

    def cum_distr(self) -> np.ndarray:
        """Cumulative distribution over bins (stats.py cumDistr)."""
        return np.cumsum(self.normalized())

    def percentile(self, percent: float) -> float:
        """Value at the given percentile (stats.py percentile)."""
        if not 0 <= percent <= 100:
            raise ValueError("percent must be in [0, 100]")
        cum = self.cum_distr()
        idx = int(np.searchsorted(cum, percent / 100.0))
        idx = min(idx, len(self.bins) - 1)
        return self.xmin + idx * self.bin_width

    def cum_value(self, x) -> np.ndarray:
        """Cumulative probability at value x (stats.py cumValue)."""
        return self.cum_distr()[self._bin_index(x)]


@dataclass
class GaussianSampler:
    """Gaussian sampler truncated to mean±3σ (GaussianRejectSampler,
    sampler.py:25), drawn by redraw."""

    mean: float
    std_dev: float
    rng: np.random.Generator = field(
        default_factory=lambda: np.random.default_rng())

    def sample(self, n: Optional[int] = None):
        shape = (n,) if n is not None else (1,)
        lo, hi = self.mean - 3 * self.std_dev, self.mean + 3 * self.std_dev
        out = self.rng.normal(self.mean, self.std_dev, shape)
        bad = (out < lo) | (out > hi)
        while bad.any():
            out[bad] = self.rng.normal(self.mean, self.std_dev, bad.sum())
            bad = (out < lo) | (out > hi)
        return out if n is not None else float(out[0])


@dataclass
class NonParamSampler:
    """Sampler over an arbitrary binned distribution (NonParamRejectSampler,
    sampler.py:50) via inverse CDF on the histogram weights."""

    xmin: float
    bin_width: float
    values: Sequence[float]
    rng: np.random.Generator = field(
        default_factory=lambda: np.random.default_rng())

    def sample(self, n: Optional[int] = None):
        p = np.asarray(self.values, np.float64)
        p = p / p.sum()
        k = self.rng.choice(len(p), size=n if n is not None else 1, p=p)
        out = self.xmin + k * self.bin_width
        return out if n is not None else float(out[0])


@dataclass
class StepDraws:
    """One sample call's randomness on the device: a proposal draw z and
    an accept uniform a step, and in mixture mode the uniform that picks
    the std. z is the normal in mixture mode and erf_inv(u) in plain
    mode, where XLA folds the constant std into the normal's sqrt(2)
    (`ops/sampling_kernels.py`)."""

    z: torch.Tensor
    uniforms: torch.Tensor
    mix: Optional[torch.Tensor]


def draw_steps(key, steps: int, mixture: bool,
               device: torch.device) -> Tuple[np.ndarray, StepDraws]:
    """(the next key, the draws) of `steps` walk steps under `key`, as the
    reference's `sample` makes them: split(key, steps + 1), keys[0] the
    next key; each later key split into (kp, ka); erf_inv of the normal's
    uniform from kp, or in mixture mode kp split into (ku, kn), the
    mixture's uniform from ku and the normal from kn; the accept uniform
    from ka."""
    keys = prng.split_many(prng.keys_tensor(key, device)[None], steps + 1)[0]
    pairs = prng.split_many(keys[1:], 2)
    kp, ka = pairs[:, 0], pairs[:, 1]
    if mixture:
        sub = prng.split_many(kp, 2)
        mix = prng.uniform_many(sub[:, 0])
        z = prng.normal_many(sub[:, 1])
    else:
        mix = None
        z = prng.erf_inv(prng.uniform_many(kp, prng.NORMAL_LO, 1.0))
    draws = StepDraws(z, prng.uniform_many(ka), mix)
    return keys[0].cpu().numpy().astype(np.uint32), draws


class MetropolisSampler:
    """Metropolis chain over a histogram target (MetropolitanSampler,
    sampler.py:78): Gaussian random-walk proposal, optional local/global
    mixture, thinning via `skip`. Its state is the reference's: `key` (the
    raw uint32 [2] key, `jax.random.key(seed)`'s bits), `cur`,
    `trans_count`. Runs on the card unless `device="cpu"`."""

    def __init__(self, proposal_std: float, xmin: float, bin_width: float,
                 values: Sequence[float], seed: int = 0,
                 global_proposal_std: Optional[float] = None,
                 mixture_threshold: float = 0.5,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.target = Histogram.initialized(xmin, bin_width, values)
        self.proposal_std = float(proposal_std)
        self.global_proposal_std = global_proposal_std
        self.mixture_threshold = float(mixture_threshold)
        self.key = prng.PRNGKey(seed)
        self.cur = float(np.random.default_rng(seed).uniform(
            self.target.xmin, self.target.xmax))
        self.trans_count = 0

    def set_mixture_proposal(self, global_std: float, threshold: float):
        self.global_proposal_std = float(global_std)
        self.mixture_threshold = float(threshold)

    def walk_target(self) -> WalkTarget:
        """The walk's float32 constants, the bins on the device; in plain
        mode the std is float32 pstd * sqrt(2), as XLA folds it."""
        t = self.target
        pstd = np.float32(self.proposal_std)
        if self.global_proposal_std is None:
            pstd = pstd * np.float32(prng.SQRT2)
        return WalkTarget.of(t.bins, t.xmin, t.xmax, t.bin_width, pstd,
                             self.global_proposal_std,
                             self.mixture_threshold, self.device)

    def walk(self, steps: int) -> Tuple[torch.Tensor, StepDraws]:
        """Advance the chain `steps` proposals: (x after each step, on the
        device; the draws the steps took). Updates key, cur, trans_count."""
        self.key, draws = draw_steps(self.key, steps,
                                     self.global_proposal_std is not None,
                                     self.device)
        chain, taken = metropolis_walk(draws.z, draws.uniforms,
                                       draws.mix, self.walk_target(),
                                       self.cur)
        self.cur = float(chain[-1]) if steps else float(np.float32(self.cur))
        self.trans_count += int(taken)
        return chain, draws

    def sample(self, n: int = 1, skip: int = 1) -> np.ndarray:
        """Draw n samples, advancing `skip` proposals per draw."""
        chain, _ = self.walk(n * skip)
        return chain[skip - 1::skip][:n].cpu().numpy()
