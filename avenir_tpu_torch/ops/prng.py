"""The port's own copy of JAX's threefry2x32 PRNG, bit for bit.

`jax.random` under JAX 0.9's defaults (`jax_default_prng_impl` threefry2x32,
`jax_threefry_partitionable` True, `jax_enable_x64` False), which the
reference's bandits draw from:

- `PRNGKey(seed)`: the key [0, seed & 0xFFFFFFFF] (a 32-bit seed; the
  high word is 0 with x64 off), `jax/_src/prng.py` `threefry_seed`;
- `split(key, num)`: the fold-like split, threefry2x32 of the counters
  (0, i) under the key, the two output words a new key
  (`_threefry_split_foldlike`, prng.py:1156);
- `random_bits(key, shape)`: threefry2x32 of the 64-bit flat index of each
  element as (high, low) words, the two output words xor-ed
  (`_threefry_random_bits_partitionable`, prng.py:1184, and
  `iota_2x32_shape`);
- `uniform(key, shape, minval, maxval)`: float32 from the top 23 bits or-ed
  into the bits of 1.0, less 1.0, scaled, shifted and held at minval
  (`jax/_src/random.py` `_uniform`, :435);
- `gumbel(key, shape)`: -log(-log(uniform(tiny, 1))), the default "low"
  mode (random.py `_gumbel`, :1723);
- `categorical(key, logits, axis, shape)`: argmax of gumbel noise plus
  the logits, the first maximum on a tie (random.py `categorical`).

A key is a uint32 [2] numpy array, the raw data of a JAX key
(`np.asarray(jax.random.PRNGKey(s))`): a JAX key handed over gives the
same bits here. The arithmetic is on int64 tensors holding uint32 values
under a 32-bit mask: PyTorch's CPU build has no shift of uint32. Bits and
uniforms are exact integer and float operations, equal to JAX's on any
device; `gumbel` takes two float32 logs, which XLA and PyTorch (and the
CPU and the card) may round differently in the last place.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: float32's smallest normal, gumbel's uniform floor
TINY = float(np.finfo(np.float32).tiny)


def PRNGKey(seed: int) -> np.ndarray:
    """The raw key of `jax.random.PRNGKey(seed)` with x64 off: uint32
    [0, seed mod 2^32]."""
    return np.array([0, int(seed) & MASK], np.uint32)


def _words(key) -> tuple:
    k = np.asarray(key, np.uint32)
    if k.shape != (2,):
        raise ValueError(f"a key is uint32 [2], not {k.shape}")
    return int(k[0]), int(k[1])


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter words x1, x2
    (int64 tensors of uint32 values) under the key words k1, k2: the two
    output words, int64 tensors of uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = a ^ _rotl(b, r)
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + i + 1) & MASK
    return a, b


def split(key, num: int = 2) -> np.ndarray:
    """uint32 [num, 2]: `jax.random.split(key, num)`'s raw keys."""
    k1, k2 = _words(key)
    lo = torch.arange(num, dtype=torch.int64)
    a, b = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([a, b], dim=1).numpy().astype(np.uint32)


def random_bits(key, shape: Sequence[int],
                device: Optional[torch.device] = None) -> torch.Tensor:
    """int64 [shape] of uint32 values: jax.random.bits(key, shape, uint32),
    on `device` (default cpu)."""
    k1, k2 = _words(key)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    a, b = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return (a ^ b).reshape(tuple(shape))


def uniform(key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device: Optional[torch.device] = None
            ) -> torch.Tensor:
    """float32 [shape] in [minval, maxval): jax.random.uniform's values."""
    bits = random_bits(key, shape, device)
    one = int(np.array(1.0, np.float32).view(np.int32))
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    lo_t = torch.tensor(lo, dtype=torch.float32, device=floats.device)
    # XLA's CPU build fuses floats * (hi - lo) + lo into one multiply-add:
    # the product of two float32s is exact in float64, then one add and a
    # rounding to float32 (exact for [0, 1) and [tiny, 1), the ranges the
    # bandits draw; elsewhere a float64 add that rounds could round twice)
    scaled = (floats.double() * float(np.float32(hi - lo))
              + float(lo)).float()
    return torch.maximum(lo_t, scaled)


def gumbel(key, shape: Sequence[int],
           device: Optional[torch.device] = None) -> torch.Tensor:
    """float32 [shape]: jax.random.gumbel's default ("low") mode."""
    return -torch.log(-torch.log(uniform(key, shape, TINY, 1.0, device)))


def categorical(key, logits: torch.Tensor, axis: int = -1,
                shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """int64: jax.random.categorical(key, logits, axis, shape) with
    replacement, on the logits' device."""
    nd = logits.dim()
    axis = axis % nd
    batch = tuple(s for i, s in enumerate(logits.shape) if i != axis)
    shape = batch if shape is None else tuple(shape)
    prefix = shape[:len(shape) - len(batch)]
    noise_shape = list(shape[len(prefix):])
    noise_shape.insert(axis, logits.shape[axis])
    noise = gumbel(key, (*prefix, *noise_shape), logits.device)
    full = logits.reshape((1,) * len(prefix) + tuple(logits.shape))
    return torch.argmax(noise + full, dim=len(prefix) + axis)
