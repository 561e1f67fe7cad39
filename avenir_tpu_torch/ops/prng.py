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
- `normal(key, shape)`: sqrt(2) * erf_inv(u) of the uniforms u in
  [nextafter(-1, 0), 1) (random.py `_normal_real`), erf_inv as XLA's
  `ErfInv32` lowers it: w = -log1p(x * -x); the nine central coefficients
  on w - 2.5 where w < 5, else the nine tail ones on sqrt(w) - 3; Horner
  steps, each one multiply-add rounded once (XLA's CPU build contracts
  them); times x; +-inf at |x| = 1;
- `categorical(key, logits, axis, shape)`: argmax of gumbel noise plus
  the logits, the first maximum on a tie (random.py `categorical`).

A key is a uint32 [2] numpy array, the raw data of a JAX key
(`np.asarray(jax.random.PRNGKey(s))`): a JAX key handed over gives the
same bits here. Many keys at once are an int64 tensor [N, 2] of uint32
values (`keys_tensor`), on any device: `split_many` splits each, and
`uniform_many` / `normal_many` draw one scalar a key, threefry of the
counter (0, 0) under it, as `jax.random.uniform(key)` with shape ().
The arithmetic is on int64 tensors holding uint32 values under a 32-bit
mask: PyTorch's CPU build has no shift of uint32. Bits and uniforms are
exact integer and float operations, equal to JAX's on any device, over
[0, 1), [tiny, 1) and normal's [nextafter(-1, 0), 1): each is a float32
in [0, 1) times the float32 span plus lo, and the float64 sum of that
exact product and lo rounds once to float32 (normal's span, 2 - 2^-24,
is 2 in float32, so the product is exact and the sum holds 25 bits).
`gumbel` takes two float32 logs and `normal` one float32 log1p, which
XLA and PyTorch (and the CPU and the card) may round differently in the
last place: on 1,048,576 draws, 0.9% of the normals differ from JAX's,
none by more than 3 ULP (`tests/test_torch_prng.py`).
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
#: normal's uniform floor: the float32 after -1 towards 0
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
#: XLA's ErfInv32 coefficients, highest power first: the central
#: polynomial on w - 2.5 (w < 5) and the tail polynomial on sqrt(w) - 3
ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
SQRT2 = float(np.float32(np.sqrt(2.0)))


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


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter words x1, x2
    (int64 tensors of uint32 values) under the key words k1, k2 (ints, or
    int64 tensors that broadcast against the counters): the two output
    words, int64 tensors of uint32 values."""
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
    return _scale(random_bits(key, shape, device), minval, maxval)


def _scale(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """float32 uniforms in [minval, maxval) from uint32 bits."""
    one = int(np.array(1.0, np.float32).view(np.int32))
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    lo_t = torch.tensor(lo, dtype=torch.float32, device=floats.device)
    # XLA's CPU build fuses floats * (hi - lo) + lo into one multiply-add:
    # the product of two float32s is exact in float64, then one add and a
    # rounding to float32. The sum is exact in float64, so it rounds once,
    # for [0, 1), [tiny, 1) and normal's [nextafter(-1, 0), 1) (the span
    # 2 - 2^-24 rounds to 2 in float32); for a span and lo far apart in
    # scale a float64 add that rounds could round twice
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


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add: the
    product is exact in float64; the float64 sum is rounded to odd (its
    last bit set where the add was inexact), so the one rounding to
    float32 that follows is the fused one."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    # TwoSum: the add's exact error
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    nudge = even & (err != 0) & torch.isfinite(s)
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    return torch.where(nudge, torch.nextafter(s, toward), s).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 erf_inv(x) as XLA's ErfInv32 computes it (module notes)."""
    w = -torch.log1p(x * -x)
    central = w < 5.0
    t = torch.where(central, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(central, torch.tensor(a, dtype=torch.float32,
                                              device=x.device),
                        torch.tensor(b, dtype=torch.float32, device=x.device))
            for a, b in zip(ERFINV_CENTRAL, ERFINV_TAIL)]
    p = coef[0].expand_as(x)
    for c in coef[1:]:
        p = fma32(p, t, c.expand_as(x))
    out = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


def _normal_of(u: torch.Tensor) -> torch.Tensor:
    return erf_inv(u) * SQRT2


def normal(key, shape: Sequence[int],
           device: Optional[torch.device] = None) -> torch.Tensor:
    """float32 [shape]: jax.random.normal's values within the log1p's
    rounding (module notes)."""
    return _normal_of(uniform(key, shape, NORMAL_LO, 1.0, device))


def keys_tensor(keys, device: Optional[torch.device] = None) -> torch.Tensor:
    """int64 [..., 2] of uint32 values from raw uint32 keys (one [2] key
    or an [N, 2] array), on `device`."""
    k = np.asarray(keys, np.uint32)
    if k.shape[-1:] != (2,):
        raise ValueError(f"keys are uint32 [..., 2], not {k.shape}")
    return torch.from_numpy(k.astype(np.int64)).to(device)


def split_many(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """int64 [N, num, 2]: `jax.random.split(k, num)` of each key of the
    [N, 2] tensor `keys`, on its device."""
    lo = torch.arange(num, dtype=torch.int64, device=keys.device)
    a, b = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(lo), lo)
    return torch.stack([a, b], dim=2)


def _bits_each(keys: torch.Tensor) -> torch.Tensor:
    """int64 [N]: one uint32 draw a key, threefry of the counter (0, 0)."""
    zero = torch.zeros((), dtype=torch.int64, device=keys.device)
    a, b = threefry2x32(keys[:, 0], keys[:, 1], zero, zero)
    return a ^ b


def uniform_many(keys: torch.Tensor, minval: float = 0.0,
                 maxval: float = 1.0) -> torch.Tensor:
    """float32 [N]: `jax.random.uniform(k, (), minval=, maxval=)` of each
    key of the [N, 2] tensor `keys`."""
    return _scale(_bits_each(keys), minval, maxval)


def normal_many(keys: torch.Tensor) -> torch.Tensor:
    """float32 [N]: `jax.random.normal(k)` of each key of the [N, 2]
    tensor `keys`, within the log1p's rounding."""
    return _normal_of(uniform_many(keys, NORMAL_LO, 1.0))
