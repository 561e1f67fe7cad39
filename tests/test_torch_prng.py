"""The port's threefry2x32 PRNG (`avenir_tpu_torch/ops/prng.py`) against
`jax.random` on the CPU.

Keys, splits, raw bits and uniforms are bit for bit (tolerance 0) for
several seeds and shapes, over [0, 1), [tiny, 1), normal's
[nextafter(-1, 0), 1) and a span like [-2.5, 7); so is a JAX key handed
over as its uint32 [2] data, and so are the batched forms (`split_many`,
`uniform_many`) against `jax.vmap` over [N, 2] keys. Gumbel noise takes
two float32 logs, which XLA and PyTorch may round differently: it is
held within 2 ULP plus 2^-21, and categorical draws are equal on these
seeds.

Normal draws take one float32 log1p, rounded apart in the same way. The
budget, measured on 1,048,576 draws under each of three keys (7, 0, 11):
0.94-0.96% of the draws differ from `jax.random.normal`, 0.34-0.35% by
more than 1 ULP, 0.067-0.070% by more than 2 ULP, none by more than 3;
every draw more than 2 ULP apart has 0.617 <= |u| <= 0.683. The test
holds them to at most 1.2% differing, 0.1% more than 2 ULP apart, none
more than 3 ULP, and the 3-ULP ones to 0.6 < |u| < 0.7 (`torch.erfinv`
instead would put 59% of the draws apart, up to 91 ULP, and XLA's old
-log((1 - x)(1 + x)) form 13%, up to 91 ULP). `fma32` is held to the
correctly rounded a * b + c, the case a float64 add would round twice
included. The defaults the port copies are checked first, so that a JAX
that changes them fails here with a clear message.
"""

from fractions import Fraction


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avenir_tpu_torch.ops import prng

SEEDS = [0, 1, 3, 42, 2**31 - 1, -1, 2**32 + 5]
SHAPES = [(1,), (7,), (3, 5), (2, 3, 10), (1000,)]


def test_jax_defaults_are_the_ports():
    assert jax.config.jax_threefry_partitionable is True, (
        "ops/prng.py copies JAX's partitionable threefry "
        "(jax_threefry_partitionable=True); this JAX has it off")
    assert jax.config.jax_default_prng_impl == "threefry2x32", (
        "ops/prng.py copies threefry2x32, the default PRNG of JAX 0.9")
    assert jax.config.jax_enable_x64 is False, (
        "ops/prng.py takes 32-bit seeds, as JAX does with x64 off")


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bit_equal(seed):
    key = prng.PRNGKey(seed)
    jkey = jax.random.PRNGKey(seed)
    assert key.dtype == np.uint32
    assert key.tolist() == np.asarray(jkey).tolist()
    for num in (2, 3, 5):
        got = prng.split(key, num)
        want = np.asarray(jax.random.split(jkey, num))
        assert got.dtype == np.uint32 and got.tolist() == want.tolist()
    # a chain of splits, as a bandit's rounds take
    k, jk = key, jkey
    for _ in range(4):
        k, _sub = prng.split(k)
        jk, _jsub = jax.random.split(jk)
    assert k.tolist() == np.asarray(jk).tolist()


@pytest.mark.parametrize("seed", SEEDS[:5])
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_bit_equal(seed, shape):
    key = prng.split(prng.PRNGKey(seed), 3)[2]
    jkey = jnp.asarray(key)
    bits = prng.random_bits(key, shape)
    jbits = np.asarray(jax.random.bits(jkey, shape, jnp.uint32))
    assert bits.numpy().astype(np.uint32).tolist() == jbits.tolist()
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0),
                   (prng.NORMAL_LO, 1.0), (-2.5, 7.0)):
        u = prng.uniform(key, shape, lo, hi)
        ju = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, lo, hi))
        assert u.dtype == torch.float32
        assert u.numpy().view(np.int32).tolist() == \
            ju.view(np.int32).tolist()


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_gumbel_within_the_log_rounding(seed):
    """-log(-log(u)) of bit-equal uniforms: each float32 log may round
    apart by an ULP, so the noise stays within 2 ULP of itself plus 2^-21
    (the inner log's rounding, carried through the outer one)."""
    key = prng.PRNGKey(seed)
    got = prng.gumbel(key, (20000,)).numpy()
    want = np.asarray(jax.random.gumbel(jnp.asarray(key), (20000,)))
    tol = 2 * np.spacing(np.abs(want)) + 2.0 ** -21
    assert (np.abs(got - want) <= tol).all()
    assert (got == want).mean() > 0.5


@pytest.mark.parametrize("seed", range(6))
def test_categorical_equal(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(300, 10)).astype(np.float32)
    logits[rng.random((300, 10)) < 0.3] = -1e30
    key = prng.PRNGKey(seed)
    got = prng.categorical(key, torch.from_numpy(logits), axis=1)
    want = np.asarray(jax.random.categorical(jnp.asarray(key),
                                             jnp.asarray(logits), axis=1))
    assert got.numpy().tolist() == want.tolist()
    # a batch of draws a row, as the softmax bandit takes
    got = prng.categorical(key, torch.from_numpy(logits)[:, None, :],
                           axis=-1, shape=(300, 3))
    want = np.asarray(jax.random.categorical(
        jnp.asarray(key), jnp.asarray(logits)[:, None, :], axis=-1,
        shape=(300, 3)))
    assert got.shape == (300, 3)
    assert got.numpy().tolist() == want.tolist()


def test_a_jax_key_carries_over():
    """A key made by JAX, split there, gives the same bits here."""
    jk = jax.random.split(jax.random.PRNGKey(7), 4)[3]
    key = np.asarray(jk)
    assert prng.random_bits(key, (64,)).numpy().astype(np.uint32).tolist() \
        == np.asarray(jax.random.bits(jk, (64,), jnp.uint32)).tolist()
    with pytest.raises(ValueError, match="uint32"):
        prng.random_bits(np.zeros(3, np.uint32), (2,))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in float32 ULPs, on the ordered integer line."""
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, -(ai & 0x7FFFFFFF), ai)
    bi = np.where(bi < 0, -(bi & 0x7FFFFFFF), bi)
    return np.abs(ai - bi)


@pytest.mark.parametrize("seed", [7, 0, 11])
def test_normal_within_its_ulp_budget(seed):
    key = prng.PRNGKey(seed)
    n = 1 << 20
    u = prng.uniform(key, (n,), prng.NORMAL_LO, 1.0).numpy()
    ju = np.asarray(jax.random.uniform(jnp.asarray(key), (n,), jnp.float32,
                                       prng.NORMAL_LO, 1.0))
    assert u.view(np.int32).tolist() == ju.view(np.int32).tolist()
    got = prng.normal(key, (n,))
    assert got.dtype == torch.float32 and got.shape == (n,)
    want = np.asarray(jax.random.normal(jnp.asarray(key), (n,)))
    d = _ulps(got.numpy(), want)
    assert (d > 0).mean() <= 0.012
    assert (d > 2).mean() <= 0.001
    assert d.max() <= 3
    far = np.abs(u[d > 2])
    assert ((far > 0.6) & (far < 0.7)).all()


def test_normal_shapes_and_edges():
    key = prng.split(prng.PRNGKey(3), 2)[1]
    for shape in [(1,), (3, 5), (2, 3, 4)]:
        got = prng.normal(key, shape).numpy()
        want = np.asarray(jax.random.normal(jnp.asarray(key), shape))
        assert got.shape == want.shape
        assert _ulps(got, want).max() <= 3
    x = torch.tensor([-1.0, 1.0, 0.0, -0.0], dtype=torch.float32)
    out = prng.erf_inv(x).numpy()
    assert out[0] == -np.inf and out[1] == np.inf and out[2] == 0.0
    assert np.signbit(out[3])


def test_batched_keys_bit_equal():
    keys = jax.random.split(jax.random.PRNGKey(5), 2000)
    kt = prng.keys_tensor(np.asarray(keys))
    assert kt.shape == (2000, 2) and kt.dtype == torch.int64
    for num in (2, 3):
        got = prng.split_many(kt, num).numpy()
        want = np.asarray(jax.vmap(lambda k: jax.random.split(k, num))(keys))
        assert got.tolist() == want.tolist()
    got = prng.uniform_many(kt).numpy()
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k))(keys))
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist()
    # a scalar draw is the vmapped one
    assert float(jax.random.uniform(keys[17])) == float(got[17])
    got = prng.normal_many(kt).numpy()
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k))(keys))
    assert _ulps(got, want).max() <= 3
    assert (got == want).mean() > 0.97
    with pytest.raises(ValueError, match="uint32"):
        prng.keys_tensor(np.zeros((4, 3), np.uint32))


def _fma_exact(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """a * b + c rounded once to float32 (nearest, ties to even), by exact
    rational arithmetic."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(exact))
    best = None
    for cand in (np.nextafter(r, np.float32(-np.inf)), r,
                 np.nextafter(r, np.float32(np.inf))):
        dist = abs(Fraction(float(cand)) - exact)
        even = (int(np.float32(cand).view(np.int32)) & 1) == 0
        if best is None or dist < best[0] or (dist == best[0] and even):
            best = (dist, cand)
    return np.float32(best[1])


def test_fma32_rounds_once():
    # a float64 add lands on a float32 midpoint the exact sum lies below
    a = np.float32(2.0 ** -24 * (1 + 2.0 ** -15))
    b = np.float32(1 - 2.0 ** -15)
    c = np.float32(1 + 2.0 ** -23)
    twice = np.float32(float(a) * float(b) + float(c))
    once = _fma_exact(a, b, c)
    assert once == c and twice != once
    got = prng.fma32(*(torch.tensor([v]) for v in (a, b, c)))
    assert got.numpy()[0] == once
    rng = np.random.default_rng(0)
    scale = np.float32(2.0) ** rng.integers(-30, 30, (3, 400)).astype(
        np.float32)
    a, b, c = rng.normal(size=(3, 400)).astype(np.float32) * scale
    got = prng.fma32(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(c)).numpy()
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist()
