"""The port's threefry2x32 PRNG (`avenir_tpu_torch/ops/prng.py`) against
`jax.random` on the CPU.

Keys, splits, raw bits and uniforms are bit for bit (tolerance 0) for
several seeds and shapes, and so is a JAX key handed over as its uint32
[2] data. Gumbel noise takes two float32 logs, which XLA and PyTorch may
round differently: it is held within 2 ULP plus 2^-21, and categorical
draws are equal on these seeds. The defaults the port copies are checked
first, so that a JAX that changes them fails here with a clear message.
"""

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
                   (-2.5, 7.0)):
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
