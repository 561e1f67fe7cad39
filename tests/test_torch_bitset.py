"""The port's bit-packed containment (`avenir_tpu_torch/ops/bitset.py`)
against the JAX package's `avenir_tpu/ops/bitset.py` on the CPU.

The packing is numpy in both, and must give the same words. The counts,
masks and the folded carry must equal the JAX package's on seeded bitsets
of W = 1, 4 and 5 words, with all-ones and sign-bit words, all-zero
(padding) candidate rows and vocabularies that are not a multiple of 32;
the port's two overlap forms (unpacked bits through one matmul, and the
word-by-word popcount fold) must give the same integers; and its SWAR
popcount must equal numpy's `bitwise_count`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avenir_tpu.ops import bitset as jax_bitset
from avenir_tpu_torch.ops import bitset

CPU = "cpu"


def _case(w: int, seed: int):
    """(multihot [B, V], candidate tuples, V) with V = 32 w - 3 (a partial
    last word for w > 1), rows of every density and candidates of lengths
    1-5, with rows all ones and all zeros."""
    rng = np.random.default_rng(seed)
    v = max(32 * w - 3, 5)
    b = 157
    mh = (rng.random((b, v)) < rng.uniform(0.05, 0.9, (b, 1))).astype(np.uint8)
    mh[0] = 1                       # every word 0xFFFFFFFF (bar padding)
    mh[1] = 0                       # an empty transaction
    cands = [tuple(sorted(rng.choice(v, k, replace=False)))
             for k in (1, 2, 3, 4, 5) for _ in range(9)]
    cands.append((v - 1,))          # the last column
    if v > 31:
        cands.append((31,))         # bit 31: the sign bit of word 0
        cands.append((0, 31))
    return mh, cands, v


def _port_words(a: np.ndarray) -> torch.Tensor:
    return bitset.as_words(a, CPU)


def test_words_for_and_packing_equal_jax():
    for n in (0, 1, 31, 32, 33, 64, 100, 129, 160):
        assert bitset.words_for(n) == jax_bitset.words_for(n)
    rng = np.random.default_rng(3)
    for v in (1, 5, 31, 32, 33, 100, 160):
        mh = (rng.random((37, v)) < 0.4).astype(np.uint8)
        got = bitset.pack_rows_u32(mh)
        assert got.dtype == np.uint32
        assert got.tobytes() == jax_bitset.pack_rows_u32(mh).tobytes()
        cands = [tuple(sorted(rng.choice(v, min(3, v), replace=False)))
                 for _ in range(5)]
        for n_rows in (0, 64):
            assert (bitset.pack_index_rows_u32(cands, v, n_rows).tobytes()
                    == jax_bitset.pack_index_rows_u32(cands, v,
                                                      n_rows).tobytes())


def test_sign_bit_and_all_ones_words():
    words = np.array([[0xFFFFFFFF], [0x80000000], [0x7FFFFFFF], [0]],
                     np.uint32)
    cand = np.array([[0x80000000], [0xFFFFFFFF], [1], [0]], np.uint32)
    got = bitset.bitset_contain_counts(_port_words(words), _port_words(cand))
    want = np.asarray(jax_bitset.bitset_contain_counts(
        jnp.asarray(words), jnp.asarray(cand)))
    assert got.dtype == torch.int32
    assert got.tolist() == want.tolist() == [2, 1, 2, 0]


@pytest.mark.parametrize("w", [1, 4, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_counts_and_mask_equal_jax(w, seed):
    mh, cands, v = _case(w, seed)
    trans = bitset.pack_rows_u32(mh)
    cand = bitset.pack_index_rows_u32(cands, v, 64)    # zero rows: padding
    assert trans.shape[1] == w
    counts = bitset.bitset_contain_counts(_port_words(trans),
                                          _port_words(cand))
    mask = bitset.bitset_contain_mask(_port_words(trans), _port_words(cand))
    j_counts = np.asarray(jax_bitset.bitset_contain_counts(
        jnp.asarray(trans), jnp.asarray(cand)))
    j_mask = np.asarray(jax_bitset.bitset_contain_mask(
        jnp.asarray(trans), jnp.asarray(cand)))
    assert counts.numpy().tolist() == j_counts.tolist()
    assert np.array_equal(mask.numpy(), j_mask)
    # the oracle: a row holds every item of the candidate
    want = [int(mh[:, list(c)].all(axis=1).sum()) for c in cands]
    assert counts[:len(cands)].tolist() == want
    assert counts[len(cands):].tolist() == [0] * (64 - len(cands))
    assert not mask[:, len(cands):].any()


@pytest.mark.parametrize("w", [1, 4, 5])
def test_fold_over_blocks_equals_jax_and_one_call(w):
    mh, cands, v = _case(w, 7 + w)
    trans = bitset.pack_rows_u32(mh)
    cand = bitset.pack_index_rows_u32(cands, v, 64)
    acc = torch.zeros(64, dtype=torch.int32)
    j_acc = jnp.zeros(64, jnp.int32)
    for s in range(0, trans.shape[0], 40):
        out = bitset.bitset_fold_counts(acc, _port_words(trans[s:s + 40]),
                                        _port_words(cand))
        assert out is acc           # the carry is updated in place
        j_acc = jax_bitset.bitset_fold_counts(
            j_acc, jnp.asarray(trans[s:s + 40]), jnp.asarray(cand))
    whole = bitset.bitset_contain_counts(_port_words(trans),
                                         _port_words(cand))
    assert acc.tolist() == whole.tolist() == np.asarray(j_acc).tolist()


@pytest.mark.parametrize("w", [1, 4, 5])
def test_unpacked_matmul_equals_word_fold(w):
    mh, cands, v = _case(w, 20 + w)
    trans = _port_words(bitset.pack_rows_u32(mh))
    cand = _port_words(bitset.pack_index_rows_u32(cands, v, 64))
    b = bitset._overlap_fold(trans, cand)
    a = bitset._overlap_fold_words(trans, cand)
    assert a.dtype == b.dtype == torch.int32
    assert torch.equal(a, b)
    assert torch.equal(bitset.bitset_contain_counts(trans, cand),
                       bitset.bitset_contain_counts(trans, cand, words=True))
    # the unpacked bits are the multi-hot rows, padded to whole words
    bits = bitset.unpack_bits(trans)
    assert bits.shape == (mh.shape[0], 32 * w)
    assert np.array_equal(bits[:, :v].numpy(), mh.astype(np.float32))
    assert not bits[:, v:].any()


def test_popcount_equals_numpy_bitwise_count():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    x[:6] = [0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x55555555]
    got = bitset.popcount32(_port_words(x))
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == np.bitwise_count(x).astype(int).tolist()
