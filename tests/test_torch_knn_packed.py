"""The port's packed top-k and its bfloat16 compute dtype (plain versions, on
the CPU) against the JAX package's Pallas kernels in interpret mode.

Tolerances: packed manhattan distances and indices bit-equal (the same
fp32 sums, truncated to the same grid, in the same order); packed
euclidean within the exact tolerance (rtol 1e-4, atol 1e-5) plus one
2^-11 quantum of the 12 masked mantissa bits. bfloat16 at the exact
kernel's tolerances against JAX at bfloat16, plus each kernel's quantum,
and the vote within 2.0 with arg-max agreement >= 0.99. Index mismatches
are allowed only between tied distances, measured in the arithmetic of
the dtype: for bfloat16, the cross term of bf16-rounded operands.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avenir_tpu.ops.distance import pad_train
from avenir_tpu.ops.pallas_knn import (knn_classify_lanes, knn_topk_lanes,
                                       knn_topk_pallas)
from avenir_tpu_torch.ops import knn_kernels as kk
from test_torch_knn_kernels import (CASES, _assert_neighbors, _corpus,
                                    _oracle, _t)

PACKED_QUANTUM = 2.0 ** -11


def _jax_packed(q, t, k, metric, n_valid=None, compute_dtype="float32"):
    d, i = knn_topk_pallas(jnp.asarray(q), jnp.asarray(t), k=k, block_q=128,
                           block_t=256, metric=metric, n_valid=n_valid,
                           interpret=True, packed=True,
                           compute_dtype=compute_dtype)
    return np.asarray(d), np.asarray(i)


@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
@pytest.mark.parametrize("case", CASES)
def test_packed_matches_pallas_interpret(metric, case):
    q, t, t_pad, n_valid = _corpus(case, 6)
    ref_d, ref_i = _jax_packed(q, t_pad, 5, metric, n_valid)
    got_d, got_i = kk.knn_topk_packed(_t(q), _t(t_pad), 5, metric, n_valid)
    got_d, got_i = got_d.numpy(), got_i.numpy()
    if metric == "manhattan":
        np.testing.assert_array_equal(got_d, ref_d)
        np.testing.assert_array_equal(got_i, ref_i)
    else:
        _assert_neighbors(got_d, got_i, ref_d, ref_i, _oracle(q, t, metric),
                          metric, extra=PACKED_QUANTUM)
    if case == "tiny":   # k > n: unfillable slots are (+inf, -1)
        assert np.isinf(got_d[:, 3:]).all() and (got_i[:, 3:] == -1).all()
    assert kk.knn_topk_packed.launches == 0   # CPU tensors: plain version


def test_knn_topk_packed_keyword_takes_the_packed_kernel():
    q, _, t_pad, n_valid = _corpus("pad", 7)
    args = (_t(q), _t(t_pad), 4, "euclidean", n_valid)
    for a, b in zip(kk.knn_topk(*args, packed=True),
                    kk.knn_topk_packed(*args)):
        assert torch.equal(a, b)
    exact_d, _ = kk.knn_topk(*args)
    packed_d, _ = kk.knn_topk_packed(*args)
    # truncated to the grid: never above the exact value, within a quantum
    sq_exact, sq_packed = exact_d ** 2, packed_d ** 2
    assert (sq_packed <= sq_exact).all()
    assert ((sq_exact - sq_packed) <= PACKED_QUANTUM * sq_exact).all()


def test_packed_ties_go_to_the_lower_index():
    """Quantized data: many exactly tied distances, which JAX's in-tile
    column bits and the port's index carry both break toward the lower
    train index."""
    rng = np.random.default_rng(2)
    q = np.round(rng.normal(size=(128, 3)) * 2).astype(np.float32) / 2
    t = np.round(rng.normal(size=(768, 3)) * 2).astype(np.float32) / 2
    ref_d, ref_i = _jax_packed(q, t, 8, "manhattan")
    got_d, got_i = kk.knn_topk_packed(_t(q), _t(t), 8, "manhattan")
    np.testing.assert_array_equal(got_d.numpy(), ref_d)
    np.testing.assert_array_equal(got_i.numpy(), ref_i)


@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
def test_packed_multi_tile_merge(metric):
    """Equal nearest rows in three of JAX's 256-row tiles (two in one):
    its first-argmin merge keeps the earlier tile's, the port the lower
    index, and both give the four lowest of the five."""
    rng = np.random.default_rng(3)
    q = np.zeros((128, 4), np.float32)
    t = rng.normal(size=(1024, 4)).astype(np.float32) * 10
    cols = [5, 300, 600, 700, 1000]
    t[cols] = 0.25
    ref_d, ref_i = _jax_packed(q, t, 4, metric)
    got_d, got_i = kk.knn_topk_packed(_t(q), _t(t), 4, metric)
    assert got_i.numpy()[0].tolist() == cols[:4]
    np.testing.assert_array_equal(got_d.numpy(), ref_d)
    np.testing.assert_array_equal(got_i.numpy(), ref_i)


def _oracle_bf16(q, t):
    """float64 euclidean distances with the bfloat16 cross term: norms of
    the fp32 values, q.t of the bf16-rounded ones."""
    qr, tr = (torch.from_numpy(x).to(torch.bfloat16).double().numpy()
              for x in (q, t))
    q64, t64 = q.astype(np.float64), t.astype(np.float64)
    sq = ((q64 ** 2).sum(1)[:, None] + (t64 ** 2).sum(1)[None, :]
          - 2.0 * qr @ tr.T)
    return np.sqrt(np.maximum(sq, 0.0) / q.shape[1])


def _jax_bf16(name, q, t, k, n_valid):
    kw = dict(k=k, block_q=128, block_t=256, metric="euclidean",
              n_valid=n_valid, interpret=True, compute_dtype="bfloat16")
    if name == "knn_topk_lanes":
        d, i = knn_topk_lanes(jnp.asarray(q), jnp.asarray(t), **kw)
    else:
        d, i = knn_topk_pallas(jnp.asarray(q), jnp.asarray(t),
                               packed=name == "knn_topk_packed", **kw)
    return np.asarray(d), np.asarray(i)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", ["knn_topk", "knn_topk_packed",
                                  "knn_topk_lanes"])
def test_bfloat16_topk_matches_pallas_interpret(name, case):
    q, t, t_pad, n_valid = _corpus(case, 8)
    ref_d, ref_i = _jax_bf16(name, q, t_pad, 5, n_valid)
    got_d, got_i = getattr(kk, name)(_t(q), _t(t_pad), 5, "euclidean",
                                     n_valid, compute_dtype="bfloat16")
    extra = {"knn_topk": 0.0, "knn_topk_packed": PACKED_QUANTUM,
             "knn_topk_lanes": 2.0 ** -(23 - kk.lane_pack_bits(t_pad.shape[0]))
             }[name]
    _assert_neighbors(got_d.numpy(), got_i.numpy(), ref_d, ref_i,
                      _oracle_bf16(q, t), "euclidean", extra=extra)
    # the dtype is real: bf16 moves the distances off the float32 ones
    f32_d, _ = getattr(kk, name)(_t(q), _t(t_pad), 5, "euclidean", n_valid)
    fin = torch.isfinite(f32_d)
    assert not torch.equal(got_d[fin], f32_d[fin])


@pytest.mark.parametrize("kernel_fn", ["none", "gaussian"])
def test_bfloat16_vote_matches_pallas_interpret(kernel_fn):
    rng = np.random.default_rng(9)
    q = rng.normal(size=(128, 6)).astype(np.float32)
    t = rng.normal(size=(700, 6)).astype(np.float32)
    labels = rng.integers(0, 3, 700).astype(np.int32)
    t_pad, _, n_valid = pad_train(t, None, 256)
    lab_pad = np.zeros(t_pad.shape[0], np.int32)
    lab_pad[:700] = labels
    ref = np.asarray(knn_classify_lanes(
        jnp.asarray(q), jnp.asarray(t_pad), jnp.asarray(lab_pad), k=5,
        n_classes=3, kernel_fn=kernel_fn, kernel_param=30.0, block_q=128,
        block_t=256, n_valid=n_valid, interpret=True,
        compute_dtype="bfloat16"))
    got = kk.knn_classify_lanes(_t(q), _t(t_pad), _t(lab_pad), 5, 3, None,
                                kernel_fn, 30.0, "euclidean", n_valid,
                                compute_dtype="bfloat16").numpy()
    assert np.abs(got - ref).max() <= 2.0
    assert (got.argmax(1) == ref.argmax(1)).mean() >= 0.99


@pytest.mark.parametrize("name", [fn.__name__ for fn in kk.KERNEL_WRAPPERS])
def test_manhattan_ignores_the_compute_dtype(name):
    q, _, t_pad, n_valid = _corpus("pad", 10)
    args = [_t(q), _t(t_pad)]
    if name == "knn_classify_lanes":
        labels = np.random.default_rng(10).integers(0, 2, t_pad.shape[0])
        args += [_t(labels.astype(np.int32)), 5, 2, None, "gaussian", 30.0]
    else:
        args += [5]
    fn = getattr(kk, name)
    f32 = fn(*args, metric="manhattan", n_valid=n_valid)
    bf16 = fn(*args, metric="manhattan", n_valid=n_valid,
              compute_dtype="bfloat16")
    for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (f32, bf16))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float16", "bf16", torch.float64])
def test_unknown_compute_dtype_raises(dtype):
    q, t = torch.zeros((4, 3)), torch.zeros((16, 3))
    with pytest.raises(ValueError, match="compute_dtype"):
        kk.knn_topk_packed(q, t, 2, compute_dtype=dtype)
    assert kk.knn_topk(q, t, 2, compute_dtype=torch.bfloat16)[0].shape == (4, 2)


@pytest.mark.parametrize("d", [1, 6, 37, 300])
@pytest.mark.parametrize("name", ["knn_topk", "knn_topk_packed",
                                  "knn_topk_lanes"])
def test_bfloat16_topk_at_ragged_depths_matches_pallas_interpret(name, d):
    """The plain bf16 top-k, which the tensor-core form is held to on the
    card, against JAX at bfloat16 where D is no multiple of the mma's
    k-step of 16 (1, 6, 37) or spans many of them (300)."""
    q, t, t_pad, n_valid = _corpus("pad", 20 + d, d=d)
    ref_d, ref_i = _jax_bf16(name, q, t_pad, 5, n_valid)
    got_d, got_i = getattr(kk, name)(_t(q), _t(t_pad), 5, "euclidean",
                                     n_valid, compute_dtype="bfloat16")
    extra = {"knn_topk": 0.0, "knn_topk_packed": PACKED_QUANTUM,
             "knn_topk_lanes": 2.0 ** -(23 - kk.lane_pack_bits(t_pad.shape[0]))
             }[name]
    _assert_neighbors(got_d.numpy(), got_i.numpy(), ref_d, ref_i,
                      _oracle_bf16(q, t), "euclidean", extra=extra)


@pytest.mark.parametrize("d", [1, 37, 300])
def test_bfloat16_vote_at_ragged_depths_matches_pallas_interpret(d):
    rng = np.random.default_rng(40 + d)
    q = rng.normal(size=(128, d)).astype(np.float32)
    t = rng.normal(size=(600, d)).astype(np.float32)
    t_pad, _, n_valid = pad_train(t, None, 256)
    lab_pad = np.zeros(t_pad.shape[0], np.int32)
    lab_pad[:600] = rng.integers(0, 3, 600)
    ref = np.asarray(knn_classify_lanes(
        jnp.asarray(q), jnp.asarray(t_pad), jnp.asarray(lab_pad), k=5,
        n_classes=3, kernel_fn="gaussian", kernel_param=30.0, block_q=128,
        block_t=256, n_valid=n_valid, interpret=True,
        compute_dtype="bfloat16"))
    got = kk.knn_classify_lanes(_t(q), _t(t_pad), _t(lab_pad), 5, 3, None,
                                "gaussian", 30.0, "euclidean", n_valid,
                                compute_dtype="bfloat16").numpy()
    assert np.abs(got - ref).max() <= 2.0
    assert (got.argmax(1) == ref.argmax(1)).mean() >= 0.99
