"""The port's KNN kernel wrappers (plain versions, on the CPU) against the
JAX package's Pallas kernels in interpret mode and its jnp route.

Tolerances: manhattan distances rtol 1e-6 (the same fp32 adds in the same
order, so bit-equality is expected); euclidean rtol 1e-4, atol 1e-5 (the
dot form loses accuracy to cancellation and the summation order differs);
lane-packed keys at most one quantum 2^-(23-pack_bits) relative on top of
that, with neighbour-set recall >= 0.99; vote scores equal for the kernel
none (neighbour counts) and otherwise within 2.0 (a floor(d*100) step on a
boundary-sitting distance), with arg-max agreement >= 0.99. Index mismatches are allowed only between tied distances.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from avenir_tpu.models.knn import _vote as jax_vote
from avenir_tpu.ops.distance import blocked_topk_neighbors, pad_train
from avenir_tpu.ops.pallas_knn import (_kernel_score, knn_classify_lanes,
                                       knn_topk_lanes, knn_topk_pallas)
from avenir_tpu_torch.ops import knn_kernels as kk

TOL = {"manhattan": (1e-6, 0.0), "euclidean": (1e-4, 1e-5)}
CASES = ["basic", "pad", "tiny", "multiblock"]


def _corpus(case, seed, d=8, nq=128):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    n = {"tiny": 3, "multiblock": 1024, "pad": 300}.get(case, 512)
    t = rng.normal(size=(n, d)).astype(np.float32)
    t_pad, _, n_valid = pad_train(t, None, 256)
    return q, t, t_pad, n_valid


def _oracle(q, t, metric):
    """float64 attribute-averaged distances [nq, nt]."""
    diff = q[:, None, :].astype(np.float64) - t[None, :, :]
    if metric == "euclidean":
        return np.sqrt((diff ** 2).mean(-1))
    return np.abs(diff).mean(-1)


def _assert_neighbors(got_d, got_i, ref_d, ref_i, full, metric, extra=0.0):
    """Distances within the metric's tolerance; an index may differ from
    the reference only where the row it names is as near (a tie)."""
    rtol, atol = TOL[metric]
    np.testing.assert_allclose(got_d, ref_d, rtol=rtol + extra, atol=atol)
    rows, cols = np.nonzero(got_i != ref_i)
    fin = np.isfinite(ref_d[rows, cols])
    assert (got_i[rows[~fin], cols[~fin]] == -1).all()
    rows, cols = rows[fin], cols[fin]
    np.testing.assert_allclose(full[rows, got_i[rows, cols]], ref_d[rows, cols],
                               rtol=1e-4 + extra, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
@pytest.mark.parametrize("case", CASES)
def test_exact_matches_pallas_interpret(metric, case):
    q, t, t_pad, n_valid = _corpus(case, 0)
    k = 5
    ref_d, ref_i = knn_topk_pallas(
        jnp.asarray(q), jnp.asarray(t_pad), k=k, block_q=128, block_t=256,
        metric=metric, n_valid=n_valid, interpret=True)
    got_d, got_i = kk.knn_topk(_t(q), _t(t_pad), k, metric, n_valid)
    assert got_d.dtype == torch.float32 and got_i.dtype == torch.int32
    _assert_neighbors(got_d.numpy(), got_i.numpy(), np.asarray(ref_d),
                      np.asarray(ref_i), _oracle(q, t, metric), metric)
    if case == "tiny":   # k > n: unfillable slots are (+inf, -1)
        assert np.isinf(got_d.numpy()[:, 3:]).all()
        assert (got_i.numpy()[:, 3:] == -1).all()
    assert kk.knn_topk.launches == 0     # CPU tensors take the plain version


@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
@pytest.mark.parametrize("case", CASES)
def test_exact_matches_blocked_topk(metric, case):
    """The jnp route of the JAX package (an independent formula)."""
    q, t, t_pad, n_valid = _corpus(case, 1, d=6)
    ref_d, ref_i = blocked_topk_neighbors(
        jnp.asarray(q), jnp.asarray(t_pad), k=7, block=256, metric=metric,
        n_valid=n_valid)
    got_d, got_i = kk.knn_topk(_t(q), _t(t_pad), 7, metric, n_valid)
    _assert_neighbors(got_d.numpy(), got_i.numpy(), np.asarray(ref_d),
                      np.asarray(ref_i), _oracle(q, t, metric), metric)


def test_exact_ties_go_to_the_lower_index():
    """Quantized data: many exactly tied distances, which both the TPU
    kernel and the port break toward the lower train index."""
    rng = np.random.default_rng(2)
    q = np.round(rng.normal(size=(128, 3)) * 2).astype(np.float32) / 2
    t = np.round(rng.normal(size=(768, 3)) * 2).astype(np.float32) / 2
    ref_d, ref_i = knn_topk_pallas(jnp.asarray(q), jnp.asarray(t), k=8,
                                   block_q=128, block_t=256,
                                   metric="manhattan", interpret=True)
    got_d, got_i = kk.knn_topk(_t(q), _t(t), 8, "manhattan")
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(ref_d))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))


def test_exact_multi_block_merge():
    """Best neighbours planted in four different 128-row blocks."""
    rng = np.random.default_rng(2)
    q = np.zeros((128, 4), np.float32)
    t = rng.normal(size=(512, 4)).astype(np.float32) * 10
    for b, scale in enumerate([0.01, 0.02, 0.03, 0.04]):
        t[b * 128 + 7] = scale
    got_d, got_i = kk.knn_topk(_t(q), _t(t), 4, "euclidean")
    assert got_i.numpy()[0].tolist() == [7, 135, 263, 391]
    assert (np.diff(got_d.numpy(), axis=1) >= 0).all()


@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
@pytest.mark.parametrize("case", CASES)
def test_lanes_matches_pallas_interpret(metric, case):
    q, t, t_pad, n_valid = _corpus(case, 4)
    k = 5
    ref_d, ref_i = knn_topk_lanes(
        jnp.asarray(q), jnp.asarray(t_pad), k=k, block_q=128, block_t=256,
        metric=metric, n_valid=n_valid, interpret=True)
    ref_d, ref_i = np.asarray(ref_d), np.asarray(ref_i)
    got_d, got_i = kk.knn_topk_lanes(_t(q), _t(t_pad), k, metric, n_valid)
    got_d, got_i = got_d.numpy(), got_i.numpy()
    quantum = 2.0 ** -(23 - kk.lane_pack_bits(t_pad.shape[0]))
    _assert_neighbors(got_d, got_i, ref_d, ref_i, _oracle(q, t, metric),
                      metric, extra=quantum)
    kk_ = min(k, t.shape[0])
    recall = np.mean([len(set(got_i[r, :kk_]) & set(ref_i[r, :kk_])) / kk_
                      for r in range(q.shape[0])])
    assert recall >= 0.99
    if metric == "manhattan":   # the same keys on the same grid
        np.testing.assert_array_equal(got_d, ref_d)


def test_lanes_quantization_grid_follows_the_padded_corpus():
    """pack_bits comes from the padded row count, as NeighborIndex pads:
    1100 valid rows padded to 1280 need 4 chunk-id bits, not 4 of 1100."""
    q, t, _, _ = _corpus("basic", 5, d=6)
    t = np.random.default_rng(5).normal(size=(1100, 6)).astype(np.float32)
    t_pad, _, n_valid = pad_train(t, None, 256)
    assert kk.lane_pack_bits(t_pad.shape[0]) == 4
    ref_d, _ = knn_topk_lanes(
        jnp.asarray(q), jnp.asarray(t_pad), k=3, block_q=128, block_t=256,
        metric="manhattan", n_valid=n_valid, interpret=True)
    got_d, _ = kk.knn_topk_lanes(_t(q), _t(t_pad), 3, "manhattan", n_valid)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(ref_d))


def test_lanes_same_lane_collisions():
    """The k nearest rows planted in one TPU lane (columns congruent mod
    128) all surface."""
    rng = np.random.default_rng(5)
    q = np.zeros((128, 4), np.float32)
    t = rng.normal(size=(1024, 4)).astype(np.float32) * 10
    cols = [3, 131, 259, 515, 899]
    for rank, c in enumerate(cols):
        t[c] = 0.01 * (rank + 1)
    _, got_i = kk.knn_topk_lanes(_t(q), _t(t), 5, "euclidean")
    assert got_i.numpy()[0].tolist() == cols


def test_lanes_rejects_oversize_corpus():
    q = torch.zeros((128, 2))
    t = torch.zeros((128 * 4096 + 256, 2))
    with pytest.raises(ValueError, match="chunk-id bits"):
        kk.knn_topk_lanes(q, t, 2)


@pytest.mark.parametrize("kernel_fn,metric", [
    ("none", "euclidean"), ("gaussian", "euclidean"),
    ("linearAdditive", "manhattan"), ("linearMultiplicative", "euclidean"),
    ("gaussian", "manhattan"), ("none", "manhattan"),
])
def test_classify_matches_pallas_interpret(kernel_fn, metric):
    rng = np.random.default_rng(9)
    nq, d, k, C = 128, 6, 5, 3
    q = rng.normal(size=(nq, d)).astype(np.float32)
    t = rng.normal(size=(700, d)).astype(np.float32)
    labels = rng.integers(0, C, 700).astype(np.int32)
    t_pad, _, n_valid = pad_train(t, None, 256)
    lab_pad = np.zeros(t_pad.shape[0], np.int32)
    lab_pad[:700] = labels
    ref = np.asarray(knn_classify_lanes(
        jnp.asarray(q), jnp.asarray(t_pad), jnp.asarray(lab_pad), k=k,
        n_classes=C, kernel_fn=kernel_fn, kernel_param=30.0, block_q=128,
        block_t=256, metric=metric, n_valid=n_valid, interpret=True))
    got = kk.knn_classify_lanes(_t(q), _t(t_pad), _t(lab_pad), k, C, None,
                                kernel_fn, 30.0, metric, n_valid).numpy()
    # "none" counts neighbours: no floored score to round differently
    if kernel_fn == "none":
        np.testing.assert_array_equal(got, ref)
    assert np.abs(got - ref).max() <= 2.0
    assert (got.argmax(1) == ref.argmax(1)).mean() >= 0.99
    if metric == "manhattan":
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kernel_fn", kk.KERNEL_FNS)
def test_classify_small_corpus_exhausts_finite(kernel_fn):
    """Only 3 real rows for k=5: empty slots vote nothing and never turn
    into NaN (the select, not multiply, of the TPU epilogue)."""
    rng = np.random.default_rng(12)
    q = rng.normal(size=(128, 4)).astype(np.float32)
    t = rng.normal(size=(3, 4)).astype(np.float32)
    t_pad, _, n_valid = pad_train(t, None, 256)
    lab_pad = np.zeros(256, np.int32)
    lab_pad[:3] = [0, 1, 1]
    got = kk.knn_classify_lanes(_t(q), _t(t_pad), _t(lab_pad), 5, 2, None,
                                kernel_fn, 30.0, "euclidean", n_valid).numpy()
    ref = np.asarray(knn_classify_lanes(
        jnp.asarray(q), jnp.asarray(t_pad), jnp.asarray(lab_pad), k=5,
        n_classes=2, kernel_fn=kernel_fn, kernel_param=30.0, block_q=128,
        block_t=256, n_valid=n_valid, interpret=True))
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 2.0
    if kernel_fn == "none":
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_allclose(got.sum(1), 3.0)


@pytest.mark.parametrize("kernel_fn", kk.KERNEL_FNS)
def test_kernel_score_matches_pallas(kernel_fn):
    dist = np.linspace(0.0, 1.5, 301).astype(np.float32)
    ref = np.asarray(_kernel_score(jnp.asarray(dist), kernel_fn, 30.0))
    got = kk.kernel_score(_t(dist), kernel_fn, 30.0).numpy()
    np.testing.assert_array_equal(got, ref)


def test_classify_matches_composed_vote_of_jax():
    """The fused vote against the JAX composed route (lane top-k + _vote)."""
    rng = np.random.default_rng(88)
    q = rng.normal(size=(128, 6)).astype(np.float32)
    t = rng.normal(size=(500, 6)).astype(np.float32)
    labels = rng.integers(0, 4, 500).astype(np.int32)
    t_pad, _, n_valid = pad_train(t, None, 256)
    lab_pad = np.zeros(t_pad.shape[0], np.int32)
    lab_pad[:500] = labels
    dist, idx = knn_topk_lanes(jnp.asarray(q), jnp.asarray(t_pad), k=6,
                               block_q=128, block_t=256, n_valid=n_valid,
                               interpret=True)
    ref = np.asarray(jax_vote(dist, jnp.asarray(lab_pad)[jnp.maximum(idx, 0)],
                              jnp.ones_like(dist), "gaussian", 30.0, 4,
                              False, False))
    got = kk.knn_classify_lanes(_t(q), _t(t_pad), _t(lab_pad), 6, 4, None,
                                "gaussian", 30.0, "euclidean", n_valid).numpy()
    assert np.abs(got - ref).max() <= 2.0
    assert (got.argmax(1) == ref.argmax(1)).mean() >= 0.98


@pytest.mark.parametrize("bad", ["dtype", "rank", "features", "k0", "kmax",
                                 "metric", "n_valid", "contiguous"])
def test_wrapper_checks_inputs(bad):
    q, t = torch.zeros((4, 3)), torch.zeros((16, 3))
    args = dict(k=2, metric="euclidean", n_valid=None)
    if bad == "dtype":
        q = q.double()
    elif bad == "rank":
        q = q[None]
    elif bad == "features":
        t = torch.zeros((16, 4))
    elif bad == "k0":
        args["k"] = 0
    elif bad == "kmax":
        args["k"] = kk.KMAX + 1
    elif bad == "metric":
        args["metric"] = "cosine"
    elif bad == "n_valid":
        args["n_valid"] = 17
    elif bad == "contiguous":
        t = torch.zeros((3, 16)).T
    with pytest.raises((TypeError, ValueError)):
        kk.knn_topk(q, t, **args)


def test_classify_checks_labels():
    q, t = torch.zeros((4, 3)), torch.zeros((16, 3))
    with pytest.raises(TypeError):
        kk.knn_classify_lanes(q, t, torch.zeros(16, dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="label bits"):
        kk.knn_classify_lanes(q, t, torch.zeros(16, dtype=torch.int32), 2,
                              n_classes=65)
    with pytest.raises(ValueError, match="unknown kernel"):
        kk.knn_classify_lanes(q, t, torch.zeros(16, dtype=torch.int32), 2,
                              kernel_fn="cosine")


def test_launch_split_covers_every_row():
    """The train-axis split: every valid row lands in exactly one split."""
    for nq, nv, sms in [(1, 1, 132), (8192, 131072, 132), (200, 300, 4),
                        (128, 0, 132), (5000, 70000, 132)]:
        splits, rows = kk._splits(nq, nv, sms)
        assert rows % kk.TT == 0 and splits >= 1
        assert (splits - 1) * rows < max(nv, 1) <= splits * rows


def test_max_features_fits_shared_memory():
    d4 = (kk.MAX_D + 3) // 4
    assert 16 * d4 * (kk.BQ + kk.TT) + 8 * kk.TT <= kk.SMEM_LIMIT
    d4 += 1
    assert 16 * d4 * (kk.BQ + kk.TT) + 8 * kk.TT > kk.SMEM_LIMIT
