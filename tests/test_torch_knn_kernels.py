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


SPLIT_CASES = [(1, 1, 132, 8), (8192, 131072, 132, 2), (200, 300, 4, 3),
               (128, 0, 132, 2), (5000, 70000, 132, 5), (8192, 131072, 132, 6),
               (512, 10000, 132, 1), (8192, 131072, 114, 4)]


def test_launch_split_covers_every_row():
    """The train-axis split: every valid row lands in exactly one split."""
    for nq, nv, sms, per_sm in SPLIT_CASES:
        for stage in (kk.TT, 4 * kk.TT):
            splits, rows = kk._splits(nq, nv, sms, per_sm, stage)
            assert rows % stage == 0 and splits >= 1
            assert (splits - 1) * rows < max(nv, 1) <= splits * rows


@pytest.mark.parametrize("nq,nv,sms,per_sm", SPLIT_CASES)
def test_launch_split_fills_whole_waves(nq, nv, sms, per_sm):
    """The grid runs in whole waves that end no later than a single wave
    or a one-split grid would, and where the corpus is large the last
    wave is as good as full: waves x rows a block scans is within 3% of a
    perfect spread of the rows over every slot."""
    splits, rows = kk._splits(nq, nv, sms, per_sm)
    blocks_x = -(-nq // kk.BQ)
    slots = sms * per_sm
    waves = -(-blocks_x * splits // slots)
    assert kk._waves(nq, splits, sms, per_sm) == blocks_x * splits / slots
    one = -(-max(nv, 1) // kk.TT) * kk.TT
    assert waves * rows <= -(-blocks_x // slots) * one
    if nv >= 64 * kk.MIN_SPLIT_ROWS and blocks_x * nv // kk.TT >= 8 * slots:
        assert waves * rows <= 1.03 * blocks_x * nv / slots + kk.TT


def test_launch_split_whole_waves_at_the_job_size():
    """8192 x 131072 at 2 blocks per SM on 132 SMs: 64 query blocks x 33
    splits is exactly 8 waves of 264 blocks."""
    splits, rows = kk._splits(8192, 131072, 132, 2)
    assert (splits, 64 * splits % 264) == (33, 0)
    assert kk._waves(8192, splits, 132, 2) == 8.0


class _FakeInfoLib:
    """Stands in for a built library's partial_info entries: a fixed
    occupancy and stage plan, and a count of the queries."""

    def __init__(self, per_sm, stage):
        self._name = f"fake-{per_sm}-{stage}"
        self.per_sm, self.stage, self.calls = per_sm, stage, 0

    def _fill(self, info):
        info[0:6] = [self.per_sm, 40, 0, self.stage, 2, 0]
        self.calls += 1
        return 0

    def knn_topk_partial_info(self, k, euclid, mode, d, info):
        return self._fill(info)

    def knn_classify_partial_info(self, k, euclid, d, info):
        return self._fill(info)


@pytest.mark.parametrize("k,mode", [(8, "exact"), (16, "lanes"),
                                    (32, "packed"), (64, "labels")])
def test_grid_takes_occupancy_and_stage_from_the_instance(monkeypatch, k,
                                                          mode):
    """A launch's grid comes from the built instance's own blocks per SM
    and stage rows, never from a copy of its stage plan."""
    lib = _FakeInfoLib(per_sm=3, stage=96)
    monkeypatch.setattr(kk, "_INFO", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(kk, "_sm_count", lambda dev: 132)
    sms, per_sm, splits, rows = kk._grid(torch.zeros(5000, 6), k, True, mode,
                                         70000, lib)
    assert (sms, per_sm, lib.calls) == (132, 3, 1)
    assert rows % 96 == 0 and (splits - 1) * rows < 70000 <= splits * rows
    assert (splits, rows) == kk._splits(5000, 70000, 132, 3, 96,
                                        kk._block_queries(k))


@pytest.mark.parametrize("mode", ["exact", "labels"])
def test_partial_info_is_cached_per_device(monkeypatch, mode):
    """Occupancy is asked once per device, instance and D: another card
    asks again, and k of one carry width share an instance."""
    lib = _FakeInfoLib(per_sm=2, stage=32)
    monkeypatch.setattr(kk, "_INFO", {})
    device = [0]
    monkeypatch.setattr(torch.cuda, "current_device", lambda: device[0])
    first = kk.partial_info(8, False, mode, 6, lib)
    assert kk.partial_info(5, False, mode, 6, lib) == first
    assert (first[0], lib.calls) == (2, 1)
    device[0], lib.per_sm = 1, 4
    assert kk.partial_info(8, False, mode, 6, lib)[0] == 4
    device[0] = 0
    assert kk.partial_info(8, False, mode, 6, lib)[0] == 2
    assert lib.calls == 2


def test_max_features_fits_shared_memory():
    """MAX_D is the widest row every carry width stages, and no less than
    the 360 features the kernels took before register blocking."""
    assert kk.MAX_D >= 360
    for k in (8, 16, 32, 64):
        assert kk._smem_bytes(kk.MAX_D, k) <= kk.SMEM_LIMIT
    assert kk._smem_bytes(kk.MAX_D + 1, 8) > kk.SMEM_LIMIT


@pytest.mark.parametrize("k", [8, 16, 32, 64])
def test_every_width_fits_shared_memory(k):
    """Every D up to MAX_D at carry width k: the block's queries and its
    ring of train stages at the bank-spread row stride fit the 227 KB cap;
    the stride is D/4 rounded up, one more where that is a multiple of 4;
    a stage is whole 32-row tiles near STAGE_BYTES, two of them where they
    fit (at least up to D=128)."""
    assert kk._block_queries(k) * {8: 1, 16: 2, 32: 4, 64: 4}[k] == kk.BQ
    for d in range(1, kk.MAX_D + 1):
        s4 = kk._row_stride4(d)
        assert s4 % 4 and 4 * s4 >= d and s4 <= (d + 3) // 4 + 1
        rows, stages, smem = kk._stage_plan(d, k)
        row = 16 * s4 + 8
        assert rows % kk.TT == 0 and stages in (1, 2)
        assert rows == kk.TT or rows * row <= kk.STAGE_BYTES < (rows + kk.TT) * row
        assert smem == 16 * s4 * kk._block_queries(k) + stages * rows * row
        assert smem == kk._smem_bytes(d, k) <= kk.SMEM_LIMIT
        if d <= 128:
            assert stages == 2


# ------------------------------------------------------------- pre-pass
def _fma_exact(a, b, c):
    """fmaf(a, b, c) of float32 scalars with exact rationals: the one
    rounding to the nearest float32, ties to even."""
    from fractions import Fraction

    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(exact))
    cands = {r, np.nextafter(r, np.float32(np.inf)),
             np.nextafter(r, np.float32(-np.inf))}
    cands = [x for x in cands if np.isfinite(x)]
    best = min(abs(Fraction(float(x)) - exact) for x in cands)
    near = [x for x in cands if abs(Fraction(float(x)) - exact) == best]
    return min(near, key=lambda x: int(np.float32(x).view(np.uint32)) & 1)


def _round_bf16_bits(x):
    """bfloat16 rounding, nearest even, on the float32 bit pattern."""
    u = x.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("c,want", [
    (0.0, 1 + 2.0 ** -11),                    # a tie: to even
    (2.0 ** -60, 1 + 2.0 ** -11 + 2.0 ** -23),  # just past the tie: up
    (-(2.0 ** -60), 1 + 2.0 ** -11),           # just short of it: down
    (3e38, float("inf")),                      # past the largest float32
])
def test_fmaf_rounds_once_at_a_tie(c, want):
    """a*a lies exactly halfway between two float32 values, and c decides
    the side only where the sum is rounded once, as the card's fmaf is."""
    a = torch.tensor([1 + 2.0 ** -12], dtype=torch.float32)
    if np.isinf(want):                         # a^2 + c overflows: +inf
        a = torch.tensor([2e19], dtype=torch.float32)
    got = kk._fmaf(a, a, torch.tensor([c], dtype=torch.float32))
    assert got.item() == np.float32(want)
    if np.isfinite(want):
        assert got.item() == _fma_exact(a.item(), a.item(), np.float32(c))


@pytest.mark.parametrize("d", [1, 6, 13])
def test_prepass_plain_norms_are_the_fmaf_chain(d):
    """Each norm is the chain s = fmaf(x_f, x_f, s) over features in order
    from 0.0, bit for bit against exact rationals rounded once a step; and
    within float32 rounding of the plain top-k's (x * x).sum(1)."""
    rng = np.random.default_rng(d)
    q = (rng.normal(size=(7, d)) * rng.choice([1e-3, 1.0, 1e3], (7, 1))
         ).astype(np.float32)
    t = rng.normal(size=(9, d)).astype(np.float32)
    qn, tn, qx, tx = kk.knn_prepass_plain(_t(q), _t(t))
    for x, norms in ((q, qn), (t, tn)):
        got = norms.numpy()
        for r in range(x.shape[0]):
            s = np.float32(0.0)
            for f in range(d):
                s = _fma_exact(x[r, f], x[r, f], s)
            assert got[r] == s
        np.testing.assert_allclose(norms.numpy(), (_t(x) * _t(x)).sum(1),
                                   rtol=1e-6 * d)
    assert torch.equal(qx, _t(q))
    assert torch.equal(tx, _t(t))


def test_prepass_plain_bf16_copies_round_to_nearest_even():
    """The bf16 operands are bfloat16 rows of depth16(D) values: each
    feature rounded to nearest even, zeros past D; the norms are the
    float32 values', never the rounded ones'."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(64, 5)).astype(np.float32)
    t = (rng.normal(size=(96, 5)) * 1e4).astype(np.float32)
    t[0, :3] = [1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8)]  # ties
    qn, tn, qx, tx = kk.knn_prepass_plain(_t(q), _t(t), bf16=True)
    for x, rows in ((q, qx), (t, tx)):
        assert rows.dtype == torch.bfloat16 and rows.shape == (x.shape[0], 16)
        np.testing.assert_array_equal(rows[:, :5].float().numpy(),
                                      _round_bf16_bits(x))
        assert not rows[:, 5:].any()
    assert torch.equal(tx[:, :5].float(), kk._round_bf16(_t(t)))
    # the norms are the fp32 values', never the rounded copies'
    assert torch.equal(tn, kk.knn_prepass_plain(_t(q), _t(t))[1])


@pytest.mark.parametrize("d", [1, 6, 16, 37, 128, 300])
def test_prepass_bf16_rows_hold_the_reference_cross_term(d):
    """knn_prepass_plain(bf16=True)'s layout against the JAX package's
    _tile_distance (pallas_knn.py:54-70) in bfloat16: bfloat16 rows of
    depth16(D) values (D rounded up to 16, a 32-byte multiple a row, as
    the tensor maps take it), zeros past D; norms of the unrounded values;
    and the cross term of the rows, with those norms, gives the
    reference's distance tile within float32 rounding of the dot form
    (the reference takes its norms by jnp.sum, the pre-pass by an fmaf
    chain, and XLA sums the products in its own order)."""
    from avenir_tpu.ops.pallas_knn import _tile_distance

    rng = np.random.default_rng(d)
    q = rng.normal(size=(48, d)).astype(np.float32)
    t = (rng.normal(size=(200, d)) * 3).astype(np.float32)
    qn, tn, qx, tx = kk.knn_prepass_plain(_t(q), _t(t), bf16=True)
    dp = -(-d // 16) * 16
    exact = (np.einsum("ij,ij->i", q, q, dtype=np.float64),
             np.einsum("ij,ij->i", t, t, dtype=np.float64))
    for x, rows, norms, want in ((q, qx, qn, exact[0]),
                                 (t, tx, tn, exact[1])):
        assert rows.dtype == torch.bfloat16 and rows.shape == (len(x), dp)
        assert (2 * dp) % 32 == 0 and not rows[:, d:].any()
        assert torch.equal(rows[:, :d], _t(x).to(torch.bfloat16))
        np.testing.assert_allclose(norms.numpy(), want, rtol=2e-6 * d)
    cross = qx.float() @ tx.float().T
    got = torch.clamp((qn[:, None] + tn[None, :]) - 2.0 * cross, min=0.0)
    want = np.asarray(_tile_distance(jnp.asarray(q), jnp.asarray(t),
                                     "euclidean", jnp.bfloat16))
    scale = (qn[:, None] + tn[None, :]).numpy()
    np.testing.assert_array_less(np.abs(got.numpy() - want),
                                 4e-6 * d * scale + 1e-6)


def test_prepass_on_cpu_tensors_is_the_plain_version():
    kk.reset_launches()
    q, t = torch.rand(8, 4), torch.rand(16, 4)
    for bf16 in (False, True):
        got = kk.knn_prepass(q, t, bf16)
        for a, b in zip(got, kk.knn_prepass_plain(q, t, bf16)):
            assert torch.equal(a, b)
    assert kk.knn_prepass.launches == 0
    assert kk.knn_prepass in kk.COUNTED_WRAPPERS
    assert kk.knn_prepass not in kk.KERNEL_WRAPPERS


# ------------------------------------------------- the tensor-core form
class _FakeFormLib(_FakeInfoLib):
    """Stands in for a built library with both forms of the partial
    kernel: every entry records its name (and a launch its arguments);
    the tensor-core instance reports its own occupancy and stage rows."""

    def __init__(self, mma_error=0):
        super().__init__(per_sm=2, stage=32)
        self.called, self.args, self.mma_error = [], [], mma_error

    def _info(self, entry, info, mma):
        self.called.append(entry)
        self.calls += 1
        info[0:6] = [3, 90, 0, 64, 2, 0] if mma else \
            [self.per_sm, 40, 0, self.stage, 2, 0]
        return 0

    def _launch(self, entry, args, err=0):
        self.called.append(entry)
        self.args.append(args)
        return err

    def knn_topk_partial_info(self, k, euclid, mode, d, info):
        return self._info("knn_topk_partial_info", info, False)

    def knn_topk_mma_info(self, k, euclid, mode, d, info):
        return self._info("knn_topk_mma_info", info, True)

    def knn_classify_partial_info(self, k, euclid, d, info):
        return self._info("knn_classify_partial_info", info, False)

    def knn_classify_mma_info(self, k, euclid, d, info):
        return self._info("knn_classify_mma_info", info, True)

    def knn_topk_launch(self, *args):
        return self._launch("knn_topk_launch", args)

    def knn_topk_mma_launch(self, *args):
        return self._launch("knn_topk_mma_launch", args, self.mma_error)

    def knn_classify_launch(self, *args):
        return self._launch("knn_classify_launch", args)

    def knn_classify_mma_launch(self, *args):
        return self._launch("knn_classify_mma_launch", args, self.mma_error)


def _on_a_fake_card(monkeypatch):
    monkeypatch.setattr(kk, "_INFO", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(kk, "_sm_count", lambda dev: 132)
    kk.reset_launches()


def _route(mode, metric, dtype, lib, nt=1000):
    """One raw launch of `mode` through `lib` on CPU tensors, as a CUDA
    call of the wrapper with this metric and dtype makes it."""
    gen = torch.Generator().manual_seed(3)
    q, t = torch.rand(200, 6, generator=gen), torch.rand(nt, 6, generator=gen)
    euclid, bf16 = metric == "euclidean", kk._bf16(dtype, metric)
    if mode == "labels":
        labels = torch.zeros(nt, dtype=torch.int32)
        kk._classify_scores(q, t, labels, 5, euclid, bf16, 2, 6, "gaussian",
                            30.0, nt, lib)
    else:
        kk._topk_keys(mode, q, t, 5, euclid, bf16, nt, lib)


@pytest.mark.parametrize("mode", ["exact", "lanes", "packed", "labels"])
@pytest.mark.parametrize("metric,dtype", [
    ("euclidean", "bfloat16"), ("euclidean", "float32"),
    ("manhattan", "bfloat16"), ("manhattan", "float32")])
def test_bf16_euclidean_takes_the_tensor_core_form(monkeypatch, mode, metric,
                                                   dtype):
    """Euclidean bfloat16 launches the tensor-core instance on the grid
    of its own partial_info, counted on knn_partial_mma; float32 and
    manhattan bfloat16 keep the CUDA-core instance."""
    _on_a_fake_card(monkeypatch)
    lib = _FakeFormLib()
    _route(mode, metric, dtype, lib)
    name = "knn_classify" if mode == "labels" else "knn_topk"
    mma = metric == "euclidean" and dtype == "bfloat16"
    form = "_mma" if mma else ""
    assert lib.called == [f"{name}{form or '_partial'}_info",
                          f"{name}{form}_launch"]
    splits, rows = lib.args[0][-7:-5] if mode != "labels" \
        else lib.args[0][-6:-4]
    assert rows % (64 if mma else 32) == 0
    assert (splits, rows) == kk._splits(200, 1000, 132, 3 if mma else 2,
                                        64 if mma else 32,
                                        kk._block_queries(5))
    assert kk.knn_partial_mma.launches == int(mma)
    assert kk.knn_partial_mma in kk.COUNTED_WRAPPERS
    assert kk.knn_partial_mma not in kk.KERNEL_WRAPPERS


@pytest.mark.parametrize("mode", ["lanes", "labels"])
def test_tensor_core_form_has_no_fallback(monkeypatch, mode):
    """A tensor-core launch that fails raises, and one a library lacks
    raises: neither reroutes to the CUDA-core form."""
    _on_a_fake_card(monkeypatch)
    lib = _FakeFormLib(mma_error=700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _route(mode, "euclidean", "bfloat16", lib)
    assert not any(c.endswith("_launch") and "mma" not in c
                   for c in lib.called)
    assert kk.knn_partial_mma.launches == 0
    bare = _FakeInfoLib(per_sm=2, stage=32)    # no tensor-core entries
    with pytest.raises(AttributeError):
        _route(mode, "euclidean", "bfloat16", bare)


class _FakePersistentLib(_FakeFormLib):
    """This checkout's library: the tensor-core form runs the persistent
    schedule, whose plan entry it has."""

    def knn_topk_mma_plan(self, *args):
        raise AssertionError("the wrapper plans with mma_schedule")

    knn_classify_mma_plan = knn_topk_mma_plan


@pytest.mark.parametrize("mode", ["exact", "lanes", "packed", "labels"])
def test_bf16_euclidean_takes_the_persistent_schedule(monkeypatch, mode):
    """With this checkout's library the tensor-core launch takes (segments,
    blocks) of mma_schedule on every SM times the instance's blocks per
    SM, where an earlier form took (splits, rows_per_split)."""
    _on_a_fake_card(monkeypatch)
    lib = _FakePersistentLib()
    _route(mode, "euclidean", "bfloat16", lib)
    segments, blocks = lib.args[0][-7:-5] if mode != "labels" \
        else lib.args[0][-6:-4]
    assert (blocks, segments) == kk.mma_schedule(200, 1000, 5, 132 * 3)
    assert (blocks, segments) == (16, 8)       # 2 query tiles x 8 tiles
    assert kk.knn_partial_mma.launches == 1


def _ranges(nq, n_valid, k, asked):
    """Each block's (query tile, train tile) pairs under mma_schedule's
    rule, and the tiles a query tile has."""
    bn = kk._mma_bn(k)
    tiles = max(1, -(-n_valid // bn))
    pairs = -(-nq // kk.MMA_BQ) * tiles
    blocks = min(asked, pairs)
    return [range(b * pairs // blocks, (b + 1) * pairs // blocks)
            for b in range(blocks)], tiles


@pytest.mark.parametrize("nq,n_valid,k,asked", [
    (8192, 131072, 5, 132), (512, 524288, 5, 132), (300, 2900, 16, 132),
    (300, 2900, 64, 132), (5, 0, 8, 132), (1, 1, 32, 132),
    (1000, 777777, 9, 131), (100000, 1000, 64, 132), (128, 128, 8, 1)])
def test_mma_schedule_covers_every_pair_once(nq, n_valid, k, asked):
    """Every (query tile, train tile) pair lies in exactly one block's
    contiguous range, the ranges differ in length by one at most, and a
    query tile's blocks, in order, take slots 0, 1, ... of at most
    `segments` lists: its lists run in column order, as the merge takes
    them."""
    blocks, segments = kk.mma_schedule(nq, n_valid, k, asked)
    ranges, tiles = _ranges(nq, n_valid, k, asked)
    assert blocks == len(ranges) <= asked
    flat = [p for r in ranges for p in r]
    assert flat == list(range(-(-nq // kk.MMA_BQ) * tiles))
    assert max(map(len, ranges)) - min(map(len, ranges)) <= 1
    per_tile = {}
    for b, r in enumerate(ranges):
        for qt in sorted({p // tiles for p in r}):
            per_tile.setdefault(qt, []).append(b)
    assert segments == max(len(bs) for bs in per_tile.values())
    for bs in per_tile.values():
        assert bs == list(range(bs[0], bs[0] + len(bs)))


def test_launch_plan_of_the_persistent_form(monkeypatch):
    """launch_plan gives the tensor-core form's grid as its persistent
    blocks (at most one wave) and its lists as the splits; the CUDA-core
    form keeps its split plan."""
    _on_a_fake_card(monkeypatch)
    lib = _FakeFormLib()
    monkeypatch.setattr(kk._build, "load", lambda name: lib)
    q, t = torch.rand(8192, 6), torch.rand(131072, 6)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: __import__(
        "contextlib").nullcontext())
    plan = kk.launch_plan(q, t, 5, "euclidean", "lanes",
                          compute_dtype="bfloat16")
    assert (plan["grid"], plan["splits"]) == kk.mma_schedule(
        8192, 131072, 5, 132 * 3)
    assert plan["rows_per_split"] is None and plan["waves"] <= 1
    fp32 = kk.launch_plan(q, t, 5, "euclidean", "lanes")
    assert fp32["rows_per_split"] % 32 == 0 and fp32["splits"] >= 1


def test_partial_info_cache_keys_the_form(monkeypatch):
    """The tensor-core and CUDA-core instances of one mode, K and D are
    cached apart; manhattan bfloat16 shares the CUDA-core entry."""
    _on_a_fake_card(monkeypatch)
    lib = _FakeFormLib()
    fma = kk.partial_info(8, True, "lanes", 128, lib)
    mma = kk.partial_info(8, True, "lanes", 128, lib, bf16=True)
    assert (fma[0], fma[3], mma[0], mma[3]) == (2, 32, 3, 64)
    assert kk.partial_info(5, True, "lanes", 128, lib, bf16=True) == mma
    assert kk.partial_info(8, True, "lanes", 128, lib) == fma
    assert lib.called == ["knn_topk_partial_info", "knn_topk_mma_info"]
    l1 = kk.partial_info(8, False, "lanes", 128, lib)
    assert kk.partial_info(8, False, "lanes", 128, lib, bf16=True) == l1
    assert lib.called[2:] == ["knn_topk_partial_info"]


@pytest.mark.parametrize("k", [8, 16, 32, 64])
def test_tensor_core_form_fits_shared_memory_at_every_width(k):
    """Every D up to MAX_D at carry width k: the block's 128 queries and
    stages of BN train rows (128; 64 at K >= 32) as bf16 rows of depth16(D)
    values, each stage with 1024 bytes of norms and labels, fit the 227 KB
    cap with the most stages (up to 8) that do, at least one, so the query
    tile is never walked in depth pieces; two stages at least up to D=256
    and four up to D=128. Every TMA box (16 features x rows, 32-byte
    swizzle) starts 1024 bytes apart, as the swizzle atoms need."""
    bn = 64 if k >= 32 else 128
    for d in range(1, kk.MAX_D + 1):
        dp = kk._depth16(d)
        assert dp % 16 == 0 and d <= dp < d + 16
        rows, stages, smem = kk._mma_stage_plan(d, k)
        assert rows == bn == kk._mma_bn(k)
        assert 1 <= stages <= kk.MMA_MAX_STAGES and smem <= kk.SMEM_LIMIT
        assert smem == kk._mma_smem(d, k, stages)
        assert stages == kk.MMA_MAX_STAGES or \
            kk._mma_smem(d, k, stages + 1) > kk.SMEM_LIMIT
        q_bytes, t_bytes = kk.MMA_BQ * dp * 2, bn * dp * 2
        assert smem >= 1024 + q_bytes + stages * (t_bytes + kk.MMA_AUX)
        assert q_bytes % 1024 == 0 and t_bytes % 1024 == 0
        assert (q_bytes // (dp // 16)) % 1024 == 0      # a query box
        assert (t_bytes // (dp // 16)) % 1024 == 0      # a train box
        assert bn * 4 <= 512                            # norms, then labels
        if d <= 256:
            assert stages >= 2
        if d <= 128:
            assert stages >= 4


@pytest.mark.parametrize("d", [1, 6, 16, 37, 128, 300, 360])
@pytest.mark.parametrize("mode", ["exact", "lanes", "packed", "labels"])
def test_zero_padding_to_the_mma_depth_keeps_the_plain_keys(monkeypatch, d,
                                                            mode):
    """The tensor-core form multiplies the pre-pass's bf16 rows, D padded
    with zeros to depth16(D). Taking the plain bf16 cross term from those
    rows (kk.bf16_rows, the layout knn_prepass_plain returns) leaves its
    keys and indices bit-equal: a zero product adds nothing."""
    rng = np.random.default_rng(d)
    q = _t(rng.normal(size=(64, d)).astype(np.float32))
    t = _t(rng.normal(size=(700, d)).astype(np.float32))
    labels = _t(rng.integers(0, 3, 700).astype(np.int32))
    mask = 0 if mode == "exact" else 3 if mode == "labels" else 0xFFF

    def select():
        return kk._select_plain(q, t, 8, "euclidean", 650, mode, mask,
                                kk.INF_BITS, True, labels)
    want = select()

    def rows(a, b, bf16):
        assert bf16
        ra, rb = kk.bf16_rows(a), kk.bf16_rows(b)
        assert ra.shape[1] == kk._depth16(d) and not ra[:, d:].any()
        return ra.float() @ rb.float().T
    monkeypatch.setattr(kk, "_cross", rows)
    got = select()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _carry_merge(key, idx, k, empty):
    """merge_splits of the first merge kernels step for step, for each
    query of lists key, idx [splits, nq, K]: a sorted carry of K slots fed
    each split's sorted list in order, an entry inserted only below the
    carry's worst key (so the earlier of equal keys stays), a split left
    at its first entry that is not. Its first k slots, [nq][k] pairs."""
    splits, nq, kw = key.shape
    out = []
    for r in range(nq):
        carry = [(empty, -1)] * kw
        for s in range(splits):
            for j in range(kw):
                if not key[s, r, j] < carry[-1][0]:
                    break
                carry = sorted(carry[:-1] + [(key[s, r, j], idx[s, r, j])],
                               key=lambda e: e[0])
        out.append(carry[:k])
    return out


@pytest.mark.parametrize("splits,kw,k", [(1, 8, 5), (7, 8, 8), (33, 16, 9),
                                         (4, 64, 64)])
def test_merge_splits_plain_is_the_merge_kernels_carry(splits, kw, k):
    """The plain split merge against merge_splits step for step: a sorted
    carry of K slots fed each split's sorted list in order, an entry
    inserted only below the carry's worst key (so the earlier of equal
    keys stays), a split left at its first entry that is not."""
    rng = np.random.default_rng(splits * kw)
    nq, empty = 20, kk.INF_BITS
    key = rng.integers(0, 40, (splits, nq, kw)).astype(np.int32)
    key[rng.random(key.shape) < 0.1] = empty      # empty slots
    key.sort(axis=2)
    idx = np.where(key == empty, -1, rng.integers(0, 10 ** 6, key.shape))
    for s in range(splits):                        # columns rise by split
        idx[s] = np.where(idx[s] < 0, -1, idx[s] + s * 10 ** 6)
    got_k, got_i = kk.merge_splits_plain(_t(key.ravel()), _t(idx.astype(
        np.int32).ravel()), nq, splits, k)
    for r, carry in enumerate(_carry_merge(key, idx, k, empty)):
        assert got_k[r].tolist() == [e[0] for e in carry]
        assert got_i[r].tolist() == [e[1] for e in carry]


#: keys that sit on the empty slots' edges
EDGE_KEYS = np.array([0, 1, kk.SENTINEL - 1, kk.SENTINEL, kk.SENTINEL + 1,
                      kk.INF_BITS - 1, kk.INF_BITS, kk.INF_BITS + 1],
                     dtype=np.int64)


def _split_lists(rng, splits, nq, kw, empty, keys, empty_queries=()):
    """Lists [splits, nq, kw] as the partial kernel leaves them: each
    sorted by (key, column), columns rising by split, a key >= empty
    (signed) only as (empty, -1) at its end; `keys` draws the candidate
    keys: "ties" (a few small values, so equal keys meet across splits
    and lanes), "signed" (the sign bit set on half of them) or "edges"
    (EDGE_KEYS). The queries in empty_queries get only empty slots."""
    shape = (splits, nq, kw)
    if keys == "ties":
        key = rng.integers(0, 6, shape)
    elif keys == "signed":
        key = rng.integers(-2 ** 31, 2 ** 31, shape)
        key[rng.random(shape) < 0.05] = -2 ** 31
    else:
        key = rng.choice(EDGE_KEYS, shape)
    col = rng.integers(0, 1000, shape) + 1000 * np.arange(splits)[:, None,
                                                                    None]
    order = np.lexsort((col, key), axis=-1)
    key = np.take_along_axis(key, order, -1)
    col = np.take_along_axis(col, order, -1)
    gone = key >= empty
    gone[:, list(empty_queries)] = True
    key[gone], col[gone] = empty, -1
    return key.astype(np.int32), col.astype(np.int32)


GROUP_CASES = [
    # (splits, K, k, group, empty, keys)
    *[(splits, 16, 13, g, kk.INF_BITS, "ties") for splits in (40, 65)
      for g in (8, 16, 32)],
    (33, 8, 5, 32, kk.SENTINEL, "ties"),     # the bench's splits
    (6, 8, 5, 8, kk.INF_BITS, "ties"),       # the job's splits
    (65, 64, 64, 32, kk.INF_BITS, "signed"),
    (40, 32, 32, 32, kk.INF_BITS, "signed"),
    (7, 8, 8, 8, kk.INF_BITS, "edges"),
    (33, 16, 16, 32, kk.SENTINEL, "edges"),
    (1, 64, 50, 8, kk.SENTINEL, "ties"),
]


@pytest.mark.parametrize("splits,kw,k,group,empty,keys", GROUP_CASES)
def test_group_merge_is_the_plain_merge_and_the_carry(splits, kw, k, group,
                                                      empty, keys):
    """The model of the merge kernels' group merge equals the plain merge
    and the first merge kernels' carry, key and index: across lanes that
    own several splits and batches of them, on ties across lanes and
    within one, keys with the sign bit set, keys at SENTINEL and INF_BITS,
    k below the carry width, and queries whose lists are all empty."""
    rng = np.random.default_rng(splits * kw + group)
    nq = 12
    key, idx = _split_lists(rng, splits, nq, kw, empty, keys, (0, 7))
    pk, pi = _t(key.ravel()), _t(idx.ravel())
    got_k, got_i = kk.merge_splits_group_plain(pk, pi, nq, splits, k, group,
                                               empty)
    want_k, want_i = kk.merge_splits_plain(pk, pi, nq, splits, k)
    assert torch.equal(got_k, want_k) and torch.equal(got_i, want_i)
    for r, carry in enumerate(_carry_merge(key, idx, k, empty)):
        assert got_k[r].tolist() == [e[0] for e in carry]
        assert got_i[r].tolist() == [e[1] for e in carry]
    assert (got_k[[0, 7]] == empty).all() and (got_i[[0, 7]] == -1).all()


def _group_vote(key, group, label_mask, n_classes, n_attrs, metric,
                kernel_fn, kernel_param):
    """The merge-and-vote kernel's epilogue (knn_classify.cu merge_vote)
    on merged label keys [nq, k]: lane l of the group holds slots
    j * group + l and scores each as _vote does (an empty slot 0); each
    lane sums its slots of a class in slot order, then the group sums the
    lanes by the xor butterfly of knn::group_sum, all in float32."""
    nq, k = key.shape
    valid = key < kk.SENTINEL
    dist = kk._average((key & ~label_mask).view(torch.float32), metric,
                       n_attrs)
    score = torch.where(valid, kk.kernel_score(dist, kernel_fn, kernel_param),
                        0.0)
    out = torch.zeros((nq, n_classes), dtype=torch.float32)
    for c in range(n_classes):
        hit = valid & ((key & label_mask) == c)
        lanes = torch.zeros((nq, group), dtype=torch.float32)
        for r in range(k):
            lanes[:, r % group] += torch.where(hit[:, r], score[:, r], 0.0)
        o = group // 2
        while o:
            lanes = lanes + lanes[:, torch.arange(group) ^ o]
            o //= 2
        out[:, c] = lanes[:, 0]
    return out


#: (kernel_fn, metric, kernel_param, sign-bit NaN keys): every kernel
#: function at 30; gaussian at 0, NaN on a zero distance; NaN distances
#: under manhattan with the kernels whose score of a NaN is NaN
VOTE_CASES = [
    *[(fn, metric, 30.0, False) for fn in kk.KERNEL_FNS
      for metric in ("euclidean", "manhattan")],
    ("gaussian", "euclidean", 0.0, False),
    ("gaussian", "manhattan", 0.0, False),
    ("none", "manhattan", 30.0, True),
    ("gaussian", "manhattan", 30.0, True),
    ("gaussian", "manhattan", 0.0, True),
]


@pytest.mark.parametrize("kernel_fn,metric,kernel_param,nan", VOTE_CASES)
@pytest.mark.parametrize("splits,k,group", [(6, 5, 8), (12, 9, 16),
                                            (33, 5, 32), (65, 16, 32)])
def test_vote_of_group_merged_keys_is_bit_equal(kernel_fn, metric,
                                                kernel_param, nan, splits, k,
                                                group):
    """The kernel's vote over the group merge's label keys (_group_vote:
    per-lane scores, per-lane sums, the group's butterfly) equals _vote
    over the carry's keys bit for bit, for every kernel function, and is
    NaN wherever _vote is: gaussian at kernel_param 0 on zero distances,
    and keys of a NaN with the sign bit set."""
    rng = np.random.default_rng(splits + k)
    nq, kw, n_classes = 16, kk._carry_width(k), 3
    mask = (1 << kk.label_bits(n_classes)) - 1
    dists = [0.0, 0.004, 0.25, 0.5, 1.0, 3.0, 40.0, 3e38]
    if nan:
        dists.append(np.uint32(0xFFC00000).view(np.float32))
    dist = rng.choice(np.float32(dists), (splits, nq, kw))
    key = (dist.view(np.int32).astype(np.int64) & ~mask) | rng.integers(
        0, n_classes, dist.shape)
    col = rng.integers(0, 1000, key.shape) + 1000 * np.arange(splits)[
        :, None, None]
    order = np.lexsort((col, key), axis=-1)
    key = np.take_along_axis(key, order, -1)
    col = np.take_along_axis(col, order, -1)
    gone = key >= kk.SENTINEL
    key[gone], col[gone] = kk.SENTINEL, -1
    pk, pi = _t(key.astype(np.int32).ravel()), _t(col.astype(np.int32).ravel())
    got = kk.merge_splits_group_plain(pk, pi, nq, splits, k, group,
                                      kk.SENTINEL)[0]
    carry = _t(np.array([[e[0] for e in row] for row in _carry_merge(
        key, col, k, kk.SENTINEL)], dtype=np.int32))
    args = (mask, n_classes, 6, metric, kernel_fn, kernel_param)
    model, want = _group_vote(got, group, *args), kk._vote(carry, *args)
    assert torch.equal(model.isnan(), want.isnan())
    assert torch.equal(model.nan_to_num(0.0).view(torch.int32),
                       want.nan_to_num(0.0).view(torch.int32))
    if kernel_fn == "gaussian" and (kernel_param == 0.0 or nan):
        assert want.isnan().any()
