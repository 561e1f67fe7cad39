"""Missing (NaN) features through every KNN route: the port's plain versions
(on the CPU) against the JAX package's Pallas kernels in interpret mode and
its blocked jnp route, on the same inputs with NaN in queries and in train
rows.

What the reference gives on a NaN distance, and so the port:
- exact (`_knn_kernel`): taken first, NaNs in column order, finished as
  (NaN, column);
- packed, lanes and the vote: an empty slot, (+inf, -1); a query whose
  every distance is NaN votes all zeros;
- blocked (`ops/distance.blocked_topk_neighbors`): first under manhattan,
  after +inf under euclidean (the sign of -d's NaN under `lax.top_k`).

NaN must match NaN and indices must be equal; vote scores bit-equal.
Finite distances are held to test_torch_knn_kernels.py's tolerances:
manhattan rtol 1e-6, euclidean rtol 1e-4 atol 1e-5, plus one quantum of
the masked mantissa bits for the packed (2^-11) and lane keys.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avenir_tpu.ops.distance import blocked_topk_neighbors as jax_blocked
from avenir_tpu.ops.pallas_knn import (knn_classify_lanes, knn_topk_lanes,
                                       knn_topk_pallas)
from avenir_tpu_torch.ops import knn_kernels as kk
from avenir_tpu_torch.ops.distance import blocked_topk_neighbors

NQ, NT, K = 128, 256, 5
NAN_QUERIES = (3, 50)          # a NaN feature each
NAN_ROWS = (7, 200)            # 200 lies in the second tile of 128 rows
TOL = {"manhattan": (1e-6, 0.0), "euclidean": (1e-4, 1e-5)}


def _inputs(d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(NQ, d)).astype(np.float32)
    t = rng.normal(size=(NT, d)).astype(np.float32)
    for r, f in zip(NAN_QUERIES, (2, 0)):
        q[r, f % d] = np.nan
    for r, f in zip(NAN_ROWS, (1, 5)):
        t[r, f % d] = np.nan
    labels = (np.arange(NT) % 2).astype(np.int32)
    return q, t, labels


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_same(got_d, got_i, ref_d, ref_i, metric, extra=0.0):
    """NaN where the reference has NaN, +inf where it has +inf, equal
    indices, finite distances within the metric's tolerance."""
    got_d, got_i = np.asarray(got_d), np.asarray(got_i)
    ref_d, ref_i = np.asarray(ref_d), np.asarray(ref_i)
    np.testing.assert_array_equal(np.isnan(got_d), np.isnan(ref_d))
    np.testing.assert_array_equal(np.isposinf(got_d), np.isposinf(ref_d))
    np.testing.assert_array_equal(got_i, ref_i)
    fin = np.isfinite(ref_d)
    rtol, atol = TOL[metric]
    np.testing.assert_allclose(got_d[fin], ref_d[fin], rtol=rtol + extra,
                               atol=atol)


def _pallas(route, q, t, labels, metric, dtype, block_t, kernel_fn="none"):
    kw = dict(k=K, block_q=NQ, block_t=block_t, metric=metric,
              interpret=True, compute_dtype=dtype)
    q, t = jnp.asarray(q), jnp.asarray(t)
    if route == "vote":
        return np.asarray(knn_classify_lanes(
            q, t, jnp.asarray(labels), n_classes=2, kernel_fn=kernel_fn,
            kernel_param=30.0, **kw))
    if route == "lanes":
        return knn_topk_lanes(q, t, **kw)
    return knn_topk_pallas(q, t, packed=route == "packed", **kw)


def _port(route, q, t, labels, metric, dtype, kernel_fn="none"):
    if route == "vote":
        return kk.knn_classify_lanes(_t(q), _t(t), _t(labels), K, 2, None,
                                     kernel_fn, 30.0, metric,
                                     compute_dtype=dtype).numpy()
    fn = {"exact": kk.knn_topk, "packed": kk.knn_topk_packed,
          "lanes": kk.knn_topk_lanes}[route]
    d, i = fn(_t(q), _t(t), K, metric, compute_dtype=dtype)
    return d.numpy(), i.numpy()


def _quantum(route):
    return {"exact": 0.0, "packed": 2.0 ** -11,
            "lanes": 2.0 ** -(23 - kk.lane_pack_bits(NT))}[route]


KERNEL_CASES = [  # (route, metric, dtype, D, train rows a Pallas tile)
    (route, metric, dtype, d, block_t)
    for route in ("exact", "packed", "lanes", "vote")
    for metric, dtype in (("euclidean", "float32"), ("manhattan", "float32"),
                          ("euclidean", "bfloat16"))
    for d, block_t in ((6, 256), (40, 256), (6, 128))
    if block_t == 256 or route in ("exact", "packed")  # lanes: pairs of 128
]


@pytest.mark.parametrize("route,metric,dtype,d,block_t", KERNEL_CASES)
def test_nan_features_match_the_pallas_kernels(route, metric, dtype, d,
                                               block_t):
    q, t, labels = _inputs(d)
    ref = _pallas(route, q, t, labels, metric, dtype, block_t)
    got = _port(route, q, t, labels, metric, dtype)
    if route == "vote":
        np.testing.assert_array_equal(got.view(np.int32),
                                      ref.view(np.int32))
        for r in NAN_QUERIES:             # every distance NaN: no vote
            assert got[r].tolist() == [0.0, 0.0]
        return
    _assert_same(*got, *ref, metric, _quantum(route))
    got_d, got_i = got
    others = np.setdiff1d(np.arange(NQ), NAN_QUERIES)
    if route == "exact":                  # NaN first, in column order
        for r in NAN_QUERIES:
            assert np.isnan(got_d[r]).all()
            assert got_i[r].tolist() == list(range(K))
        assert np.isnan(got_d[others, :2]).all()
        assert (got_i[others, :2] == list(NAN_ROWS)).all()
        assert np.isfinite(got_d[others, 2:]).all()
    else:                                 # an empty slot
        for r in NAN_QUERIES:
            assert np.isposinf(got_d[r]).all() and (got_i[r] == -1).all()
        assert not np.isin(got_i, NAN_ROWS).any()
        assert np.isfinite(got_d[others]).all()


@pytest.mark.parametrize("metric", ["manhattan", "euclidean"])
def test_nan_vote_gaussian_matches_the_pallas_kernel(metric):
    q, t, labels = _inputs(6, seed=1)
    ref = _pallas("vote", q, t, labels, metric, "float32", 256, "gaussian")
    got = _port("vote", q, t, labels, metric, "float32", "gaussian")
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("metric", ["manhattan", "euclidean"])
@pytest.mark.parametrize("d,block", [(6, 256), (40, 256), (6, 128), (6, 64)])
def test_nan_features_match_the_blocked_route(metric, d, block):
    q, t, _ = _inputs(d)
    ref = jax_blocked(jnp.asarray(q), jnp.asarray(t), k=K, block=block,
                      metric=metric)
    got_d, got_i = blocked_topk_neighbors(_t(q), _t(t), k=K, block=block,
                                          metric=metric)
    _assert_same(got_d.numpy(), got_i.numpy(), *ref, metric)
    got_d, got_i = got_d.numpy(), got_i.numpy()
    others = np.setdiff1d(np.arange(NQ), NAN_QUERIES)
    if metric == "manhattan":             # NaN first, in column order
        assert (got_i[others, :2] == list(NAN_ROWS)).all()
        for r in NAN_QUERIES:
            assert np.isnan(got_d[r]).all()
            assert got_i[r].tolist() == list(range(K))
    else:                                 # NaN after +inf: never taken
        assert not np.isin(got_i, NAN_ROWS).any()
        for r in NAN_QUERIES:             # kept only from a lone block
            if block == NT:
                assert np.isnan(got_d[r]).all()
            else:
                assert np.isposinf(got_d[r]).all()


@pytest.mark.parametrize("mode", ["exact", "packed", "lanes", "labels"])
@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
def test_nan_keys_of_each_mode(mode, metric):
    """The raw keys of the plain selection: NAN_KEY (a sign-bit NaN, below
    every key) in exact mode only; in the others a NaN's bits stay above
    the empty key, so no key of a NaN query is ever taken."""
    q, t, labels = _inputs(6)
    q, t = _t(q), _t(t)
    bits, mask, empty = kk._key_spec(mode if mode != "labels" else "lanes", t)
    if mode == "labels":
        mask, empty = 1, kk.SENTINEL
    key, idx = kk._select_plain(q, t, K, metric, NT, mode, mask, empty,
                                labels=_t(labels))
    if mode == "exact":
        assert (key[list(NAN_QUERIES)] == kk.NAN_KEY).all()
        assert kk.NAN_KEY < 0 and np.isnan(
            np.int32(kk.NAN_KEY).view(np.float32))
    else:
        assert (key[list(NAN_QUERIES)] == empty).all()
        assert (key >= 0).all()
    assert (key[:, :-1] <= key[:, 1:]).all()
