"""The port's SVM and basic neural net (`avenir_tpu_torch/models/svm.py`,
`models/neural.py`) against the JAX package on the CPU, on the fixtures
of `tests/test_svm_neural.py` (blobs, moons).

Tolerances, with what was measured:
- SVM dual coefficients within SVM_COEF_RTOL = 1e-5 of the largest
  |coefficient| (measured up to 3.7e-7: the Gram products and GEMVs sum
  in another order than XLA's, then 200-400 contracting descent steps),
  intercepts within the same share of the largest |coefficient|.
  Decision values within SVM_DEC_ATOL = 1e-4 (measured 7.2e-7), and
  predictions equal wherever the reference's |decision| is at least
  MARGIN = 1e-4; fold reports, votes and out-of-bag scores equal where
  no row lies within the margin.
- `support_indices` compares |coef| against 1e-6 of the largest: the two
  sets are equal but for indices whose |coef| lies within the
  coefficient tolerance of that threshold.
- The net's initial weights are `jax.random.normal` draws over float32
  sqrt(fan-in): within NORMAL_ULPS = 4 float32 ULP of JAX's (3 for the
  normal, 1 for the division). Training is held apart from that: from
  the JAX package's own initial params, carried over, every parameter
  after 300-800 steps in each of the three modes within NN_ATOL = 1e-5
  (measured up to 9.5e-7: matmul sums and XLA's contracted updates);
  predictions equal off a probability margin of 1e-4 around 0.5.
"""

import jax
import numpy as np
import pytest
import torch

from avenir_tpu.models import neural as jnn
from avenir_tpu.models import svm as jsvm
from avenir_tpu_torch.models import convert
from avenir_tpu_torch.models import neural as tnn
from avenir_tpu_torch.models import svm as tsvm

SVM_COEF_RTOL = 1e-5
SVM_DEC_ATOL = 1e-4
MARGIN = 1e-4
NORMAL_ULPS = 4
NN_ATOL = 1e-5


def _blobs(n=120, seed=0):
    rng = np.random.default_rng(seed)
    half = n // 2
    x = np.concatenate([
        rng.normal(-2.0, 0.6, (half, 2)),
        rng.normal(2.0, 0.6, (n - half, 2)),
    ]).astype(np.float32)
    y = np.concatenate([np.zeros(half, np.int64), np.ones(n - half, np.int64)])
    perm = rng.permutation(n)
    return x[perm], y[perm]


#: (name, hyperparameters, data) of the reference's SVM tests
FITS = [
    ("linear", dict(kernel="linear", c=10.0, epochs=300), lambda: _blobs()),
    ("rbf", dict(kernel="rbf", gamma=2.0, c=10.0, epochs=400),
     lambda: jnn.make_moons(200, noise=0.1, seed=1)),
    ("poly", dict(kernel="poly", degree=2, gamma=0.5, c=5.0, epochs=200),
     lambda: _blobs(80)),
    ("poly3", dict(kernel="poly", degree=3, gamma=0.3, c=2.0, epochs=150),
     lambda: jnn.make_moons(150, noise=0.2, seed=4)),
    ("linear_short", dict(kernel="linear", epochs=100), lambda: _blobs(60)),
]


def _close_coefs(jc, tc):
    scale = np.abs(np.asarray(jc)).max()
    assert np.abs(np.asarray(jc) - np.asarray(tc)).max() <= \
        SVM_COEF_RTOL * scale


def _same_off_margin(f_ref, pred_ref, pred) -> np.ndarray:
    """Predictions equal off the margin; returns the rows within it."""
    near = np.abs(f_ref) < MARGIN
    assert np.array_equal(pred_ref[~near], pred[~near])
    return near


def _jax_fold_decisions(kw, x, y, vmasks):
    """The reference's `_folds_validate` decision values [n, folds]: one
    Gram matrix, its trainer vmapped over the folds' train masks."""
    jnp = jax.numpy
    m = jsvm.SVMClassifier(**kw)
    xj = jnp.asarray(x, jnp.float32)
    ypm = jnp.asarray(np.where(y > 0, 1.0, -1.0), jnp.float32)
    gram = jsvm._kernel_matrix(xj, xj, m.kernel, m.gamma, m.degree, m.coef0)
    ays, bs = jax.vmap(lambda mk: jsvm._train_kernel_primal(
        gram, ypm, mk, m.c, m.learning_rate, m.epochs))(
        jnp.asarray((~vmasks).astype(np.float32)))
    return np.asarray(gram @ ays.T + bs)


@pytest.mark.parametrize("name,kw,data", FITS, ids=[f[0] for f in FITS])
def test_fit_against_jax(name, kw, data):
    x, y = data()
    j = jsvm.SVMClassifier(**kw).fit(x, y)
    t = tsvm.SVMClassifier(**kw, device="cpu").fit(x, y)
    _close_coefs(j.dual_coef, t.dual_coef)
    scale = np.abs(j.dual_coef).max()
    assert abs(j.intercept - t.intercept) <= SVM_COEF_RTOL * scale
    fj, ft = j.decision_function(x), t.decision_function(x)
    assert ft.dtype == np.float32 and isinstance(t.intercept, float)
    assert np.abs(fj - ft).max() <= SVM_DEC_ATOL
    _same_off_margin(fj, j.predict(x), t.predict(x))
    assert t.x_train.dtype == np.float32
    # support vectors: the same set but within the tolerance of the cut
    cut = 1e-6 * max(np.abs(j.dual_coef).max(), 1e-30)
    near = np.flatnonzero(np.abs(np.abs(j.dual_coef) - cut)
                          <= SVM_COEF_RTOL * scale)
    assert set(j.support_indices) - set(near) == \
        set(t.support_indices) - set(near)


def test_sample_mask_fit():
    x, y = _blobs(90, seed=5)
    mask = (np.arange(90) % 3 != 0).astype(np.float32)
    kw = dict(kernel="rbf", gamma=1.0, c=3.0, epochs=150)
    j = jsvm.SVMClassifier(**kw).fit(x, y, sample_mask=mask)
    t = tsvm.SVMClassifier(**kw, device="cpu").fit(x, y, sample_mask=mask)
    _close_coefs(j.dual_coef, t.dual_coef)


@pytest.mark.parametrize("nfold", [3, 5])
def test_kfold_against_jax(nfold):
    x, y = _blobs(150, seed=2)
    kw = dict(kernel="linear", c=10.0, epochs=200)
    vmasks = tsvm.kfold_masks(len(x), nfold)
    ft = tsvm.fold_decisions(tsvm.SVMClassifier(**kw, device="cpu"), x, y,
                             vmasks)
    jm = jsvm.SVMClassifier(**kw)
    rj = jsvm.kfold_validate(jm, x, y, nfold)
    rt = tsvm.kfold_validate(tsvm.SVMClassifier(**kw, device="cpu"), x, y,
                             nfold)
    assert len(rt.fold_errors) == nfold
    fj = _jax_fold_decisions(kw, x, y, vmasks)
    assert np.abs(fj - ft).max() <= SVM_DEC_ATOL
    for i, vm in enumerate(vmasks):
        near = _same_off_margin(fj[:, i], fj[:, i] > 0, ft[:, i] > 0)
        if not near[vm].any():
            assert rt.fold_errors[i] == rj.fold_errors[i]
    assert rt.avg_error == pytest.approx(rt.avg_fp_error + rt.avg_fn_error,
                                         abs=1e-9)
    assert rt.avg_error < 0.1


def test_rfold_and_cost_against_jax():
    x, y = _blobs(100, seed=3)
    kw = dict(kernel="linear", c=10.0, epochs=150)
    rj = jsvm.rfold_validate(jsvm.SVMClassifier(**kw), x, y, nfold=5,
                             niter=3, seed=1)
    rt = tsvm.rfold_validate(tsvm.SVMClassifier(**kw, device="cpu"), x, y,
                             nfold=5, niter=3, seed=1)
    assert len(rt.fold_errors) == 3
    vmasks = tsvm.rfold_masks(len(x), 5, 3, seed=1)
    fj = _jax_fold_decisions(kw, x, y, vmasks)
    assert np.abs(fj).min() >= MARGIN
    assert rt.fold_errors == rj.fold_errors
    assert rt.cost(fp_cost=2.0, fn_cost=1.0) == rj.cost(fp_cost=2.0,
                                                        fn_cost=1.0)
    assert rt.cost(fp_cost=2.0, fn_cost=1.0) >= rt.avg_fn_error


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_bagging_with_oob_against_jax(kernel):
    x, y = _blobs(120, seed=4)
    kw = dict(kernel=kernel, c=10.0, gamma=0.5, epochs=150)
    j = jsvm.BaggedSVM(jsvm.SVMClassifier(**kw), num_estimators=5,
                       sample_fraction=0.7, use_oob=True).fit(x, y, seed=0)
    t = tsvm.BaggedSVM(tsvm.SVMClassifier(**kw, device="cpu"),
                       num_estimators=5, sample_fraction=0.7,
                       use_oob=True).fit(x, y, seed=0)
    assert t.dual_coefs.shape == (5, len(x))
    for e in range(5):
        _close_coefs(j.dual_coefs[e], t.dual_coefs[e])
    f = (np.asarray(jsvm._kernel_matrix(x, x, kernel, 0.5, 3, 1.0))
         @ j.dual_coefs.T + j.intercepts)
    assert np.abs(f).min() >= MARGIN
    assert t.oob_score_ == j.oob_score_
    assert np.array_equal(t.predict(x), j.predict(x))
    assert t.score(x, y) > 0.9 and t.oob_score_ > 0.8


def test_npz_files_cross_load(tmp_path):
    x, y = _blobs(60)
    kw = dict(kernel="rbf", gamma=1.0, epochs=100)
    j = jsvm.SVMClassifier(**kw).fit(x, y)
    t = tsvm.SVMClassifier(**kw, device="cpu").fit(x, y)
    j.save(str(tmp_path / "jax.npz"))
    t.save(str(tmp_path / "port"))
    from_jax = tsvm.SVMClassifier.load(str(tmp_path / "jax.npz"),
                                       device="cpu")
    from_port = jsvm.SVMClassifier.load(str(tmp_path / "port.npz"))
    for k in ("kernel", "c", "gamma", "degree", "coef0", "learning_rate",
              "epochs", "intercept"):
        assert getattr(from_jax, k) == getattr(j, k)
        assert getattr(from_port, k) == getattr(t, k)
    assert np.array_equal(from_jax.dual_coef, j.dual_coef)
    assert np.array_equal(from_port.dual_coef, t.dual_coef)
    fj = j.decision_function(x)
    assert np.abs(from_jax.decision_function(x) - fj).max() <= SVM_DEC_ATOL
    _same_off_margin(fj, j.predict(x), from_jax.predict(x))
    _same_off_margin(fj, j.predict(x), from_port.predict(x))


def test_converters_carry_fitted_models():
    x, y = _blobs(80, seed=7)
    kw = dict(kernel="poly", degree=2, gamma=0.5, c=5.0, epochs=120)
    j = jsvm.SVMClassifier(**kw).fit(x, y)
    t = convert.svm_from_jax(j, device="cpu")
    assert (t.kernel, t.degree, t.epochs) == ("poly", 2, 120)
    assert np.abs(t.decision_function(x) - j.decision_function(x)).max() \
        <= SVM_DEC_ATOL
    jb = jsvm.BaggedSVM(jsvm.SVMClassifier(kernel="linear", epochs=80),
                        num_estimators=3, use_oob=True).fit(x, y, seed=2)
    tb = convert.bagged_svm_from_jax(jb, device="cpu")
    assert tb.oob_score_ == jb.oob_score_ and tb.num_estimators == 3
    assert np.array_equal(tb.predict(x), jb.predict(x))
    assert convert.svm_from_jax(jsvm.SVMClassifier(), "cpu").dual_coef is None


def test_svm_behaves_as_the_references():
    x, y = _blobs()
    assert tsvm.SVMClassifier(kernel="linear", c=10.0, epochs=300,
                              device="cpu").fit(x, y).score(x, y) > 0.95
    x, y = tnn.make_moons(200, noise=0.1, seed=1)
    assert tsvm.SVMClassifier(kernel="rbf", gamma=2.0, c=10.0, epochs=400,
                              device="cpu").fit(x, y).score(x, y) > 0.9
    x, y = _blobs(60)
    m = tsvm.SVMClassifier(kernel="linear", epochs=100, device="cpu").fit(
        x, y)
    assert np.array_equal(m.predict(x),
                          (m.decision_function(x) > 0).astype(np.int64))
    assert 0 < len(m.support_indices) <= len(x)
    with pytest.raises(ValueError):
        tsvm.SVMClassifier(kernel="sigmoid")
    with pytest.raises(RuntimeError, match="not fitted"):
        tsvm.SVMClassifier(device="cpu").decision_function(x)


def test_integer_pow_is_xlas_order():
    v = torch.tensor(np.random.default_rng(0).normal(size=500)
                     .astype(np.float32))
    for y in (1, 2, 3, 4, 5, 7):
        want = np.asarray(jax.lax.integer_pow(v.numpy(), y))
        assert tsvm._integer_pow(v, y).numpy().tolist() == want.tolist()


# ------------------------------------------------------------- the net
def test_make_moons_bytes_equal():
    for n, noise, seed in ((300, 0.15, 5), (101, 0.2, 0), (2, 0.0, 9)):
        xj, yj = jnn.make_moons(n, noise, seed)
        xt, yt = tnn.make_moons(n, noise, seed)
        assert xj.tobytes() == xt.tobytes() and yj.tobytes() == yt.tobytes()


def _ulps(a, b):
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, -(ai & 0x7FFFFFFF), ai)
    bi = np.where(bi < 0, -(bi & 0x7FFFFFFF), bi)
    return np.abs(ai - bi)


@pytest.mark.parametrize("seed,n_in,n_hidden", [(0, 2, 16), (3, 2, 8),
                                                (11, 30, 64)])
def test_init_within_the_normal_budget(seed, n_in, n_hidden):
    jp = jnn._init_params(jax.random.key(seed), n_in, n_hidden, 2)
    tp = tnn._init_params(np.asarray(jax.random.key_data(
        jax.random.key(seed))), n_in, n_hidden, 2,
        torch.device("cpu")).arrays()
    for k in ("w1", "w2"):
        assert _ulps(np.asarray(jp[k]), tp[k]).max() <= NORMAL_ULPS
    for k in ("b1", "b2"):
        assert not np.asarray(jp[k]).any() and not tp[k].any()
    assert tp["w1"].shape == (n_in, n_hidden) and tp["w2"].shape == (
        n_hidden, 2)


def _carried(seed, n_in, n_hidden):
    jp = jnn._init_params(jax.random.key(seed), n_in, n_hidden, 2)
    return jp, convert.neural_params_from_jax(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu")


@pytest.mark.parametrize("mode,iters,lr", [("batch", 800, 0.5),
                                           ("minibatch", 600, 0.2),
                                           ("stochastic", 300, 0.5)])
def test_training_from_carried_params(mode, iters, lr):
    x, y = jnn.make_moons(300, noise=0.15, seed=5)
    jp, net = _carried(0, 2, 16)
    jm = jnn.BasicNeuralNetwork(n_hidden=16, learning_rate=lr,
                                iterations=iters, training_mode=mode,
                                batch_size=32, seed=0)
    # the reference's fit from its own initial params: the same steps as
    # BasicNeuralNetwork.fit, which draws those params itself
    xj = jax.numpy.asarray(x, jax.numpy.float32)
    yj = jax.numpy.asarray(y, jax.numpy.int32)
    if mode == "batch":
        jm.params = jnn._train_batch(jp, xj, yj, lr, iters, jm.reg)
    else:
        bs = 1 if mode == "stochastic" else 32
        order = np.random.default_rng(0).integers(0, len(x), (iters, bs))
        jm.params = jnn._train_minibatch(jp, xj[order], yj[order], lr,
                                         jm.reg)
    tm = tnn.BasicNeuralNetwork(n_hidden=16, learning_rate=lr,
                                iterations=iters, training_mode=mode,
                                batch_size=32, seed=0,
                                device="cpu").fit(x, y, init=net)
    for k, v in tm.params.arrays().items():
        assert np.abs(np.asarray(jm.params[k]) - v).max() <= NN_ATOL, k
    pj, pt = jm.predict_proba(x), tm.predict_proba(x)
    assert np.abs(pj - pt).max() <= NN_ATOL
    keep = np.abs(pj[:, 1] - 0.5) >= 1e-4
    assert np.array_equal(jm.predict(x)[keep], tm.predict(x)[keep])


def test_full_fit_against_jax():
    x, y = jnn.make_moons(300, noise=0.15, seed=5)
    for mode in ("batch", "minibatch"):
        kw = dict(n_hidden=16, learning_rate=0.5, iterations=400,
                  training_mode=mode, seed=1)
        jm = jnn.BasicNeuralNetwork(**kw).fit(x, y)
        tm = tnn.BasicNeuralNetwork(**kw, device="cpu").fit(x, y)
        for k, v in tm.params.arrays().items():
            assert np.abs(np.asarray(jm.params[k]) - v).max() <= NN_ATOL, k
        pj = jm.predict_proba(x)
        keep = np.abs(pj[:, 1] - 0.5) >= 1e-4
        assert np.array_equal(jm.predict(x)[keep], tm.predict(x)[keep])


def test_net_behaves_as_the_references():
    x, y = tnn.make_moons(300, noise=0.15, seed=5)
    nn = tnn.BasicNeuralNetwork(n_hidden=16, learning_rate=0.5,
                                iterations=800, training_mode="batch",
                                seed=0, device="cpu").fit(x, y)
    assert nn.score(x, y) > 0.9
    x, y = tnn.make_moons(256, noise=0.15, seed=6)
    nn = tnn.BasicNeuralNetwork(n_hidden=16, learning_rate=0.2,
                                iterations=600, training_mode="minibatch",
                                batch_size=32, seed=0, device="cpu").fit(x, y)
    assert nn.score(x, y) > 0.85
    x, y = tnn.make_moons(100, noise=0.2, seed=7)
    nn = tnn.BasicNeuralNetwork(iterations=50, device="cpu").fit(x, y)
    p = nn.predict_proba(x)
    np.testing.assert_allclose(p.sum(axis=1), 1.0, atol=1e-5)
    with pytest.raises(RuntimeError, match="not fitted"):
        tnn.BasicNeuralNetwork(device="cpu").predict(x)
