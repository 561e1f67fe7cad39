"""The port's class-conditional KNN, `approx=True` and NaN votes on the CPU
against the JAX package.

- The job: JAX `run_job("nearestNeighbor")` and the port's, with
  class-conditional weighting under both key spellings
  (`nen.class.condtion.weighted`, the reference's, and
  `nen.class.condition.weighted`), write byte-identical output and equal
  `Validation:*` counters on seeded e-learning CSVs (600 train, 200
  test rows).
- The classifier: with a Naive Bayes model fitted on the train rows or
  given as `nb_model=` (a JAX model carried across by
  `nb_model_from_jax_arrays`), and rebuilt from a JAX class-conditional
  classifier by `classifier_from_jax_arrays`: predictions and class
  scores equal to the JAX classifier's, bit for bit.
- `approx=True`: the JAX package's `lax.approx_min_k` route on the CPU,
  against the port's exact one: `blocked_topk_neighbors` distances and
  indices equal; the index's neighbours as in tests/test_torch_knn.py.
- NaN distances: the plain `kernel_score` and `_vote` score NaN where
  the JAX `_kernel_score` and `_vote` do, for the four kernel functions;
  so does the plain version of the card's fused vote on label keys.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.data import generate_elearn as jax_generate_elearn
from avenir_tpu.models.knn import NearestNeighborClassifier as JaxClassifier
from avenir_tpu.models.knn import NeighborIndex as JaxIndex
from avenir_tpu.models.knn import _vote as jax_vote
from avenir_tpu.models.naive_bayes import NaiveBayesModel as JaxModel
from avenir_tpu.ops.distance import blocked_topk_neighbors as jax_blocked
from avenir_tpu.ops.pallas_knn import _kernel_score as jax_kernel_score
from avenir_tpu.runner import run_job as jax_run_job
from avenir_tpu_torch.data import elearn_schema, generate_elearn
from avenir_tpu_torch.models import knn as tknn
from avenir_tpu_torch.models.convert import (classifier_from_jax_arrays,
                                             nb_model_from_jax_arrays)
from avenir_tpu_torch.ops import knn_kernels as kk
from avenir_tpu_torch.ops.distance import blocked_topk_neighbors, pad_train
from avenir_tpu_torch.runner import run_job

CPU = "cpu"
KERNELS = ("none", "linearMultiplicative", "linearAdditive", "gaussian")


@pytest.fixture(scope="module")
def elearn_csvs(tmp_path_factory):
    d = tmp_path_factory.mktemp("elearn_cc")
    schema = str(d / "elearn.json")
    elearn_schema().save(schema)
    train, test = d / "train.csv", d / "test.csv"
    train.write_text(generate_elearn(600, seed=23, as_csv=True))
    test.write_text(generate_elearn(200, seed=24, as_csv=True))
    return {"schema": schema, "train": str(train), "test": str(test)}


def _validation(counters):
    return {k: v for k, v in counters.items() if k.startswith("Validation:")}


@pytest.mark.parametrize("key", ["class.condtion.weighted",
                                 "class.condition.weighted"])
@pytest.mark.parametrize("variant", [
    {"nen.kernel.function": "gaussian", "nen.kernel.param": "30"},
    {"nen.kernel.function": "linearMultiplicative",
     "nen.inverse.distance.weighted": "true", "nen.output.class.distr": "true"},
    {"nen.kernel.function": "none", "nen.device.fused.vote": "true",
     "nen.decision.threshold": "1.5", "nen.positive.class.value": "pass"},
], ids=["gaussian", "linearMultiplicative_inverse", "fused_threshold"])
def test_class_conditional_job_byte_identical_to_jax(elearn_csvs, tmp_path,
                                                     key, variant):
    """fused=True and a decision threshold are ignored in this mode, as in
    JAX (knn.py:342, :358-359)."""
    props = {"nen.feature.schema.file.path": elearn_csvs["schema"],
             "nen.top.match.count": "5", "nen.validation.mode": "true",
             f"nen.{key}": "true", **variant}
    inputs = [elearn_csvs["train"], elearn_csvs["test"]]
    ref = jax_run_job("nearestNeighbor", props, inputs, str(tmp_path / "jax"))
    got = run_job("nearestNeighbor", props, inputs, str(tmp_path / "port"),
                  device=CPU)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    assert _validation(got.counters) == _validation(ref.counters)
    assert got.counters["Validation:Accuracy"] > 60


def _jax_nb_arrays(model):
    return {name: getattr(model, name) for name in
            ("post_counts", "cont_moments", "class_counts", "cont_params",
             "cont_prior_params")}


@pytest.mark.parametrize("metric", ["manhattan", "euclidean"])
@pytest.mark.parametrize("nb", ["fitted", "given"])
def test_class_conditional_classifier_matches_jax(metric, nb):
    train, test = generate_elearn(500, seed=25), generate_elearn(120, seed=26)
    jtrain, jtest = (jax_generate_elearn(500, seed=25),
                     jax_generate_elearn(120, seed=26))
    params = dict(top_match_count=5, kernel_function="gaussian",
                  kernel_param=30.0, metric=metric, class_cond_weighted=True)
    jax_model = JaxModel.fit(jtrain)
    ref = JaxClassifier(jtrain, nb_model=jax_model, **params)
    extra = {}
    if nb == "given":
        extra["nb_model"] = nb_model_from_jax_arrays(
            _jax_nb_arrays(jax_model), train.schema, jax_model.class_values,
            jax_model.bins, device=CPU)
    got = tknn.NearestNeighborClassifier(train, device=CPU, **params, **extra)
    # the routes pad the train rows differently; pads weigh 1
    post = got.train_post.numpy()
    np.testing.assert_array_equal(post[:500], np.asarray(ref.train_post)[:500])
    assert (post[500:] == 1.0).all()
    pred, scores = got.predict(test)
    ref_pred, ref_scores = ref.predict(jtest)
    np.testing.assert_array_equal(pred, ref_pred)
    np.testing.assert_array_equal(scores, np.asarray(ref_scores))


def test_class_conditional_from_jax_arrays_matches_jax():
    """A JAX class-conditional classifier's index, labels and posteriors
    carried across give its scores."""
    jtrain, jtest = (jax_generate_elearn(400, seed=27),
                     jax_generate_elearn(100, seed=28))
    params = dict(kernel_function="linearAdditive",
                  inverse_distance_weighted=True)
    ref = JaxClassifier(jtrain, top_match_count=6, metric="manhattan",
                        class_cond_weighted=True, **params)
    index = ref.index
    arrays = {"t_num": np.asarray(index.t_num), "t_cat": None,
              "ranges": np.asarray(index.ranges),
              "train_labels": np.asarray(ref.train_labels),
              "train_post": np.asarray(ref.train_post)}
    meta = {name: getattr(index, name) for name in
            ("k", "metric", "block", "n_valid", "n_attrs", "cat_bins",
             "use_pallas", "packed")}
    got = classifier_from_jax_arrays(arrays, meta, ref.class_values,
                                     device=CPU, class_cond_weighted=True,
                                     **params)
    pred, scores = got.predict(generate_elearn(100, seed=28))
    ref_pred, ref_scores = ref.predict(jtest)
    np.testing.assert_array_equal(pred, ref_pred)
    np.testing.assert_array_equal(scores, np.asarray(ref_scores))


@pytest.mark.parametrize("metric", ["manhattan", "euclidean"])
def test_approx_blocked_topk_matches_jax(metric):
    """approx=True: JAX's approx_min_k per block on the CPU, the port's
    exact selection; values and indices equal."""
    rng = np.random.default_rng(29)
    q = rng.random((64, 5), dtype=np.float32)
    t = rng.random((1000, 5), dtype=np.float32)
    tp, _, n_valid = pad_train(t, None, 256)
    rd, ri = jax_blocked(jnp.asarray(q), jnp.asarray(tp), k=7, block=256,
                         metric=metric, n_valid=n_valid, approx=True)
    gd, gi = blocked_topk_neighbors(torch.from_numpy(q), torch.from_numpy(tp),
                                    k=7, block=256, metric=metric,
                                    n_valid=n_valid, approx=True)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=1e-6,
                               atol=1e-7)


def test_approx_index_matches_jax():
    """The port's approx=True index finds the JAX approx=True index's
    neighbours (the kernel route in the port, the jnp one in JAX)."""
    ref = JaxIndex(jax_generate_elearn(700, seed=30), k=5, approx=True,
                   block=256)
    got = tknn.NeighborIndex(generate_elearn(700, seed=30), k=5, approx=True,
                             device=CPU)
    assert not ref.use_pallas and got.use_kernels
    rd, ri = ref.neighbors(jax_generate_elearn(90, seed=31))
    gd, gi = got.neighbors(generate_elearn(90, seed=31))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=1e-6,
                               atol=1e-7)
    clf = tknn.NearestNeighborClassifier(generate_elearn(700, seed=30),
                                         approx=True, device=CPU)
    jclf = JaxClassifier(jax_generate_elearn(700, seed=30), approx=True,
                         block=256)
    np.testing.assert_array_equal(clf.predict(generate_elearn(90, seed=31))[0],
                                  jclf.predict(jax_generate_elearn(90,
                                                                   seed=31))[0])


def _nan_distances():
    dist = np.float32([[0.0, 0.004, np.nan, 0.25, np.inf],
                       [np.nan, np.nan, 1.5, 0.031, 0.0],
                       [-np.nan, 0.5, 0.5, np.nan, 3.0]])
    labels = np.int32([[0, 1, 1, 0, 1], [1, 0, 1, 1, 0], [0, 0, 1, 1, 1]])
    return dist, labels


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("param", [30.0, 0.0])
def test_nan_votes_match_jax(kernel, param):
    """A NaN distance scores NaN under every kernel function but none,
    as in JAX; the composed vote, as JAX's, drops a distance that is not
    finite (NaN, or inf: an empty slot)."""
    dist, labels = _nan_distances()
    got = kk.kernel_score(torch.from_numpy(dist), kernel, param).numpy()
    ref = np.asarray(jax_kernel_score(jnp.asarray(dist), kernel, param))
    np.testing.assert_array_equal(got, ref)
    assert np.isnan(got[np.isnan(dist)]).all() == (kernel != "none")
    post = np.float32([[0.5, 1.0, 2.0, 0.0, 1.0]] * 3)
    for class_cond in (False, True):
        got = tknn._vote(torch.from_numpy(dist), torch.from_numpy(labels),
                         torch.from_numpy(post), kernel, param, 2,
                         class_cond).numpy()
        ref = np.asarray(jax_vote(jnp.asarray(dist), jnp.asarray(labels),
                                  jnp.asarray(post), kernel, param, 2,
                                  class_cond, False))
        np.testing.assert_array_equal(got, ref)
        # the composed vote masks distances that are not finite: a NaN
        # distance votes nothing there (the fused vote scores it NaN)
        assert np.isnan(got).any() == (kernel == "gaussian" and param == 0)


@pytest.mark.parametrize("metric", ["manhattan", "euclidean"])
def test_label_key_vote_scores_nan_keys_as_jax(metric):
    """The plain version of the card's vote (knn_kernels._vote on label
    keys) scores a sign-bit NaN key NaN under every kernel function but
    none, as the JAX vote epilogue's jnp.maximum and sqrt do."""
    nan = np.uint32(0xFFC00000).view(np.float32)
    d2 = np.float32([[nan, 0.02, 0.5], [0.0, nan, 0.3]])
    key = (d2.view(np.int32) & ~1) | np.int32([[1, 0, 1], [0, 1, 1]])
    key_t = torch.from_numpy(np.ascontiguousarray(key))
    for kernel in KERNELS:
        got = kk._vote(key_t, 1, 2, 6, metric, kernel, 30.0).numpy()
        bits = np.ascontiguousarray(key & ~1).view(np.float32)
        dist = (np.sqrt(np.maximum(bits, 0.0) / 6) if metric == "euclidean"
                else bits / 6)
        score = np.asarray(jax_kernel_score(jnp.asarray(dist), kernel, 30.0))
        ref = np.zeros((2, 2), np.float32)
        for q in range(2):
            for j in range(3):
                ref[q, key[q, j] & 1] += score[q, j]
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(ref))
        assert np.isnan(got).any() == (kernel != "none")
