"""The port's `nearestNeighbor` slice on the CPU against the JAX package.

- The whole job: JAX `run_job("nearestNeighbor")` and the port's
  `run_job(..., device="cpu")` on the same seeded e-learning CSVs (600
  train, 200 test rows) write byte-identical output and equal
  `Validation:*` counters.
- The classifier: the JAX kernel route (Pallas kernels in interpret mode)
  against the port's packed and fused modes. Predictions are equal on
  e-learning; on churn (categoricals one-hot expanded) the bars of
  tests/test_knn.py: arg-max agreement >= 0.98, total vote mass within
  1e-3, and >= 95% of rows with scores within 2.0.
- `index_from_jax_arrays` from both JAX layouts finds the JAX index's
  neighbours: squared sums within rtol 1e-4, atol 4e-6 (the dot form's
  cancellation error is absolute in the squared sum), indices equal except
  between equal distances.
- Entry points with no device given raise RuntimeError without a GPU.
"""

import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from avenir_tpu.data import generate_churn as jax_generate_churn
from avenir_tpu.data import generate_elearn as jax_generate_elearn
from avenir_tpu.models.knn import NearestNeighborClassifier as JaxClassifier
from avenir_tpu.models.knn import NearestNeighborRegressor as JaxRegressor
from avenir_tpu.models.knn import NeighborIndex as JaxIndex
from avenir_tpu.runner import run_job as jax_run_job
from avenir_tpu_torch.data import (elearn_schema, generate_churn,
                                   generate_elearn)
from avenir_tpu_torch.models import knn as tknn
from avenir_tpu_torch.models.convert import (classifier_from_jax_arrays,
                                             index_from_jax_arrays)
from avenir_tpu_torch.ops import knn_kernels as kk
from avenir_tpu_torch.runner import run_job

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(scope="module")
def elearn_csvs(tmp_path_factory):
    d = tmp_path_factory.mktemp("elearn")
    schema = str(d / "elearn.json")
    elearn_schema().save(schema)
    train, test = d / "train.csv", d / "test.csv"
    train.write_text(generate_elearn(600, seed=21, as_csv=True))
    test.write_text(generate_elearn(200, seed=22, as_csv=True))
    return {"schema": schema, "train": str(train), "test": str(test)}


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX classifier on its kernel route, the Pallas kernels in
    interpret mode (as tests/test_knn.py runs them on the CPU)."""
    import avenir_tpu.ops.pallas_knn as pk

    monkeypatch.setattr(pk, "pallas_available", lambda: True)
    for name in ("knn_classify_lanes", "knn_topk_lanes", "knn_topk_pallas"):
        monkeypatch.setattr(pk, name, functools.partial(getattr(pk, name),
                                                        interpret=True))


def _validation(counters):
    return {k: v for k, v in counters.items() if k.startswith("Validation:")}


JOB_VARIANTS = {
    "none_distr": {"nen.kernel.function": "none",
                   "nen.output.class.distr": "true"},
    "gaussian": {"nen.kernel.function": "gaussian", "nen.kernel.param": "30"},
    "linearAdditive_k7": {"nen.kernel.function": "linearAdditive",
                          "nen.top.match.count": "7",
                          "nen.output.class.distr": "true"},
    "linearMultiplicative": {"nen.kernel.function": "linearMultiplicative"},
    "threshold": {"nen.kernel.function": "gaussian", "nen.kernel.param": "30",
                  "nen.decision.threshold": "1.5",
                  "nen.positive.class.value": "pass"},
    "cost_based": {"nen.use.cost.based.classifier": "true",
                   "nen.class.attribute.values": "pass,fail",
                   "nen.misclassification.cost": "1,3"},
    "packed": {"nen.kernel.function": "gaussian", "nen.kernel.param": "30",
               "nen.device.packed.kernel": "true"},
    "fused": {"nen.kernel.function": "gaussian", "nen.kernel.param": "30",
              "nen.device.fused.vote": "true"},
}


@pytest.mark.parametrize("variant", sorted(JOB_VARIANTS))
def test_job_output_byte_identical_to_jax(elearn_csvs, tmp_path, variant):
    props = {"nen.feature.schema.file.path": elearn_csvs["schema"],
             "nen.top.match.count": "5", "nen.validation.mode": "true",
             **JOB_VARIANTS[variant]}
    inputs = [elearn_csvs["train"], elearn_csvs["test"]]
    ref = jax_run_job("nearestNeighbor", props, inputs, str(tmp_path / "jax"))
    got = run_job("nearestNeighbor", props, inputs, str(tmp_path / "port"),
                  device=CPU)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    assert _validation(got.counters) == _validation(ref.counters)
    assert got.counters["Validation:Accuracy"] > 60


def test_job_through_properties_file_and_cli(elearn_csvs, tmp_path):
    props = tmp_path / "knn.properties"
    props.write_text(
        f"nen.feature.schema.file.path={elearn_csvs['schema']}\n"
        "nen.top.match.count=5\nnen.validation.mode=true\n")
    proc = subprocess.run(
        [sys.executable, "-m", "avenir_tpu_torch",
         "org.avenir.knn.NearestNeighbor", "--conf", str(props),
         elearn_csvs["train"], elearn_csvs["test"], str(tmp_path / "out") + "/",
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    assert row["job"] == "nearestNeighbor"
    assert row["counters"]["Validation:Accuracy"] > 60
    ref = jax_run_job("nearestNeighbor", str(props),
                      [elearn_csvs["train"], elearn_csvs["test"]],
                      str(tmp_path / "jax.txt"))
    assert (tmp_path / "out" / "part-r-00000").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    assert _validation(row["counters"]) == _validation(ref.counters)


def test_generators_match_jax():
    for port, ref in ((generate_elearn(300, seed=3), jax_generate_elearn(300, seed=3)),
                      (generate_churn(300, seed=4), jax_generate_churn(300, seed=4))):
        np.testing.assert_array_equal(port.feature_matrix(), ref.feature_matrix())
        np.testing.assert_array_equal(port.labels(), ref.labels())
        assert list(port.ids()) == list(ref.ids())


@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
def test_classifier_modes_match_jax_kernel_route_elearn(pallas_interpret,
                                                         metric):
    train, test = generate_elearn(600, seed=31), generate_elearn(150, seed=32)
    jtrain, jtest = jax_generate_elearn(600, seed=31), jax_generate_elearn(150, seed=32)
    base = dict(top_match_count=5, kernel_function="gaussian",
                kernel_param=30.0, metric=metric)
    ref = JaxClassifier(jtrain, **base)
    assert ref.index.use_pallas
    ref_pred, ref_scores = ref.predict(jtest)
    for mode in ({}, {"packed": True}, {"fused": True}):
        got = tknn.NearestNeighborClassifier(train, device=CPU, **base, **mode)
        assert got.index.use_kernels and got.index.n_padded == ref.index.n_padded
        pred, scores = got.predict(test)
        np.testing.assert_array_equal(pred, ref_pred)
        assert np.abs(scores - ref_scores).max() <= 2.0
    for name in ("packed", "fused"):
        jx = JaxClassifier(jtrain, **base, **{name: True})
        port = tknn.NearestNeighborClassifier(train, device=CPU, **base,
                                              **{name: True})
        np.testing.assert_array_equal(port.predict(test)[0],
                                      jx.predict(jtest)[0])


@pytest.mark.parametrize("mode", ["default", "packed", "fused"])
def test_classifier_modes_match_jax_kernel_route_churn(pallas_interpret, mode):
    """Mixed categoricals through _expand_mixed; churn's quantized features
    tie often, so the bars are those of tests/test_knn.py."""
    opts = {"default": {}, "packed": {"packed": True},
            "fused": {"fused": True}}[mode]
    base = dict(top_match_count=5, kernel_function="gaussian",
                kernel_param=30.0, metric="euclidean")
    ref = JaxClassifier(jax_generate_churn(700, seed=31), **base, **opts)
    got = tknn.NearestNeighborClassifier(generate_churn(700, seed=31),
                                         device=CPU, **base, **opts)
    assert got.index.n_attrs == ref.index.n_attrs == 5
    rp, rs = ref.predict(jax_generate_churn(150, seed=32))
    gp, gs = got.predict(generate_churn(150, seed=32))
    assert (gp == rp).mean() >= 0.98
    np.testing.assert_allclose(gs.sum(axis=1), rs.sum(axis=1), atol=1e-3)
    assert (np.abs(gs - rs).max(axis=1) <= 2.0).mean() >= 0.95


def test_expand_mixed_matches_jax():
    from avenir_tpu.models.knn import _expand_mixed as jax_expand
    from avenir_tpu_torch.core.dataset import extract_mixed_features

    for metric in ("euclidean", "manhattan"):
        feats = extract_mixed_features(generate_churn(200, seed=8))
        got, n_attrs = tknn._expand_mixed(*feats, metric)
        ref, ref_attrs = jax_expand(*feats, metric)
        np.testing.assert_array_equal(got, np.asarray(ref))
        assert n_attrs == ref_attrs


def _mixed_query(ds):
    from avenir_tpu_torch.core.dataset import extract_mixed_features

    q_num, _, q_cat, _ = extract_mixed_features(ds)
    return q_num, q_cat


def _index_arrays(index):
    arrays = {"t_num": np.asarray(index.t_num),
              "t_cat": None if index.t_cat is None else np.asarray(index.t_cat)}
    if index.use_pallas:
        arrays["ranges"] = np.asarray(index._expand_ranges)
    else:
        arrays["ranges"] = (None if index.ranges is None
                            else np.asarray(index.ranges))
    meta = {name: getattr(index, name) for name in
            ("k", "metric", "block", "n_valid", "n_attrs", "cat_bins",
             "use_pallas", "packed")}
    return arrays, meta


@pytest.mark.parametrize("layout", ["jnp", "kernel"])
@pytest.mark.parametrize("data", ["elearn", "churn"])
def test_index_from_jax_arrays(monkeypatch, layout, data, request):
    if layout == "kernel":
        request.getfixturevalue("pallas_interpret")
    gen_j, gen_t = ((jax_generate_elearn, generate_elearn) if data == "elearn"
                    else (jax_generate_churn, generate_churn))
    ref = JaxIndex(gen_j(500, seed=41), k=6, metric="euclidean")
    assert ref.use_pallas == (layout == "kernel")
    arrays, meta = _index_arrays(ref)
    got = index_from_jax_arrays(arrays, meta, device=CPU)
    assert got.use_kernels and got.n_valid == ref.n_valid
    rd, ri = (np.asarray(a) for a in ref.neighbors(gen_j(100, seed=42)))
    gd, gi = (a.numpy() for a in got.neighbors(gen_t(100, seed=42)))
    # the dot form's error is absolute in the squared sum: a few fp32 ulps
    # of |q|^2 + |t|^2 (at most about 8 here), which the sqrt of a near-zero
    # sum magnifies; so compare the squared sums
    n_attrs = got.n_attrs
    np.testing.assert_allclose(gd ** 2 * n_attrs, rd ** 2 * n_attrs,
                               rtol=1e-4, atol=4e-6)
    # an index may differ only where the row it names is as near (a tie)
    rows, cols = np.nonzero(gi != ri)
    q = got._query(*_mixed_query(gen_t(100, seed=42))).numpy()
    t = got.t_num.numpy()
    true = ((q[rows].astype(np.float64) - t[gi[rows, cols]]) ** 2).sum(1)
    np.testing.assert_allclose(true, rd[rows, cols] ** 2 * n_attrs,
                               rtol=1e-4, atol=4e-6)
    if data == "elearn":     # continuous features: no ties
        np.testing.assert_array_equal(gi, ri)


def test_classifier_from_jax_arrays(pallas_interpret):
    train, test = jax_generate_elearn(400, seed=51), jax_generate_elearn(90, seed=52)
    ref = JaxClassifier(train, top_match_count=5, kernel_function="gaussian",
                        kernel_param=30.0, metric="euclidean")
    arrays, meta = _index_arrays(ref.index)
    arrays.update(train_labels=np.asarray(ref.train_labels),
                  train_post=np.asarray(ref.train_post))
    got = classifier_from_jax_arrays(
        arrays, meta, ref.class_values, device=CPU,
        kernel_function="gaussian", kernel_param=30.0)
    np.testing.assert_array_equal(got.predict(generate_elearn(90, seed=52))[0],
                                  ref.predict(test)[0])


@pytest.mark.parametrize("method,k", [("average", 5), ("median", 5),
                                      ("median", 4), ("linearRegression", 5)])
def test_regressor_matches_jax(method, k):
    train, test = generate_elearn(400, seed=61), generate_elearn(80, seed=62)
    jtrain, jtest = jax_generate_elearn(400, seed=61), jax_generate_elearn(80, seed=62)
    x_in = train.feature_matrix()[:, 0]
    target = np.sin(x_in / 10.0) * 5.0 + x_in
    extra = ({"regr_input": x_in} if method == "linearRegression" else {})
    q_in = test.feature_matrix()[:, 0] if extra else None
    ref = JaxRegressor(jtrain, target, top_match_count=k, method=method,
                       block=128, **extra).predict(jtest, query_input=q_in)
    got = tknn.NearestNeighborRegressor(
        train, target, top_match_count=k, method=method, device=CPU,
        **extra).predict(test, query_input=q_in)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_plain_route_for_other_metrics_matches_jax():
    """A metric the kernels do not take goes to blocked_topk_neighbors."""
    train, test = generate_churn(300, seed=71), generate_churn(60, seed=72)
    ref = JaxIndex(jax_generate_churn(300, seed=71), k=4, metric="cosine",
                   block=128)
    got = tknn.NeighborIndex(train, k=4, metric="cosine", block=128,
                             device=CPU)
    assert not got.use_kernels
    rd, _ = ref.neighbors(jax_generate_churn(60, seed=72))
    gd, _ = got.neighbors(test)
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=1e-6, atol=1e-6)


def test_k_above_kernel_maximum_raises():
    """k above the kernels' carry stays on the kernel route, whose wrapper
    raises; there is no plain-torch detour for it."""
    train, test = generate_elearn(200, seed=73), generate_elearn(20, seed=74)
    index = tknn.NeighborIndex(train, k=kk.KMAX + 1, device=CPU)
    assert index.use_kernels and index.k == kk.KMAX + 1
    with pytest.raises(ValueError, match=f"k={kk.KMAX + 1}"):
        index.neighbors(test)
    clf = tknn.NearestNeighborClassifier(train, top_match_count=kk.KMAX + 1,
                                         fused=True, device=CPU)
    with pytest.raises(ValueError, match=f"k={kk.KMAX + 1}"):
        clf.predict(test)


def test_class_conditional_weighting_not_ported(elearn_csvs, tmp_path):
    """Class-conditional weighting and approx=True, which raised
    NotImplementedError before they were ported, now run: the job writes
    the JAX job's bytes, and the approx index finds the exact one's
    neighbours (tests/test_torch_knn_classcond.py holds both further)."""
    props = {"nen.feature.schema.file.path": elearn_csvs["schema"],
             "nen.class.condtion.weighted": "true"}
    inputs = [elearn_csvs["train"], elearn_csvs["test"]]
    run_job("nearestNeighbor", props, inputs, str(tmp_path / "o"), device=CPU)
    jax_run_job("nearestNeighbor", props, inputs, str(tmp_path / "jax"))
    assert (tmp_path / "o").read_bytes() == (tmp_path / "jax").read_bytes()
    train, test = generate_elearn(50), generate_elearn(10, seed=9)
    approx = tknn.NeighborIndex(train, approx=True, device=CPU)
    exact = tknn.NeighborIndex(train, device=CPU)
    for a, b in zip(approx.neighbors(test), exact.neighbors(test)):
        assert torch.equal(a, b)


def test_default_device_needs_a_gpu(monkeypatch, elearn_csvs, tmp_path):
    """No device given and no GPU: every entry point raises, none falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train = generate_elearn(50)
    props = {"nen.feature.schema.file.path": elearn_csvs["schema"]}
    for call in (
            lambda: tknn.NeighborIndex(train),
            lambda: tknn.NearestNeighborClassifier(train),
            lambda: tknn.NearestNeighborRegressor(train, np.zeros(50)),
            lambda: run_job("nearestNeighbor", props,
                            [elearn_csvs["train"], elearn_csvs["test"]],
                            str(tmp_path / "o"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "o").exists()


def test_cli_without_device_raises_without_gpu(elearn_csvs, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c",
         "import torch, sys; torch.cuda.is_available = lambda: False; "
         "from avenir_tpu_torch.runner import run_from_cli; "
         "run_from_cli(sys.argv[1:])",
         "nearestNeighbor", "--conf", "/dev/null", elearn_csvs["train"],
         elearn_csvs["test"], str(tmp_path / "o")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "RuntimeError" in proc.stderr and "device='cpu'" in proc.stderr
    assert not (tmp_path / "o").exists()


def test_cpu_tensors_never_count_launches(elearn_csvs, tmp_path):
    kk.reset_launches()
    for extra in ({}, {"nen.device.packed.kernel": "true"},
                  {"nen.device.fused.vote": "true"}):
        run_job("nearestNeighbor",
                {"nen.feature.schema.file.path": elearn_csvs["schema"], **extra},
                [elearn_csvs["train"], elearn_csvs["test"]],
                str(tmp_path / "o"), device=CPU)
    assert [fn.launches for fn in kk.KERNEL_WRAPPERS] == [0, 0, 0, 0]


@pytest.mark.parametrize("inverse", [False, True])
def test_class_conditional_vote_from_jax_arrays(inverse):
    """The JAX classifier's Naive Bayes feature posteriors carried across
    drive the port's class-conditional vote (Neighbor.setScore) to the
    same predictions."""
    train, test = jax_generate_churn(400, seed=81), jax_generate_churn(100, seed=82)
    params = dict(kernel_function="linearMultiplicative",
                  inverse_distance_weighted=inverse)
    ref = JaxClassifier(train, top_match_count=5, metric="euclidean",
                        class_cond_weighted=True, **params)
    arrays, meta = _index_arrays(ref.index)
    arrays.update(train_labels=np.asarray(ref.train_labels),
                  train_post=np.asarray(ref.train_post))
    got = classifier_from_jax_arrays(arrays, meta, ref.class_values,
                                     device=CPU, class_cond_weighted=True,
                                     **params)
    rp, rs = ref.predict(test)
    gp, gs = got.predict(generate_churn(100, seed=82))
    # churn ties often, and a tie may go to another member of the set (with
    # another posterior) on either side: the bars of tests/test_knn.py
    assert (gp == rp).mean() >= 0.98
    close = np.isclose(gs, rs, rtol=1e-4, atol=1e-3).all(axis=1)
    assert close.mean() >= 0.95


def test_properties_and_missing_key_match_jax(tmp_path):
    from avenir_tpu.core.config import JobConfig as JaxConfig
    from avenir_tpu.core.config import load_properties as jax_load
    from avenir_tpu_torch.core.config import (JobConfig, MissingConfigError,
                                              load_properties)

    path = tmp_path / "knn.properties"
    path.write_text("# comment\n! bang\nnen.top.match.count = 7\n"
                    "field.delim.regex: ;\nnen.kernel.function=gauss\\\n"
                    "ian\nempty=\n")
    assert load_properties(str(path)) == jax_load(str(path))
    cfg, ref = JobConfig.from_file(str(path), "nen"), JaxConfig.from_file(str(path), "nen")
    assert cfg.get_int("top.match.count") == ref.get_int("top.match.count") == 7
    assert cfg.get("kernel.function") == ref.get("kernel.function")
    assert cfg.field_delim_regex == ref.field_delim_regex == ";"
    with pytest.raises(MissingConfigError, match="nen.feature.schema.file.path"):
        cfg.assert_get("feature.schema.file.path")
