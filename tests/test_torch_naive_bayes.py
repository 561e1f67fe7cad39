"""The port's Naive Bayes slice on the CPU against the JAX package.

Corpora: the churn generator's 800 train / 200 test rows (as
tests/test_runner.py), a 20,000 / 5,000-row corpus, and a moments variant
of each whose `acctAge` has no bucketWidth (a Gaussian feature).

- The model file and its `.stamp.json` sidecar are byte-identical to the
  JAX `NaiveBayesModel`'s, fitted whole and streamed in 5 chunks; on the
  CPU the port's float32 moment sums run in row order, as XLA's einsum
  does there, so even the mean/std lines come out the same. The test
  holds them to one unit of their 6th printed decimal.
- `predict`: codes and int percents equal JAX's `NaiveBayesPredictor` on
  every row of the binned corpora. The port sums the binned log terms over
  f in ascending order; XLA's einsum sums the flattened one-hot product
  in its own vectorized order, which depends on the codes. On the moments
  variant at 20,000 / 5,000 rows this leaves three rows (3363, 3586 and
  3757, each with acctAge 13) whose log posterior differs by one float32
  ulp and whose exp(.) * 100 straddles 6: JAX floors 6.0 to 6, the port
  5.999994 to 5. The test allows a row to differ only so: its float64
  posterior percent within 1e-4 of an integer, the percents one apart,
  and at most 0.1% of rows.
- `feature_prob` within rtol 1e-6; the four `bayesianPredictor` modes
  (plain, validation, feature-prob-only, cost) write byte-identical files
  with equal counters; `nb_model_from_jax_arrays` predicts what JAX does.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.core.dataset import Dataset as JaxDataset
from avenir_tpu.core.schema import FeatureField as JaxField
from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.models.naive_bayes import NaiveBayesModel as JaxModel
from avenir_tpu.models.naive_bayes import NaiveBayesPredictor as JaxPredictor
from avenir_tpu.runner import run_job as jax_run_job
from avenir_tpu.utils.metrics import CostBasedArbitrator as JaxArbitrator
from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.core.schema import FeatureField, FeatureSchema
from avenir_tpu_torch.data import churn_schema, generate_churn
from avenir_tpu_torch.models.artifact import ModelFormatSkew
from avenir_tpu_torch.models.convert import nb_model_from_jax_arrays
from avenir_tpu_torch.models.naive_bayes import (NaiveBayesModel,
                                                 NaiveBayesPredictor)
from avenir_tpu_torch.ops import knn_kernels as kk
from avenir_tpu_torch.ops import matmul_ceiling as mc
from avenir_tpu_torch import obs
from avenir_tpu_torch.runner import DELTA_COUNTERS, MEM_COUNTERS, run_job
from avenir_tpu_torch.utils.metrics import CostBasedArbitrator
from test_torch_native_ingest import engine_of, parse_engines

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
#: corpus -> (train rows, train seed, test rows, test seed)
CORPORA = {"small": (800, 3, 200, 4), "large": (20000, 5, 5000, 6)}
VARIANTS = ("binned", "moments")
CHUNKS = 5


def _schema_json(variant):
    obj = churn_schema().to_json()
    if variant == "moments":
        for fld in obj["fields"]:
            if fld["name"] == "acctAge":
                del fld["bucketWidth"]
    return obj


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """CSV text of every corpus, and one schema file per variant."""
    d = tmp_path_factory.mktemp("nb")
    out = {"dir": d}
    for variant in VARIANTS:
        path = d / f"churn_{variant}.json"
        path.write_text(json.dumps(_schema_json(variant)))
        out[variant] = str(path)
    for name, (n_train, s_train, n_test, s_test) in CORPORA.items():
        for part, n, seed in (("train", n_train, s_train),
                              ("test", n_test, s_test)):
            path = d / f"{name}_{part}.csv"
            path.write_text(generate_churn(n, seed=seed, as_csv=True))
            out[f"{name}_{part}"] = str(path)
    return out


def _both(csv_path, variant):
    """(port Dataset, JAX Dataset) of one CSV, each on a fresh schema."""
    text = Path(csv_path).read_text()
    obj = _schema_json(variant)
    return (Dataset.from_csv(text, FeatureSchema.from_json(obj)),
            JaxDataset.from_csv(text, JaxSchema.from_json(obj),
                                engine="python"))


def _chunks(csv_path, n):
    lines = Path(csv_path).read_text().splitlines(True)
    step = -(-len(lines) // n)
    return ["".join(lines[i:i + step]) for i in range(0, len(lines), step)]


def _streamed(csv_path, variant, jax=False):
    """A model whose counts folded chunk by chunk (accumulate with
    defer=True), in the port or the JAX package."""
    obj = _schema_json(variant)
    if jax:
        schema = JaxSchema.from_json(obj)
        model = JaxModel.empty(schema)
    else:
        schema = FeatureSchema.from_json(obj)
        model = NaiveBayesModel.empty(schema, CPU)
    for text in _chunks(csv_path, CHUNKS):
        ds = (JaxDataset.from_csv(text, schema, engine="python") if jax
              else Dataset.from_csv(text, schema))
        codes, _ = ds.feature_codes(model.binned_fields)
        model.accumulate(codes, ds.labels(),
                         ds.feature_matrix(model.cont_fields), defer=True)
    if not jax:
        assert model._pending is not None    # the chunks folded on the device
    return model


def _moment_values(line):
    return [float(v) for v in line.split(",")[3:]]


def _assert_model_text_equal(got, ref, variant):
    assert len(got) == len(ref)
    for a, b in zip(got.splitlines(), ref.splitlines()):
        if a == b:
            continue
        # only a moment line may differ, by one unit of its 6th decimal
        assert variant == "moments" and a.split(",")[:3] == b.split(",")[:3]
        np.testing.assert_allclose(_moment_values(a), _moment_values(b),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("how", ["whole", "streamed"])
def test_model_file_and_stamp_match_jax(corpora, tmp_path, variant, corpus,
                                        how):
    train = corpora[f"{corpus}_train"]
    ds, jds = _both(train, variant)
    if how == "whole":
        got, ref = NaiveBayesModel.fit(ds, device=CPU), JaxModel.fit(jds)
    else:
        got, ref = _streamed(train, variant), _streamed(train, variant, True)
    got.save(str(tmp_path / "port.csv"))
    ref.save(str(tmp_path / "jax.csv"))
    got_text = (tmp_path / "port.csv").read_text()
    _assert_model_text_equal(got_text, (tmp_path / "jax.csv").read_text(),
                             variant)
    if got_text == (tmp_path / "jax.csv").read_text():
        assert (tmp_path / "port.csv.stamp.json").read_bytes() == \
            (tmp_path / "jax.csv.stamp.json").read_bytes()
    np.testing.assert_array_equal(got.post_counts, ref.post_counts)
    np.testing.assert_array_equal(got.class_counts, ref.class_counts)


@pytest.mark.parametrize("variant", VARIANTS)
def test_merge_of_halves_equals_whole(corpora, variant):
    """Counts merge exactly; moments, summed in float32 per fit, within
    rtol 1e-4 of the whole fit's (the float32 rounding of sums of squares
    near 7e7), and the merged file equals the JAX package's merge."""
    train = corpora["large_train"]
    whole = NaiveBayesModel.fit(_both(train, variant)[0], device=CPU)
    halves = [[], []]
    for text in _chunks(train, 2):
        obj = _schema_json(variant)
        halves[0].append(NaiveBayesModel.fit(
            Dataset.from_csv(text, FeatureSchema.from_json(obj)), device=CPU))
        halves[1].append(JaxModel.fit(JaxDataset.from_csv(
            text, JaxSchema.from_json(obj), engine="python")))
    merged = halves[0][0].merge(halves[0][1])
    np.testing.assert_array_equal(merged.post_counts, whole.post_counts)
    np.testing.assert_array_equal(merged.class_counts, whole.class_counts)
    np.testing.assert_allclose(merged.cont_moments, whole.cont_moments,
                               rtol=1e-4)
    _assert_model_text_equal(merged.to_csv(),
                             halves[1][0].merge(halves[1][1]).to_csv(),
                             variant)


def test_distr_fold_merge_equals_one_fold(corpora, tmp_path):
    """Two `_NBDistrFold`s over the two halves of the input, merged, write
    the one fold's (and the JAX job's) model bytes."""
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.runner import _NBDistrFold

    cfg = JobConfig({"bad.feature.schema.file.path": corpora["binned"]}, "bad")
    schema = FeatureSchema.from_json(_schema_json("binned"))
    folds = [_NBDistrFold(cfg, [], schema, torch.device(CPU))
             for _ in range(2)]
    for fold, text in zip(folds, _chunks(corpora["large_train"], 2)):
        fold.consume(Dataset.from_csv(text, schema))
    res = folds[0].merge(folds[1]).finish(str(tmp_path / "merged.csv"))
    assert res.counters == {"Distribution Data:Records": 20000}
    jax_run_job("bayesianDistr", {"bad.feature.schema.file.path": corpora["binned"]},
                [corpora["large_train"]], str(tmp_path / "jax.csv"))
    for ext in ("", ".stamp.json"):
        assert (tmp_path / f"merged.csv{ext}").read_bytes() == \
            (tmp_path / f"jax.csv{ext}").read_bytes()


@pytest.mark.parametrize("variant", VARIANTS)
def test_load_round_trip_and_cross_load(corpora, tmp_path, variant):
    ds, jds = _both(corpora["small_train"], variant)
    test, jtest = _both(corpora["small_test"], variant)
    model = NaiveBayesModel.fit(ds, device=CPU)
    path = str(tmp_path / "model.csv")
    model.save(path)
    schema = FeatureSchema.from_json(_schema_json(variant))
    again = NaiveBayesModel.load(path, schema, device=CPU)
    if variant == "binned":
        np.testing.assert_array_equal(again.post_counts, model.post_counts)
        for a, b in zip(NaiveBayesPredictor(again).predict(test),
                        NaiveBayesPredictor(model).predict(test)):
            np.testing.assert_array_equal(a, b)
    # the JAX package loads the port's stamped file and the port JAX's
    jax_loaded = JaxModel.load(path, JaxSchema.from_json(_schema_json(variant)))
    JaxModel.fit(jds).save(str(tmp_path / "jax.csv"))
    port_loaded = NaiveBayesModel.load(str(tmp_path / "jax.csv"), schema,
                                       device=CPU)
    for a, b in zip(NaiveBayesPredictor(port_loaded).predict(test),
                    JaxPredictor(jax_loaded).predict(jtest)):
        np.testing.assert_array_equal(a, b)


def test_load_refuses_a_changed_or_foreign_stamp(corpora, tmp_path):
    ds, _ = _both(corpora["small_train"], "binned")
    path = tmp_path / "model.csv"
    NaiveBayesModel.fit(ds, device=CPU).save(str(path))
    schema = FeatureSchema.from_json(_schema_json("binned"))
    path.write_text(path.read_text() + "open,,,1\n")
    with pytest.raises(ModelFormatSkew, match="does not match its stamp"):
        NaiveBayesModel.load(str(path), schema, device=CPU)
    stamp = tmp_path / "model.csv.stamp.json"
    stamp.write_text(json.dumps({"format_version": 2, "digest": "x"}))
    with pytest.raises(ModelFormatSkew, match="format_version=2"):
        NaiveBayesModel.load(str(path), schema, device=CPU)


def _boundary_row(log_post_64: np.ndarray, got: np.ndarray,
                  ref: np.ndarray) -> bool:
    """A row may differ only where a percent sits on a floor boundary at
    float32 precision: its float64 value within 1e-4 of an integer, and
    the two percents one apart."""
    pct = np.exp(log_post_64) * 100.0
    near = np.abs(pct - np.rint(pct)) <= 1e-4
    diff = got != ref
    return bool(np.all(np.abs(got - ref)[diff] == 1) and np.all(near[diff]))


def _log_post_64(model, ds):
    """The posterior in float64 from the model's float32 tables."""
    t = {k: v.double().numpy() for k, v in model.finish().items()}
    codes, _ = ds.feature_codes(model.binned_fields)
    x = ds.feature_matrix(model.cont_fields).astype(np.float64)
    lp = sum(t["log_post"][f][:, codes[:, f]].T for f in range(codes.shape[1]))
    lpr = sum(t["log_prior"][f][codes[:, f]] for f in range(codes.shape[1]))
    if x.shape[1]:
        def gauss(x, m, s):
            return -0.5 * np.log(2 * np.pi) - np.log(s) - 0.5 * ((x - m) / s) ** 2
        lp = lp + gauss(x[:, :, None], t["cont_mean"][None],
                        t["cont_std"][None]).sum(1)
        lpr = lpr + gauss(x, t["cont_prior_mean"][None],
                          t["cont_prior_std"][None]).sum(1)
    return lp + t["log_class"][None] - lpr[:, None]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_predict_matches_jax(corpora, variant, corpus):
    ds, jds = _both(corpora[f"{corpus}_train"], variant)
    test, jtest = _both(corpora[f"{corpus}_test"], variant)
    model = NaiveBayesModel.fit(ds, device=CPU)
    pred, pct = NaiveBayesPredictor(model).predict(test)
    ref_pred, ref_pct = JaxPredictor(JaxModel.fit(jds)).predict(jtest)
    assert pct.dtype == ref_pct.dtype == np.int32
    rows = np.nonzero((pct != ref_pct).any(1) | (pred != ref_pred))[0]
    if variant == "binned":
        assert rows.tolist() == []
        return
    assert len(rows) <= len(pct) // 1000, rows.tolist()
    assert _boundary_row(_log_post_64(model, test)[rows], pct[rows],
                         ref_pct[rows]), rows.tolist()
    # the class follows from the percents: argmax, ties to the first class
    np.testing.assert_array_equal(pred, pct.argmax(1))


def test_cost_arbitration_matches_jax(corpora):
    ds, jds = _both(corpora["large_train"], "binned")
    test, jtest = _both(corpora["large_test"], "binned")
    got, _ = NaiveBayesPredictor(
        NaiveBayesModel.fit(ds, device=CPU),
        CostBasedArbitrator("open", "closed", 10, 1)).predict(test)
    ref, _ = JaxPredictor(JaxModel.fit(jds),
                          JaxArbitrator("open", "closed", 10, 1)).predict(jtest)
    np.testing.assert_array_equal(got, ref)
    assert (got == 1).sum() > (NaiveBayesPredictor(
        NaiveBayesModel.fit(ds, device=CPU)).predict(test)[0] == 1).sum()


@pytest.mark.parametrize("variant", VARIANTS)
def test_feature_prob_and_validate_match_jax(corpora, variant):
    ds, jds = _both(corpora["large_train"], variant)
    test, jtest = _both(corpora["large_test"], variant)
    port, ref = (NaiveBayesPredictor(NaiveBayesModel.fit(ds, device=CPU)),
                 JaxPredictor(JaxModel.fit(jds)))
    np.testing.assert_allclose(port.feature_prob(test),
                               ref.feature_prob(jtest), rtol=1e-6)
    cm, ref_cm = port.validate(test, pos_class=1), ref.validate(jtest, 1)
    if variant == "binned":
        assert cm.counters() == ref_cm.counters()
    assert cm.counters()["Validation:Accuracy"] > 80


JOB_MODES = {
    "plain": {},
    "validation": {"bap.validation.mode": "true",
                   "bap.positive.class.value": "closed"},
    "prob_only": {"bap.output.feature.prob.only": "true"},
    "cost": {"bap.predict.class.cost": "50,1",
             "bap.predict.class": "open,closed",
             "bap.validation.mode": "true"},
}


@pytest.mark.parametrize("block_mb", [None, "0.01"])
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_distr_job_byte_identical_to_jax(corpora, tmp_path, corpus,
                                         block_mb):
    # the sidecar off: each run parses its corpus, with the engine asked
    props = {"bad.feature.schema.file.path": corpora["binned"],
             "bad.stream.sidecar": "false"}
    if block_mb:
        props["bad.stream.block.size.mb"] = block_mb
    train = [corpora[f"{corpus}_train"]]
    ref = jax_run_job("bayesianDistr", props, train, str(tmp_path / "jax.csv"))
    for engine in ("auto", "python"):     # the native parser, then Python's
        out = tmp_path / f"port_{engine}.csv"
        with obs.capture() as rec:
            got = run_job("bayesianDistr", {**props, "csv.engine": engine},
                          train, str(out), device=CPU)
        assert parse_engines(rec) == {engine_of(engine)}
        for ext in ("", ".stamp.json"):
            assert (tmp_path / f"port_{engine}.csv{ext}").read_bytes() == \
                (tmp_path / f"jax.csv{ext}").read_bytes()
        key = "Distribution Data:Records"
        assert got.counters[key] == ref.counters[key] == CORPORA[corpus][0]


@pytest.mark.parametrize("mode", sorted(JOB_MODES))
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_predictor_job_byte_identical_to_jax(corpora, tmp_path, corpus, mode):
    model = str(tmp_path / "model.csv")
    run_job("bayesianDistr",
            {"bad.feature.schema.file.path": corpora["binned"]},
            [corpora[f"{corpus}_train"]], model, device=CPU)
    props = {"bap.feature.schema.file.path": corpora["binned"],
             "bap.bayesian.model.file.path": model,
             "bap.stream.block.size.mb": "0.05", **JOB_MODES[mode]}
    test = [corpora[f"{corpus}_test"]]
    ref = jax_run_job("bayesianPredictor", props, test, str(tmp_path / "jax"))
    got = run_job("bayesianPredictor", props, test, str(tmp_path / "port"),
                  device=CPU)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    validation = {k: v for k, v in ref.counters.items()
                  if k.startswith("Validation:")}
    assert got.counters == validation
    if "bap.validation.mode" in props:
        assert got.counters["Validation:Accuracy"] > 70


def test_jobs_through_properties_file_and_cli(corpora, tmp_path):
    props = tmp_path / "nb.properties"
    model = tmp_path / "distr" / "part-r-00000"
    props.write_text(
        f"bad.feature.schema.file.path={corpora['binned']}\n"
        f"bap.feature.schema.file.path={corpora['binned']}\n"
        f"bap.bayesian.model.file.path={model}\n"
        "bap.validation.mode=true\nbap.positive.class.value=closed\n")
    rows = []
    for name, paths in (("org.avenir.bayesian.BayesianDistribution",
                         [corpora["small_train"], str(tmp_path / "distr") + "/"]),
                        ("bayesianPredictor",
                         [corpora["small_test"], str(tmp_path / "pred.txt")])):
        proc = subprocess.run(
            [sys.executable, "-m", "avenir_tpu_torch", name, "--conf",
             str(props), *paths, "--device", "cpu"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert rows[0]["job"] == "bayesianDistr" and model.exists()
    assert {k: v for k, v in rows[0]["counters"].items()
            if k not in DELTA_COUNTERS and k not in MEM_COUNTERS} == \
        {"Distribution Data:Records": 800}
    assert rows[0]["counters"]["Mem:PredictedPeakBytes"] == jax_run_job(
        "bayesianDistr", str(props), [corpora["small_train"]],
        str(tmp_path / "jax_distr") + "/").counters["Mem:PredictedPeakBytes"]
    assert rows[1]["counters"]["Validation:Accuracy"] > 70
    jax_run_job("bayesianPredictor", str(props), [corpora["small_test"]],
                str(tmp_path / "jax.txt"))
    assert (tmp_path / "pred.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("variant", VARIANTS)
def test_nb_model_from_jax_arrays(corpora, tmp_path, variant):
    _, jds = _both(corpora["large_train"], variant)
    test, jtest = _both(corpora["large_test"], variant)
    ref = JaxModel.fit(jds)
    if variant == "moments":
        # a model loaded from its file carries (mean, std), not moments
        ref.save(str(tmp_path / "m.csv"))
        ref = JaxModel.load(str(tmp_path / "m.csv"),
                            JaxSchema.from_json(_schema_json(variant)))
    arrays = {name: getattr(ref, name) for name in
              ("post_counts", "cont_moments", "class_counts", "cont_params",
               "cont_prior_params")}
    got = nb_model_from_jax_arrays(
        arrays, FeatureSchema.from_json(_schema_json(variant)),
        ref.class_values, ref.bins, device=CPU)
    pred, pct = NaiveBayesPredictor(got).predict(test)
    ref_pred, ref_pct = JaxPredictor(ref).predict(jtest)
    rows = np.nonzero((pct != ref_pct).any(1))[0]
    assert len(rows) <= len(pct) // 1000, rows.tolist()
    np.testing.assert_array_equal(np.delete(pred, rows),
                                  np.delete(ref_pred, rows))
    with pytest.raises(ValueError, match="bins"):
        nb_model_from_jax_arrays(arrays, FeatureSchema.from_json(
            _schema_json(variant)), ref.class_values, [2] * len(ref.bins),
            device=CPU)


def test_num_bins_needs_a_max_as_jax():
    """A bucketized numeric with no max has no dense code: the port raises
    the JAX package's error."""
    obj = {"name": "age", "ordinal": 1, "dataType": "int", "feature": True,
           "bucketWidth": 12}
    with pytest.raises(ValueError) as got:
        FeatureField.from_json(obj).num_bins()
    with pytest.raises(ValueError) as ref:
        JaxField.from_json(obj).num_bins()
    assert str(got.value) == str(ref.value) == \
        "field 'age': bucketWidth set but no max bound"
    both = [FeatureField.from_json({**obj, "min": 0, "max": 120}),
            JaxField.from_json({**obj, "min": 0, "max": 120})]
    assert [f.num_bins() for f in both] == [11, 11]
    assert [f.encode_value("37") for f in both] == [3, 3]


def test_feature_codes_match_jax(corpora):
    for variant in VARIANTS:
        ds, jds = _both(corpora["small_train"], variant)
        codes, bins = ds.feature_codes()
        ref_codes, ref_bins = jds.feature_codes()
        np.testing.assert_array_equal(codes, ref_codes)
        assert bins == ref_bins


def test_vocabulary_growing_mid_stream_raises(tmp_path):
    """As in JAX: a categorical discovered from the first chunk cannot grow
    in a later one while the counts stream."""
    obj = churn_schema().to_json()
    for fld in obj["fields"]:
        if fld["name"] == "payment":
            del fld["cardinality"]
    schema = tmp_path / "s.json"
    schema.write_text(json.dumps(obj))
    train = tmp_path / "t.csv"
    lines = generate_churn(400, seed=9, as_csv=True).splitlines(True)
    first = "".join(ln for ln in lines if ",good," not in ln)
    # the new value first shows 8 blocks in: past the blocks the JAX
    # package's parser thread may parse (and grow the shared vocabulary
    # with) before its fold sizes the model from the first one
    reps = -(-8 * 5243 // len(first))
    train.write_text(first * reps + "".join(lines))
    props = {"bad.feature.schema.file.path": str(schema),
             "bad.stream.block.size.mb": "0.005"}
    with pytest.raises(ValueError, match="vocabulary grew mid-stream"):
        run_job("bayesianDistr", props, [str(train)], str(tmp_path / "o"),
                device=CPU)
    with pytest.raises(ValueError, match="vocabulary grew mid-stream"):
        jax_run_job("bayesianDistr", props, [str(train)],
                    str(tmp_path / "j"))


def test_default_device_needs_a_gpu(monkeypatch, corpora, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    schema = FeatureSchema.from_json(_schema_json("binned"))
    ds, _ = _both(corpora["small_train"], "binned")
    props = {"bad.feature.schema.file.path": corpora["binned"]}
    for call in (lambda: NaiveBayesModel.empty(schema),
                 lambda: NaiveBayesModel.fit(ds),
                 lambda: run_job("bayesianDistr", props,
                                 [corpora["small_train"]],
                                 str(tmp_path / "o"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "o").exists()


def test_nb_jobs_launch_no_kernel(corpora, tmp_path):
    """NB has no TPU kernel; on the CPU no wrapper counts a launch."""
    kk.reset_launches()
    mc.reset_launches()
    model = str(tmp_path / "m.csv")
    run_job("bayesianDistr", {"bad.feature.schema.file.path": corpora["binned"]},
            [corpora["small_train"]], model, device=CPU)
    run_job("bayesianPredictor",
            {"bap.feature.schema.file.path": corpora["binned"],
             "bap.bayesian.model.file.path": model},
            [corpora["small_test"]], str(tmp_path / "p"), device=CPU)
    assert [fn.launches for fn in kk.KERNEL_WRAPPERS + mc.KERNEL_WRAPPERS] \
        == [0] * 5


# ------------------------------------------------- more than three classes
#: batch rows of the moment-order checks: below 8 (where XLA's CPU dot
#: sums some shapes in row order), both sides of 8192 and past two blocks
MULTI_N = (4, 5, 6, 7, 8, 9, 301, 4097, 8195, 20003)


def _multiclass_moments(n, k, fc):
    """(port, JAX) count batches of one seeded multi-class batch."""
    import jax.numpy as jnp

    from avenir_tpu.models.naive_bayes import _count_batch_kernel
    from avenir_tpu_torch.models.naive_bayes import _count_batch

    rng = np.random.default_rng(1000 * k + 10 * fc + n)
    x = (rng.random((n, fc)) * 120).astype(np.float32)
    y = rng.integers(0, k, n).astype(np.int32)
    codes = rng.integers(0, 3, (n, 1)).astype(np.int32)
    ref = _count_batch_kernel(jnp.asarray(codes), jnp.asarray(y),
                              jnp.asarray(x), jnp.ones((n,), jnp.float32),
                              k, 3)
    got = _count_batch(codes, y, x, k, 3, torch.device(CPU))
    return [g.numpy() for g in got], [np.asarray(r) for r in ref]


@pytest.mark.parametrize("fc", [1, 2, 3])
@pytest.mark.parametrize("k", [4, 5, 8, 12, 16, 17, 20, 33, 64])
def test_multiclass_moment_bits_match_jax(k, fc):
    """The moments of 4-64 classes bit-equal to the JAX package's
    `_count_batch_kernel` on the CPU, at every batch size of MULTI_N (from
    17 classes blocks of 1927 to 512 rows: 4097 and more rows cross a
    block's end): the port follows XLA's CPU dot order for each
    (classes, fields, rows) (`ops.reduce._dot_block`)."""
    for n in MULTI_N:
        got, ref = _multiclass_moments(n, k, fc)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r, err_msg=f"n={n}")


@pytest.mark.parametrize("k,fc", [(2, 1), (4, 1), (5, 2), (33, 1)])
def test_moment_bits_past_two_to_the_21_rows(k, fc):
    """One batch of 2,200,003 rows, past 2^24 / 8 rows a class cell and
    about the rows of a default 64 MB block: the reference's order is
    the one `_dot_block` gives at 20,000 rows (rows in order, 8192- and
    4096-row lanes, read off by `row_block`; 992-row blocks in order,
    checked at a few rows by `order_holds`), and the moment bits are
    equal."""
    from nb_moment_probe import order_holds, port_order, row_block

    n = 2_200_003
    assert port_order(k, fc, n) == port_order(k, fc, 20000)
    if k <= 16:
        assert row_block(n, k, fc) == port_order(k, fc, n)
    else:
        assert order_holds(n, k, fc, port_order(k, fc, n))
    got, ref = _multiclass_moments(n, k, fc)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("k,fc", [(2, 1), (3, 2), (4, 1), (5, 1), (8, 3),
                                  (9, 2), (12, 1), (13, 5), (16, 3)])
def test_dot_block_is_the_reference_tree(k, fc):
    """`_dot_block` is the order read off the reference's sum tree
    (`tests/nb_moment_probe.py`, one +M/-M pair of rows at a time): the
    block at 20,000 rows, and rows in order below 8 rows exactly where
    the reference sums them in order."""
    from nb_moment_probe import in_row_order, row_block

    from avenir_tpu_torch.ops.reduce import _dot_block

    assert row_block(20000, k, fc) == _dot_block(k, fc, 20000)
    for n in (4, 5, 6, 7):
        assert in_row_order(n, k, fc) == (_dot_block(k, fc, n) is None), n


@pytest.mark.parametrize("k,fc", [(17, 1), (20, 2), (33, 3), (48, 5),
                                  (64, 1), (65, 2), (100, 1), (130, 3),
                                  (200, 1)])
def test_dot_panels_are_the_reference_tree(k, fc):
    """From 17 classes `_dot_block` is the order read off the reference's
    sum tree at 20,000 rows for the first, a middle and the last class of
    every panel of 64 classes (each panel's rows in order over blocks of
    32768 // its classes, a last panel of one class wholly in order),
    and rows in order below 8 rows."""
    from nb_moment_probe import class_orders, in_row_order, port_order

    probed = sorted({c for p in range(0, k, 64)
                     for c in (p, min(p + 31, k - 1), min(p + 63, k - 1))})
    for c0, c1, order in class_orders(20000, k, fc, probed):
        assert all(port_order(k, fc, 20000, c) == order
                   for c in probed if c0 <= c < c1), (c0, c1, order)
    for n in (4, 5, 6, 7):
        assert in_row_order(n, k, fc) and port_order(k, fc, n) is None, n


@pytest.mark.parametrize("fc", [1, 2, 3])
@pytest.mark.parametrize("k", [65, 80, 100, 130, 200, 256])
def test_moment_bits_in_class_panels_match_jax(k, fc):
    """Above 64 classes XLA's CPU dot sums each panel of 64 classes in its
    own order (the last panel's blocks are longer): the moments bit-equal
    to the reference's at 20,003 rows and on a block's end (4,097)."""
    for n in (4097, 20003):
        got, ref = _multiclass_moments(n, k, fc)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r, err_msg=f"n={n}")


@pytest.mark.parametrize("fc", [1, 2, 3])
@pytest.mark.parametrize("k", [4, 5, 8, 20])
def test_multiclass_model_file_byte_identical_to_jax(tmp_path, k, fc):
    """bayesianDistr on a multi-class corpus with continuous fields:
    model file and stamp byte-identical to `avenir_tpu.runner.run_job`'s,
    in one chunk and in three."""
    from avenir_tpu_torch.data import generate_multiclass, multiclass_schema

    schema = tmp_path / "multi.json"
    multiclass_schema(k, fc).save(str(schema))
    train = tmp_path / "train.csv"
    train.write_text(generate_multiclass(20000, k, fc, seed=k * 10 + fc,
                                         as_csv=True))
    block = f"{train.stat().st_size / 3 / (1 << 20):.4f}"
    for block_mb in (None, block):
        props = {"bad.feature.schema.file.path": str(schema)}
        if block_mb:
            props["bad.stream.block.size.mb"] = block_mb
        jax_run_job("bayesianDistr", props, [str(train)],
                    str(tmp_path / "jax.csv"))
        run_job("bayesianDistr", props, [str(train)],
                str(tmp_path / "port.csv"), device=CPU)
        for ext in ("", ".stamp.json"):
            assert (tmp_path / f"port.csv{ext}").read_bytes() == \
                (tmp_path / f"jax.csv{ext}").read_bytes(), (block_mb, ext)
