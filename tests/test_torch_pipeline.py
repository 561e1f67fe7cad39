"""The port's `Pipeline` and `knn_pipeline` on the CPU against the JAX
package.

- `knn_pipeline` at 300 train x 80 test e-learning rows
  (`generate_elearn` seeds 40/41, as tests/test_pipelines.py) with
  class-conditional weighting: all five files (simi.txt, distr.csv,
  condProb.txt, join.txt, knn_out.txt) byte-identical to the JAX
  pipeline's, and the counters equal.
- `Pipeline`: stage overrides over one properties file; a failed stage
  re-runs up to `mapreduce.map.maxattempts` times with `on_retry` called
  before each retry, as in JAX; `run(only=)` runs one stage.
- `decision_tree_pipeline` (decTree, and randomForest with forest=True)
  on 3,001 call-hangup rows: decPathOut.txt and every tree-NNN.json
  byte-identical to the JAX pipeline's.
- `fuse=True`: two stages that share a scan (`bayesianDistr` then
  `mutualInformation` on one input) run as one `run_shared` scan, with
  outputs equal to the sequential run's; where no such group forms the
  stages run as without it.
"""

import os

import pytest

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.pipelines import \
    decision_tree_pipeline as jax_decision_tree_pipeline
from avenir_tpu.pipelines import knn_pipeline as jax_knn_pipeline
from avenir_tpu.runner import Pipeline as JaxPipeline
from avenir_tpu.runner import Stage as JaxStage
from avenir_tpu_torch.data import (call_hangup_schema, elearn_schema,
                                   generate_call_hangup, generate_elearn)
from avenir_tpu_torch import obs
from avenir_tpu_torch.pipelines import decision_tree_pipeline, knn_pipeline
from avenir_tpu_torch.runner import MEM_COUNTERS, Pipeline, Stage
from test_torch_native_ingest import engine_of, parse_engines

CPU = "cpu"
FILES = ("simi.txt", "distr.csv", "condProb.txt", "join.txt", "knn_out.txt")


@pytest.fixture(scope="module")
def elearn_env(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe_elearn")
    schema = str(d / "elearn.json")
    elearn_schema().save(schema)
    train, test = str(d / "train.csv"), str(d / "test.csv")
    with open(train, "w") as fh:
        fh.write(generate_elearn(300, seed=40, as_csv=True))
    with open(test, "w") as fh:
        fh.write(generate_elearn(80, seed=41, as_csv=True))
    return {"schema": schema, "train": train, "test": test}


def _counters(results):
    """Each stage's counters, without the JAX runner's own (sidecar,
    cache, memory) that the port does not keep."""
    return {name: {k: v for k, v in res.counters.items()
                   if k.split(":")[0] in ("Similarity", "Join", "Validation",
                                          "Distribution Data")}
            for name, res in results.items()}


@pytest.mark.parametrize("fuse", [False, True])
def test_knn_pipeline_files_match_jax(elearn_env, tmp_path, fuse):
    props = {"nen.top.match.count": "5", "nen.validation.mode": "true",
             "nen.class.condtion.weighted": "true"}
    args = (props, elearn_env["train"], elearn_env["test"])
    ref = jax_knn_pipeline(*args, str(tmp_path / "jax"),
                           schema_path=elearn_env["schema"]).run()
    for engine in ("auto", "python"):     # the native parser, then Python's
        # the feature posteriors echo rows: the Python parser under auto
        with obs.capture() as rec:
            got = knn_pipeline({**props, "csv.engine": engine},
                               *args[1:], str(tmp_path / engine),
                               schema_path=elearn_env["schema"],
                               device=CPU).run(fuse=fuse)
        assert parse_engines(rec) == {engine_of(engine), "python"}
        assert list(got) == list(ref) == ["similarity", "bayesianDistr",
                                          "featurePosterior", "join",
                                          "nearestNeighbor"]
        assert _counters(got) == _counters(ref)
        assert got["similarity"].counters["Similarity:Pairs"] == 300 * 80
        assert got["join"].counters["Join:Pairs"] == 300 * 80
        assert got["nearestNeighbor"].counters["Validation:Accuracy"] > 60
        for f in FILES:
            assert (tmp_path / engine / f).read_bytes() == \
                (tmp_path / "jax" / f).read_bytes(), f


@pytest.mark.parametrize("forest", [False, True])
def test_decision_tree_pipeline_matches_jax(tmp_path, forest):
    schema = str(tmp_path / "call_hangup.json")
    call_hangup_schema().save(schema)
    train = tmp_path / "train.csv"
    train.write_text(generate_call_hangup(3001, seed=12, as_csv=True))
    props = {"dtb.max.depth.limit": "4", "dtb.num.trees": "3",
             "dtb.split.algorithm": "giniIndex"}
    ref = jax_decision_tree_pipeline(props, str(train), str(tmp_path / "jax"),
                                     schema_path=schema, forest=forest).run()
    got = decision_tree_pipeline(props, str(train), str(tmp_path / "port"),
                                 schema_path=schema, forest=forest,
                                 device=CPU).run()
    assert list(got) == list(ref) == ["decTree"]
    assert got["decTree"].counters == ref["decTree"].counters
    files = ([f"forest/tree-{t:03d}.json" for t in range(3)] if forest
             else ["decPathOut.txt"])
    assert [os.path.relpath(p, tmp_path / "port")
            for p in got["decTree"].outputs] == files
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f


def test_properties_file_and_stage_overrides(elearn_env, tmp_path):
    """One properties file for every stage; a stage's overrides win."""
    conf = tmp_path / "knn.properties"
    conf.write_text(f"sts.feature.schema.file.path={elearn_env['schema']}\n"
                    "sts.distance.scale=1000\n")
    stages = [Stage("s1000", "recordSimilarity", [elearn_env["test"]],
                    str(tmp_path / "s1000.txt")),
              Stage("s10", "recordSimilarity", [elearn_env["test"]],
                    str(tmp_path / "s10.txt"), {"sts.distance.scale": "10"})]
    jstages = [JaxStage(st.name, st.job, st.inputs, st.output + ".jax",
                        st.conf_overrides) for st in stages]
    got = Pipeline(str(conf), stages, device=CPU).run()
    JaxPipeline(str(conf), jstages).run()
    assert got["s10"].counters["Similarity:Pairs"] == 80 * 79 // 2
    for st in stages:
        assert open(st.output).read() == open(st.output + ".jax").read()
    first = open(tmp_path / "s10.txt").readline().split(",")
    assert int(first[2]) < 10 < int(open(tmp_path / "s1000.txt")
                                    .readline().split(",")[2])


def _retry_case(tmp_path, pipeline_cls, stage_cls, attempts, suffix, **kw):
    """A stage whose input appears only in on_retry: the first attempt
    fails, a retry (if allowed) succeeds."""
    missing = tmp_path / f"late{suffix}.csv"
    seen = []

    def on_retry(name, attempt, exc):
        seen.append((name, attempt, type(exc).__name__))
        missing.write_text(generate_elearn(20, seed=1, as_csv=True))

    schema = str(tmp_path / "elearn.json")
    elearn_schema().save(schema)
    props = {"sts.feature.schema.file.path": schema,
             "mapreduce.map.maxattempts": str(attempts)}
    pipe = pipeline_cls(props, [stage_cls("sim", "recordSimilarity",
                                          [str(missing)],
                                          str(tmp_path / f"o{suffix}.txt"))],
                        on_retry=on_retry, **kw)
    return pipe, seen


@pytest.mark.parametrize("attempts", [1, 2, 3])
def test_retry_and_on_retry_as_jax(tmp_path, attempts):
    pipe, seen = _retry_case(tmp_path, Pipeline, Stage, attempts, "p",
                             device=CPU)
    jpipe, jseen = _retry_case(tmp_path, JaxPipeline, JaxStage, attempts, "j")
    if attempts == 1:
        with pytest.raises(FileNotFoundError):
            pipe.run()
        with pytest.raises(FileNotFoundError):
            jpipe.run()
        assert seen == jseen == [] and pipe.attempts == {"sim": 1}
        return
    got, ref = pipe.run(), jpipe.run()
    assert pipe.attempts == jpipe.attempts == {"sim": 2}
    assert seen == jseen == [("sim", 1, "FileNotFoundError")]
    assert got["sim"].counters == {"Similarity:Pairs": 190}
    assert ref["sim"].counters["Similarity:Pairs"] == 190


def test_run_only_one_stage(elearn_env, tmp_path):
    pipe = knn_pipeline({}, elearn_env["train"], elearn_env["test"],
                        str(tmp_path), schema_path=elearn_env["schema"],
                        device=CPU)
    got = pipe.run(only="bayesianDistr")
    assert list(got) == ["bayesianDistr"]
    assert sorted(os.listdir(tmp_path)) == ["distr.csv",
                                            "distr.csv.stamp.json"]


def test_fuse_runs_a_shared_scan_group(elearn_env, tmp_path):
    """bayesianDistr then mutualInformation on the same input run as one
    shared scan under fuse=True (one `job.dispatch` span naming both),
    with outputs byte-identical to the sequential run's; beside a stage
    that shares no scan, the ported stage runs under fuse=True. On churn
    rows: MI scores the encodable (categorical or binned) features, and
    e-learning has none."""
    from avenir_tpu_torch.data import churn_schema, generate_churn

    schema, train = str(tmp_path / "churn.json"), tmp_path / "churn.csv"
    churn_schema().save(schema)
    train.write_text(generate_churn(300, seed=40, as_csv=True))
    props = {"bad.feature.schema.file.path": schema,
             "mut.feature.schema.file.path": schema,
             "mut.mutual.info.score.algorithms": "joint.mutual.info"}

    def stages(d):
        return [Stage("distr", "bayesianDistr", [str(train)],
                      str(d / "distr.csv")),
                Stage("mi", "mutualInformation", [str(train)],
                      str(d / "mi.txt"))]

    with obs.capture() as rec:
        fused = Pipeline(props, stages(tmp_path / "f"), device=CPU).run(
            fuse=True)
    seq = Pipeline(props, stages(tmp_path / "s"), device=CPU).run()
    assert [sp.attrs["jobs"] for sp in rec.spans()
            if sp.name == "job.dispatch"] == ["bayesianDistr,mutualInformation"]
    for name, fname in (("distr", "distr.csv"), ("mi", "mi.txt")):
        assert (tmp_path / "f" / fname).read_bytes() == \
            (tmp_path / "s" / fname).read_bytes()
        # the fused scan packed the sidecar; the plain runs replayed it.
        # Mem:PeakRSS is the process's peak so far, which the later
        # sequential runs may raise: the prediction is held on its own
        assert {k: v for k, v in fused[name].counters.items()
                if not k.startswith("Sidecar:") and k not in MEM_COUNTERS} \
            == {k: v for k, v in seq[name].counters.items()
                if not k.startswith("Sidecar:") and k not in MEM_COUNTERS}
        assert fused[name].counters.get("Mem:PredictedPeakBytes") == \
            seq[name].counters.get("Mem:PredictedPeakBytes")
        assert fused[name].counters["Sidecar:DeltaBlocks"] \
            == seq[name].counters["Sidecar:HitBlocks"] >= 1
    got = Pipeline(props, stages(tmp_path / "o")[:1] + [Stage(
        "s", "recordSimilarity", [elearn_env["test"]],
        str(tmp_path / "s.txt"),
        {"sts.feature.schema.file.path": elearn_env["schema"]})],
        device=CPU).run(fuse=True)
    assert got["distr"].counters["Distribution Data:Records"] == 300


@pytest.mark.parametrize("n", [3, 301, 8192, 8195, 20003])
@pytest.mark.parametrize("fc,k", [(2, 2), (6, 2), (6, 3), (1, 2)])
def test_nb_moments_sum_in_xla_cpu_order(n, fc, k):
    """Naive Bayes moment sums bit-equal to the JAX package's einsum on
    the CPU (what distr.csv prints), for the layouts the corpora use: one
    continuous field, and two or more with two or three classes."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from avenir_tpu.models.naive_bayes import _count_batch_kernel
    from avenir_tpu_torch.models.naive_bayes import _count_batch

    rng = np.random.default_rng(n + fc)
    x = (rng.random((n, fc), dtype=np.float32) * 100).astype(np.float32)
    y = rng.integers(0, k, n).astype(np.int32)
    codes = rng.integers(0, 3, (n, 1)).astype(np.int32)
    ref = _count_batch_kernel(jnp.asarray(codes), jnp.asarray(y),
                              jnp.asarray(x), jnp.ones((n,), jnp.float32),
                              k, 3)
    got = _count_batch(codes, y, x, k, 3, torch.device(CPU))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
