"""The port's decision-tree path (`avenir_tpu_torch.models.tree`, the tree
jobs of `runner.py`, `explore.ClassPartitionGenerator`) on the CPU against
the JAX package, on the same seeded inputs:

- `enumerate_splits` equal (predicates, bounds, groups, segments) on
  `call_hangup_schema` and on tests/test_tree.py's HANGUP_SCHEMA;
- the level histogram bit for bit in float32 (one tree, and forests of 2
  and 5 trees with bootstrap weights, in one row block and in many), and
  the advance equal;
- `decTree` (entropy and giniIndex, each stopping strategy, notUsedYet,
  randomNotUsedYet and the other attribute strategies): decPathOut.txt
  byte-identical; `randomForest` (withReplace, withoutReplace): every
  tree-NNN.json byte-identical; the forest's one histogram call a level;
- `DevicePathEvaluator` equal to JAX's, and to the host predict where
  JAX's is, with a NaN numeric and an unknown category; a JAX-saved tree
  loaded into the port;
- `dataPartitioner`'s files byte-identical; `classPartitionGenerator`'s
  entropy, gini and Hellinger stats byte-identical, with the same best
  split.

At most 5,003 rows: a few seconds for the file.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.core.dataset import Dataset as JaxDataset
from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.models import tree as jtree
from avenir_tpu.models.explore import \
    ClassPartitionGenerator as JaxClassPartitionGenerator
from avenir_tpu.runner import run_job as jax_run_job
from avenir_tpu_torch import obs
from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.data import call_hangup_schema, generate_call_hangup
from avenir_tpu_torch.models import tree as ptree
from avenir_tpu_torch.models.explore import ClassPartitionGenerator
from avenir_tpu_torch.runner import run_job
from test_tree import HANGUP_SCHEMA

CPU = "cpu"
ROWS = 5003


@pytest.fixture(scope="module")
def hangup(tmp_path_factory):
    """The call-hangup corpus (`generate_call_hangup`, seed 3) as a CSV
    and its schema file."""
    d = tmp_path_factory.mktemp("tree")
    schema = d / "call_hangup.json"
    call_hangup_schema().save(str(schema))
    train = d / "train.csv"
    train.write_text(generate_call_hangup(ROWS, seed=3, as_csv=True))
    return {"schema": str(schema), "train": str(train), "dir": d}


def _both(text, schema_json):
    """(port, JAX) datasets of the same CSV text."""
    return (Dataset.from_csv(text, FeatureSchema.from_json(schema_json)),
            JaxDataset.from_csv(text, JaxSchema.from_json(schema_json)))


# ------------------------------------------------------------------ splits
@pytest.mark.parametrize("which", ["call_hangup", "hangup"])
def test_enumerate_splits_match_jax(which):
    obj = (call_hangup_schema().to_json() if which == "call_hangup"
           else HANGUP_SCHEMA.to_json())
    got = ptree.enumerate_splits(FeatureSchema.from_json(obj))
    ref = jtree.enumerate_splits(JaxSchema.from_json(obj))
    assert len(got) == len(ref) > 0
    col_num = np.array([-5, 0, 59, 60, 61, 199, 200, 599, 600, 1e9, np.nan],
                       np.float32)
    for g, r in zip(got, ref):
        assert (g.attribute, g.split_id, g.n_segments, g._kind) == \
            (r.attribute, r.split_id, r.n_segments, r._kind)
        assert [p.to_json() for p in g.predicates] == \
            [p.to_json() for p in r.predicates]
        if g._kind == "numeric":
            np.testing.assert_array_equal(g._bounds, r._bounds)
            col = col_num
        else:
            np.testing.assert_array_equal(g._group_of, r._group_of)
            col = np.arange(len(g._group_of), dtype=np.int32)
        np.testing.assert_array_equal(g.segment_of(col), r.segment_of(col))
    # NaN (a missing numeric) lands in the last segment, as numpy puts it
    num = next(g for g in got if g._kind == "numeric")
    assert num.segment_of(np.array([np.nan], np.float32))[0] == \
        num.n_segments - 1


# --------------------------------------------------------------- histogram
def _level_inputs(t, n, ns, smax, k, n_leaves, seed):
    rng = np.random.default_rng(seed)
    leaf = rng.integers(0, n_leaves - 1, (t, n)).astype(np.int32)
    seg = rng.integers(0, smax, (n, ns)).astype(np.int8)
    y = rng.integers(0, k, n).astype(np.int32)
    # bootstrap counts, as the forest draws them
    w = np.stack([np.bincount(rng.integers(0, n, n), minlength=n)
                  for _ in range(t)]).astype(np.float32)
    return leaf, seg, y, w


@pytest.mark.parametrize("key_block", [None, 999])
@pytest.mark.parametrize("t", [1, 2, 5])
def test_level_histogram_bits_match_jax(monkeypatch, t, key_block):
    """float32 bits of every cell equal to JAX's `segment_sum`, for one
    tree and for forests of 2 and 5 bootstrap-weighted trees, in one row
    block and in many (KEY_BLOCK cut to 999 keys)."""
    if key_block is not None:
        monkeypatch.setattr(ptree, "KEY_BLOCK", key_block)
    n, ns, smax, k, lpad = 3001, 7, 3, 2, 8
    leaf, seg, y, w = _level_inputs(t, n, ns, smax, k, lpad, seed=t)
    args = (torch.from_numpy(seg), torch.from_numpy(y))
    jargs = (jnp.asarray(seg), jnp.asarray(y))
    if t == 1:
        got = ptree._level_histogram(torch.from_numpy(leaf[0]), *args,
                                     torch.from_numpy(w[0]), lpad, ns, smax,
                                     k).numpy()
        ref = np.asarray(jtree._level_histogram(
            jnp.asarray(leaf[0]), *jargs, jnp.asarray(w[0]), lpad, ns, smax,
            k))
    else:
        got = ptree._level_histogram_forest(
            torch.from_numpy(leaf), *args, torch.from_numpy(w), lpad, ns,
            smax, k).numpy()
        ref = np.asarray(jtree._level_histogram_forest(
            jnp.asarray(leaf), *jargs, jnp.asarray(w), lpad, ns, smax, k))
    assert got.dtype == ref.dtype == np.float32
    assert got.tobytes() == ref.tobytes()
    assert got.sum() == w.sum() * ns


@pytest.mark.parametrize("t", [1, 3])
def test_advance_leaves_match_jax(t):
    n, ns, smax, lpad = 2001, 5, 3, 8
    leaf, seg, _, _ = _level_inputs(t, n, ns, smax, 2, lpad, seed=10 + t)
    rng = np.random.default_rng(t)
    best = rng.integers(-1, ns, (t, lpad)).astype(np.int32)
    off = np.where(best >= 0, rng.integers(8, 40, (t, lpad)), -1) \
        .astype(np.int32)
    if t == 1:
        got = ptree._advance_leaves(*(torch.from_numpy(a) for a in
                                      (leaf[0], seg, best[0], off[0])))
        ref = jtree._advance_leaves(*(jnp.asarray(a) for a in
                                      (leaf[0], seg, best[0], off[0])))
    else:
        got = ptree._advance_leaves_forest(*(torch.from_numpy(a) for a in
                                             (leaf, seg, best, off)))
        ref = jtree._advance_leaves_forest(*(jnp.asarray(a) for a in
                                             (leaf, seg, best, off)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------- the jobs
def _dec_tree_pair(hangup, tmp_path, **props):
    props = {"dtb.feature.schema.file.path": hangup["schema"],
             "dtb.max.depth.limit": "4", **props}
    jax_run_job("decTree", {**props, "dtb.decision.file.path.out":
                            str(tmp_path / "jax.txt")}, [hangup["train"]], "")
    res = run_job("decTree", {**props, "dtb.decision.file.path.out":
                              str(tmp_path / "port.txt")}, [hangup["train"]],
                  "", device=CPU)
    return res, (tmp_path / "port.txt").read_bytes(), \
        (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("stopping,limit", [
    ("maxDepth", {}), ("minInfoGain", {"dtb.min.info.gain.limit": "0.02"}),
    ("minPopulation", {"dtb.min.population.limit": "400"})])
@pytest.mark.parametrize("algo", ["entropy", "giniIndex"])
def test_dec_tree_file_matches_jax(hangup, tmp_path, algo, stopping, limit):
    res, got, ref = _dec_tree_pair(hangup, tmp_path,
                                   **{"dtb.split.algorithm": algo,
                                      "dtb.path.stopping.strategy": stopping,
                                      **limit})
    assert got == ref
    assert res.counters["Tree:Paths"] == len(json.loads(got)["decisionPaths"])
    assert res.counters["Tree:Paths"] >= 2


@pytest.mark.parametrize("strategy", ["notUsedYet", "randomNotUsedYet",
                                      "randomAll", "all"])
def test_dec_tree_attribute_strategies_match_jax(hangup, tmp_path, strategy):
    """The random strategies draw from the builder's seeded numpy rng in
    the JAX package's order."""
    _, got, ref = _dec_tree_pair(
        hangup, tmp_path,
        **{"dtb.split.attribute.selection.strategy": strategy})
    assert got == ref


@pytest.mark.parametrize("sampling", ["withReplace", "withoutReplace"])
def test_random_forest_trees_match_jax(hangup, tmp_path, sampling):
    props = {"dtb.feature.schema.file.path": hangup["schema"],
             "dtb.num.trees": "4", "dtb.max.depth.limit": "4",
             "dtb.sub.sampling.strategy": sampling}
    ref = jax_run_job("randomForest", props, [hangup["train"]],
                      str(tmp_path / "jax"))
    got = run_job("randomForest", props, [hangup["train"]],
                  str(tmp_path / "port"), device=CPU)
    assert got.counters == {"Tree:Trees": 4} == ref.counters
    assert [p.split("/")[-1] for p in got.outputs] == \
        [f"tree-{t:03d}.json" for t in range(4)]
    for g, r in zip(got.outputs, ref.outputs):
        assert open(g, "rb").read() == open(r, "rb").read(), g


def test_forest_runs_one_histogram_call_a_level(hangup):
    """All trees grow together: one `_level_histogram_forest` call a level
    for the whole forest, and one more for the final distributions."""
    ds = Dataset.from_csv(hangup["train"], call_hangup_schema())
    before = ptree._level_histogram_forest.calls
    rf = ptree.RandomForestBuilder(ds.schema, num_trees=5, max_depth=4,
                                   seed=2, device=CPU).fit(ds)
    levels = max(len(p.predicates) for t in rf.trees for p in t.paths)
    assert levels == 4
    assert ptree._level_histogram_forest.calls - before == levels + 1


def test_tree_jobs_record_their_spans(hangup, tmp_path):
    props = {"dtb.feature.schema.file.path": hangup["schema"],
             "dtb.num.trees": "2", "dtb.max.depth.limit": "3"}
    with obs.capture() as rec:
        run_job("randomForest", props, [hangup["train"]],
                str(tmp_path / "f"), device=CPU)
    spans = rec.spans()
    names = {sp.name for sp in spans}
    assert {"job.run", "stream.read", "stream.parse", "stream.fold",
            "job.finish"} <= names
    levels = [sp.attrs["chunk"] for sp in spans if sp.name == "stream.fold"
              and sp.attrs["sink"] == "forest_level"]
    assert levels == [0, 1, 2, "final"]


# ----------------------------------------------------------------- predict
def _with_missing(text, n_missing=40):
    """CSV text with some hold times blank (NaN) and some rows' issue
    changed, for an unknown category code made later."""
    lines = text.splitlines()
    for i in range(0, n_missing * 7, 7):
        toks = lines[i].split(",")
        toks[5] = ""
        lines[i] = ",".join(toks)
    return "\n".join(lines) + "\n"


def _unknown_category(ds, rows):
    """Set the `issue` code (ordinal 3) of `rows` to -1, a code no
    cardinality holds."""
    col = np.array(ds.column(3), copy=True)
    col[rows] = -1
    ds.columns[3] = col


def test_device_path_evaluator_matches_jax_and_host(hangup):
    text = _with_missing(open(hangup["train"]).read())
    obj = call_hangup_schema().to_json()
    ds, jds = _both(generate_call_hangup(2000, seed=9, as_csv=True), obj)
    rf = ptree.RandomForestBuilder(ds.schema, num_trees=3, max_depth=4,
                                   seed=4, device=CPU).fit(ds)
    jrf = jtree.RandomForestBuilder(jds.schema, num_trees=3, max_depth=4,
                                    seed=4).fit(jds)
    assert [t.to_json() for t in rf.trees] == [t.to_json() for t in jrf.trees]
    test, jtest = _both(text, obj)
    assert np.isnan(test.column(5)).sum() == 40
    unknown = np.arange(3, 300, 11)
    _unknown_category(test, unknown)
    _unknown_category(jtest, unknown)
    for trees in (rf.trees, rf.trees[:1]):
        dev = ptree.DevicePathEvaluator(trees, test.schema, rf.class_values,
                                        device=CPU)
        jdev = jtree.DevicePathEvaluator(
            [jtree.DecisionPathList.from_json(t.to_json()) for t in trees],
            jtest.schema, jrf.class_values)
        got = dev.per_tree_predict(test, row_block=1000)
        ref = jdev.per_tree_predict(jtest)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(dev.predict(test), jdev.predict(jtest))
        for ti, t in enumerate(trees):
            host = t.predict(test, rf.class_values)
            jhost = jtree.DecisionPathList.from_json(t.to_json()).predict(
                jtest, jrf.class_values)
            np.testing.assert_array_equal(host, jhost)
            # the device evaluator agrees with the host loop exactly where
            # the JAX package's does (NaN rows alike; an unknown code
            # reads as category 0 on the device, as jnp.clip makes it)
            np.testing.assert_array_equal(got[:, ti] == host,
                                          ref[:, ti] == jhost)
            nan_rows = np.isnan(test.column(5))
            np.testing.assert_array_equal(got[nan_rows, ti], host[nan_rows])
    np.testing.assert_array_equal(rf.predict(test, device=True),
                                  jrf.predict(jtest, device=True))
    np.testing.assert_array_equal(rf.predict(test), jrf.predict(jtest))


def test_jax_saved_tree_loads_in_port(hangup, tmp_path):
    """A DecisionPathList the JAX package saved is the port's model: the
    same paths, and the same predictions on the host and the device."""
    obj = call_hangup_schema().to_json()
    ds, jds = _both(open(hangup["train"]).read(), obj)
    jtree_model = jtree.DecisionTreeBuilder(jds.schema, max_depth=4).fit(jds)
    path = tmp_path / "decPath.json"
    jtree_model.save(str(path))
    got = ptree.DecisionPathList.load(str(path))
    assert got.to_json() == jtree_model.to_json()
    classes = ds.schema.class_values()
    np.testing.assert_array_equal(got.predict(ds, classes),
                                  jtree_model.predict(jds, classes))
    dev = ptree.DevicePathEvaluator([got], ds.schema, classes, device=CPU)
    jdev = jtree.DevicePathEvaluator([jtree_model], jds.schema, classes)
    np.testing.assert_array_equal(dev.predict(ds), jdev.predict(jds))
    again = tmp_path / "again.json"
    got.save(str(again))
    assert again.read_bytes() == path.read_bytes()


def test_default_device_needs_a_gpu(monkeypatch, hangup, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    schema = call_hangup_schema()
    for call in (lambda: ptree.DecisionTreeBuilder(schema),
                 lambda: ptree.RandomForestBuilder(schema),
                 lambda: run_job("decTree", {
                     "dtb.feature.schema.file.path": hangup["schema"]},
                     [hangup["train"]], str(tmp_path / "o.txt"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ------------------------------------------------- partitions and stats
@pytest.mark.parametrize("props", [
    {}, {"dap.split.algorithm": "entropy"}, {"dap.split.attribute": "5"},
    {"dap.split.attribute": "3", "dap.split.algorithm": "entropy"}])
def test_data_partitioner_files_match_jax(hangup, tmp_path, props):
    props = {"dap.feature.schema.file.path": hangup["schema"], **props}
    ref = jax_run_job("dataPartitioner", props, [hangup["train"]],
                      str(tmp_path / "jax"))
    got = run_job("dataPartitioner", props, [hangup["train"]],
                  str(tmp_path / "port"), device=CPU)
    assert got.counters == ref.counters
    assert [p.split("/port/")[1] for p in got.outputs] == \
        [p.split("/jax/")[1] for p in ref.outputs]
    rows = 0
    for g, r in zip(got.outputs, ref.outputs):
        assert open(g, "rb").read() == open(r, "rb").read(), g
        rows += len(open(g).read().splitlines())
    assert rows == ROWS


def test_to_csv_matches_jax(hangup):
    """Raw rows pass through; rebuilt rows (codes decoded, NaN blank,
    the undeclared area code an empty token) as JAX writes them."""
    obj = call_hangup_schema().to_json()
    text = _with_missing(generate_call_hangup(300, seed=8, as_csv=True))
    ds, jds = _both(text, obj)
    assert ds.to_csv() == jds.to_csv()
    assert ds.to_csv(";") == jds.to_csv(";")
    raw = Dataset.from_csv(text, FeatureSchema.from_json(obj), keep_raw=True)
    assert raw.to_csv() == text
    assert raw.take(np.arange(5, 50)).to_csv() == \
        "".join(text.splitlines(True)[5:50])


@pytest.mark.parametrize("algo", ["entropy", "giniIndex"])
def test_class_partition_stats_within_1e6_of_jax(hangup, tmp_path, algo):
    """Entropy and gini stats come from float32 logs and sums in XLA's
    CPU order (`ops/infotheory.py` on `xla_math`): the reference's bit for
    bit, so the file is byte-identical, with the same best split."""
    props = {"cpg.feature.schema.file.path": hangup["schema"],
             "cpg.split.algorithm": algo}
    ref = jax_run_job("classPartitionGenerator", props, [hangup["train"]],
                      str(tmp_path / "jax.txt"))
    got = run_job("classPartitionGenerator", props, [hangup["train"]],
                  str(tmp_path / "port.txt"), device=CPU)
    assert got.counters == ref.counters == {"Splits:Candidates": 18}
    g = [ln.split(",") for ln in open(got.outputs[0]).read().splitlines()]
    r = [ln.split(",") for ln in open(ref.outputs[0]).read().splitlines()]
    assert [x[:2] for x in g] == [x[:2] for x in r]
    assert g == r
    obj = call_hangup_schema().to_json()
    ds, jds = _both(open(hangup["train"]).read(), obj)
    best = ClassPartitionGenerator(ds, algorithm=algo, device=CPU).best_split()
    jbest = JaxClassPartitionGenerator(jds, algorithm=algo).best_split()
    assert best[0].split_id == jbest[0].split_id
    assert best[1] == jbest[1]


def test_class_partition_hellinger_byte_identical(hangup, tmp_path):
    props = {"cpg.feature.schema.file.path": hangup["schema"],
             "cpg.split.algorithm": "hellingerDistance",
             "cpg.split.attributes": "3,5"}
    ref = jax_run_job("splitGenerator", props, [hangup["train"]],
                      str(tmp_path / "jax.txt"))
    got = run_job("org.avenir.tree.SplitGenerator", props, [hangup["train"]],
                  str(tmp_path / "port.txt"), device=CPU)
    assert got.counters == ref.counters == {"Splits:Candidates": 16}
    assert open(got.outputs[0], "rb").read() == \
        open(ref.outputs[0], "rb").read()
