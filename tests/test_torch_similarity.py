"""The port's record similarity and the joiner on the CPU against the JAX
package.

- `RecordSimilarity` intra and inter pairs, on the mixed schema of
  tests/test_similarity.py (a categorical and two numerics) and on
  e-learning, under both metrics, with and without attribute weights,
  `id_first` both ways, with a block smaller than the rows (several tiles,
  the tiles below the diagonal skipped): the pairs and the `save` bytes
  equal JAX's. Under manhattan every byte is equal. Under euclidean the
  cross term is a matrix product whose sum order XLA's CPU dot picks by
  shape; a line may then differ, and only by one, where the two fp32
  distances lie on either side of the rounding boundary (k + 0.5) / scale
  and their squared sums differ by at most 4 ulps of |q|^2 + |t|^2 (the
  dot form's cancellation error). Each such pair is named.
- `read_distance_file` and `distance_matrix_from_file` equal JAX's.
- The jobs `recordSimilarity` (and its alias `sameTypeSimilarity`, the
  three schema key spellings), `groupedRecordSimilarity` and
  `featureCondProbJoiner`: output bytes and counters equal JAX
  `run_job`'s.
- Divide against reciprocal: `pairwise_distance(divide=True)` equals the
  JAX function called eagerly (as RecordSimilarity calls it), and the
  default equals it under `jax.jit` (as the KNN route runs it), bit for
  bit; the two differ on some pairs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.core.dataset import Dataset as JaxDataset
from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.models import similarity as jsim
from avenir_tpu.ops.distance import pairwise_distance as jax_pairwise
from avenir_tpu.runner import run_job as jax_run_job
from avenir_tpu_torch.core.config import MissingConfigError
from avenir_tpu_torch.core.dataset import Dataset, extract_mixed_features
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.data import elearn_schema, generate_elearn
from avenir_tpu_torch.models import similarity as tsim
from avenir_tpu_torch.ops.distance import pairwise_distance
from avenir_tpu_torch.runner import run_job

CPU = "cpu"
MIXED = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "grp", "ordinal": 1, "dataType": "categorical",
     "cardinality": ["a", "b", "c"], "feature": True},
    {"name": "x", "ordinal": 2, "dataType": "double", "feature": True,
     "min": 0, "max": 10},
    {"name": "y", "ordinal": 3, "dataType": "double", "feature": True,
     "min": 0, "max": 10},
    {"name": "kind", "ordinal": 4, "dataType": "categorical",
     "cardinality": ["u", "v"], "feature": True},
]}


def _mixed_rows(n, seed):
    rng = np.random.default_rng(seed)
    return [f"r{i:04d},{'abc'[rng.integers(3)]},{rng.integers(0, 1001) / 100},"
            f"{rng.integers(0, 101) / 10},{'uv'[rng.integers(2)]}"
            for i in range(n)]


def _both(kind, n, seed):
    """(port Dataset, JAX Dataset) of the same seeded rows."""
    if kind == "mixed":
        rows = [r.split(",") for r in _mixed_rows(n, seed)]
        return (Dataset.from_rows(rows, FeatureSchema.from_json(MIXED)),
                JaxDataset.from_rows(rows, JaxSchema.from_json(MIXED)))
    from avenir_tpu.data import generate_elearn as jax_generate_elearn
    return generate_elearn(n, seed=seed), jax_generate_elearn(n, seed=seed)


def _weights(kind, weighted):
    if not weighted:
        return {}
    if kind == "mixed":
        return {"num_weights": [0.5, 2.0], "cat_weights": [1.5, 0.25]}
    return {"num_weights": [1.0, 2.0, 0.5, 1.5, 3.0, 0.25]}


def _exact(ds, weights, metric):
    """id -> (scaled numeric row, categorical codes) in float64, and the
    categorical weights: what the exact squared sum of a pair needs."""
    x, ranges, x_cat, _ = extract_mixed_features(ds)
    w = np.asarray(weights.get("num_weights", np.ones(x.shape[1])), np.float64)
    s = (np.sqrt(w) if metric == "euclidean" else w) / ranges
    cats = (x_cat if x_cat is not None
            else np.zeros((len(ds), 0), np.int32))
    rows = dict(zip(ds.ids(), zip(x.astype(np.float64) * s, cats)))
    return rows, np.asarray(weights.get("cat_weights",
                                        np.ones(cats.shape[1])), np.float64)


def _check_lines(got, ref, metric, exact_a, exact_b, scale, w_total,
                 id_first):
    """Bytes equal, or (euclidean) the differing lines under the boundary
    rule of the module docstring. Returns the differing pairs."""
    assert len(got) == len(ref)
    if metric != "euclidean":
        assert got == ref
        return []
    (rows_a, cw), (rows_b, _) = exact_a, exact_b
    named = []
    for g, r in zip(got, ref):
        if g == r:
            continue
        gt, rt = g.split(","), r.split(",")
        if id_first:
            ids, sg, sr = gt[:2], int(gt[2]), int(rt[2])
            assert rt[:2] == ids
        else:
            ids, sg, sr = gt[1:], int(gt[0]), int(rt[0])
            assert rt[1:] == ids
        assert abs(sg - sr) == 1, (g, r)
        (q, qc), (t, tc) = rows_a[ids[0]], rows_b[ids[1]]
        norms = float(q @ q + t @ t)
        sum2 = float(((q - t) ** 2).sum() + (cw * (qc != tc)).sum())
        # the boundary's squared sum lies within the fp32 cross term's
        # cancellation error of the pair's exact one
        b2 = ((min(sg, sr) + 0.5) / scale) ** 2 * w_total
        assert abs(b2 - sum2) <= 4 * 2 ** -23 * norms + 2 ** -22 * b2, \
            (g, r, b2, sum2, norms)
        named.append((ids[0], ids[1], sg, sr))
    assert len(named) <= max(1, len(got) // 10000), named
    return named


@pytest.mark.parametrize("kind", ["mixed", "elearn"])
@pytest.mark.parametrize("metric", ["manhattan", "euclidean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("id_first", [True, False])
def test_pairs_and_save_match_jax(tmp_path, kind, metric, weighted, id_first):
    a, ja = _both(kind, 230, seed=1)
    b, jb = _both(kind, 170, seed=2)
    kw = _weights(kind, weighted)
    got = tsim.RecordSimilarity(metric=metric, block=64, device=CPU, **kw)
    ref = jsim.RecordSimilarity(metric=metric, block=64, **kw)
    w_total = (sum(kw.get("num_weights", [1.0] * 6 if kind == "elearn"
                          else [1.0] * 2))
               + sum(kw.get("cat_weights", [1.0] * 2 if kind == "mixed"
                            else [])))
    for name, gp, rp, rows in (
            ("intra", got.intra(a), ref.intra(ja), (a, a)),
            ("inter", got.inter(a, b), ref.inter(ja, jb), (a, b))):
        n = got.save(gp, str(tmp_path / f"{name}_port"), id_first=id_first)
        n_ref = ref.save(rp, str(tmp_path / f"{name}_jax"), id_first=id_first)
        assert n == n_ref == (230 * 229 // 2 if name == "intra" else 230 * 170)
        lines = (tmp_path / f"{name}_port").read_text().splitlines()
        ref_lines = (tmp_path / f"{name}_jax").read_text().splitlines()
        named = _check_lines(lines, ref_lines, metric,
                             _exact(rows[0], kw, metric),
                             _exact(rows[1], kw, metric), got.scale, w_total,
                             id_first)
        if named:
            print(f"{kind} {metric} weighted={weighted} {name}: {named}")
    # iterating yields the JAX generator's triples, order and values
    trip = list(got.inter(a, b))
    ref_trip = list(ref.inter(ja, jb))
    assert [t[:2] for t in trip] == [t[:2] for t in ref_trip]
    if metric == "manhattan":
        assert [t[2] for t in trip] == [t[2] for t in ref_trip]


@pytest.mark.parametrize("weighted", [False, True])
def test_euclidean_boundary_pairs_are_named(tmp_path, weighted):
    """E-learning 1000 x 600 in 256-row tiles: where XLA's CPU dot sums a
    tile's cross term in another order than torch's, a pair on a rounding
    boundary may round the other way; each is named and held to the
    boundary rule. (Probed: 3 and 4 such pairs of 600,000, none intra.)"""
    a, ja = _both("elearn", 1000, seed=1)
    b, jb = _both("elearn", 600, seed=2)
    kw = _weights("elearn", weighted)
    got = tsim.RecordSimilarity(metric="euclidean", block=256, device=CPU,
                                **kw)
    ref = jsim.RecordSimilarity(metric="euclidean", block=256, **kw)
    got.save(got.inter(a, b), str(tmp_path / "port"))
    ref.save(ref.inter(ja, jb), str(tmp_path / "jax"))
    named = _check_lines(
        (tmp_path / "port").read_text().splitlines(),
        (tmp_path / "jax").read_text().splitlines(), "euclidean",
        _exact(a, kw, "euclidean"), _exact(b, kw, "euclidean"), got.scale,
        sum(kw.get("num_weights", [1.0] * 6)), True)
    print(f"euclidean weighted={weighted}: {named}")


@pytest.mark.parametrize("metric", ["manhattan", "euclidean"])
def test_divide_and_reciprocal_against_jax_eager_and_jitted(metric):
    """The similarity path divides by the weight total, as the eager JAX
    call does, and equals it bit for bit. The reciprocal (the KNN route's
    default, where XLA folds the constant) rounds differently: under
    manhattan here some scaled integers flip, so the distance file needs
    the division. The jitted JAX call also fuses the rest of the
    arithmetic, so the reciprocal path is held to it within 1e-6 (the
    euclidean squared sums as in tests/test_torch_knn.py)."""
    a, _ = _both("elearn", 300, seed=13)
    x, ranges, _, _ = extract_mixed_features(a)
    j_args = (jnp.asarray(x), jnp.asarray(x), None, None, None,
              jnp.asarray(ranges), metric)
    eager = np.asarray(jax_pairwise(*j_args))
    jitted = np.asarray(jax.jit(jax_pairwise, static_argnums=(4, 6))(*j_args))
    t_args = (torch.from_numpy(x), torch.from_numpy(x), None, None, None,
              torch.from_numpy(ranges), metric)
    div = pairwise_distance(*t_args, divide=True).numpy()
    mul = pairwise_distance(*t_args).numpy()
    np.testing.assert_array_equal(div, eager)
    if metric == "manhattan":
        np.testing.assert_allclose(mul, jitted, rtol=1e-6, atol=1e-7)
    else:
        # the dot form's error is absolute in the squared sum (as in
        # tests/test_torch_knn.py), which the root magnifies near 0
        np.testing.assert_allclose(mul ** 2 * 6, jitted ** 2 * 6,
                                   rtol=1e-4, atol=4e-6)
    assert (div != mul).mean() > 0.1

    def scaled(d):
        return np.rint(d.astype(np.float64) * 1000)
    flips = int((scaled(div) != scaled(mul)).sum())
    assert flips > 0 or metric == "euclidean", flips


def test_pairs_through_save_from_a_plain_iterable(tmp_path):
    a, ja = _both("mixed", 40, seed=3)
    got = tsim.RecordSimilarity(block=16, device=CPU)
    ref = jsim.RecordSimilarity(block=16)
    for id_first in (True, False):
        got.save(iter(list(got.intra(a))), str(tmp_path / "p"),
                 id_first=id_first)
        ref.save(ref.intra(ja), str(tmp_path / "j"), id_first=id_first)
        assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()


def test_non_finite_distance_raises(tmp_path):
    rows = [r.split(",") for r in _mixed_rows(6, seed=4)]
    rows[2][2] = ""                       # a missing numeric: NaN
    ds = Dataset.from_rows(rows, FeatureSchema.from_json(MIXED))
    sim = tsim.RecordSimilarity(device=CPU)
    with pytest.raises(ValueError, match="not finite"):
        sim.save(sim.intra(ds), str(tmp_path / "o"))


@pytest.mark.parametrize("id_first", [True, False])
def test_read_distance_file_and_matrix_match_jax(tmp_path, id_first):
    a, ja = _both("mixed", 50, seed=5)
    path = str(tmp_path / "d.txt")
    sim = tsim.RecordSimilarity(block=16, device=CPU)
    sim.save(sim.intra(a), path, id_first=id_first)
    got = tsim.read_distance_file(path, id_first=id_first)
    ref = jsim.read_distance_file(path, id_first=id_first)
    assert got == ref and len(got) == 50 * 49
    ids = list(a.ids()) + ["absent"]
    m = tsim.distance_matrix_from_file(path, ids, pairs=got)
    np.testing.assert_array_equal(m, jsim.distance_matrix_from_file(
        path, ids, pairs=ref))
    if id_first:
        np.testing.assert_array_equal(
            tsim.distance_matrix_from_file(path, ids, default=-1.0),
            jsim.distance_matrix_from_file(path, ids, default=-1.0))


def test_grouped_intra_matches_jax():
    a, ja = _both("mixed", 120, seed=6)
    got = tsim.GroupedRecordSimilarity([1, 4], block=8, device=CPU)
    ref = jsim.GroupedRecordSimilarity([1, 4], block=8)
    g, r = list(got.grouped_intra(a)), list(ref.grouped_intra(ja))
    assert g == r and len({t[0] for t in g}) == 6


def test_take_and_decode_value_match_jax():
    a, ja = _both("mixed", 30, seed=7)
    idx = np.asarray([5, 0, 29, 5])
    sub, jsub = a.take(idx), ja.take(idx)
    assert len(sub) == len(jsub) == 4
    for o in range(5):
        np.testing.assert_array_equal(sub.column(o), jsub.column(o))
    fld, jfld = a.schema.field_by_ordinal(1), ja.schema.field_by_ordinal(1)
    assert [fld.decode_value(c) for c in range(3)] == \
        [jfld.decode_value(c) for c in range(3)]
    with pytest.raises(ValueError, match="not categorical"):
        a.schema.field_by_ordinal(2).decode_value(0)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sim_jobs")
    mixed = d / "mixed.json"
    mixed.write_text(__import__("json").dumps(MIXED))
    elearn = d / "elearn.json"
    elearn_schema().save(str(elearn))
    (d / "m1.csv").write_text("\n".join(_mixed_rows(90, seed=8)) + "\n")
    (d / "m2.csv").write_text("\n".join(_mixed_rows(40, seed=9)) + "\n")
    (d / "e1.csv").write_text(generate_elearn(80, seed=10, as_csv=True))
    (d / "e2.csv").write_text(generate_elearn(30, seed=11, as_csv=True))
    return d


def _same_job(name, props, inputs, tmp_path):
    ref = jax_run_job(name, props, inputs, str(tmp_path / "jax.txt"))
    got = run_job(name, props, inputs, str(tmp_path / "port.txt"), device=CPU)
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    assert got.counters == {k: v for k, v in ref.counters.items()
                            if k in got.counters} and got.counters
    return got


@pytest.mark.parametrize("case", [
    ("recordSimilarity", "mixed", ["m1"], {}),
    ("recordSimilarity", "mixed", ["m1", "m2"],
     {"sts.output.id.first": "false", "sts.cat.attribute.weights": "2,0.5",
      "sts.num.attribute.weights": "1,3"}),
    ("sameTypeSimilarity", "elearn", ["e1"],
     {"sts.inter.set.matching": "true", "sts.distance.scale": "100"}),
    ("org.avenir.spark.similarity.RecordSimilarity", "elearn", ["e1", "e2"],
     {"field.delim": ";", "sts.num.attribute.weights": "1,1,2,2,0.5,0.5"}),
], ids=["intra", "inter_weighted", "alias_inter_one_input", "class_name"])
@pytest.mark.parametrize("schema_key", ["feature.schema.file.path",
                                        "same.schema.file.path",
                                        "rich.attr.schema.path"])
def test_record_similarity_job_matches_jax(files, tmp_path, case, schema_key):
    name, schema, inputs, extra = case
    props = {f"sts.{schema_key}": str(files / f"{schema}.json"), **extra}
    got = _same_job(name, props, [str(files / f"{i}.csv") for i in inputs],
                    tmp_path)
    assert got.name == "recordSimilarity"
    assert got.counters["Similarity:Pairs"] > 0


def test_record_similarity_job_without_schema_raises(files, tmp_path):
    with pytest.raises(MissingConfigError,
                       match="sts.feature.schema.file.path"):
        run_job("recordSimilarity", {}, [str(files / "m1.csv")],
                str(tmp_path / "o"), device=CPU)


@pytest.mark.parametrize("ordinals", ["1", "1,4", "2"])
def test_grouped_record_similarity_job_matches_jax(files, tmp_path, ordinals):
    props = {"grs.feature.schema.file.path": str(files / "mixed.json"),
             "grs.group.field.ordinals": ordinals,
             "grs.distance.metric": "euclidean"}
    _same_job("groupedRecordSimilarity", props, [str(files / "m1.csv")],
              tmp_path)


@pytest.mark.parametrize("variant", ["prefix", "last_input", "id_last",
                                     "swapped", "delim"])
def test_feature_cond_prob_joiner_matches_jax(files, tmp_path, variant):
    """The distance file from recordSimilarity, the posterior file written
    as bayesianPredictor's feature-prob mode writes it."""
    d = tmp_path / "in"
    d.mkdir()
    delim = ";" if variant == "delim" else ","
    props = {"sts.feature.schema.file.path": str(files / "elearn.json"),
             "field.delim": delim}
    if variant == "id_last":
        props["sts.output.id.first"] = "false"
    # the train set first, so each row's second id is the train row's;
    # swapped: the train set second, so the joiner swaps the pair
    sets = (["e2", "e1"] if variant == "swapped" else ["e1", "e2"])
    run_job("recordSimilarity", props, [str(files / f"{s}.csv") for s in sets],
            str(d / "simi.txt"), device=CPU)
    train = generate_elearn(80, seed=10)
    rng = np.random.default_rng(12)
    probs = "".join(f"{rid}{delim}{p:.6g}\n" for rid, p in
                    zip(train.ids()[::2], rng.random(40)))
    name = "probs.txt" if variant == "last_input" else "condProb.txt"
    (d / name).write_text(probs)
    inputs = [str(d / name), str(d / "simi.txt")]
    if variant == "last_input":
        inputs = inputs[::-1]
    got = _same_job("featureCondProbJoiner", props, inputs, tmp_path)
    assert 0 < got.counters["Join:Pairs"] < 80 * 30
