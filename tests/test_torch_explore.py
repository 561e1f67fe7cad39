"""The port's profiling ops and models on the CPU against the JAX package.

- `ops/reduce.py`: every keyed reduction equal to its JAX function on the
  same seeded inputs (counts exactly; `moment_reduce` bit for bit in the
  order of the JAX Naive Bayes einsum it follows).
- `ops/infotheory.py`: float32 like the reference, bit for bit (XLA's
  CPU log and reduce orders, `ops/xla_math.py`).
- `models/explore.py`: the MI count tables exactly, through the fused
  keyspace, its host twin and the per-pair path past the fused limit;
  every score algorithm (same feature order, values within 1e-6); the
  contingency family; `NumericMomentAccumulator`.
- the jobs `mutualInformation`, `cramerCorrelation`,
  `categoricalCorrelation`, `heterogeneityReduction` and
  `numericalCorrelation` through `run_job` and the CLI: Cramér and
  numerical correlation, MI and heterogeneity byte-identical to
  `avenir_tpu.runner.run_job`'s.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.core.dataset import Dataset as JaxDataset
from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.models import explore as jex
from avenir_tpu.ops import infotheory as jinfo
from avenir_tpu.ops import reduce as jred
from avenir_tpu.runner import run_job as jax_run_job
from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.data import (churn_schema, elearn_schema, generate_churn,
                                   generate_elearn)
from avenir_tpu_torch.models import explore as ex
from avenir_tpu_torch.ops import infotheory as info
from avenir_tpu_torch.ops import reduce as red
from avenir_tpu_torch.runner import DELTA_COUNTERS, MEM_COUNTERS, run_job

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
ALGOS = ("mutual.info.maximization", "mutual.info.selection",
         "joint.mutual.info", "double.input.symmetric.relevance",
         "min.redundancy.max.relevance")


def _units(a: float, b: float) -> int:
    """|a - b| in units of the 6th decimal."""
    return round(abs(a - b) * 1e6)


def assert_within_one_unit(got: str, ref: str, delim: str = ","):
    """Same lines, every token equal but the last, the last (a `%.6f`
    value) within one unit in the 6th decimal."""
    g_lines, r_lines = got.splitlines(), ref.splitlines()
    assert len(g_lines) == len(r_lines)
    for g, r in zip(g_lines, r_lines):
        gt, rt = g.split(delim), r.split(delim)
        assert gt[:-1] == rt[:-1], (g, r)
        assert _units(float(gt[-1]), float(rt[-1])) <= 1, (g, r)


def _churn_text(n, seed):
    return generate_churn(n, seed=seed, as_csv=True)


def _both(text, schema_obj):
    return (Dataset.from_csv(text, FeatureSchema.from_json(schema_obj)),
            JaxDataset.from_csv(text, JaxSchema.from_json(schema_obj),
                                engine="python"))


def _mixed_schema():
    """churn with a data-discovered (undeclared) vocabulary on payment, so
    its bin axis can grow between chunks."""
    obj = churn_schema().to_json()
    for fld in obj["fields"]:
        if fld["name"] == "payment":
            del fld["cardinality"]
    return obj


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    d = tmp_path_factory.mktemp("explore")
    out = {"dir": d}
    for name, obj in (("churn", churn_schema().to_json()),
                      ("mixed", _mixed_schema()),
                      ("elearn", elearn_schema().to_json())):
        path = d / f"{name}.json"
        path.write_text(json.dumps(obj))
        out[f"{name}_schema"] = str(path)
    (d / "churn.csv").write_text(_churn_text(3000, 21))
    (d / "elearn.csv").write_text(generate_elearn(2000, seed=22, as_csv=True))
    out["churn"], out["elearn"] = str(d / "churn.csv"), str(d / "elearn.csv")
    return out


# ---------------------------------------------------------------- reduce
@pytest.mark.parametrize("k", [2, 3, 7])
@pytest.mark.parametrize("n", [1, 257, 20003])
def test_keyed_reduce_and_moment_reduce_match_jax(n, k):
    """Counts exactly. `moment_reduce` bit for bit in the order of the
    JAX package's Naive Bayes count einsum, which it follows, for x [n]
    and x [n, 2]; where that order is the rows in order (one field, at
    most three keys) also bit for bit the JAX `moment_reduce` (a
    segment_sum, which adds in row order on the CPU)."""
    from avenir_tpu.models.naive_bayes import _count_batch_kernel

    rng = np.random.default_rng(n + k)
    keys = rng.integers(0, k, n).astype(np.int32)
    x = (rng.random((n, 2)) * 100).astype(np.float32)
    kt = torch.from_numpy(keys)
    counts = red.keyed_reduce(kt, k)
    assert counts.dtype == torch.int64
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(jred.keyed_reduce(jnp.asarray(keys), None, k)))

    def einsum_order(xx):
        return np.asarray(_count_batch_kernel(
            jnp.zeros((n, 1), jnp.int32), jnp.asarray(keys), jnp.asarray(xx),
            jnp.ones((n,), jnp.float32), k, 1)[1])

    got1 = red.moment_reduce(kt, torch.from_numpy(x[:, 0]), k)
    np.testing.assert_array_equal(got1.numpy(), einsum_order(x[:, :1])[0])
    got2 = red.moment_reduce(kt, torch.from_numpy(x), k)
    np.testing.assert_array_equal(got2.numpy(), einsum_order(x))
    seg = np.asarray(jred.moment_reduce(jnp.asarray(keys),
                                        jnp.asarray(x[:, 0]), k))
    np.testing.assert_array_equal(got1.numpy()[:, 0], seg[:, 0])
    if k <= 3:
        np.testing.assert_array_equal(got1.numpy(), seg)


def test_counts_combine_and_cross_match_jax():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 4, 999).astype(np.int32)
    b = rng.integers(0, 6, 999).astype(np.int32)
    c = rng.integers(0, 3, (999, 5)).astype(np.int32)
    at, bt, ct = (torch.from_numpy(x) for x in (a, b, c))
    np.testing.assert_array_equal(
        red.combine_codes([at, bt], [4, 6]).numpy(),
        np.asarray(jred.combine_codes([jnp.asarray(a), jnp.asarray(b)],
                                      [4, 6])))
    np.testing.assert_array_equal(
        red.cross_count(at, bt, 4, 6).numpy(),
        np.asarray(jred.cross_count(jnp.asarray(a), jnp.asarray(b), 4, 6)))
    np.testing.assert_array_equal(
        red.one_hot_count(at, 4).numpy(),
        np.asarray(jred.one_hot_count(jnp.asarray(a), 4)))
    np.testing.assert_array_equal(
        red.one_hot_count(ct, 3).numpy(),
        np.asarray(jred.one_hot_count(jnp.asarray(c), 3)))
    for t in (red.cross_count(at, bt, 4, 6), red.one_hot_count(ct, 3)):
        assert t.dtype == torch.int64


# ------------------------------------------------------------ infotheory
def _tables(seed):
    rng = np.random.default_rng(seed)
    out = [np.floor(rng.random((r, 2)) * 200000) for r in (4, 9, 36)]
    out.append(np.array([[0, 5], [0, 0], [7, 0]], np.float64))
    out.append(np.floor(rng.random((3, 4, 5)) * 50))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_infotheory_matches_jax(seed):
    for t in _tables(seed):
        jt = jnp.asarray(t)
        pairs = [(info.mutual_information(t), jinfo.mutual_information(jt)),
                 (info.entropy(t), jinfo.entropy(jt)),
                 (info.entropy(t, axis=0), jinfo.entropy(jt, axis=0)),
                 (info.bits_entropy(t), jinfo.bits_entropy(jt)),
                 (info.gini(t), jinfo.gini(jt)),
                 (info.weighted_split_score(t),
                  jinfo.weighted_split_score(jt)),
                 (info.weighted_split_score(t, "giniIndex"),
                  jinfo.weighted_split_score(jt, "giniIndex"))]
        for got, ref in pairs:
            assert got.dtype == torch.float32
            ref = np.asarray(ref)
            assert got.shape == ref.shape
            np.testing.assert_array_equal(got.numpy(), ref)


def test_tutorial_mi_value_one_float32_ulp_from_jax(env):
    """The MI value of docs/tutorial_scale_streaming.md that sat one
    float32 ULP from the reference's while the port summed its terms in
    torch's order: featureClassMI of churn field 5 on the tutorial's
    2,000 rows (seed 33), on a 6th-decimal rounding edge. The count table
    and its 22 terms are the reference's; the terms' sum now runs in
    XLA's CPU order (`xla_math.sum_last2`), so the value is the
    reference's bit for bit and prints as it does."""
    port, ref = _analyzers(generate_churn(2000, seed=33, as_csv=True),
                           churn_schema().to_json())
    i = [f.ordinal for f in port.fields].index(5)
    np.testing.assert_array_equal(port._fc[i], ref._fc[i])
    assert port._fc[i].shape == (11, 2)
    got = np.float32(info.mutual_information(port._fc[i]))
    want = np.float32(jinfo.mutual_information(jnp.asarray(ref._fc[i])))
    assert got == want, _xla_host()
    assert f"{got:.6f}" == f"{want:.6f}" == "0.305638"


def _xla_host():
    """Why a bit test of XLA's CPU order may fail on another host: the
    jaxlib and CPU flags the orders were read on (`xla_math.READ_ON`),
    beside this run's."""
    import platform

    import jaxlib

    from avenir_tpu_torch.ops import xla_math
    flags = ""
    try:
        with open("/proc/cpuinfo") as fh:
            line = next(ln for ln in fh if ln.startswith("flags"))
        flags = " ".join(sorted(f for f in line.split()
                                if f.startswith(("avx", "fma", "sse4"))))
    except (OSError, StopIteration):
        pass
    return (f"XLA's CPU orders were read on jaxlib "
            f"{xla_math.READ_ON['jaxlib']} ({xla_math.READ_ON['cpu']}); "
            f"this run: jaxlib {jaxlib.__version__} on "
            f"{platform.machine()} with [{flags}]. A mismatch on "
            f"another jaxlib or vector ISA is a host or compiler change, "
            f"not a port fault.")


#: XLA's CPU reduce of an [R, C] float32 table over both axes, by class
#: of shape: serial rows (R not 2, 4 or 8 below 16; one column; more
#: than eight), 2 / 4 / 8 lanes, both lane counts of 16-32 rows, the
#: windows of 32 unpadded and padded, on rows, on columns, on both, and
#: two rounds of windows; the MI jobs' own tables are among them ([11, 2]
#: [12, 2] [16, 2] [2, 2] [3, 11] [3, 4] [4, 3] [33, 2] [36, 2] [44, 2]
#: [9, 2] and the flattened pair-class tables)
SUM_SHAPES = [(1, 1), (1, 7), (2, 2), (2, 9), (3, 2), (3, 11), (4, 2),
              (4, 3), (4, 4), (4, 11), (5, 3), (7, 3), (8, 4), (8, 9),
              (9, 2), (11, 2), (12, 2), (15, 8), (16, 2), (16, 7),
              (20, 3), (21, 2), (24, 6), (28, 2), (29, 5), (31, 8),
              (32, 2), (32, 1), (32, 32), (33, 2), (36, 2), (44, 2),
              (64, 3), (100, 2), (121, 2), (3, 40), (40, 40), (1100, 2)]


@pytest.mark.parametrize("shape", SUM_SHAPES[::3], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("axis", [-2, -1])
def test_sum_axis_is_xlas_cpu_reduce(shape, axis):
    """`xla_math.sum_axis` gives the bits of a jitted
    `jnp.sum(t, axis=axis, keepdims=True)` (windows of 32 past 32)."""
    from avenir_tpu_torch.ops import xla_math
    rng = np.random.default_rng(sum(shape) + axis)
    t = (rng.random((4,) + shape)
         * rng.choice([1.0, 1e3, 1e-3], (4,) + shape)).astype(np.float32)
    red = jax.jit(lambda x: jnp.sum(x, axis=axis, keepdims=True))
    np.testing.assert_array_equal(
        xla_math.sum_axis(t, axis),
        np.stack([np.asarray(red(jnp.asarray(x))) for x in t]),
        err_msg=_xla_host())


def test_log_is_xlas_cpu_log():
    """`xla_math.log` gives the bits of `jnp.log` on the CPU: 1,108,000
    values over the whole float32 range, denormals, 0, negatives, inf and
    NaN, and the MI ratios' range, in arrays long enough to vectorize and
    short enough not to."""
    from avenir_tpu_torch.ops import xla_math
    rng = np.random.default_rng(0)
    xs = np.concatenate([
        rng.random(200_000), rng.random(200_000) * 10,
        np.exp(rng.uniform(-80, 80, 200_000)),
        rng.integers(0, 2 ** 31, 200_000, dtype=np.uint32).view(np.float32),
        [0, -1, np.inf, np.nan, 1e-12, 1, 2, 1e-45, 1.17e-38],
        np.exp(rng.uniform(-30, 5, 308_000))]).astype(np.float32)
    for x in (xs[:800_009], xs[800_009:]):
        want = np.asarray(jnp.log(jnp.asarray(x)))
        got = xla_math.log(x)
        same = (got.view(np.uint32) == want.view(np.uint32)) | \
            (np.isnan(got) & np.isnan(want))
        assert same.all(), (x[~same][:5], got[~same][:5], want[~same][:5],
                            _xla_host())
    small = xs[-22:].reshape(11, 2)
    np.testing.assert_array_equal(xla_math.log(small),
                                  np.asarray(jnp.log(jnp.asarray(small))),
                                  err_msg=_xla_host())


#: the MI tables of the churn and tutorial jobs' shapes, and batches
MI_SHAPES = [(11, 2), (12, 2), (16, 2), (2, 2), (3, 11), (3, 2), (3, 3),
             (3, 4), (4, 11), (4, 3), (4, 4), (9, 2), (33, 2), (36, 2),
             (44, 2), (121, 2), (20, 20), (40, 3), (3, 4, 5)]


@pytest.mark.parametrize("shape", MI_SHAPES, ids=str)
def test_mutual_information_bits_equal_jax(shape):
    """MI of random count tables (a fifth of the cells empty) bit for
    bit the reference's: XLA's sum orders and log."""
    rng = np.random.default_rng(len(shape) * 100 + shape[0] * 7 + shape[-1])
    for _ in range(20):
        c = (rng.integers(0, 50, shape) * (rng.random(shape) > 0.2)
             ).astype(np.float32)
        np.testing.assert_array_equal(
            info.mutual_information(c).numpy(),
            np.asarray(jinfo.mutual_information(jnp.asarray(c))),
            err_msg=_xla_host())


@pytest.mark.parametrize("shape", SUM_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sum_last2_is_xlas_cpu_reduce(shape):
    """`xla_math.sum_last2` gives the bits of a jitted
    `jnp.sum(t, axis=(-2, -1))` on random float32 tables of mixed
    magnitudes (ten a shape, and a batch of three under one call)."""
    from avenir_tpu_torch.ops import xla_math
    rng = np.random.default_rng(sum(shape))
    t = (rng.random((10,) + shape)
         * rng.choice([1.0, 1e3, 1e-3], (10,) + shape)).astype(np.float32)
    red = jax.jit(lambda x: jnp.sum(x, axis=(-2, -1)))
    want = np.stack([np.asarray(red(jnp.asarray(x))) for x in t])
    np.testing.assert_array_equal(xla_math.sum_last2(t), want,
                                  err_msg=_xla_host())
    np.testing.assert_array_equal(xla_math.sum_last2(t[:3]),
                                  np.asarray(red(jnp.asarray(t[:3]))),
                                  err_msg=_xla_host())


# ------------------------------------------------------------ MI tables
def _chunks(text, n):
    lines = text.splitlines(True)
    step = -(-len(lines) // n)
    return ["".join(lines[i:i + step]) for i in range(0, len(lines), step)]


def _analyzers(text, schema_obj, chunks=1):
    port = ex.MutualInformationAnalyzer(device=CPU)
    ref = jex.MutualInformationAnalyzer()
    ps, js = FeatureSchema.from_json(schema_obj), JaxSchema.from_json(schema_obj)
    for part in _chunks(text, chunks):
        port.add(Dataset.from_csv(part, ps))
        ref.add(JaxDataset.from_csv(part, js, engine="python"))
    port.finalize()
    ref.finalize()
    return port, ref


def _assert_tables_equal(port, ref):
    assert port.bins == ref.bins and port.n == ref.n and port.k == ref.k
    assert [f.ordinal for f in port.fields] == [f.ordinal for f in ref.fields]
    for a, b in zip(port._fc, ref._fc):
        np.testing.assert_array_equal(a, b)
    assert sorted(port._pair) == sorted(ref._pair)
    for key in ref._pair:
        np.testing.assert_array_equal(port._pair[key], ref._pair[key])
        np.testing.assert_array_equal(port._pairc[key], ref._pairc[key])


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("schema,chunks", [("churn", 1), ("churn", 4),
                                           ("mixed", 4)])
def test_mi_tables_exactly_equal(env, monkeypatch, schema, chunks, fused):
    """The count tables equal the reference's, cell for cell, in the fused
    keyspace and, with the fused limits at 1 in both packages, pair by
    pair."""
    if not fused:
        monkeypatch.setattr(ex, "_FUSED_BYTES_LIMIT", 1)
        monkeypatch.setattr(jex, "_FUSED_KEYSPACE_LIMIT", 1)
    obj = _mixed_schema() if schema == "mixed" else churn_schema().to_json()
    text = _churn_text(1500, 31)
    if schema == "mixed":
        # a value first seen in the last chunk grows payment's bin axis
        lines = text.splitlines(True)
        lines[-1] = lines[-1].replace(",poor,", ",bankrupt,").replace(
            ",average,", ",bankrupt,").replace(",good,", ",bankrupt,")
        text = "".join(lines)
    port, ref = _analyzers(text, obj, chunks)
    _assert_tables_equal(port, ref)


def test_device_count_path_equals_its_host_twin():
    """`_mi_chunk_counts` (torch bincounts, the card's path, here on CPU
    tensors) and `_mi_chunk_counts_host` (the CPU run's) give the same
    integer tables, and the reference's host twin the same again."""
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 6, (3001, 5)).astype(np.int32)
    y = rng.integers(0, 3, 3001).astype(np.int32)
    dev = ex._mi_chunk_counts(torch.from_numpy(codes.astype(np.int64)),
                              torch.from_numpy(y), 6, 3, 5)
    host = ex._mi_chunk_counts_host(codes, y, 6, 3, 5)
    ref = jex._mi_chunk_counts_host(codes, y, 6, 3, 5)
    jit = jex._mi_chunk_counts(jnp.asarray(codes), jnp.asarray(y), 6, 3, 5)
    for d, h, r, j in zip(dev, host, ref, jit):
        assert d.dtype == torch.int64
        np.testing.assert_array_equal(d.numpy(), h)
        np.testing.assert_array_equal(h, r)
        np.testing.assert_array_equal(h, np.asarray(j))
    one = ex._mi_chunk_counts(torch.from_numpy(codes[:, :1].astype(np.int64)),
                              torch.from_numpy(y), 6, 3, 1)
    assert one[1].shape == (0, 6, 6) and one[2].shape == (0, 6, 6, 3)


def test_scores_match_jax(env):
    port, ref = _analyzers(_churn_text(3000, 41), churn_schema().to_json(), 3)
    np.testing.assert_allclose(port.feature_class_mi, ref.feature_class_mi,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.pair_mi, ref.pair_mi, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.pair_class_mi, ref.pair_class_mi,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.pair_class_entropy,
                               ref.pair_class_entropy, rtol=0, atol=1e-6)
    for algo in ALGOS:
        for beta in (1.0, 0.5):
            got, want = port.score(algo, beta), ref.score(algo, beta)
            assert [o for o, _ in got] == [o for o, _ in want], algo
            for (_, g), (_, w) in zip(got, want):
                assert abs(g - w) <= 1e-6, (algo, g, w)


def test_mi_merge_of_shards_equals_whole(env):
    text = _churn_text(2400, 51)
    obj = churn_schema().to_json()
    whole, _ = _analyzers(text, obj, 1)
    halves = _chunks(text, 2)
    a, _ = _analyzers(halves[0], obj, 1)
    b, _ = _analyzers(halves[1], obj, 1)
    empty = ex.MutualInformationAnalyzer(device=CPU)
    merged = empty.merge(a).merge(b).merge(
        ex.MutualInformationAnalyzer(device=CPU))
    merged.finalize()
    _assert_tables_equal(merged, whole)
    np.testing.assert_array_equal(merged.feature_class_mi,
                                  whole.feature_class_mi)


def test_from_chunks_and_dataset_constructor(env):
    text = _churn_text(900, 61)
    obj = churn_schema().to_json()
    schema = FeatureSchema.from_json(obj)
    streamed = ex.MutualInformationAnalyzer.from_chunks(
        (Dataset.from_csv(p, schema) for p in _chunks(text, 3)), device=CPU)
    whole = ex.MutualInformationAnalyzer(Dataset.from_csv(text, schema),
                                         device=CPU)
    _assert_tables_equal(streamed, whole)
    assert streamed.mim() == whole.mim()
    with pytest.raises(ValueError, match="no input chunks"):
        ex.MutualInformationAnalyzer.from_chunks([], device=CPU)


# ------------------------------------------------------- correlations
@pytest.mark.parametrize("schema", ["churn", "mixed"])
def test_contingency_family_matches_jax(schema):
    obj = _mixed_schema() if schema == "mixed" else churn_schema().to_json()
    text = _churn_text(2000, 71)
    ds, jds = _both(text, obj)
    tables = [(ex.contingency(ds, fld, device=CPU),
               np.asarray(jex.contingency(jds, jfld)))
              for fld, jfld in zip(ds.encodable_feature_fields(),
                                   jds.encodable_feature_fields())]
    for got, ref in tables:
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, ref)
    table = tables[0][0].astype(np.float64)
    assert ex.cramer_index(table) == jex.cramer_index(table)
    assert ex.cramer_correlation(ds, device=CPU) == jex.cramer_correlation(jds)
    for algo in ("entropy", "gini"):
        got = ex.heterogeneity_reduction(ds, algo, device=CPU)
        ref = jex.heterogeneity_reduction(jds, algo)
        assert sorted(got) == sorted(ref)
        assert got == ref, algo
    acc, jacc = ex.ContingencyAccumulator(CPU), jex.ContingencyAccumulator()
    for part in _chunks(text, 3):
        a, b = _both(part, obj)
        acc.add(a)
        jacc.add(b)
    assert acc.n == jacc.n
    np.testing.assert_array_equal(acc.class_counts, jacc.class_counts)
    for o, t in jacc.tables.items():
        np.testing.assert_array_equal(acc.tables[o], t)


def test_numeric_moments_match_jax():
    text = generate_elearn(3000, seed=81, as_csv=True)
    obj = elearn_schema().to_json()
    acc, jacc = ex.NumericMomentAccumulator(), jex.NumericMomentAccumulator()
    for part in _chunks(text, 4):
        a, b = _both(part, obj)
        acc.add(a)
        jacc.add(b)
    assert acc.n == jacc.n
    assert acc.s.tobytes() == jacc.s.tobytes()
    assert acc.ss.tobytes() == jacc.ss.tobytes()
    assert acc.correlation().tobytes() == jacc.correlation().tobytes()
    ds, jds = _both(text, obj)
    assert ex.numerical_correlation(ds).tobytes() == \
        jex.numerical_correlation(jds).tobytes()


# ------------------------------------------------------------------ jobs
#: case -> (prefix, schema, data file, extra properties)
JOBS = {
    "cramerCorrelation": ("crc", "churn", "churn", {}),
    "categoricalCorrelation": ("cac", "churn", "churn", {}),
    "heterogeneityReduction": ("hrc", "churn", "churn", {}),
    "heterogeneityReduction:gini": ("hrc", "churn", "churn",
                                    {"heterogeneity.algorithm": "gini"}),
    "numericalCorrelation": ("nuc", "elearn", "elearn", {}),
    "mutualInformation": ("mut", "churn", "churn", {
        "mutual.info.score.algorithms": ",".join(ALGOS),
        "redundancy.factor": "0.8"}),
    "ruleEvaluator": ("rue", "churn", "churn", {
        "rule.names": "r1,r2,r3",
        "rule.r1": "1 eq low => 6 eq closed",
        "rule.r2": "5 gt 30 & 3 in high:med:bogus => 6 eq open",
        "rule.r3": "1 ne low & 5 le 24 => 6 ne closed"}),
    "categoricalClassAffinity": ("cca", "mixed", "churn", {"top.count": "2"}),
    "categoricalContinuousEncoding:supervisedRatio": ("coe", "mixed", "churn",
                                                      {}),
    "categoricalContinuousEncoding:weightOfEvidence": (
        "coe", "churn", "churn", {"encoding.strategy": "weightOfEvidence",
                                  "pos.class.attr.value": "open"}),
}


def _job_counters(counters):
    """A result's counters without the delta-scan ones (DELTA_COUNTERS),
    which every streamed result carries and which count what a restore or
    the columnar sidecar served, and without the memory counters
    (MEM_COUNTERS: the tests hold the prediction to the reference's on
    its own; the peak RSS measures the process)."""
    return {k: v for k, v in counters.items()
            if k not in DELTA_COUNTERS and k not in MEM_COUNTERS}


def _same_prediction(port, ref):
    """Mem:PredictedPeakBytes of a port result equals the reference's (both
    absent for a job that is not streamed)."""
    assert port.get("Mem:PredictedPeakBytes") == \
        ref.get("Mem:PredictedPeakBytes")


@pytest.mark.parametrize("block_mb", [None, "0.02"])
@pytest.mark.parametrize("case", sorted(JOBS))
def test_job_matches_jax(env, tmp_path, case, block_mb):
    job = case.split(":")[0]
    prefix, schema, data, extra = JOBS[case]
    props = {f"{prefix}.feature.schema.file.path": env[f"{schema}_schema"],
             **{f"{prefix}.{k}": v for k, v in extra.items()}}
    if block_mb:
        props[f"{prefix}.stream.block.size.mb"] = block_mb
    ref = jax_run_job(job, props, [env[data]], str(tmp_path / "jax.txt"))
    got = run_job(job, props, [env[data]], str(tmp_path / "port.txt"),
                  device=CPU)
    g = (tmp_path / "port.txt").read_text()
    r = (tmp_path / "jax.txt").read_text()
    assert g == r
    assert _job_counters(got.counters) == {
        k: v for k, v in ref.counters.items() if k.startswith("Basic:")}
    _same_prediction(got.counters, ref.counters)
    assert got.name == job and got.outputs == [str(tmp_path / "port.txt")]


@pytest.mark.parametrize("job,prefix", [("mutualInformation", "mut"),
                                        ("cramerCorrelation", "crc"),
                                        ("numericalCorrelation", "nuc")])
def test_empty_input_raises_as_jax(tmp_path, env, job, prefix):
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    props = {f"{prefix}.feature.schema.file.path": env["churn_schema"]}
    with pytest.raises(ValueError, match="empty input"):
        run_job(job, props, [str(empty)], str(tmp_path / "o"), device=CPU)
    with pytest.raises(ValueError, match="empty input"):
        jax_run_job(job, props, [str(empty)], str(tmp_path / "j"))


def test_jobs_through_the_cli(env, tmp_path):
    props = tmp_path / "explore.properties"
    props.write_text(
        f"mut.feature.schema.file.path={env['churn_schema']}\n"
        f"crc.feature.schema.file.path={env['churn_schema']}\n"
        "mut.mutual.info.score.algorithms=joint.mutual.info\n")
    for name in ("org.avenir.explore.MutualInformation",
                 "org.avenir.explore.CramerCorrelation"):
        out = tmp_path / name.rsplit(".", 1)[-1]
        proc = subprocess.run(
            [sys.executable, "-m", "avenir_tpu_torch", name, "--conf",
             str(props), env["churn"], str(out), "--device", "cpu"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        assert _job_counters(row["counters"]) == {"Basic:Records": 3000}
        ref = jax_run_job(name, str(props), [env["churn"]],
                          str(out) + ".jax")
        _same_prediction(row["counters"], ref.counters)
        assert out.read_bytes() == Path(str(out) + ".jax").read_bytes()


# ------------------------------------------- relief, samplers, top matches
@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX NeighborIndex on its kernel route, the Pallas kernels in
    interpret mode (as tests/test_knn.py runs them on the CPU): the route
    the reference takes on its device, which the port's index takes on
    the card (the EXACT top-k kernel) and, in its plain version, here."""
    import functools

    import avenir_tpu.ops.pallas_knn as pk

    monkeypatch.setattr(pk, "pallas_available", lambda: True)
    monkeypatch.setattr(pk, "knn_topk_pallas",
                        functools.partial(pk.knn_topk_pallas, interpret=True))


def _jobs_equal(tmp_path, job, prefix, schema, data, extra=()):
    """`job` through both packages on the same file: (port result, JAX
    result), their output files asserted byte-identical."""
    props = {f"{prefix}.feature.schema.file.path": schema,
             **{f"{prefix}.{k}": v for k, v in dict(extra).items()}}
    ref = jax_run_job(job, props, [data], str(tmp_path / "jax.txt"))
    got = run_job(job, props, [data], str(tmp_path / "port.txt"), device=CPU)
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    return got, ref


def _odd_elearn(tmp_path):
    """e-learning rows with duplicates (every 7th row repeated at the
    end, so a duplicate follows its twin) and a class of one row."""
    lines = generate_elearn(300, seed=91, as_csv=True).splitlines()
    fails = [ln for ln in lines if ln.endswith(",fail")]
    passes = [ln for ln in lines if ln.endswith(",pass")]
    rows = fails + fails[::7] + passes[:1]
    path = tmp_path / "odd.csv"
    path.write_text("\n".join(rows) + "\n")
    return str(path)


@pytest.mark.parametrize("data,sample", [("elearn", None), ("elearn", "300"),
                                         ("churn", "500"), ("odd", None),
                                         ("odd", "40")])
def test_relief_matches_jax(env, tmp_path, data, sample):
    schema = env["churn_schema" if data == "churn" else "elearn_schema"]
    path = _odd_elearn(tmp_path) if data == "odd" else env[data]
    extra = {"sample.size": sample} if sample else {}
    got, ref = _jobs_equal(tmp_path, "reliefFeatureRelevance", "ffr", schema,
                           path, extra)
    assert got.counters == {}
    sch = FeatureSchema.from_file(schema)
    ds = Dataset.from_csv(Path(path).read_text(), sch)
    jds = JaxDataset.from_csv(Path(path).read_text(),
                              JaxSchema.from_file(schema), engine="python")
    size = int(sample) if sample else None
    assert ex.relief_relevance(ds, size, seed=4, block=64, query_block=96,
                               device=CPU) == \
        jex.relief_relevance(jds, size, seed=4, block=64, query_block=96)


def test_relief_singleton_class_has_no_hit(tmp_path):
    """With every row but one in one class, no record has both a hit and
    a miss: every weight is 0, in both packages."""
    lines = generate_elearn(60, seed=92, as_csv=True).splitlines()
    rows = [ln.rsplit(",", 1)[0] + ",fail" for ln in lines[:-1]]
    rows.append(lines[-1].rsplit(",", 1)[0] + ",pass")
    obj = elearn_schema().to_json()
    ds, jds = _both("\n".join(rows) + "\n", obj)
    got = ex.relief_relevance(ds, device=CPU)
    assert got == jex.relief_relevance(jds)
    assert set(got.values()) != {0.0}
    single = ds.take(np.array([0, len(ds) - 1]))
    jsingle = jds.take(np.array([0, len(jds) - 1]))
    assert ex.relief_relevance(single, device=CPU) == \
        jex.relief_relevance(jsingle) == {o: 0.0 for o in range(1, 7)}


@pytest.mark.parametrize("job,prefix,extra", [
    ("underSamplingBalancer", "usb", {}),
    ("underSamplingBalancer", "usb", {"seed": "7"}),
    ("baggingSampler", "bas", {"sample.rate": "0.5", "seed": "3"}),
    ("baggingSampler", "bas", {"sample.rate": "1.7"})])
def test_samplers_match_jax(env, tmp_path, job, prefix, extra):
    got, ref = _jobs_equal(tmp_path, job, prefix, env["churn_schema"],
                           env["churn"], extra)
    assert got.counters == {k: v for k, v in ref.counters.items()
                            if k.startswith("Basic:")}
    # rows pass through as they were written
    src = set(Path(env["churn"]).read_text().splitlines())
    assert set((tmp_path / "port.txt").read_text().splitlines()) <= src


@pytest.mark.parametrize("data,k", [("elearn", "3"), ("churn", "2"),
                                    ("odd", "4")])
def test_top_matches_match_jax_kernel_route(env, tmp_path, pallas_interpret,
                                            data, k):
    schema = env["churn_schema" if data == "churn" else "elearn_schema"]
    if data == "odd":
        path = _odd_elearn(tmp_path)
    else:
        path = str(tmp_path / f"{data}.csv")
        Path(path).write_text("\n".join(
            Path(env[data]).read_text().splitlines()[:400]) + "\n")
    got, ref = _jobs_equal(tmp_path, "topMatchesByClass", "tmc", schema, path,
                           {"top.match.count": k})
    assert got.counters == {k: v for k, v in ref.counters.items()
                            if k.startswith("Basic:")}
    lines = (tmp_path / "port.txt").read_text().splitlines()
    if data == "odd":
        # the one-row class is skipped; a duplicate's twin comes first at 0
        assert not any(ln.startswith("pass,") for ln in lines)
        assert any(":0.0000" in ln.split(",")[2] for ln in lines)


def test_rule_and_explore_errors_match_jax(env, tmp_path):
    schema = env["churn_schema"]
    bad = {"rue.feature.schema.file.path": schema, "rue.rule.names": "a",
           "rue.rule.a": "1 eq low"}
    for runner in (lambda p, o: run_job("ruleEvaluator", p, [env["churn"]],
                                        o, device=CPU),
                   lambda p, o: jax_run_job("ruleEvaluator", p,
                                            [env["churn"]], o)):
        with pytest.raises(ValueError,
                           match=r"rue\.rule\.a must contain exactly one '=>'"):
            runner(bad, str(tmp_path / "o"))
        with pytest.raises(ValueError, match="exactly one '=>'"):
            runner({**bad, "rue.rule.a": "1 eq low => 6 eq open => x"},
                   str(tmp_path / "o"))
        with pytest.raises(KeyError, match="bogus"):
            runner({**bad, "rue.rule.a": "1 eq bogus => 6 eq open"},
                   str(tmp_path / "o"))
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    for job, prefix in (("ruleEvaluator", "rue"),
                        ("categoricalClassAffinity", "cca"),
                        ("categoricalContinuousEncoding", "coe")):
        props = {f"{prefix}.feature.schema.file.path": schema,
                 "rue.rule.names": "a", "rue.rule.a": "1 eq low => 6 eq open"}
        for runner in (run_job, jax_run_job):
            kw = {"device": CPU} if runner is run_job else {}
            with pytest.raises(ValueError, match=f"{job}: empty input"):
                runner(job, props, [str(empty)], str(tmp_path / "e"), **kw)


def test_affinity_and_encoding_functions_match_jax():
    text = _churn_text(1500, 93)
    ds, jds = _both(text, churn_schema().to_json())
    for fld, jfld in zip(ds.schema.feature_fields, jds.schema.feature_fields):
        if not fld.is_categorical:
            continue
        assert ex.class_affinity(ds, fld, 2, device=CPU) == \
            jex.class_affinity(jds, jfld, 2)
        for strategy in ("supervisedRatio", "weightOfEvidence"):
            for pos in (None, "open"):
                assert ex.supervised_encoding(ds, fld, strategy, pos,
                                              device=CPU) == \
                    jex.supervised_encoding(jds, jfld, strategy, pos)
    # ties in P(value | class) keep numpy's argsort order
    tab = np.array([[2.0, 1.0], [2.0, 3.0], [1.0, 1.0], [2.0, 0.0]])
    fld = ds.schema.field_by_ordinal(1)
    assert ex.class_affinity_from_table(tab, fld, ["open", "closed"], 3) == \
        jex.class_affinity_from_table(tab, jds.schema.field_by_ordinal(1),
                                      ["open", "closed"], 3)
