"""The port's logistic regression and clustering on the CPU against the JAX
package.

- `ops/xla_math.inner_dot`: XLA's CPU dot over a small contiguous depth,
  bit for bit against the JAX package's jitted product on the same
  seeded inputs; `ops/cluster_kernels.centre_sums`' plain version bit for
  bit against `jax.ops.segment_sum`.
- Logistic regression (`tests/test_regress_cluster.py`'s cases, then the
  reference's): the exit status equal under all three criteria, every
  printed coefficient within one unit of the 6th decimal, and the count
  of differing printed cells at most the count stated in `LR_CELLS`. The
  port takes the gradient in float64 where XLA keeps eight running
  float32 lanes (no parallel form), so the coefficients differ by at most
  `LR_ATOL`.
- k-means: labels equal on the blobs and e-learning fixtures, centres
  within `KMEANS_ULP` (0) float32 ULPs, the inertia within
  `INERTIA_RTOL`. DBSCAN and agglomerative labels equal; squared dataset
  distances within `DIST2_ATOL`; `hopkins_statistic` and `k_dist` within
  `TENDENCY_RTOL`.
- The jobs `logisticRegression`, `clusterTrain` (k-means and DBSCAN,
  alias `kmeansCluster`) and `agglomerativeGraphical` through `run_job`
  and the CLI; and the port's registry against the reference's.
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

from avenir_tpu.core.dataset import Dataset as JaxDataset
from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.models import cluster as jcl
from avenir_tpu.models import regress as jrg
from avenir_tpu.runner import job_names as jax_job_names
from avenir_tpu.runner import run_job as jax_run_job
from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.data import elearn_schema, generate_elearn
from avenir_tpu_torch.models import cluster as cl
from avenir_tpu_torch.models import regress as rg
from avenir_tpu_torch.ops import cluster_kernels as ck
from avenir_tpu_torch.ops import xla_math
from avenir_tpu_torch.runner import job_names, run_job

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
#: (rows, criterion) -> the most printed coefficient cells (of 7 a row)
#: that may differ from the reference's, as measured on these fixtures
LR_CELLS = {(2000, "iterLimit"): 2, (2000, "allBelowThreshold"): 2,
            (2000, "averageBelowThreshold"): 2, (5000, "iterLimit"): 2,
            (5000, "allBelowThreshold"): 4,
            (5000, "averageBelowThreshold"): 1}
#: the largest coefficient difference from the reference's
LR_ATOL = 1e-7
#: the largest centre difference from the reference's, in float32 ULPs
#: (the port adds each cluster's rows in order, as XLA's segment_sum does)
KMEANS_ULP = 0
#: k-means inertia (summed by halves; XLA's reduce has its own order)
INERTIA_RTOL = 1e-5
#: squared dataset distances: at 300 rows the reference's cross term is
#: XLA's matrix product, not the small-depth order of `inner_dot`
DIST2_ATOL = 4e-7
#: hopkins_statistic and k_dist against the reference's
TENDENCY_RTOL = 1e-5


def _both(text):
    obj = elearn_schema().to_json()
    return (Dataset.from_csv(text, FeatureSchema.from_json(obj)),
            JaxDataset.from_csv(text, JaxSchema.from_json(obj),
                                engine="python"))


@pytest.fixture(scope="module")
def elearn():
    return {n: _both(generate_elearn(n, seed=31, as_csv=True))
            for n in (1500, 2000, 5000)}


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(5)
    a = rng.normal(0, 0.5, (50, 2))
    b = rng.normal(5, 0.5, (50, 2))
    return np.concatenate([a, b]).astype(np.float32)


# --------------------------------------------------------------- xla_math
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6, 7, 9, 11])
def test_inner_dot_bit_for_bit(d):
    rng = np.random.default_rng(d)
    x = rng.normal(0, 1, (700, d)).astype(np.float32)
    c = rng.normal(0, 1, (3, d)).astype(np.float32)
    inner = np.asarray(jax.jit(lambda a, b: a @ b.T)(x, c))
    got = xla_math.inner_dot(torch.from_numpy(x), torch.from_numpy(c))
    assert got.numpy().tobytes() == inner.tobytes()


def test_tree_sum_is_by_halves():
    t = torch.tensor([1.0, 2.0 ** 24, 1.0, -2.0 ** 24, 1.0])
    # (1 + 1) + ((2^24 + -2^24) + 1 + 0) by halves over 8 padded rows
    assert float(xla_math.tree_sum(t)) == 3.0
    assert float(xla_math.tree_sum(t[:0])) == 0.0


# ---------------------------------------------------- logistic regression
@pytest.mark.parametrize("criteria", ["iterLimit", "allBelowThreshold",
                                      "averageBelowThreshold"])
@pytest.mark.parametrize("n", [2000, 5000])
def test_lr_matches_jax(elearn, n, criteria):
    ds, jds = elearn[n]
    limit = 10 if criteria == "iterLimit" else 50
    ref = jrg.LogisticRegression(iteration_limit=limit,
                                 convergence_criteria=criteria).fit(jds)
    got = rg.LogisticRegression(iteration_limit=limit,
                                convergence_criteria=criteria,
                                device=CPU).fit(ds)
    assert got.check_convergence() == ref.check_convergence()
    rh, gh = np.array(ref.coeff_history), np.array(got.coeff_history)
    assert rh.shape == gh.shape
    assert np.abs(rh - gh).max() <= LR_ATOL
    printed = [(f"{a:.6f}", f"{b:.6f}") for a, b in zip(rh.ravel(),
                                                       gh.ravel())]
    assert all(abs(float(a) - float(b)) <= 1.5e-6 for a, b in printed)
    assert sum(a != b for a, b in printed) <= LR_CELLS[(n, criteria)]
    np.testing.assert_array_equal(got.predict(ds), ref.predict(jds))
    assert got.validate(ds).counters() == ref.validate(jds).counters()


def test_lr_design_bit_for_bit_and_gradient_in_float64(elearn):
    """The design matrix is the reference's bits; the gradient is the
    float64 one rounded to float32, near the reference's float32 one."""
    ds, jds = elearn[2000]
    lr, jlr = rg.LogisticRegression(device=CPU), jrg.LogisticRegression()
    x, y = lr._design(ds)
    jx, jy = jlr._design(jds)
    assert x.numpy().tobytes() == np.asarray(jx).tobytes()
    coeff = torch.full((x.shape[1],), 0.25)
    g = rg._lr_grad(coeff, x, y).numpy()
    xd = x.numpy().astype(np.float64)
    exact = xd.T @ (y.numpy() - 1.0 / (1.0 + np.exp(-(xd @ np.full(
        x.shape[1], 0.25)))))
    np.testing.assert_array_equal(g, exact.astype(np.float32))
    jg = np.asarray(jrg._lr_grad(jnp.full(x.shape[1], 0.25), jx, jy))
    np.testing.assert_allclose(g, jg, rtol=2e-6, atol=1e-3)


def test_lr_learns_and_reads_back(elearn, tmp_path):
    ds, _ = elearn[1500]
    lr = rg.LogisticRegression(learning_rate=2.0, iteration_limit=200,
                               device=CPU).fit(ds)
    assert lr.validate(ds).accuracy() > 0.9
    one = rg.LogisticRegression(learning_rate=0.5, iteration_limit=1,
                                device=CPU).fit(ds)
    x = ds.feature_matrix().astype(np.float64)
    x = (x - x.mean(axis=0)) / np.maximum(x.std(axis=0), 1e-9)
    x = np.concatenate([np.ones((len(ds), 1)), x], axis=1)
    grad = x.T @ (ds.labels().astype(np.float64) - 0.5) / len(ds)
    np.testing.assert_allclose(one.coeff_history[1], 0.5 * grad, rtol=1e-4)
    conv = rg.LogisticRegression(
        learning_rate=0.1, iteration_limit=500,
        convergence_criteria="averageBelowThreshold",
        convergence_threshold=0.5, device=CPU).fit(ds)
    assert len(conv.coeff_history) - 1 < 500
    assert conv.check_convergence() == rg.CONVERGED
    five = rg.LogisticRegression(iteration_limit=5, device=CPU).fit(ds)
    path = tmp_path / "coeff.txt"
    five.save_coeff_history(str(path))
    np.testing.assert_allclose(rg.LogisticRegression.load_coeff(str(path)),
                               five.coeff, atol=1e-5)
    assert len(path.read_text().splitlines()) == len(five.coeff_history)
    with pytest.raises(ValueError, match="invalid convergence criteria"):
        rg.LogisticRegression(convergence_criteria="bogus", iteration_limit=2,
                              device=CPU).fit(ds)


# ------------------------------------------------------------- clustering
def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("data,k,seed", [("blobs", 2, 1), ("blobs", 5, 1),
                                         ("elearn", 3, 0), ("elearn", 5, 2)])
def test_kmeans_matches_jax(blobs, elearn, data, k, seed):
    x = blobs if data == "blobs" else elearn[2000][0].feature_matrix()
    ref = jcl.KMeans(k=k, seed=seed).fit(x)
    got = cl.KMeans(k=k, seed=seed, device=CPU).fit(x)
    np.testing.assert_array_equal(got.labels_, ref.labels_)
    assert _ulps(got.centers, ref.centers) <= KMEANS_ULP
    assert abs(got.inertia_ - ref.inertia_) <= INERTIA_RTOL * ref.inertia_
    q = x[::7] + np.float32(0.01)
    np.testing.assert_array_equal(got.predict(q), ref.predict(q))
    if data == "blobs" and k == 2:
        assert len(set(got.labels_[:50])) == 1
        assert len(set(got.labels_[50:])) == 1
        assert got.labels_[0] != got.labels_[60]
        assert cl.cohesion(blobs, got.labels_) < 2.0
        assert cl.inter_cluster_distance(blobs, got.labels_) > 4.0
        assert cl.cohesion(blobs, got.labels_) == \
            jcl.cohesion(blobs, ref.labels_)
        assert cl.inter_cluster_distance(blobs, got.labels_) == \
            jcl.inter_cluster_distance(blobs, ref.labels_)


def test_kmeans_step_keeps_an_empty_cluster():
    x = torch.tensor([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0]])
    centers = torch.tensor([[0.0, 0.0], [5.0, 5.0], [100.0, 100.0]])
    new, assign, inertia = cl._kmeans_step(x, centers, 3)
    jnew, jassign, jinertia = jcl._kmeans_step(jnp.asarray(x.numpy()),
                                               jnp.asarray(centers.numpy()), 3)
    assert new.numpy().tobytes() == np.asarray(jnew).tobytes()
    np.testing.assert_array_equal(assign.numpy(), np.asarray(jassign))
    assert float(inertia) == float(jinertia)
    assert new[2].tolist() == [100.0, 100.0]


def _centre_case(n, d, k, labels="mixed"):
    """x with large and small values mixed (the order shows) and a -0 first
    row; labels "mixed" in [-1, k] (outside [0, k) adds nowhere) with
    cluster k - 1 emptied, "one": every row in cluster 0, "sparse": k
    clusters of which only every fifth holds rows."""
    rng = np.random.default_rng(n + d + k)
    x = (rng.normal(0, 1, (n, d))
         * 10.0 ** rng.integers(-4, 5, (n, d))).astype(np.float32)
    if n:
        x[0] = -0.0
    if labels == "one":
        return x, np.zeros(n, np.int32)
    if labels == "sparse":
        return x, (5 * rng.integers(0, (k + 4) // 5, n)).astype(np.int32)
    assign = rng.integers(-1, k + 1, n).astype(np.int32)
    assign[assign == k - 1] = 0
    return x, assign


# the kernel's paths: its column planes (33 and 64 columns make two), one
# cluster's chain over every row, empty clusters, and row counts off the
# partition's tiles of 2048 rows (at d=6)
@pytest.mark.parametrize("n,d,k,labels", [
    pytest.param(0, 3, 2, "mixed", id="0-3-2"),
    pytest.param(1, 1, 1, "mixed", id="1-1-1"),
    pytest.param(5000, 6, 3, "mixed", id="5000-6-3"),
    pytest.param(3000, 11, 7, "mixed", id="3000-11-7"),
    pytest.param(700, 2, 40, "mixed", id="700-2-40"),
    (1500, 33, 3, "mixed"), (900, 64, 5, "mixed"), (6000, 6, 1, "one"),
    (4099, 6, 3, "one"), (3000, 5, 64, "sparse"), (4097, 6, 3, "mixed"),
    (1, 6, 1, "one")])
def test_centre_sums_plain_is_segment_sum(n, d, k, labels):
    """The kernel's plain version is XLA's serial segment_sum bit for bit:
    large and small values mixed (the order shows), a -0 row, empty
    clusters and labels outside [0, k), which add nowhere."""
    x, assign = _centre_case(n, d, k, labels)
    got = ck.centre_sums(torch.from_numpy(x), torch.from_numpy(assign), k)
    ref = np.asarray(jax.jit(lambda a, s: jax.ops.segment_sum(
        a, s, num_segments=k))(x, assign))
    assert got.dtype == torch.float32 and got.shape == (k, d)
    assert got.numpy().tobytes() == ref.tobytes()
    assert ck.centre_sums.launches == 0


def test_kmeans_step_of_one_row_keeps_its_signs():
    """XLA's segment_sum of a single row is a copy of it, -0 kept (from
    two rows on, a lone -0 row sums to +0): the centre of that row's
    cluster keeps its -0 cells, as the reference's does."""
    x = np.array([[-0.0, 1.5, -0.0]], np.float32)
    centers = np.array([[5.0, 5.0, 5.0], [-1.0, 0.0, 2.0]], np.float32)
    new, assign, _ = cl._kmeans_step(torch.from_numpy(x),
                                     torch.from_numpy(centers), 2)
    jnew, jassign, _ = jcl._kmeans_step(jnp.asarray(x), jnp.asarray(centers),
                                        2)
    assert new.numpy().tobytes() == np.asarray(jnew).tobytes()
    assert np.signbit(new[1].numpy()).tolist() == [True, False, True]
    assert assign.tolist() == np.asarray(jassign).tolist() == [1]


@pytest.mark.parametrize("bad", ["dtype", "labels", "shape", "k"])
def test_centre_sums_rejects(bad):
    x, a, k = torch.zeros((4, 2)), torch.zeros(4, dtype=torch.int32), 2
    if bad == "dtype":
        x = x.double()
    elif bad == "labels":
        a = a.long()
    elif bad == "shape":
        a = a[:3]
    else:
        k = 0
    with pytest.raises((TypeError, ValueError)):
        ck.centre_sums(x, a, k)


@pytest.mark.parametrize("max_avg", [None, 2.0])
def test_agglomerative_and_dbscan_match_jax(blobs, max_avg):
    d = np.sqrt(((blobs[:, None] - blobs[None]) ** 2).sum(-1))
    got = cl.AgglomerativeGraphical(num_clusters=2,
                                    max_avg_distance=max_avg).fit(d)
    ref = jcl.AgglomerativeGraphical(num_clusters=2,
                                     max_avg_distance=max_avg).fit(d)
    np.testing.assert_array_equal(got.labels_, ref.labels_)
    if max_avg is None:
        assert got.labels_[0] != got.labels_[60]
    db = cl.DBSCAN(eps=1.0, min_samples=4).fit(d)
    np.testing.assert_array_equal(db.labels_,
                                  jcl.DBSCAN(eps=1.0, min_samples=4).fit(d)
                                  .labels_)
    assert len(set(db.labels_[db.labels_ >= 0])) == 2


@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
def test_dataset_distance_matrix_matches_jax(elearn, metric):
    ds, jds = elearn[1500]
    sub, jsub = ds.take(np.arange(300)), jds.take(np.arange(300))
    got = cl.dataset_distance_matrix(sub, metric, device=CPU)
    ref = jcl.dataset_distance_matrix(jsub, metric)
    assert got.shape == (300, 300)
    np.testing.assert_allclose(got ** 2, ref ** 2, rtol=0, atol=DIST2_ATOL)
    np.testing.assert_allclose(np.diag(got), 0.0, atol=1e-3)
    for eps in (0.05, 0.1):
        np.testing.assert_array_equal(
            cl.DBSCAN(eps=eps).fit(got).labels_,
            jcl.DBSCAN(eps=eps).fit(ref).labels_)


def test_cluster_tendency_matches_jax():
    rng = np.random.default_rng(8)
    clustered = np.concatenate([rng.normal(-5, 0.3, (100, 2)),
                                rng.normal(5, 0.3, (100, 2))])
    uniform_ref = rng.uniform(-6, 6, (200, 2))
    uniform2 = rng.uniform(-6, 6, (200, 2))
    h_c = cl.hopkins_statistic(clustered, uniform_ref, 20, num_iters=4,
                               seed=0, device=CPU)
    h_u = cl.hopkins_statistic(uniform_ref, uniform2, 20, num_iters=4,
                               seed=0, device=CPU)
    assert h_c < h_u and h_c < 0.3
    assert h_c == pytest.approx(jcl.hopkins_statistic(
        clustered, uniform_ref, 20, num_iters=4, seed=0), rel=TENDENCY_RTOL)
    assert h_u == pytest.approx(jcl.hopkins_statistic(
        uniform_ref, uniform2, 20, num_iters=4, seed=0), rel=TENDENCY_RTOL)
    with pytest.raises(ValueError, match="must be <"):
        cl.hopkins_statistic(clustered, uniform_ref, 200, device=CPU)
    x = np.random.default_rng(9).normal(0, 1, (50, 3))
    for diff in (False, True):
        got = cl.k_dist(x, neighbor_index=3, first_order_diff=diff,
                        device=CPU)
        ref = jcl.k_dist(x, neighbor_index=3, first_order_diff=diff)
        assert got.shape == ((49, 3) if diff else (50, 3))
        np.testing.assert_allclose(got, ref, rtol=TENDENCY_RTOL, atol=1e-6)
    assert np.all(np.diff(cl.k_dist(x, 3, device=CPU), axis=0) >= -1e-6)
    under = np.array([5.0, 3.0, 1.0, 0.5])
    over = np.array([0.1, 0.3, 1.0, 4.0])
    v = cl.validity_index(under, over)
    assert v.tobytes() == jcl.validity_index(under, over).tobytes()
    assert v.argmin() in (1, 2)


# ------------------------------------------------------------------- jobs
@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("regress_cluster")
    schema = d / "elearn.json"
    schema.write_text(json.dumps(elearn_schema().to_json()))
    data = d / "elearn.csv"
    data.write_text(generate_elearn(2000, seed=61, as_csv=True))
    small = d / "small.csv"
    small.write_text(generate_elearn(200, seed=62, as_csv=True))
    return {"dir": d, "schema": str(schema), "data": str(data),
            "small": str(small)}


JOBS = {
    "logisticRegression": ("lrj", "data", {}),
    "logisticRegression:all": ("lrj", "data", {
        "convergence.criteria": "allBelowThreshold", "iteration.limit": "40",
        "positive.class.value": "pass"}),
    "clusterTrain": ("train", "data", {"num.clusters": "3"}),
    "kmeansCluster": ("train", "data", {"num.clusters": "2",
                                        "num.iters": "5"}),
    "clusterTrain:dbscan": ("train", "small", {"algo": "dbscan",
                                               "eps": "0.12"}),
}


@pytest.mark.parametrize("case", sorted(JOBS))
def test_job_matches_jax(files, tmp_path, case):
    job = case.split(":")[0]
    prefix, data, extra = JOBS[case]
    props = {f"{prefix}.feature.schema.file.path": files["schema"],
             **{f"{prefix}.{k}": v for k, v in extra.items()}}
    ref = jax_run_job(job, props, [files[data]], str(tmp_path / "jax") + "/")
    got = run_job(job, props, [files[data]], str(tmp_path / "port") + "/",
                  device=CPU)
    g, r = (Path(res.outputs[0]).read_text() for res in (got, ref))
    assert got.counters == {k: v for k, v in ref.counters.items()
                            if not k.startswith("Mem:")}
    if job == "logisticRegression":
        assert Path(got.outputs[0]).name == "coeff.txt"
        cells = [(a, b) for gl, rl in zip(g.splitlines(), r.splitlines())
                 for a, b in zip(gl.split(","), rl.split(","))]
        assert len(g.splitlines()) == len(r.splitlines())
        assert all(abs(float(a) - float(b)) <= 1.5e-6 for a, b in cells)
        assert sum(a != b for a, b in cells) <= 4
    else:
        assert g == r


def _distance_file(tmp_path, files) -> str:
    """The port's recordSimilarity over the small e-learning file."""
    props = {"sts.feature.schema.file.path": files["schema"]}
    out = tmp_path / "dist.txt"
    run_job("recordSimilarity", props, [files["small"]], str(out), device=CPU)
    return str(out)


@pytest.mark.parametrize("source,extra", [
    ("handmade", {"agg.num.clusters": "2"}),
    ("similarity", {"agg.num.clusters": "4"}),
    ("similarity", {"agg.num.clusters": "2", "agg.max.avg.distance": "0.08"})])
def test_agglomerative_job_matches_jax(files, tmp_path, source, extra):
    if source == "handmade":
        dist = tmp_path / "hand.txt"
        dist.write_text("a,b,100\nc,d,120\na,c,900\na,d,910\nb,c,920\n"
                        "b,d,930\n")
        dist = str(dist)
    else:
        dist = _distance_file(tmp_path, files)
    got = run_job("agglomerativeGraphical", extra, [dist],
                  str(tmp_path / "port.txt"), device=CPU)
    ref = jax_run_job("agglomerativeGraphical", extra, [dist],
                      str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    assert got.counters == ref.counters
    if source == "handmade":
        assign = dict(ln.split(",") for ln in
                      (tmp_path / "port.txt").read_text().splitlines())
        assert assign["a"] == assign["b"] != assign["c"] == assign["d"]


def test_registry_covers_every_reference_job():
    assert set(jax_job_names()) <= set(job_names())
    assert len({run_name for run_name in jax_job_names()}) == \
        len(set(jax_job_names()))


def test_new_jobs_through_the_cli(files, tmp_path):
    props = tmp_path / "jobs.properties"
    props.write_text(f"lrj.feature.schema.file.path={files['schema']}\n"
                     f"train.feature.schema.file.path={files['schema']}\n"
                     "train.num.clusters=2\n")
    for name in ("org.avenir.regress.LogisticRegressionJob", "kmeansCluster"):
        out = tmp_path / name.rsplit(".", 1)[-1]
        proc = subprocess.run(
            [sys.executable, "-m", "avenir_tpu_torch", name, "--conf",
             str(props), files["small"], str(out) + "/", "--device", "cpu"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        ref = jax_run_job(name, str(props), [files["small"]],
                          str(out) + ".jax/")
        assert row["counters"] == {k: v for k, v in ref.counters.items()
                                   if not k.startswith("Mem:")}
