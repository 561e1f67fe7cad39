"""Clustering: k-means on the device, agglomerative and DBSCAN on the host.

The port of `avenir_tpu/models/cluster.py` (cluster/
AgglomerativeGraphical.java:43, python/unsupv/cluster.py):

- k-means: Lloyd steps on `device` (default cuda), each under the
  profiler range `cluster::kmeans_step`: squared distances by the norm
  expansion (the cross term in the order of XLA's CPU dot,
  `ops/xla_math.inner_dot`), the first minimum's cluster, exact counts,
  and the centre sums in row order as XLA's CPU `segment_sum` adds them
  (`ops/cluster_kernels.centre_sums`: a CUDA kernel on the card, no float
  atomics); an empty cluster keeps its centre; the reference's stop rule
  on the float32 inertia, summed by halves (`xla_math.tree_sum`, within
  the tolerance the tests state of XLA's reduce). So centres and labels
  are the reference's bit for bit, and a card run's are its CPU twin's;
- agglomerative (average linkage under an average-edge membership bound)
  and DBSCAN: host loops over a distance matrix, as in the reference;
- `dataset_distance_matrix`: the port's `pairwise_distance` on the
  device, its cross term as `inner_dot`, so DBSCAN's eps compares see
  the same bits on the card and the CPU;
- `hopkins_statistic` and `k_dist`: their distances on the device;
  `cohesion`, `inter_cluster_distance` and `validity_index`: host numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from avenir_tpu_torch.core.dataset import Dataset, extract_mixed_features
from avenir_tpu_torch.ops import xla_math
from avenir_tpu_torch.ops.cluster_kernels import centre_sums
from avenir_tpu_torch.ops.distance import _column_sum, _sqrt, pairwise_distance
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device

#: the profiler range of each Lloyd step
STEP_RANGE = "cluster::kmeans_step"


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------
def _kmeans_step(x: torch.Tensor, centers: torch.Tensor, k: int):
    """One Lloyd step: (new centres [k, d], assignment [n], inertia [])."""
    with torch.profiler.record_function(STEP_RANGE):
        d2 = (_column_sum(x * x)[:, None] + _column_sum(centers * centers)[None, :]
              - xla_math.inner_dot(2.0 * x, centers))
        assign = torch.argmin(d2, dim=1)
        # integer counts (bincount would read the labels' max back)
        cnts = torch.zeros(k, dtype=torch.int64, device=x.device).scatter_add_(
            0, assign, torch.ones_like(assign)).to(torch.float32)
        new = (centre_sums(x, assign.to(torch.int32), k)
               / torch.clamp(cnts[:, None], min=1.0))
        new = torch.where(cnts[:, None] > 0, new, centers)
        inertia = xla_math.tree_sum(d2.min(dim=1).values)
        return new, assign, inertia


class KMeans:
    """Lloyd's k-means from k distinct seeded rows (`default_rng(seed)`),
    until the inertia moves by less than tol x max(inertia, 1) or `iters`
    steps."""

    def __init__(self, k: int, iters: int = 50, seed: int = 0,
                 tol: float = 1e-5, device: DeviceLike = None):
        self.k = k
        self.iters = iters
        self.seed = seed
        self.tol = tol
        self.device = resolve_device(device)

    def fit(self, x: np.ndarray) -> "KMeans":
        rng = np.random.default_rng(self.seed)
        x = np.asarray(x, np.float32)
        init = x[rng.choice(len(x), self.k, replace=False)]
        centers = torch.from_numpy(init).to(self.device)
        xd = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        prev_inertia = np.inf
        for _ in range(self.iters):
            centers, assign, inertia = _kmeans_step(xd, centers, self.k)
            inertia = float(inertia)
            if abs(prev_inertia - inertia) < self.tol * max(inertia, 1.0):
                break
            prev_inertia = inertia
        self.centers = centers.cpu().numpy()
        self.labels_ = assign.cpu().numpy()
        self.inertia_ = inertia
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        d2 = ((np.asarray(x)[:, None, :] - self.centers[None]) ** 2).sum(-1)
        return d2.argmin(axis=1)


# ---------------------------------------------------------------------------
# agglomerative (average linkage over a distance matrix)
# ---------------------------------------------------------------------------
class AgglomerativeGraphical:
    """Greedy agglomerative merging over pairwise distances
    (AgglomerativeGraphical.java:43, EdgeWeightedCluster.java:32): merge
    the closest pair of clusters (average linkage, the first pair on a
    tie) while the merged cluster's average intra-edge distance stays at
    most `max_avg_distance`, down to `num_clusters`."""

    def __init__(self, num_clusters: int = 2,
                 max_avg_distance: Optional[float] = None):
        self.num_clusters = num_clusters
        self.max_avg_distance = max_avg_distance

    def fit(self, dist: np.ndarray) -> "AgglomerativeGraphical":
        n = dist.shape[0]
        clusters: Dict[int, List[int]] = {i: [i] for i in range(n)}
        d = dist.astype(np.float64).copy()
        np.fill_diagonal(d, np.inf)
        cd = {(i, j): d[i, j] for i in range(n) for j in range(i + 1, n)}

        def avg_intra(members: List[int]) -> float:
            if len(members) < 2:
                return 0.0
            s = cnt = 0
            for a in range(len(members)):
                for b in range(a + 1, len(members)):
                    s += dist[members[a], members[b]]
                    cnt += 1
            return s / cnt

        while len(clusters) > self.num_clusters:
            (i, j), _ = min(
                ((pair, val) for pair, val in cd.items()
                 if pair[0] in clusters and pair[1] in clusters),
                key=lambda kv: kv[1])
            merged = clusters[i] + clusters[j]
            if (self.max_avg_distance is not None
                    and avg_intra(merged) > self.max_avg_distance):
                break
            del clusters[j]
            clusters[i] = merged
            for k in list(clusters):
                if k == i:
                    continue
                a, b = min(i, k), max(i, k)
                pairs = [(p, q) for p in clusters[i] for q in clusters[k]]
                cd[(a, b)] = float(np.mean([dist[p, q] for p, q in pairs]))

        self.labels_ = np.zeros(n, np.int32)
        for li, members in enumerate(clusters.values()):
            for m in members:
                self.labels_[m] = li
        return self


# ---------------------------------------------------------------------------
# DBSCAN
# ---------------------------------------------------------------------------
class DBSCAN:
    """Density clustering over a distance matrix (python/unsupv/cluster.py);
    noise points get label -1."""

    def __init__(self, eps: float, min_samples: int = 4):
        self.eps = eps
        self.min_samples = min_samples

    def fit(self, dist: np.ndarray) -> "DBSCAN":
        n = dist.shape[0]
        neigh = [np.flatnonzero(dist[i] <= self.eps) for i in range(n)]
        core = np.array([len(nb) >= self.min_samples for nb in neigh])
        labels = np.full(n, -1, np.int32)
        cid = 0
        for i in range(n):
            if labels[i] != -1 or not core[i]:
                continue
            stack = [i]
            labels[i] = cid
            while stack:
                p = stack.pop()
                for q in neigh[p]:
                    if labels[q] == -1:
                        labels[q] = cid
                        if core[q]:
                            stack.append(q)
            cid += 1
        self.labels_ = labels
        return self


# ---------------------------------------------------------------------------
# model selection metrics (python/unsupv/cluster.py cohesion / separation)
# ---------------------------------------------------------------------------
def cohesion(x: np.ndarray, labels: np.ndarray) -> float:
    """Mean distance to the own cluster's centroid (lower is tighter)."""
    total = 0.0
    for c in np.unique(labels[labels >= 0]):
        members = x[labels == c]
        centroid = members.mean(axis=0)
        total += np.linalg.norm(members - centroid, axis=1).sum()
    valid = (labels >= 0).sum()
    return total / max(valid, 1)


def inter_cluster_distance(x: np.ndarray, labels: np.ndarray) -> float:
    """Mean pairwise centroid distance (higher is better separated)."""
    cents = [x[labels == c].mean(axis=0) for c in np.unique(labels[labels >= 0])]
    if len(cents) < 2:
        return 0.0
    tot = cnt = 0
    for a in range(len(cents)):
        for b in range(a + 1, len(cents)):
            tot += np.linalg.norm(cents[a] - cents[b])
            cnt += 1
    return tot / cnt


def dataset_distance_matrix(ds: Dataset, metric: str = "euclidean",
                            device: DeviceLike = None) -> np.ndarray:
    """float32 [n, n] mixed-attribute distance of every row pair on
    `device` (the EntityDistanceMapFileAccessor role): the reference's
    eager `pairwise_distance`, a true division by the attribute count,
    with the euclidean cross term as `xla_math.inner_dot`."""
    dev = resolve_device(device)
    x_num, ranges, x_cat, bins = extract_mixed_features(ds)
    num = torch.from_numpy(x_num).to(dev)
    cat = torch.from_numpy(x_cat).to(dev) if x_cat is not None else None
    d = pairwise_distance(
        num, num, cat, cat, cat_bins=bins,
        num_ranges=torch.from_numpy(ranges).to(dev) if ranges.size else None,
        metric=metric, divide=True, cross=xla_math.inner_dot)
    return d.cpu().numpy()


# ---------------------------------------------------------------------------
# cluster-tendency exploration (python/unsupv/cluster.py expl_* functions)
# ---------------------------------------------------------------------------
def _min_cross_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance from each row of `a` to its nearest row of `b`
    (lib/support.py find_min_distances)."""
    d2 = torch.clamp(_column_sum(a * a)[:, None] + _column_sum(b * b)[None, :]
                     - 2.0 * (a @ b.T), min=0.0)
    return _sqrt(d2.min(dim=1).values)


def hopkins_statistic(x: np.ndarray, x_random: np.ndarray, sample_size: int,
                      num_iters: int = 1, seed: int = 0,
                      device: DeviceLike = None) -> float:
    """Hopkins cluster-tendency statistic (expl_hopkins,
    unsupv/cluster.py:104-134): about 0.5 with no cluster structure, near
    0 when clustered. Each iteration splits off `sample_size` real and
    `sample_size` uniform-random points, sums their nearest-neighbour
    distances to the remaining data on `device`, and the statistic
    averages spl_sum / (ran_sum + spl_sum)."""
    if sample_size >= len(x):
        raise ValueError(f"sample_size {sample_size} must be < len(x) {len(x)}")
    if sample_size > len(x_random):
        raise ValueError(
            f"sample_size {sample_size} exceeds len(x_random) {len(x_random)}")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    xd = torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    xr = torch.from_numpy(np.asarray(x_random, np.float32)).to(dev)
    stats = []
    for _ in range(num_iters):
        perm = torch.from_numpy(rng.permutation(len(x))).to(dev)
        spl, tra = xd[perm[:sample_size]], xd[perm[sample_size:]]
        ran = xr[torch.from_numpy(
            rng.permutation(len(x_random))[:sample_size]).to(dev)]
        ran_sum = float(_min_cross_distances(ran, tra).sum())
        spl_sum = float(_min_cross_distances(spl, tra).sum())
        stats.append(spl_sum / max(ran_sum + spl_sum, 1e-30))
    return float(np.mean(stats))


def k_dist(x: np.ndarray, neighbor_index: int, first_order_diff: bool = False,
           device: DeviceLike = None) -> np.ndarray:
    """Sorted distance-to-kth-neighbour curves for DBSCAN's eps
    (expl_kdist, unsupv/cluster.py:138-158): [n, k] columns, each sorted
    ascending (or their first-order differences [n - 1, k])."""
    dev = resolve_device(device)
    xd = torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    n = xd.shape[0]
    sq = _column_sum(xd * xd)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (xd @ xd.T), min=0.0)
    d2 = torch.where(torch.eye(n, dtype=torch.bool, device=dev),
                     torch.full_like(d2, float("inf")), d2)
    dist = torch.sort(_sqrt(d2), dim=1).values[:, :neighbor_index]
    out = torch.sort(dist, dim=0).values.cpu().numpy()
    return np.diff(out, axis=0) if first_order_diff else out


def _scale_min_max(v: np.ndarray) -> np.ndarray:
    lo, hi = v.min(), v.max()
    return (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)


def validity_index(under_partition: np.ndarray,
                   over_partition: np.ndarray) -> np.ndarray:
    """Cluster-count selection index (validity_index,
    unsupv/cluster.py:168-172): the min-max-scaled under-partition measure
    (e.g. cohesion) plus the scaled over-partition one (e.g.
    1/separation); minimize over candidate k."""
    return (_scale_min_max(np.asarray(under_partition, np.float64))
            + _scale_min_max(np.asarray(over_partition, np.float64)))
