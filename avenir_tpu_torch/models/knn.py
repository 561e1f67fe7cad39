"""K-nearest-neighbour classifier and regressor on the port's CUDA kernels.

The port of `avenir_tpu/models/knn.py`. The reference's 5-job KNN pipeline
(resource/knn.sh: sifarish all-pairs distances, Bayesian feature
posteriors, a join, and NearestNeighbor's secondary-sorted vote) is one
device program per test batch: a streaming top-k over the train rows and
a kernel-weighted vote.

Routing, as in the JAX package: numeric and mixed data with a euclidean or
manhattan metric go to the top-k kernels (categoricals one-hot expanded by
`_expand_mixed`); `packed=True` takes the lane-packed kernel and
`fused=True` the in-kernel vote. Another metric, or no features, goes to
the plain-torch `ops.distance.blocked_topk_neighbors`, as in JAX
knn.py:168-172. Class-conditional weighting never fuses (JAX knn.py:342):
it composes the exact top-k with `_vote`. Shapes the kernels do not take
(k above `KMAX`, more expanded columns than `MAX_D`, more than 64
classes) raise in the kernel wrappers.

Vote scores follow Neighborhood.processClassDitribution
(Neighborhood.java:150-218) with KERNEL_SCALE=100 and int-floored scores:
  none                 score = 1
  linearMultiplicative score = d==0 ? 200 : floor(100/d)
  linearAdditive       score = max(100 - d, 0)
  gaussian             score = floor(100 * exp(-0.5 (d/param)^2))
with d = floor(100 * distance). Classification is the arg-max class score
or the decision-threshold pos/neg ratio test; regression is the average,
median or per-query simple linear regression of the neighbours' targets.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from avenir_tpu_torch.core.dataset import (Dataset, extract_mixed_features,
                                           pad_rows)
from avenir_tpu_torch.models.naive_bayes import (NaiveBayesModel,
                                                 NaiveBayesPredictor)
from avenir_tpu_torch.ops.distance import blocked_topk_neighbors, pad_train
from avenir_tpu_torch.ops.knn_kernels import (LANE_CORPUS_CAP, kernel_score,
                                              knn_classify_lanes, knn_topk,
                                              knn_topk_lanes)
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device
from avenir_tpu_torch.utils.metrics import ConfusionMatrix

KERNEL_SCALE = 100
CLASS_COND_KEY = "nen.class.condtion.weighted"


def _expand_mixed(x_num, ranges, x_cat, bins, metric: str):
    """One-hot-expand categoricals into the numeric matrix so mixed data
    rides the numeric kernels: a one-hot pair contributes ||a-b||^2 =
    2*[a != b] (and L1 = 2*[a != b]), so scaling the one-hot by 1/sqrt(2)
    (euclidean) or 1/2 (manhattan) makes the summed term exactly the
    mismatch count of ops.distance's mixed semantics. Numeric columns are
    divided by their range. Returns (x float32 [n, D], n_attrs), n_attrs
    being the semantic attribute count the distance averages over."""
    n = x_num.shape[0] if x_num is not None else x_cat.shape[0]
    cols = []
    if x_num is not None and x_num.shape[1]:
        cols.append(np.asarray(x_num, np.float32)
                    / np.maximum(np.asarray(ranges, np.float32), 1e-9))
    scale = (1.0 / np.sqrt(2.0)) if metric == "euclidean" else 0.5
    rows = np.arange(n, dtype=np.int32)
    for f, b in enumerate(bins or ()):
        oh = np.zeros((n, b), np.float32)
        oh[rows, np.asarray(x_cat[:, f], np.int32)] = scale
        cols.append(oh)
    x = np.concatenate(cols, axis=1) if cols else np.zeros((n, 0), np.float32)
    n_attrs = (x_num.shape[1] if x_num is not None else 0) + len(bins or ())
    return np.ascontiguousarray(x, np.float32), n_attrs


def _vote(dist: torch.Tensor, neigh_labels: torch.Tensor,
          neigh_post: torch.Tensor, kernel: str, kernel_param: float,
          num_classes: int, class_cond: bool = False,
          inverse_weighted: bool = False) -> torch.Tensor:
    """Class scores [nq, C] of the kernel-weighted vote of [nq, k]
    neighbours; unfilled slots (dist=inf) vote nothing. class_cond
    multiplies each score by the neighbour's feature posterior (and by
    1/d with inverse_weighted), Neighbor.setScore."""
    score = kernel_score(dist, kernel, kernel_param)
    if class_cond:
        score = torch.where(neigh_post > 0, score * neigh_post, score)
        if inverse_weighted:
            d = torch.floor(dist * KERNEL_SCALE)
            score = score / torch.clamp(d, min=1.0)
    score = torch.where(torch.isfinite(dist), score, 0.0)
    oh = F.one_hot(neigh_labels.long(), num_classes).to(torch.float32)
    return torch.einsum("qk,qkc->qc", score.to(torch.float32), oh)


class NeighborIndex:
    """Streaming nearest-neighbour search over a train Dataset — the part
    of the pipeline that replaces sifarish. Label-free, so usable for
    regression datasets too. Lives on `device` (default cuda)."""

    def __init__(self, train: Dataset, k: int = 5, metric: str = "manhattan",
                 block: int = 4096, approx: bool = False,
                 packed: bool = False, device: DeviceLike = None):
        """packed=True opts into the lane-packed kernel: distances are
        quantized to ~2^-13 relative, which can reorder near-tied
        neighbours. approx=True selects exactly (see
        `ops.distance.blocked_topk_neighbors`), on the kernels where they
        apply."""
        x_num, ranges, x_cat, bins = extract_mixed_features(train)
        self._setup(x_num, ranges, x_cat, bins, len(train), k, metric, block,
                    packed, resolve_device(device))

    @classmethod
    def from_expanded(cls, x: np.ndarray, n_attrs: int, ranges: np.ndarray,
                      bins, k: int, metric: str, packed: bool,
                      device: DeviceLike = None) -> "NeighborIndex":
        """A kernel-route index over rows already normalized and one-hot
        expanded by `_expand_mixed` (ranges and bins expand the queries)."""
        if metric not in ("euclidean", "manhattan"):
            raise ValueError("expanded rows need the kernel route: a "
                             "euclidean or manhattan metric")
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.k = max(1, min(k, x.shape[0]))
        self.metric = metric
        self.cat_bins = tuple(bins) if bins else None
        self._ranges_np = np.asarray(ranges, np.float32)
        self.use_kernels = True
        self.ranges = None
        self.t_cat = None
        self.n_attrs = n_attrs
        self._set_kernel_train(np.ascontiguousarray(x, np.float32), packed)
        return self

    def _setup(self, x_num, ranges, x_cat, bins, n, k, metric, block,
               packed, device: torch.device) -> None:
        self.device = device
        # the reference takes "the first topMatchCount values": a train
        # set smaller than k just yields all of it
        self.k = max(1, min(k, n))
        self.metric = metric
        self.cat_bins = tuple(bins) if bins else None
        self._ranges_np = np.asarray(ranges, np.float32)
        n_features = x_num.shape[1] + (x_cat.shape[1] if x_cat is not None
                                       else 0)
        self.use_kernels = (n_features > 0
                            and metric in ("euclidean", "manhattan"))
        self.ranges = None
        self.t_cat = None
        if self.use_kernels:
            x, self.n_attrs = _expand_mixed(x_num, ranges, x_cat, bins, metric)
            self._set_kernel_train(x, packed)
        else:
            self.n_attrs = None
            self.packed = False
            self.block = min(block, max(n, 1))
            t_num, t_cat, self.n_valid = pad_train(x_num, x_cat, self.block)
            self.t_num = torch.from_numpy(t_num).to(device)
            if t_cat is not None:
                self.t_cat = torch.from_numpy(t_cat).to(device)
            if self._ranges_np.size:
                self.ranges = torch.from_numpy(self._ranges_np).to(device)
            self.n_padded = self.t_num.shape[0]

    def _set_kernel_train(self, x: np.ndarray, packed: bool) -> None:
        """Pad the expanded, normalized train matrix as the JAX index pads
        it (256-row granularity, block at most 8192): the lane kernel's
        quantization grid depends on the padded row count."""
        self.block = max(256, min(pad_rows(x.shape[0], 256), 8192))
        t, _, self.n_valid = pad_train(x, None, self.block)
        self.packed = packed and t.shape[0] <= LANE_CORPUS_CAP
        self.t_num = torch.from_numpy(t).to(self.device)
        self.n_padded = t.shape[0]

    def _query(self, q_num: np.ndarray, q_cat) -> torch.Tensor:
        q, _ = _expand_mixed(q_num, self._ranges_np, q_cat, self.cat_bins,
                             self.metric)
        return torch.from_numpy(q).to(self.device)

    def neighbors(self, test: Dataset) -> Tuple[torch.Tensor, torch.Tensor]:
        """(dist [nq,k], train index [nq,k]) on the index's device;
        unfillable slots are (+inf, -1)."""
        q_num, _, q_cat, _ = extract_mixed_features(test)
        if self.use_kernels:
            topk = knn_topk_lanes if self.packed else knn_topk
            return topk(self._query(q_num, q_cat), self.t_num, k=self.k,
                        metric=self.metric, n_valid=self.n_valid,
                        n_attrs=self.n_attrs)
        dev = self.device
        return blocked_topk_neighbors(
            torch.from_numpy(q_num).to(dev),
            self.t_num,
            torch.from_numpy(q_cat).to(dev) if self.t_cat is not None else None,
            self.t_cat, cat_bins=self.cat_bins, num_ranges=self.ranges,
            k=self.k, block=self.block, metric=self.metric,
            n_valid=self.n_valid)

    def classify_scores(self, test: Dataset, train_labels: torch.Tensor,
                        n_classes: int, kernel_fn: str,
                        kernel_param: float) -> Optional[torch.Tensor]:
        """Class scores [nq, C] from the fused vote kernel, or None on
        the plain-torch route."""
        if not self.use_kernels:
            return None
        q_num, _, q_cat, _ = extract_mixed_features(test)
        return knn_classify_lanes(
            self._query(q_num, q_cat), self.t_num, train_labels, k=self.k,
            n_classes=n_classes, n_attrs=self.n_attrs, kernel_fn=kernel_fn,
            kernel_param=kernel_param, metric=self.metric,
            n_valid=self.n_valid)


def _padded(values: np.ndarray, n: int, dtype) -> np.ndarray:
    out = np.zeros((n,), dtype)
    out[:len(values)] = values
    return out


class NearestNeighborClassifier:
    """nen.* job equivalent. Parameters mirror the knn.properties keys."""

    def __init__(self, train: Dataset, top_match_count: int = 5,
                 kernel_function: str = "none", kernel_param: float = 1.0,
                 class_cond_weighted: bool = False,
                 inverse_distance_weighted: bool = False,
                 decision_threshold: float = -1.0,
                 positive_class: Optional[str] = None,
                 metric: str = "manhattan", block: int = 4096,
                 nb_model: Optional[NaiveBayesModel] = None,
                 approx: bool = False, fused: bool = False,
                 packed: bool = False, device: DeviceLike = None):
        """fused=True opts into the in-kernel vote for the
        non-class-conditional modes (distances quantized ~2^-21, ties
        biased toward lower class codes); packed=True opts the top-k into
        the lane-packed kernel. The default composes the exact top-k with
        `_vote`, as class-conditional weighting always does. That mode
        weights each train row by P(its features | its class) from
        `nb_model`, or from a Naive Bayes model fitted on `train`."""
        index = NeighborIndex(train, k=top_match_count, metric=metric,
                              block=block, approx=approx, packed=packed,
                              device=device)
        post = None
        if class_cond_weighted:
            model = (nb_model if nb_model is not None
                     else NaiveBayesModel.fit(train, device=index.device))
            post = NaiveBayesPredictor(model).feature_prob(train).astype(
                np.float32)
        self._setup(index, train.labels(), train.schema.class_values(), post,
                    kernel_function, kernel_param, class_cond_weighted,
                    inverse_distance_weighted, decision_threshold,
                    positive_class, fused)

    @classmethod
    def from_index(cls, index: NeighborIndex, train_labels: np.ndarray,
                   class_values: Sequence[str],
                   train_post: Optional[np.ndarray] = None,
                   kernel_function: str = "none", kernel_param: float = 1.0,
                   class_cond_weighted: bool = False,
                   inverse_distance_weighted: bool = False,
                   decision_threshold: float = -1.0,
                   positive_class: Optional[str] = None,
                   fused: bool = False) -> "NearestNeighborClassifier":
        """A classifier over a built index and its rows' labels (and, for
        class-conditional weighting, their feature posteriors)."""
        if class_cond_weighted and train_post is None:
            raise ValueError(f"{CLASS_COND_KEY}=true needs train_post")
        self = cls.__new__(cls)
        self._setup(index, train_labels, class_values, train_post,
                    kernel_function, kernel_param, class_cond_weighted,
                    inverse_distance_weighted, decision_threshold,
                    positive_class, fused)
        return self

    def _setup(self, index, labels, class_values, post, kernel_function,
               kernel_param, class_cond, inverse_weighted,
               decision_threshold, positive_class, fused) -> None:
        self.index = index
        self.fused = fused
        self.k = index.k
        self.kernel = kernel_function
        self.kernel_param = kernel_param
        self.class_cond = class_cond
        self.inverse_weighted = inverse_weighted
        self.decision_threshold = decision_threshold
        self.class_values = list(class_values)
        self.positive_class = (self.class_values.index(positive_class)
                               if positive_class else 1)
        n = index.n_padded
        dev = index.device
        self.train_labels = torch.from_numpy(
            _padded(np.asarray(labels, np.int32)[:index.n_valid], n,
                    np.int32)).to(dev)
        post_full = np.ones((n,), np.float32)
        if post is not None:
            post_full[:index.n_valid] = np.asarray(post,
                                                   np.float32)[:index.n_valid]
        self.train_post = torch.from_numpy(post_full).to(dev)

    def neighbors(self, test: Dataset) -> Tuple[torch.Tensor, torch.Tensor]:
        """(dist [nq,k], train index [nq,k]) over the real train rows."""
        return self.index.neighbors(test)

    def predict(self, test: Dataset) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (predicted class codes [nq], class scores [nq, K])."""
        n_classes = len(self.class_values)
        scores = None
        if self.fused and not self.class_cond:
            scores = self.index.classify_scores(
                test, self.train_labels, n_classes, self.kernel,
                self.kernel_param)
        if scores is None:
            dist, idx = self.neighbors(test)
            li = idx.long()
            scores = _vote(dist, self.train_labels[li], self.train_post[li],
                           self.kernel, self.kernel_param, n_classes,
                           self.class_cond, self.inverse_weighted)
        scores = scores.cpu().numpy()
        # the reference's threshold branch exists only in non-class-cond
        # mode (Neighborhood.classify(), :272-312)
        if (self.decision_threshold > 0 and n_classes == 2
                and not self.class_cond):
            pos = self.positive_class
            neg = 1 - pos
            ratio = scores[:, pos] / np.maximum(scores[:, neg], 1e-9)
            pred = np.where(ratio > self.decision_threshold, pos,
                            neg).astype(np.int32)
        else:
            pred = scores.argmax(axis=1).astype(np.int32)
        return pred, scores

    def validate(self, test: Dataset,
                 pos_class: Optional[int] = None) -> ConfusionMatrix:
        pred, _ = self.predict(test)
        cm = ConfusionMatrix(
            self.class_values,
            pos_class=self.positive_class if pos_class is None else pos_class)
        cm.add(test.labels(), pred)
        return cm


class NearestNeighborRegressor:
    """Regression modes of Neighborhood.doRegression: average / median /
    per-query simple linear regression over the k neighbours' targets."""

    def __init__(self, train: Dataset, target: np.ndarray,
                 top_match_count: int = 5, method: str = "average",
                 regr_input: Optional[np.ndarray] = None,
                 metric: str = "manhattan", block: int = 4096,
                 device: DeviceLike = None):
        self.index = NeighborIndex(train, k=top_match_count, metric=metric,
                                   block=block, device=device)
        n, dev = self.index.n_padded, self.index.device
        self.target = torch.from_numpy(
            _padded(np.asarray(target, np.float32), n, np.float32)).to(dev)
        self.method = method
        self.regr_input = None
        if regr_input is not None:
            self.regr_input = torch.from_numpy(
                _padded(np.asarray(regr_input, np.float32), n,
                        np.float32)).to(dev)

    def predict(self, test: Dataset,
                query_input: Optional[np.ndarray] = None) -> np.ndarray:
        _, idx = self.index.neighbors(test)
        li = idx.long()
        y = self.target[li]                                     # [nq, k]
        if self.method == "average":
            return y.mean(dim=1).cpu().numpy()
        if self.method == "median":
            # the midpoint of the two middle values for an even k, as
            # jnp.median does (torch.median would take the lower one)
            ys = torch.sort(y, dim=1).values
            k = ys.shape[1]
            mid = (ys[:, (k - 1) // 2] + ys[:, k // 2]) * 0.5
            return mid.cpu().numpy()
        if self.method == "linearRegression":
            if self.regr_input is None or query_input is None:
                raise ValueError("linearRegression needs regr_input and "
                                 "query_input")
            x = self.regr_input[li]                             # [nq, k]
            xm = x.mean(dim=1, keepdim=True)
            ym = y.mean(dim=1, keepdim=True)
            cov = ((x - xm) * (y - ym)).sum(dim=1)
            var = ((x - xm) ** 2).sum(dim=1)
            slope = cov / torch.clamp(var, min=1e-9)
            intercept = ym[:, 0] - slope * xm[:, 0]
            qi = torch.as_tensor(np.asarray(query_input, np.float32),
                                 device=y.device)
            return (intercept + slope * qi).cpu().numpy()
        raise ValueError(f"unknown regression method {self.method}")
