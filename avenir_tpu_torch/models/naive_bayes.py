"""Naive Bayes: class-conditional feature distributions and a posterior predictor.

The port of `avenir_tpu/models/naive_bayes.py`. Reference semantics
(org.avenir.bayesian):
- Train (BayesianDistribution.java): one pass over labeled CSV. Categorical
  and bucketed numeric features contribute (classVal, featureOrd, bin) ->
  count; unbinned numerics contribute (classVal, featureOrd) -> (count,
  sum, sum-sq), turned into per-class Gaussian mean/stddev; class priors and
  feature priors aggregate from the posteriors. The model is a flat CSV.
- Predict (BayesianPredictor.java): per record and class, P(C|F) =
  P(F|C) P(C) / P(F) with P(F|C) a product over per-feature bin
  probabilities (a Gaussian density for continuous features), scaled to
  int percent; max-prob or cost-based arbitration; confusion counters.

The JAX package carries both with XLA ops (a one-hot einsum), no Pallas
kernel, so plain torch ops carry them here, on the device the model names:
- counting: one `torch.bincount` over a flat (feature, class, bin) key for
  unweighted counts with no continuous field; `index_add_` in float32 per
  batch, folded in float64 on the host, for weights or moments, the
  moments of two or more continuous fields summed in the order of XLA's
  CPU dot (`_xla_cpu_row_sum`), the same bits on the CPU and the card;
- predicting: a gather of `log_post[f, :, code_f]` summed over f in
  ascending order in float32 (the order of the JAX einsum's sum, and no
  matrix product whose precision a TF32 setting could change).

Deviation from the reference, as in the JAX package: continuous means use
float math where the reference divides longs (BayesianDistribution.java:248).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.core.schema import FeatureField, FeatureSchema
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device
from avenir_tpu_torch.utils.metrics import ConfusionMatrix, CostBasedArbitrator

_TINY = 1e-30
_INT32_MAX = 2 ** 31 - 1


@dataclass
class NaiveBayesModel:
    """Count-space model (additive; finish() derives probability tables)."""

    schema: FeatureSchema
    class_values: List[str]
    binned_fields: List[FeatureField]
    cont_fields: List[FeatureField]
    bins: List[int]
    # counts: [F, K, Bmax] posterior bin counts (padded over B)
    post_counts: np.ndarray
    # continuous: [Fc, K, 3] (count, sum, sumsq)
    cont_moments: np.ndarray
    class_counts: np.ndarray  # [K]
    # set when a model was loaded from CSV (mean/std known, raw moments not):
    cont_params: Optional[np.ndarray] = None        # [Fc, K, 2] (mean, std)
    cont_prior_params: Optional[np.ndarray] = None  # [Fc, 2]
    device: torch.device = torch.device("cpu")
    # deferred device-side accumulator (streaming ingest): the per-batch
    # count tensors summed on the device, drained to the float64 host
    # arrays by flush(). Unweighted counts with no continuous field fold
    # as int64 — exact to 2^63 rows, so unlike the JAX package's int32
    # fold (_FLUSH_ROWS_INT) they need no mid-stream flush. Weighted or
    # moment-bearing folds stay float32 and flush before any cell could
    # pass float32 integer exactness (2^24).
    _pending: Optional[tuple] = None
    _pending_rows: int = 0
    _pending_int: bool = False

    _FLUSH_ROWS = 14 << 20

    # ------------------------------------------------------------ training
    @classmethod
    def empty(cls, schema: FeatureSchema, device: DeviceLike = None
              ) -> "NaiveBayesModel":
        binned = [f for f in schema.feature_fields if f.num_bins() > 0]
        cont = [f for f in schema.feature_fields
                if f.is_numeric and not f.bucket_width]
        bins = [f.num_bins() for f in binned]
        k = schema.num_classes()
        bmax = max(bins) if bins else 1
        return cls(
            schema=schema,
            class_values=schema.class_values(),
            binned_fields=binned,
            cont_fields=cont,
            bins=bins,
            post_counts=np.zeros((len(binned), k, bmax), np.float64),
            cont_moments=np.zeros((len(cont), k, 3), np.float64),
            class_counts=np.zeros((k,), np.float64),
            device=resolve_device(device),
        )

    def accumulate(self, codes, labels, x_cont, weights=None,
                   defer: bool = False) -> None:
        """Add one batch of sufficient statistics, counted on the model's
        device. defer=False drains the batch to the host arrays at once;
        defer=True (the streaming path) sums it into a device-side
        accumulator that flush() (called by finish, to_csv and merge)
        drains."""
        k = len(self.class_values)
        bmax = self.post_counts.shape[2]
        int_mode = weights is None and self.cont_moments.shape[0] == 0
        if self._pending is not None and self._pending_int != int_mode:
            self.flush()
        batch = _count_batch(codes, labels, x_cont, k, bmax, weights,
                             self.device)
        if self._pending is None:
            self._pending = batch
            self._pending_int = int_mode
        else:
            self._pending = tuple(a + b for a, b in zip(self._pending, batch))
        self._pending_rows += int(labels.shape[0])
        if not defer or (not int_mode
                         and self._pending_rows >= self._FLUSH_ROWS):
            self.flush()

    def flush(self) -> None:
        """Drain the deferred device accumulator into the host arrays."""
        if self._pending is None:
            return
        post, mom, cls = (t.cpu().numpy().astype(np.float64)
                          for t in self._pending)
        self._pending = None
        self._pending_rows = 0
        self.post_counts += post
        self.cont_moments += mom
        self.class_counts += cls

    @classmethod
    def fit(cls, dataset: Dataset, device: DeviceLike = None
            ) -> "NaiveBayesModel":
        model = cls.empty(dataset.schema, device)
        codes, _ = dataset.feature_codes(model.binned_fields)
        x_cont = dataset.feature_matrix(model.cont_fields)
        model.accumulate(codes, dataset.labels(), x_cont)
        return model

    def merge(self, other: "NaiveBayesModel") -> "NaiveBayesModel":
        """Combine the sufficient statistics of two partial fits (counts
        are additive: the reducer's summation)."""
        if self.cont_params is not None or other.cont_params is not None:
            raise ValueError("cannot merge models loaded from CSV "
                             "(raw moments unavailable)")
        self.flush()
        other.flush()
        self.post_counts = self.post_counts + other.post_counts
        self.cont_moments = self.cont_moments + other.cont_moments
        self.class_counts = self.class_counts + other.class_counts
        return self

    # ----------------------------------------------------------- finishing
    def finish(self) -> Dict[str, torch.Tensor]:
        """The predictor's probability tables, float32 on the model's
        device: the posterior P(bin|class) normalized within class, the
        feature prior P(bin), the class prior P(class), and per-class and
        prior Gaussian (mean, std) of continuous features
        (BayesianModel.finishUp, BayesianModel.java:217-233). Computed in
        float64 on the host as the JAX package does, then rounded."""
        self.flush()
        post = self.post_counts
        post_p = post / np.maximum(post.sum(axis=2, keepdims=True), _TINY)
        prior_counts = post.sum(axis=1)                       # [F, B]
        prior_p = prior_counts / np.maximum(
            prior_counts.sum(axis=1, keepdims=True), _TINY)
        class_p = self.class_counts / max(self.class_counts.sum(), _TINY)

        if self.cont_params is not None:
            mean, std = self.cont_params[..., 0], self.cont_params[..., 1]
            pmean = self.cont_prior_params[..., 0]
            pstd = self.cont_prior_params[..., 1]
        else:
            cm = self.cont_moments
            cnt = np.maximum(cm[..., 0], _TINY)
            mean = cm[..., 1] / cnt
            var = (cm[..., 2] - cnt * mean * mean) / np.maximum(cnt - 1, 1.0)
            std = np.sqrt(np.maximum(var, _TINY))
            pm = cm.sum(axis=1)                                # [Fc, 3]
            pcnt = np.maximum(pm[..., 0], _TINY)
            pmean = pm[..., 1] / pcnt
            pvar = (pm[..., 2] - pcnt * pmean * pmean) / np.maximum(pcnt - 1, 1.0)
            pstd = np.sqrt(np.maximum(pvar, _TINY))
        std = np.maximum(std, 1e-6)
        pstd = np.maximum(pstd, 1e-6)

        def f32(x) -> torch.Tensor:
            return torch.from_numpy(np.asarray(x, np.float32)).to(self.device)

        return {
            "log_post": f32(np.log(np.maximum(post_p, _TINY))),
            "log_prior": f32(np.log(np.maximum(prior_p, _TINY))),
            "log_class": f32(np.log(np.maximum(class_p, _TINY))),
            "cont_mean": f32(mean),
            "cont_std": f32(std),
            "cont_prior_mean": f32(pmean),
            "cont_prior_std": f32(pstd),
        }

    # ------------------------------------------------------------- file IO
    def to_csv(self, delim: str = ",") -> str:
        """Reference-compatible model CSV (BayesianDistribution reducer
        format, parsed back by BayesianPredictor.loadModel :186-224):
          classVal,ord,bin,count          feature posterior (binned)
          classVal,ord,,mean,stddev       feature posterior (continuous)
          classVal,,,count                class prior (per reduce emit)
          ,ord,bin,count                  feature prior (binned, per class)
          ,ord,,mean,stddev               feature prior (continuous)
        """
        self.flush()
        out: List[str] = []
        d = delim
        for fi, fld in enumerate(self.binned_fields):
            for ki, cv in enumerate(self.class_values):
                for b in range(self.bins[fi]):
                    c = int(self.post_counts[fi, ki, b])
                    if c == 0:
                        continue
                    blabel = fld.cardinality[b] if fld.is_categorical else str(b)
                    out.append(f"{cv}{d}{fld.ordinal}{d}{blabel}{d}{c}")
                    out.append(f"{cv}{d}{d}{d}{c}")
                    out.append(f"{d}{fld.ordinal}{d}{blabel}{d}{c}")
        for fi, fld in enumerate(self.cont_fields):
            for ki, cv in enumerate(self.class_values):
                cnt, s, sq = self.cont_moments[fi, ki]
                if cnt <= 0:
                    continue
                mean = s / cnt
                var = (sq - cnt * mean * mean) / max(cnt - 1, 1.0)
                std = math.sqrt(max(var, 0.0))
                out.append(f"{cv}{d}{fld.ordinal}{d}{d}{mean:.6f}{d}{std:.6f}")
                out.append(f"{cv}{d}{d}{d}{int(cnt)}")
            pm = self.cont_moments[fi].sum(axis=0)
            pmean = pm[1] / max(pm[0], 1.0)
            pvar = (pm[2] - pm[0] * pmean * pmean) / max(pm[0] - 1, 1.0)
            out.append(
                f"{d}{fld.ordinal}{d}{d}{pmean:.6f}{d}{math.sqrt(max(pvar, 0.0)):.6f}"
            )
        return "\n".join(out) + "\n"

    def save(self, path: str, delim: str = ",", stamp: bool = True) -> None:
        """``stamp`` publishes the format/digest sidecar that load
        verifies (models/artifact.py)."""
        with open(path, "w") as fh:
            fh.write(self.to_csv(delim))
        if stamp:
            from avenir_tpu_torch.models.artifact import write_stamp
            write_stamp(path)

    @classmethod
    def load(cls, path: str, schema: FeatureSchema, delim: str = ",",
             device: DeviceLike = None) -> "NaiveBayesModel":
        from avenir_tpu_torch.models.artifact import verify_stamp
        verify_stamp(path)
        # the model file is self-describing (BayesianPredictor.java:332-340):
        # class values and categorical bins it mentions extend any
        # data-discovered vocabularies a freshly loaded schema lacks, in
        # file order so codes match the training side's discovery
        cat_need = {f.ordinal: f for f in schema.fields
                    if f.is_categorical and not f.cardinality
                    and not f.id_field}
        if cat_need:
            cls_fld = schema.class_field
            cls_ord = cls_fld.ordinal if cls_fld is not None else None
            seen: Dict[int, List[str]] = {o: [] for o in cat_need}
            with open(path) as fh:
                for line in fh:
                    items = line.rstrip("\n").split(delim)
                    if len(items) < 4:
                        continue
                    cv, o, b = items[0], items[1], items[2]
                    if cv and cls_ord in seen and cv not in seen[cls_ord]:
                        seen[cls_ord].append(cv)
                    if o and b:
                        ordn = int(o)
                        if ordn in seen and ordn != cls_ord \
                                and b not in seen[ordn]:
                            seen[ordn].append(b)
            for o, fld in cat_need.items():
                if seen[o]:
                    fld.cardinality = seen[o]
                    fld.discovered_cardinality = True
        model = cls.empty(schema, device)
        bin_index = {f.ordinal: i for i, f in enumerate(model.binned_fields)}
        cont_index = {f.ordinal: i for i, f in enumerate(model.cont_fields)}
        cls_index = {v: i for i, v in enumerate(model.class_values)}
        k = len(model.class_values)
        if model.cont_fields:
            model.cont_params = np.zeros((len(model.cont_fields), k, 2))
            model.cont_prior_params = np.zeros((len(model.cont_fields), 2))
        class_counts = np.zeros_like(model.class_counts)
        with open(path) as fh:
            for line in fh:
                items = line.rstrip("\n").split(delim)
                if len(items) < 4:
                    continue
                cv, o, b = items[0], items[1], items[2]
                if cv == "" and o != "":
                    if b == "":  # continuous feature prior: ,ord,,mean,std
                        fi = cont_index[int(o)]
                        model.cont_prior_params[fi] = [float(items[3]),
                                                       float(items[4])]
                    # binned feature priors re-derive from posteriors
                elif cv != "" and o == "" and b == "":
                    # class prior rows: one per reduce group, summed on load
                    # (BayesianModel.addClassPrior); normalization cancels
                    # the duplication
                    class_counts[cls_index[cv]] += float(items[3])
                elif cv != "" and o != "":
                    ordn = int(o)
                    ki = cls_index[cv]
                    if b != "":  # binned posterior
                        fi = bin_index[ordn]
                        fld = model.binned_fields[fi]
                        code = (fld.cardinality_index()[b]
                                if fld.is_categorical else int(b))
                        model.post_counts[fi, ki, code] += float(items[3])
                    else:  # continuous posterior: classVal,ord,,mean,std
                        fi = cont_index[ordn]
                        model.cont_params[fi, ki] = [float(items[3]),
                                                     float(items[4])]
        model.class_counts = class_counts
        return model


def _count_batch(codes, labels, x_cont, k: int, bmax: int, weights,
                 device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(post [F, K, Bmax], moments [Fc, K, 3], class counts [K]) of one
    batch (numpy arrays or tensors) on `device`: int64 from one bincount
    when unweighted with no continuous field, else float32 (the JAX
    package's per-batch dtype)."""
    codes_t = torch.as_tensor(codes, device=device).long()
    y = torch.as_tensor(labels, device=device).long()
    n, f = codes_t.shape
    x = torch.as_tensor(x_cont, dtype=torch.float32, device=device)
    fc = x.shape[1]
    # flat (feature, class, bin) key of every (row, feature) pair
    key = ((torch.arange(f, device=device)[None, :] * k + y[:, None]) * bmax
           + codes_t).reshape(-1)
    if weights is None and fc == 0:
        post = torch.bincount(key, minlength=f * k * bmax)
        return (post.reshape(f, k, bmax),
                torch.zeros((0, k, 3), dtype=torch.int64, device=device),
                torch.bincount(y, minlength=k))
    w = (torch.ones(n, dtype=torch.float32, device=device) if weights is None
         else torch.as_tensor(weights, dtype=torch.float32, device=device))
    # index_add_ sums each cell's rows in row order on the CPU (as XLA's
    # einsum does there, bit for bit) and in atomics' order on the card;
    # unit weights count exactly either way below 2^24 rows per batch
    post = torch.zeros(f * k * bmax, dtype=torch.float32, device=device)
    post.index_add_(0, key, w[:, None].expand(n, f).reshape(-1))
    trip = torch.stack([torch.ones_like(x), x, x * x], dim=-1)   # [n, Fc, 3]
    if fc > 1:
        # [n, K, Fc, 3]: a row's terms in its class, zeros in the others,
        # as the JAX einsum's one-hot product has them
        terms = ((y[:, None] == torch.arange(k, device=device)[None, :])
                 .to(torch.float32) * w[:, None])[:, :, None, None] \
            * trip[:, None]
        mom = _xla_cpu_row_sum(terms).permute(1, 0, 2)
    else:
        # one continuous field: XLA's CPU dot sums the rows in order, as
        # index_add_ does on the CPU (on the card, in its atomics' order)
        ckey = (torch.arange(fc, device=device)[None, :] * k
                + y[:, None]).reshape(-1)
        mom = torch.zeros((fc * k, 3), dtype=torch.float32, device=device)
        mom.index_add_(0, ckey, (w[:, None, None] * trip).reshape(-1, 3))
        mom = mom.reshape(fc, k, 3)
    cls = torch.zeros(k, dtype=torch.float32, device=device).index_add_(0, y, w)
    return post.reshape(f, k, bmax), mom, cls


#: rows per block of XLA's CPU dot over a long contraction
_DOT_BLOCK = 8192


def _xla_cpu_row_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum over the rows of `terms` [n, ...] in float32, in the order
    XLA's CPU dot takes for the moments of two or more continuous fields
    (found by probing the JAX package's einsum on the CPU, with two and
    three classes): blocks of 8192 rows, added in order, each the sum of
    four running sums over its rows i % 4 = 0..3, combined as (s0 + s1)
    + (s2 + s3); then the last n % 4 rows, summed in order, added.
    Only elementwise adds, so the bits are the same on the CPU and the
    card, and no matrix product whose precision a setting could change.
    One add a step over n / 4 steps at most 2048 a block (all blocks
    at once)."""
    n = terms.shape[0]
    rest = terms.shape[1:]
    n_blocks = max(1, -(-n // _DOT_BLOCK))
    last = n - (n_blocks - 1) * _DOT_BLOCK
    main = (n_blocks - 1) * _DOT_BLOCK + last // 4 * 4
    # zero rows pad the lanes of the last block: x + 0 is x
    lanes = torch.zeros((n_blocks * _DOT_BLOCK,) + rest, dtype=terms.dtype,
                        device=terms.device)
    lanes[:main] = terms[:main]
    lanes = lanes.reshape((n_blocks, _DOT_BLOCK // 4, 4) + rest)
    steps = _DOT_BLOCK // 4 if n_blocks > 1 else main // 4
    acc = torch.zeros((n_blocks, 4) + rest, dtype=terms.dtype,
                      device=terms.device)
    for j in range(steps):
        acc = acc + lanes[:, j]
    block = (acc[:, 0] + acc[:, 1]) + (acc[:, 2] + acc[:, 3])
    tail = torch.zeros(rest, dtype=terms.dtype, device=terms.device)
    for i in range(main, n):
        tail = tail + terms[i]
    total = block[0]
    for b in range(1, n_blocks):
        total = total + block[b]
    return total + tail


def _log_gauss(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor
               ) -> torch.Tensor:
    """Elementwise log N(x; mean, std) in float32, in the JAX package's
    order: (-0.5 log(2 pi) - log(std)) - 0.5 ((x - mean) / std)^2."""
    c = -0.5 * torch.log(torch.tensor(2 * math.pi, dtype=torch.float32,
                                      device=x.device))
    return c - torch.log(std) - 0.5 * ((x - mean) / std) ** 2


def _saturating_int32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts: clamped to the int32 range, NaN
    to 0."""
    x = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    return torch.clamp(x, -2.0 ** 31, _INT32_MAX).to(torch.int32)


class NaiveBayesPredictor:
    """Posterior computation and arbitration over a finished model, on the
    model's device."""

    def __init__(self, model: NaiveBayesModel,
                 arbitrator: Optional[CostBasedArbitrator] = None):
        self.model = model
        self.device = model.device
        self.tables = model.finish()
        # [F, B, K]: one code's row of class log-probabilities is contiguous
        self._log_post_fbk = self.tables["log_post"].transpose(1, 2).contiguous()
        self.arbitrator = arbitrator

    def predict_tensors(self, codes: torch.Tensor, x_cont: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pred int64 [n], int-percent posteriors int32 [n, K]) of codes
        (integer [n, F]) and x_cont (float32 [n, Fc]) on the device."""
        tables = self.tables
        codes = codes.long()
        log_feat_c = log_feat = None
        if codes.shape[1] > 0:
            lp, lpr = self._log_post_fbk, tables["log_prior"]
            # sum_f log_post[f, :, code_f], f ascending, in float32
            log_feat_c = lp[0][codes[:, 0]]
            log_feat = lpr[0][codes[:, 0]]
            for f in range(1, codes.shape[1]):
                log_feat_c = log_feat_c + lp[f][codes[:, f]]
                log_feat = log_feat + lpr[f][codes[:, f]]
        if x_cont.shape[1] > 0:
            lpc = _log_gauss(x_cont[:, :, None], tables["cont_mean"][None],
                             tables["cont_std"][None]).sum(dim=1)
            lprc = _log_gauss(x_cont, tables["cont_prior_mean"][None],
                              tables["cont_prior_std"][None]).sum(dim=1)
            log_feat_c = lpc if log_feat_c is None else log_feat_c + lpc
            log_feat = lprc if log_feat is None else log_feat + lprc
        n = codes.shape[0]
        if log_feat_c is None:
            log_feat_c = torch.zeros((n, 1), dtype=torch.float32,
                                     device=self.device)
            log_feat = torch.zeros(n, dtype=torch.float32, device=self.device)
        log_post = log_feat_c + tables["log_class"][None, :] - log_feat[:, None]
        prob_pct = _saturating_int32(torch.floor(torch.exp(log_post) * 100.0))
        return torch.argmax(prob_pct, dim=1), prob_pct

    def predict(self, dataset: Dataset) -> Tuple[np.ndarray, np.ndarray]:
        """(pred int32 [n], int-percent posteriors int32 [n, K]) on the
        host, after cost-based arbitration when an arbitrator is set."""
        codes, _ = dataset.feature_codes(self.model.binned_fields)
        x_cont = dataset.feature_matrix(self.model.cont_fields)
        pred, prob = self.predict_tensors(
            torch.as_tensor(codes, device=self.device),
            torch.as_tensor(x_cont, device=self.device))
        pred = pred.cpu().numpy().astype(np.int32)
        prob = prob.cpu().numpy()
        if self.arbitrator is not None and len(self.model.class_values) == 2:
            neg = self.model.class_values.index(self.arbitrator.neg_class)
            pos = 1 - neg
            is_pos = self.arbitrator.arbitrate(prob[:, neg], prob[:, pos])
            pred = np.where(is_pos, pos, neg).astype(pred.dtype)
        return pred, prob

    def validate(self, dataset: Dataset, pos_class: int = 0) -> ConfusionMatrix:
        pred, _ = self.predict(dataset)
        cm = ConfusionMatrix(self.model.class_values, pos_class=pos_class)
        cm.add(dataset.labels(), pred)
        return cm

    def feature_prob(self, dataset: Dataset) -> np.ndarray:
        """Per-row P(features | actual class) in float64 on the host from
        the float32 tables: the bap.output.feature.prob.only mode
        (BayesianPredictor.java:262-286)."""
        codes, _ = dataset.feature_codes(self.model.binned_fields)
        y = dataset.labels()
        logp = np.zeros(len(dataset), np.float64)
        if codes.shape[1]:
            lp = self.tables["log_post"].cpu().numpy()          # [F, K, B]
            for f in range(codes.shape[1]):
                logp += lp[f, y, codes[:, f]]
        x_cont = dataset.feature_matrix(self.model.cont_fields)
        if x_cont.shape[1]:
            mean = self.tables["cont_mean"].cpu().numpy()       # [Fc, K]
            std = self.tables["cont_std"].cpu().numpy()
            for f in range(x_cont.shape[1]):
                m, s = mean[f, y], std[f, y]
                logp += (-0.5 * np.log(2 * np.pi) - np.log(s)
                         - 0.5 * ((x_cont[:, f] - m) / s) ** 2)
        return np.exp(logp)
