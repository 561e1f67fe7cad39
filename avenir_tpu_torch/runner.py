"""Properties-driven job runner: the `hadoop jar` surface of the reference.

The port of the job registry of `avenir_tpu/runner.py`, with the jobs
ported so far: `nearestNeighbor` (org.avenir.knn.NearestNeighbor),
`bayesianDistr` (org.avenir.bayesian.BayesianDistribution) and
`bayesianPredictor` (org.avenir.bayesian.BayesianPredictor). A job reads
the reference's namespaced keys (`nen.*`, `bad.*`, `bap.*`) from one flat
properties file and runs in-process on the device the caller names —
``cuda`` unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.core.config import JobConfig, load_properties
from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device
from avenir_tpu_torch.utils.metrics import ConfusionMatrix, CostBasedArbitrator


@dataclass
class JobResult:
    """What a job hands back: Hadoop-counter-style counters (the
    reference's "Validation:*" group) plus the files it wrote."""

    name: str
    counters: Dict[str, float] = field(default_factory=dict)
    outputs: List[str] = field(default_factory=list)

    def __repr__(self) -> str:
        return f"JobResult({self.name}, counters={self.counters}, outputs={self.outputs})"


JobFn = Callable[[JobConfig, List[str], str, torch.device], JobResult]

# registry key (job name or Tool class alias) -> (canonical name, prefix, fn)
_REGISTRY: Dict[str, Tuple[str, str, JobFn]] = {}


def job(name: str, prefix: str, *aliases: str):
    """Register a job under its pipeline name + reference Tool class name."""

    def deco(fn: JobFn) -> JobFn:
        for key in (name, *aliases):
            _REGISTRY[key] = (name, prefix, fn)
        return fn

    return deco


def job_names() -> List[str]:
    return sorted(_REGISTRY)


def run_job(name: str, conf, inputs: Sequence[str], output: str = "",
            device: DeviceLike = None) -> JobResult:
    """Run a registered job on `device` (default cuda). `conf` is a
    properties file path, a dict, or a JobConfig; the job sees it scoped
    under its reference prefix."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown job {name!r}; known: {', '.join(job_names())}")
    canonical, prefix, fn = _REGISTRY[name]
    if isinstance(conf, str):
        cfg = JobConfig(load_properties(conf), prefix)
    elif isinstance(conf, dict):
        cfg = JobConfig(conf, prefix)
    else:
        cfg = conf.scoped(prefix)
    dev = resolve_device(device)
    return fn(cfg, list(inputs), output, dev)


def _out_file(output: str, part: str = "part-r-00000") -> str:
    """A directory (Hadoop-style `part-r-00000` inside) when the path ends
    with '/' or already is a directory, else a plain file."""
    if output.endswith(os.sep) or os.path.isdir(output):
        os.makedirs(output, exist_ok=True)
        return os.path.join(output, part)
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    return output


def _schema(cfg: JobConfig) -> FeatureSchema:
    return FeatureSchema.from_file(cfg.assert_get("feature.schema.file.path"))


# =================================================================== bayesian
class _NBDistrFold:
    """bayesianDistr (tabular) as a stream fold: each Dataset chunk's
    counts are summed on the device (NaiveBayesModel.accumulate with
    defer=True) and drained to the host once, at finish. The port of
    `avenir_tpu/runner.py::_NBDistrFold`."""

    def __init__(self, cfg: JobConfig, schema: FeatureSchema,
                 device: torch.device):
        self.cfg = cfg
        self.schema = schema
        self.device = device
        self.model = None
        self.rows = 0

    def consume(self, ds: Dataset) -> None:
        from avenir_tpu_torch.models.naive_bayes import NaiveBayesModel

        if self.model is None:
            # after the first parse, so data-discovered categorical
            # vocabularies are sized into the count tensors
            self.model = NaiveBayesModel.empty(self.schema, self.device)
        codes, bins = ds.feature_codes(self.model.binned_fields)
        if bins != self.model.bins:
            raise ValueError(
                "categorical vocabulary grew mid-stream (a chunk saw a "
                "value absent from the first chunk / declared "
                "cardinality); declare full cardinalities in the schema "
                "to stream")
        x_cont = ds.feature_matrix(self.model.cont_fields)
        self.model.accumulate(codes, ds.labels(), x_cont, defer=True)
        self.rows += len(ds)

    def finish(self, output: str) -> JobResult:
        from avenir_tpu_torch.models.naive_bayes import NaiveBayesModel

        out = _out_file(output)
        model = self.model
        if model is None:
            model = NaiveBayesModel.empty(self.schema, self.device)
        model.save(out, delim=self.cfg.field_delim)
        return JobResult("bayesianDistr",
                         {"Distribution Data:Records": self.rows}, [out])

    def merge(self, other: "_NBDistrFold") -> "_NBDistrFold":
        """NB sufficient statistics are additive (NaiveBayesModel.merge),
        so merging two folds equals folding both inputs."""
        if other.model is not None:
            if self.model is None:
                self.model = other.model
            else:
                self.model.merge(other.model)
        self.rows += other.rows
        return self


@job("bayesianDistr", "bad", "org.avenir.bayesian.BayesianDistribution")
def bayesian_distribution(cfg: JobConfig, inputs: List[str], output: str,
                          device: torch.device) -> JobResult:
    """Naive Bayes sufficient statistics -> CSV model file and its stamp.
    Input blocks stream through `stream_job_inputs` (host memory O(block),
    `bad.stream.block.size.mb`); counts are additive, so the chunking
    cannot change the model."""
    from avenir_tpu_torch.core.stream import stream_job_inputs

    if not cfg.get_bool("tabular.input", True):
        raise NotImplementedError(
            "bad.tabular.input=false (the free-text Naive Bayes of "
            "models/text.py) is not ported yet")
    schema = _schema(cfg)
    fold = _NBDistrFold(cfg, schema, device)
    for ds in stream_job_inputs(cfg, inputs, schema):
        fold.consume(ds)
    return fold.finish(output)


@job("bayesianPredictor", "bap", "org.avenir.bayesian.BayesianPredictor")
def bayesian_predictor(cfg: JobConfig, inputs: List[str], output: str,
                       device: torch.device) -> JobResult:
    """Map-only Naive Bayes prediction: each input row echoed with the
    predicted class and its rounded percent. With
    `bap.output.feature.prob.only=true` each row's id and P(features |
    actual class) instead (BayesianPredictor.java:262-286); with
    `bap.validation.mode=true` the confusion counters."""
    from avenir_tpu_torch.core.stream import stream_job_inputs
    from avenir_tpu_torch.models.naive_bayes import (NaiveBayesModel,
                                                     NaiveBayesPredictor)

    schema = _schema(cfg)
    model = NaiveBayesModel.load(cfg.assert_get("bayesian.model.file.path"),
                                 schema, delim=cfg.field_delim, device=device)
    # cost-based arbitration (BayesianPredictor.java:140-144):
    # bap.predict.class.cost = falseNegCost,falsePosCost with
    # bap.predict.class = negClass,posClass (cardinality order fallback)
    arbitrator = None
    costs = cfg.get_list("predict.class.cost", delim=cfg.field_delim)
    if costs:
        classes = cfg.get_list("predict.class",
                               delim=cfg.field_delim) or schema.class_values()
        arbitrator = CostBasedArbitrator(classes[0], classes[1],
                                         int(costs[0]), int(costs[1]))
    pred = NaiveBayesPredictor(model, arbitrator=arbitrator)
    prob_only = cfg.get_bool("output.feature.prob.only", False)
    validate = cfg.get_bool("validation.mode", False)
    delim = cfg.field_delim
    out = _out_file(output)
    cls_vals = schema.class_values()
    # the confusion matrix is additive: it folds per chunk
    cm: Optional[ConfusionMatrix] = None
    with open(out, "w") as fh:
        for ds in stream_job_inputs(cfg, inputs, schema, keep_raw=True):
            if prob_only:
                probs = pred.feature_prob(ds)
                for rid, p in zip(ds.ids(), probs):
                    fh.write(f"{rid}{delim}{p:.6g}\n")
                continue
            codes, post = pred.predict(ds)
            for raw, c, row_post in zip(ds.raw_rows, codes, post):
                # row_post is the reference's int-percent unnormalized
                # posterior; normalized across classes for the appended
                # confidence field
                tot = float(np.sum(row_post)) or 1.0
                prob = int(np.rint(100.0 * row_post[int(c)] / tot))
                fh.write(delim.join(raw + [cls_vals[int(c)], str(prob)]) + "\n")
            if validate:
                if cm is None:
                    pos = cfg.get("positive.class.value")
                    cm = ConfusionMatrix(
                        cls_vals, pos_class=cls_vals.index(pos) if pos else 1)
                cm.add(ds.labels(), codes)
    counters: Dict[str, float] = cm.counters() if cm is not None else {}
    return JobResult("bayesianPredictor", counters, [out])


# ======================================================================== knn
@job("nearestNeighbor", "nen", "org.avenir.knn.NearestNeighbor")
def nearest_neighbor(cfg: JobConfig, inputs: List[str], output: str,
                     device: torch.device) -> JobResult:
    """Fused KNN: inputs = [train CSV, test CSV]. Replaces stages (1)-(5)
    of resource/knn.sh. Key names follow knn.properties, including the
    reference's `class.condtion.weighted` spelling."""
    from avenir_tpu_torch.core.stream import stream_job_inputs
    from avenir_tpu_torch.models.knn import NearestNeighborClassifier

    train_path, test_path = inputs[0], inputs[-1]
    schema = _schema(cfg)
    train = Dataset.from_csv(train_path, schema, delim=cfg.field_delim_regex)
    clf = NearestNeighborClassifier(
        train,
        top_match_count=cfg.get_int("top.match.count", 5),
        kernel_function=cfg.get("kernel.function", "none"),
        kernel_param=cfg.get_float("kernel.param", 1.0),
        class_cond_weighted=cfg.get_bool("class.condtion.weighted", False)
        or cfg.get_bool("class.condition.weighted", False),
        inverse_distance_weighted=cfg.get_bool("inverse.distance.weighted", False),
        decision_threshold=cfg.get_float("decision.threshold", -1.0),
        positive_class=cfg.get("positive.class.value"),
        # fast-path toggles with no reference analog: the lane-packed
        # top-k kernel and the in-kernel fused vote
        packed=cfg.get_bool("device.packed.kernel", False),
        fused=cfg.get_bool("device.fused.vote", False),
        device=device,
    )
    out = _out_file(output)
    out_delim = cfg.field_delim
    cls_vals = schema.class_values()
    with_distr = cfg.get_bool("output.class.distr", False)
    validate = cfg.get_bool("validation.mode", False)
    # cost-based arbitration (NearestNeighbor.java:264-277, :383-387):
    # nen.misclassification.cost = falsePosCost,falseNegCost with
    # nen.class.attribute.values = posClass,negClass
    arbitrator = pos_i = neg_i = None
    if cfg.get_bool("use.cost.based.classifier", False):
        cav = cfg.get_list("class.attribute.values") or [cls_vals[1], cls_vals[0]]
        pos_v, neg_v = cav[0], cav[1]
        costs = cfg.assert_list("misclassification.cost")
        fp_cost, fn_cost = int(costs[0]), int(costs[1])
        arbitrator = CostBasedArbitrator(neg_v, pos_v, fn_cost, fp_cost)
        pos_i, neg_i = cls_vals.index(pos_v), cls_vals.index(neg_v)
        clf.positive_class = pos_i
    # queries stream in blocks against the resident train index; the
    # confusion matrix is additive, so it folds per chunk
    cm: Optional[ConfusionMatrix] = None
    with open(out, "w") as fh:
        for test in stream_job_inputs(cfg, [test_path], schema):
            codes, scores = clf.predict(test)
            if arbitrator is not None:
                # getClassProb int-percent scale (Neighborhood.java:319-334)
                tot = np.maximum(scores.sum(axis=1), 1e-9)
                pos_prob = np.floor(100.0 * scores[:, pos_i] / tot)
                codes = np.where(arbitrator.classify(pos_prob),
                                 pos_i, neg_i).astype(np.int32)
            for i, (rid, c) in enumerate(zip(test.ids(), codes)):
                fields = [str(rid), cls_vals[int(c)]]
                if with_distr:
                    tot = float(np.sum(scores[i])) or 1.0
                    fields += [f"{cls_vals[j]}:{scores[i][j] / tot:.3f}"
                               for j in range(len(cls_vals))]
                fh.write(out_delim.join(fields) + "\n")
            if validate:
                if cm is None:
                    cm = ConfusionMatrix(cls_vals, pos_class=clf.positive_class)
                cm.add(test.labels(), codes)
    counters: Dict[str, float] = cm.counters() if cm is not None else {}
    return JobResult("nearestNeighbor", counters, [out])


def run_from_cli(argv: Sequence[str]) -> JobResult:
    """`python -m avenir_tpu_torch <jobName> --conf <props> IN... OUT
    [--device cpu]`; prints the result as one JSON line."""
    ap = argparse.ArgumentParser(prog="avenir_tpu_torch")
    ap.add_argument("jobname", help="job name or reference Tool class")
    ap.add_argument("--conf", default=None,
                    help="properties file (the -Dconf.path analog)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    ap.add_argument("paths", nargs="*", help="input paths... output path")
    args = ap.parse_intermixed_args(argv)
    if not args.paths:
        ap.error("expected IN... OUT paths (at least an output path)")
    short = args.jobname.rsplit(".", 1)[-1]
    name = (args.jobname if args.jobname in _REGISTRY
            else short[0].lower() + short[1:])
    res = run_job(name, args.conf or {}, args.paths[:-1], args.paths[-1],
                  device=args.device)
    print(json.dumps({"job": res.name, "counters": res.counters,
                      "outputs": res.outputs}))
    return res


if __name__ == "__main__":
    run_from_cli(sys.argv[1:])
