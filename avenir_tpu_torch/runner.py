"""Properties-driven job runner: the `hadoop jar` surface of the reference.

The port of the job registry of `avenir_tpu/runner.py`, with the jobs
ported so far: `nearestNeighbor` (org.avenir.knn.NearestNeighbor),
`bayesianDistr` (org.avenir.bayesian.BayesianDistribution),
`bayesianPredictor` (org.avenir.bayesian.BayesianPredictor),
`recordSimilarity` (sifarish SameTypeSimilarity), `groupedRecordSimilarity`
and `featureCondProbJoiner` (org.avenir.knn.FeatureCondProbJoiner), and
`Stage` / `Pipeline`, which chain them as the reference's shell drivers
did. A job reads the reference's namespaced keys (`nen.*`, `bad.*`,
`bap.*`, `sts.*`, `grs.*`, `fcb.*`) from one flat properties file and runs
in-process on the device the caller names — ``cuda`` unless
``device="cpu"`` is passed.

Each job records the reference's spans (`obs`): `job.run` around it,
`stream.read` and `stream.parse` for its input, `stream.fold` around the
work on each chunk (a fold's consume, a predict, a tile of distances,
a join) and `job.finish` around its output. None synchronizes the device.
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

from avenir_tpu_torch import obs
from avenir_tpu_torch.core.config import (JobConfig, MissingConfigError,
                                          load_properties)
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
    t0 = obs.now()
    res = fn(cfg, list(inputs), output, dev)
    obs.record("job.run", t0, job=canonical)
    return res


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


def _lines(data: bytes) -> List[str]:
    """The non-blank lines of a block of a job's output file."""
    return [ln for ln in data.decode().split("\n") if ln.strip()]


def _last_three(data: bytes, delim: str) -> Tuple[List[str], List[str],
                                                  List[str]]:
    """The last three stripped tokens of each non-blank line of a block,
    as three lists of strings: no list a line, so the millions of lines
    of a distance file leave nothing for the garbage collector to
    trace."""
    a: List[str] = []
    b: List[str] = []
    c: List[str] = []
    for ln in _lines(data):
        toks = ln.split(delim)
        a.append(toks[-3].strip())
        b.append(toks[-2].strip())
        c.append(toks[-1].strip())
    return a, b, c


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
    for n, ds in enumerate(stream_job_inputs(cfg, inputs, schema)):
        with obs.span("stream.fold", sink="bayesianDistr", chunk=n):
            fold.consume(ds)
    with obs.span("job.finish", job="bayesianDistr"):
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
        for n, ds in enumerate(stream_job_inputs(cfg, inputs, schema,
                                                 keep_raw=True)):
            if prob_only:
                with obs.span("stream.fold", sink="bayesianPredictor",
                              chunk=n):
                    probs = pred.feature_prob(ds)
                with obs.span("job.finish", job="bayesianPredictor"):
                    for rid, p in zip(ds.ids(), probs):
                        fh.write(f"{rid}{delim}{p:.6g}\n")
                continue
            with obs.span("stream.fold", sink="bayesianPredictor", chunk=n):
                codes, post = pred.predict(ds)
            with obs.span("job.finish", job="bayesianPredictor"):
                for raw, c, row_post in zip(ds.raw_rows, codes, post):
                    # row_post is the reference's int-percent unnormalized
                    # posterior; normalized across classes for the
                    # appended confidence field
                    tot = float(np.sum(row_post)) or 1.0
                    prob = int(np.rint(100.0 * row_post[int(c)] / tot))
                    fh.write(delim.join(raw + [cls_vals[int(c)], str(prob)])
                             + "\n")
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
    from avenir_tpu_torch.core.stream import read_dataset, stream_job_inputs
    from avenir_tpu_torch.models.knn import NearestNeighborClassifier

    train_path, test_path = inputs[0], inputs[-1]
    schema = _schema(cfg)
    train = read_dataset(cfg, train_path, schema)
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
        for n, test in enumerate(stream_job_inputs(cfg, [test_path], schema)):
            with obs.span("stream.fold", sink="nearestNeighbor", chunk=n):
                codes, scores = clf.predict(test)
            if arbitrator is not None:
                # getClassProb int-percent scale (Neighborhood.java:319-334)
                tot = np.maximum(scores.sum(axis=1), 1e-9)
                pos_prob = np.floor(100.0 * scores[:, pos_i] / tot)
                codes = np.where(arbitrator.classify(pos_prob),
                                 pos_i, neg_i).astype(np.int32)
            with obs.span("job.finish", job="nearestNeighbor"):
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


# ================================================================= similarity
def _similarity_schema(cfg: JobConfig) -> FeatureSchema:
    """The schema under any of the reference's three key spellings:
    `feature.schema.file.path`, sifarish `same.schema.file.path` or spark
    `rich.attr.schema.path`."""
    for key in ("feature.schema.file.path", "same.schema.file.path",
                "rich.attr.schema.path"):
        path = cfg.get(key)
        if path:
            return FeatureSchema.from_file(path)
    raise MissingConfigError(
        f"missing schema config param: {cfg.prefix}.feature.schema.file.path")


@job("recordSimilarity", "sts", "sameTypeSimilarity",
     "org.avenir.spark.similarity.RecordSimilarity")
def record_similarity(cfg: JobConfig, inputs: List[str], output: str,
                      device: torch.device) -> JobResult:
    """All-pairs record distance file (the sifarish stage of
    resource/knn.sh:44-57, RecordSimilarity.scala:34). One input: the
    i < j pairs of it; two inputs (or sts.inter.set.matching=true): the
    cross pairs. Rows: id1,id2,scaled-int-distance."""
    from avenir_tpu_torch.core.stream import read_dataset
    from avenir_tpu_torch.models.similarity import RecordSimilarity

    schema = _similarity_schema(cfg)
    sim = RecordSimilarity(
        metric=cfg.get("distance.metric", "manhattan"),
        scale=cfg.get_int("distance.scale", 1000),
        num_weights=cfg.get_float_list("num.attribute.weights"),
        cat_weights=cfg.get_float_list("cat.attribute.weights"),
        device=device)
    out = _out_file(output)
    id_first = cfg.get_bool("output.id.first", True)
    if cfg.get_bool("inter.set.matching", len(inputs) > 1):
        pairs = sim.inter(read_dataset(cfg, inputs[0], schema),
                          read_dataset(cfg, inputs[-1], schema))
    else:
        pairs = sim.intra(read_dataset(cfg, inputs[0], schema))
    n = sim.save(pairs, out, delim=cfg.field_delim, id_first=id_first)
    return JobResult("recordSimilarity", {"Similarity:Pairs": n}, [out])


@job("groupedRecordSimilarity", "grs",
     "org.avenir.spark.similarity.GroupedRecordSimilarity")
def grouped_record_similarity(cfg: JobConfig, inputs: List[str], output: str,
                              device: torch.device) -> JobResult:
    """Within-group pair distances (GroupedRecordSimilarity.scala:29),
    groups by `grs.group.field.ordinals`. Rows: group key fields, id1,
    id2, scaled-int-distance."""
    from avenir_tpu_torch.core.stream import read_dataset
    from avenir_tpu_torch.models.similarity import GroupedRecordSimilarity

    schema = _similarity_schema(cfg)
    ds = read_dataset(cfg, inputs[0], schema)
    sim = GroupedRecordSimilarity(
        [int(o) for o in cfg.assert_list("group.field.ordinals")],
        metric=cfg.get("distance.metric", "manhattan"),
        scale=cfg.get_int("distance.scale", 1000), device=device)
    out = _out_file(output)
    delim = cfg.field_delim
    n = 0
    with open(out, "w") as fh:
        for key, pairs in sim.grouped_pairs(ds):
            n += sim.write(pairs, fh, delim,
                           prefix="".join(k + delim for k in key))
    return JobResult("groupedRecordSimilarity", {"Similarity:Pairs": n},
                     [out])


@job("featureCondProbJoiner", "fcb", "org.avenir.knn.FeatureCondProbJoiner")
def feature_cond_prob_joiner(cfg: JobConfig, inputs: List[str], output: str,
                             device: torch.device) -> JobResult:
    """Stage (4) of resource/knn.sh (FeatureCondProbJoiner.java:46): the
    distance file (`id1,id2,dist` as its last fields) joined on the train
    entity with the feature posterior file (`id,prob` rows, the
    bap.output.feature.prob.only output). The posterior files are the
    inputs whose name starts with fcb.feature.cond.prob.split.prefix
    (default condProb), else the last input. Rows:
    testId,trainId,distance,trainFeaturePostProb. Host work only."""
    from avenir_tpu_torch.core.stream import iter_byte_blocks, read_file

    # both inputs are outputs of other jobs: split on the output delimiter
    delim = cfg.field_delim
    prefix = cfg.get("feature.cond.prob.split.prefix", "condProb")
    prob_files = [p for p in inputs if os.path.basename(p).startswith(prefix)]
    dist_files = [p for p in inputs if p not in prob_files]
    if not prob_files:
        prob_files, dist_files = [inputs[-1]], inputs[:-1]
    probs: Dict[str, str] = {}
    for p in prob_files:
        data = read_file(p)
        with obs.span("stream.parse", nbytes=len(data), engine="python"):
            for ln in _lines(data):
                toks = ln.split(delim)
                probs[toks[0].strip()] = toks[-1].strip()
    # the distance file's column order is the similarity job's key
    id_first = cfg.scoped("sts").get_bool("output.id.first", True)
    block = int(cfg.get_float("stream.block.size.mb", 64.0) * (1 << 20))
    out = _out_file(output)
    n = 0
    with open(out, "w") as fh:
        for p in dist_files:
            for chunk, blk in enumerate(iter_byte_blocks(p, block)):
                with obs.span("stream.parse", nbytes=len(blk), engine="python"):
                    cols = _last_three(blk, delim)
                with obs.span("stream.fold", sink="featureCondProbJoiner",
                              chunk=chunk):
                    if not id_first:     # dist, id1, id2
                        cols = (cols[1], cols[2], cols[0])
                    lines = []
                    for id1, id2, dist in zip(*cols):
                        pr = probs.get(id2)
                        if pr is None and id1 in probs:
                            # a row may carry (test, train) in either order
                            id1, id2 = id2, id1
                            pr = probs[id2]
                        if pr is not None:
                            lines.append(f"{id1}{delim}{id2}{delim}{dist}"
                                         f"{delim}{pr}\n")
                with obs.span("job.finish", job="featureCondProbJoiner"):
                    fh.write("".join(lines))
                n += len(lines)
    return JobResult("featureCondProbJoiner", {"Join:Pairs": n}, [out])


# =================================================================== pipeline
#: the jobs the reference's Pipeline(fuse=True) runs as one shared scan
#: (run_shared; JAX runner.py:1069-1077); of them the port has
#: bayesianDistr, and not run_shared
_SHARED_SCAN_JOBS = frozenset((
    "bayesianDistr", "mutualInformation", "fisherDiscriminant",
    "markovStateTransitionModel", "frequentItemsApriori",
    "candidateGenerationWithSelfJoin"))


@dataclass
class Stage:
    name: str
    job: str
    inputs: List[str]
    output: str
    conf_overrides: Dict[str, str] = field(default_factory=dict)


class Pipeline:
    """The resource/*.sh drivers: named stages over one shared properties
    file, each stage's `conf_overrides` over it; a stage's output feeds
    later stages by path (knn.sh's five stages, SURVEY §3.3). Runs every
    stage, or the one named by `run(only=)`, on `device` (default cuda).

    A failed stage re-runs up to `mapreduce.map.maxattempts` times
    (default 2; every job rewrites its outputs from its inputs, so a
    retry is a Hadoop task re-attempt); `on_retry(stage, attempt, exc)`
    is called before each retry."""

    def __init__(self, conf, stages: Sequence[Stage], on_retry=None,
                 device: DeviceLike = None):
        self.props = (load_properties(conf) if isinstance(conf, str)
                      else dict(conf))
        self.stages = list(stages)
        self.results: Dict[str, JobResult] = {}
        self.max_attempts = max(
            int(self.props.get("mapreduce.map.maxattempts", "2")), 1)
        self.on_retry = on_retry
        self.attempts: Dict[str, int] = {}
        self.device = resolve_device(device)

    def _stage_props(self, st: Stage) -> Dict[str, str]:
        props = dict(self.props)
        props.update(st.conf_overrides)
        return props

    def _run_stage(self, st: Stage) -> None:
        for attempt in range(1, self.max_attempts + 1):
            self.attempts[st.name] = attempt
            try:
                self.results[st.name] = run_job(
                    st.job, self._stage_props(st), st.inputs, st.output,
                    device=self.device)
                break
            except Exception as exc:
                if attempt >= self.max_attempts:
                    raise
                if self.on_retry is not None:
                    self.on_retry(st.name, attempt, exc)

    @staticmethod
    def _shared_scan_job(st: Stage) -> Optional[str]:
        name = _REGISTRY[st.job][0] if st.job in _REGISTRY else st.job
        return name if name in _SHARED_SCAN_JOBS else None

    def _check_no_shared_scan(self, stages: Sequence[Stage]) -> None:
        """Raise where the reference's fuse=True would run consecutive
        stages on the same inputs as one shared scan (run_shared)."""
        for i, st in enumerate(stages):
            group = [st]
            seen = {self._shared_scan_job(st)}
            for nxt in stages[i + 1:]:
                name = self._shared_scan_job(nxt)
                if (None in seen or name is None or name in seen
                        or nxt.inputs != st.inputs):
                    break
                group.append(nxt)
                seen.add(name)
            if len(group) >= 2:
                raise NotImplementedError(
                    "fuse=True would run stages "
                    + "+".join(g.name for g in group) + " as one shared "
                    "scan (run_shared), which is not ported yet")

    def run(self, only: Optional[str] = None,
            fuse: bool = False) -> Dict[str, JobResult]:
        """Run the stages in order (only the one named `only`, if given).
        fuse=True runs them as the reference does where no two
        consecutive stages would share a scan, and raises where they
        would."""
        stages = [st for st in self.stages if only is None or st.name == only]
        if fuse:
            self._check_no_shared_scan(stages)
        for st in stages:
            self._run_stage(st)
        return self.results


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
