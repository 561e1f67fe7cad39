"""Properties-driven job runner: the `hadoop jar` surface of the reference.

The port of the job registry of `avenir_tpu/runner.py`, with the jobs
ported so far: `nearestNeighbor` (org.avenir.knn.NearestNeighbor),
`bayesianDistr` (org.avenir.bayesian.BayesianDistribution),
`bayesianPredictor` (org.avenir.bayesian.BayesianPredictor),
`recordSimilarity` (sifarish SameTypeSimilarity), `groupedRecordSimilarity`,
`featureCondProbJoiner` (org.avenir.knn.FeatureCondProbJoiner),
`mutualInformation` (org.avenir.explore.MutualInformation),
`fisherDiscriminant` (org.avenir.discriminant.FisherDiscriminant),
`cramerCorrelation`, `categoricalCorrelation`, `heterogeneityReduction`,
`numericalCorrelation` and `classPartitionGenerator` (org.avenir.explore),
`decTree`, `randomForest` and `dataPartitioner` (org.avenir.tree),
`wordCounter` (org.avenir.text.WordCounter), `frequentItemsApriori`,
`associationRuleMiner` and `infrequentItemMarker` (org.avenir.association),
`candidateGenerationWithSelfJoin` and `sequencePositionalCluster`
(org.avenir.sequence), `sequenceGenerator`
(org.avenir.spark.sequence), the four batch bandits `greedyRandomBandit`,
`auerDeterministic`, `randomFirstGreedyBandit` and `softMaxBandit`
(org.avenir.reinforce), the Markov family `markovStateTransitionModel`,
`markovModelClassifier`, `hiddenMarkovModelBuilder`,
`viterbiStatePredictor` and `probabilisticSuffixTree` (org.avenir.markov),
`stateTransitionRate` and `contTimeStateTransitionStats`
(org.avenir.spark.markov) and `eventTimeDistribution`
(org.avenir.spark.sequence), the rest of org.avenir.explore
(`ruleEvaluator`, `reliefFeatureRelevance`, `categoricalClassAffinity`,
`categoricalContinuousEncoding`, `topMatchesByClass`,
`underSamplingBalancer`, `baggingSampler`), `agglomerativeGraphical` and
`clusterTrain` (alias `kmeansCluster`; org.avenir.cluster and the python
layer's cluster.py), `logisticRegression` (org.avenir.regress): all 45
jobs of the reference; and `Stage` / `Pipeline`, which chain them
as the reference's shell scripts did. A job reads the reference's
namespaced keys (`nen.*`, `bad.*`, `bap.*`, `sts.*`, `grs.*`, `fcb.*`,
`mut.*`, `fid.*`, `crc.*`, `cac.*`, `hrc.*`, `nuc.*`, `cpg.*`, `dtb.*`,
`dap.*`, `wco.*`, `fia.*`, `arm.*`, `iim.*`, `cgs.*`, `spc.*`, `seg.*`,
`grb.*`, `aue.*`, `rfg.*`, `smb.*`, `mst.*`, `mmc.*`, `hmmb.*`, `vsp.*`,
`pstg.*`, `str.*`, `cts.*`, `etd.*`, `rue.*`, `ffr.*`, `cca.*`, `coe.*`,
`tmc.*`, `usb.*`, `bas.*`, `agg.*`, `train.*`, `lrj.*`) from one flat
properties file and
runs in-process on the device the caller names — ``cuda`` unless
``device="cpu"`` is passed.

The streamed jobs `bayesianDistr`, `mutualInformation` and
`fisherDiscriminant` (of Dataset chunks) and `markovStateTransitionModel`
per class, `frequentItemsApriori` and `candidateGenerationWithSelfJoin`
(of raw byte blocks; the miners' pass 1) are fold sinks with the reference's
`StreamFoldOps` contract (merge, `state_dict`, `load_state`); `run_shared`
drives several of one kind over one scan of their common input, and
`Pipeline.run(fuse=True)` groups consecutive such stages into one.
`run_incremental` (`--incremental`) refreshes one of them after an append
by restoring its checkpointed carry and folding only the new blocks, and
`run_incremental_shared` refreshes several over one delta scan. Their
feeds go through the columnar sidecar (`native/sidecar.py`, on unless
`stream.sidecar=false`), so a repeat scan of unchanged bytes parses
nothing.

Each job records the reference's spans (`obs`): `job.run` around it,
`stream.read` and `stream.parse` for its input, `stream.fold` around the
work on each chunk (a fold's consume, a predict, a tile of distances,
a join, a tree level) and `job.finish` around its output; a shared scan
records `job.dispatch` (mode "shared") around its scan; an incremental
run records `job.restore` and `job.checkpoint`. None synchronizes the
device.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch import obs
from avenir_tpu_torch.core.config import (JobConfig, MissingConfigError,
                                          load_properties)
from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.native import sidecar
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device
from avenir_tpu_torch.utils.metrics import (ConfusionMatrix,
                                            CostBasedArbitrator,
                                            throughput_counters)


@dataclass
class JobResult:
    """What a job hands back: Hadoop-counter-style counters (the
    reference's "Validation:*" group) plus the files it wrote, and for the
    tree and split jobs the fitted object as `payload` (the decision paths,
    the forest, the split generator), as the reference hands them back."""

    name: str
    counters: Dict[str, float] = field(default_factory=dict)
    outputs: List[str] = field(default_factory=list)
    payload: object = None

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


def job_prefix(name: str) -> str:
    """The reference config prefix a registered job (or an alias of it)
    reads, e.g. greedyRandomBandit -> 'grb'."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown job {name!r}")
    return _REGISTRY[name][1]


def _job_cfg(name: str, conf) -> Tuple[str, JobConfig]:
    """(canonical name, JobConfig scoped under the job's prefix) of a
    registered job. `conf` is a properties file path, a HOCON `.conf` path
    (the block named after the job), a dict, or a JobConfig."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown job {name!r}; known: {', '.join(job_names())}")
    canonical, prefix, _fn = _REGISTRY[name]
    if isinstance(conf, str):
        if conf.endswith(".conf"):
            # Spark-surface HOCON config: one block per job name
            cfg = JobConfig.from_hocon(conf, canonical, prefix)
        else:
            cfg = JobConfig(load_properties(conf), prefix)
    elif isinstance(conf, dict):
        cfg = JobConfig(conf, prefix)
    else:
        cfg = conf.scoped(prefix)
    return canonical, cfg


def run_job(name: str, conf, inputs: Sequence[str], output: str = "",
            device: DeviceLike = None) -> JobResult:
    """Run a registered job on `device` (default cuda). `conf` is a
    properties file path, a dict, or a JobConfig; the job sees it scoped
    under its reference prefix.

    A streamed job's result also carries the memory counters
    (`_add_mem_counters`): `Mem:PredictedPeakBytes`, the footprint model
    of `analysis/mem.py` at the job's block size and corpus, beside the
    measured `Mem:PeakRSS`. With the `stream.autotune` key (the CLI's
    `--autotune`) the run applies the profile store's knobs and records
    its signals for the next run (`tune.begin_run`)."""
    canonical, cfg = _job_cfg(name, conf)
    dev = resolve_device(device)
    session = _autotune_begin([canonical], [cfg], inputs)
    rss0 = _rss_now()
    sc0 = sidecar.counters_snapshot()
    t0 = obs.now()
    try:
        res = _REGISTRY[canonical][2](cfg, list(inputs), output, dev)
    except BaseException:
        if session is not None:
            session.close()   # a leaked session would contaminate
        raise                 # every later one in this process
    obs.record("job.run", t0, job=canonical)
    _note_sidecar_counters(canonical, res, sc0)
    _add_mem_counters(canonical, cfg, inputs, res, rss0=rss0)
    if session is not None:
        session.finish({canonical: res})
    return res


#: the highest process-lifetime peak RSS (bytes) already attributed to a
#: streamed result. ru_maxrss is a lifetime peak: in a resident process
#: every later job re-reads the largest job's number, so a residual
#: recorded from it would inflate the learned admission factor of every
#: small job after it. Only a run that raises the peak records one.
#: Unlocked: a racing double or missed record costs one advisory sample.
_residual_peak_seen = 0


def _rss_now() -> int:
    """Current (not peak) resident bytes; 0 where they cannot be read.
    Taken at a job's start, so that the residual record prices the job's
    incremental footprint (the peak less what the process already held:
    the interpreter, torch, a CUDA context, earlier jobs' arenas), which
    is what the footprint model predicts."""
    from avenir_tpu_torch.analysis.mem import MemAuditError, _read_rss_bytes

    try:
        return _read_rss_bytes()
    except MemAuditError:
        return 0


def _add_mem_counters(canonical: str, cfg: JobConfig,
                      inputs: Sequence[str], res: "JobResult",
                      rss0: Optional[int] = None) -> None:
    """The memory counters of a streamed job's result:
    `Mem:PredictedPeakBytes` (the footprint model of `analysis/mem.py` at
    the job's block size, prefetch depth and corpus; the incremental
    driver sets it first) and `Mem:PeakRSS` (the process peak, an upper
    bound in a long-lived process). When the run raised the process peak
    and the caller gave its starting RSS `rss0`, the pair (predicted,
    peak - rss0) goes into the job's profile store
    (`tune.record_residual`), autotune on or off. Advisory: a failure to
    predict never fails a job that ran, so any error drops the
    counters."""
    if canonical not in _STREAM_FOLDS:
        return
    try:
        import resource

        from avenir_tpu_torch.analysis.mem import (corpus_stats,
                                                   footprint_model)

        paths = [p for p in inputs if os.path.exists(p)]
        if not paths:
            return
        # linux ru_maxrss is in KB
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        if "Mem:PredictedPeakBytes" not in res.counters:
            from avenir_tpu_torch.core.stream import prefetch_depth

            block = int(cfg.get_float("stream.block.size.mb", 64.0)
                        * (1 << 20))
            stats = corpus_stats(paths, delim=cfg.field_delim_regex)
            schema = None
            schema_path = cfg.get("feature.schema.file.path")
            if schema_path:
                schema = FeatureSchema.from_file(schema_path)
            est = footprint_model(canonical, block, schema, stats,
                                  prefetch_depth=prefetch_depth(cfg))
            res.counters["Mem:PredictedPeakBytes"] = float(est.total_bytes)
        res.counters["Mem:PeakRSS"] = float(rss)
        global _residual_peak_seen
        if rss > _residual_peak_seen:
            _residual_peak_seen = rss
            if rss0 is not None and rss - rss0 > 0:
                from avenir_tpu_torch import tune

                tune.record_residual(
                    canonical, cfg, paths,
                    res.counters["Mem:PredictedPeakBytes"], rss - rss0)
    except Exception:
        pass


def _autotune_begin(canonicals: Sequence[str], cfgs: Sequence[JobConfig],
                    inputs: Sequence[str]):
    """The autotune session of a run whose (first) config sets
    `stream.autotune` and whose jobs are all streamed: the profile store's
    knobs are overlaid onto the configs, and the session's
    ``finish(results)`` records the run and chooses the next knobs
    (`tune.begin_run`). None when autotune is off or does not apply.
    A profile naming an unknown or out-of-range knob raises KnobError;
    any other storage failure runs untuned."""
    cfg0 = cfgs[0]
    if not cfg0.get_bool("stream.autotune", False):
        return None
    if not inputs or any(c not in _STREAM_FOLDS for c in canonicals):
        return None
    from avenir_tpu_torch import tune

    try:
        return tune.begin_run(list(canonicals), list(cfgs), list(inputs))
    except tune.KnobError:
        raise
    except Exception:
        return None


#: the delta-scan counters every streamed result carries: the blocks a
#: restored carry covered and the blocks folded (Cache:HitBlocks,
#: Cache:DeltaBlocks), the bytes the carry skipped (Resume:SkippedBytes),
#: and the sidecar blocks replayed and parsed (Sidecar:HitBlocks,
#: Sidecar:DeltaBlocks); a cold run keeps the zeros
DELTA_COUNTERS = ("Cache:HitBlocks", "Cache:DeltaBlocks",
                  "Resume:SkippedBytes", "Sidecar:HitBlocks",
                  "Sidecar:DeltaBlocks")

#: the memory counters every streamed result carries (`_add_mem_counters`):
#: the footprint model's prediction and the process's peak RSS
MEM_COUNTERS = ("Mem:PredictedPeakBytes", "Mem:PeakRSS")


def _note_sidecar_counters(canonical: str, res: "JobResult",
                           before: dict) -> None:
    """A streamed result's delta-scan counters (DELTA_COUNTERS, 0 unless
    set already) and the sidecar blocks its scan replayed
    (Sidecar:HitBlocks) and parsed (Sidecar:DeltaBlocks) since `before`
    (sidecar.counters_snapshot() taken before the scan). The counters
    are process-wide, so a fused scan attributes its totals to every fold
    it fed: the replays served each of them."""
    if canonical not in _STREAM_FOLDS:
        return
    for key in DELTA_COUNTERS:
        res.counters.setdefault(key, 0.0)
    after = sidecar.counters_snapshot()
    res.counters["Sidecar:HitBlocks"] = float(
        after["hit_blocks"] - before["hit_blocks"])
    res.counters["Sidecar:DeltaBlocks"] = float(
        after["delta_blocks"] - before["delta_blocks"])


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


# ============================================================ stream folds
# A streamed job's work on each Dataset chunk is a fold sink: its own
# one-scan job drives it alone (`_drive_fold`), and `run_shared` drives
# several over one scan, so the two paths share one body and write the
# same bytes.

def _drive_fold(fold, chunks, job: str) -> int:
    """Drive one fold sink (an object with `consume`, or a callable taking
    a chunk) over a chunk iterator through `SharedScan`, the one-sink
    case of the shared scan: every streamed job and the shared path
    record their `stream.fold` spans and `chunk_latency_ms` at one place.
    Returns the number of chunks."""
    from avenir_tpu_torch.core.stream import SharedScan

    scan = SharedScan(chunks)
    scan.add_sink(fold, label=job)
    return scan.run()


def _finish_fold(fold, output: str, job: str) -> JobResult:
    """fold.finish(output) under the `job.finish` span."""
    with obs.span("job.finish", job=job):
        return fold.finish(output)


class _NBDistrFold:
    """bayesianDistr (tabular) as a stream fold: each Dataset chunk's
    counts are summed on the device (NaiveBayesModel.accumulate with
    defer=True) and drained to the host at finish or checkpoint. The port
    of `avenir_tpu/runner.py::_NBDistrFold`."""

    def __init__(self, cfg: JobConfig, inputs: Sequence[str],
                 schema: FeatureSchema, device: torch.device):
        self.cfg = cfg
        self.schema = schema
        self.device = device
        self.model = None
        self.rows = 0

    def consume(self, ds: Dataset) -> None:
        from avenir_tpu_torch.models.naive_bayes import NaiveBayesModel

        if self.model is None:
            # sized from the first chunk's own bins, so data-discovered
            # categorical vocabularies are in the count tensors as that
            # chunk's parse left them, however far a prefetch thread has
            # parsed (and grown the shared schema) since
            self.model = NaiveBayesModel.empty(self.schema, self.device,
                                               chunk=ds)
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

    def state_dict(self) -> Dict[str, object]:
        """The reference's checkpoint: a JSON `meta` (`rows`, and `cards`,
        the categorical vocabularies, which later chunks' codes index)
        and the float64 arrays `post`, `mom` and `cls`."""
        meta = {"rows": self.rows, "cards": None}
        arrays: Dict[str, object] = {}
        if self.model is not None:
            m = self.model
            m.flush()
            # the vocabularies the model was sized with: the shared
            # schema may already hold values of chunks not folded yet
            meta["cards"] = {str(f.ordinal): list(f.cardinality[:b])
                             for f, b in zip(m.binned_fields, m.bins)
                             if f.is_categorical}
            arrays = {"post": m.post_counts, "mom": m.cont_moments,
                      "cls": m.class_counts}
        return {"meta": np.array(json.dumps(meta)), **arrays}

    def load_state(self, state: Dict[str, object]) -> None:
        from avenir_tpu_torch.models.naive_bayes import NaiveBayesModel

        meta = json.loads(str(state["meta"]))
        self.rows = int(meta["rows"])
        if meta["cards"] is None:
            return                      # checkpoint taken before any chunk
        by_ord = {f.ordinal: f for f in self.schema.fields}
        for o, card in meta["cards"].items():
            fld = by_ord[int(o)]
            if fld.is_categorical and list(fld.cardinality or []) != card:
                fld.cardinality = list(card)
                fld.discovered_cardinality = True
        self.model = NaiveBayesModel.empty(self.schema, self.device)
        for key, attr in (("post", "post_counts"), ("mom", "cont_moments"),
                          ("cls", "class_counts")):
            arr = np.asarray(state[key], np.float64)
            if arr.shape != getattr(self.model, attr).shape:
                raise ValueError(
                    f"checkpointed NB {attr} shape {arr.shape} does not "
                    f"match the schema-derived model "
                    f"{getattr(self.model, attr).shape}")
            setattr(self.model, attr, arr)


class _MutualInfoFold:
    """mutualInformation as a stream fold: additive contingency tables
    folded a Dataset chunk at a time (MutualInformationAnalyzer.add)."""

    def __init__(self, cfg: JobConfig, inputs: Sequence[str],
                 schema: Optional[FeatureSchema], device: torch.device):
        from avenir_tpu_torch.models.explore import MutualInformationAnalyzer

        self.cfg = cfg
        self.inputs = list(inputs)
        self.schema = schema
        self.mi = MutualInformationAnalyzer(device=device)

    def consume(self, ds: Dataset) -> None:
        self.mi.add(ds)

    def merge(self, other: "_MutualInfoFold") -> "_MutualInfoFold":
        """Every MI table is an additive integer count
        (MutualInformationAnalyzer.merge)."""
        self.mi.merge(other.mi)
        return self

    def state_dict(self) -> Dict[str, object]:
        mi = self.mi
        meta = {"n": mi.n, "k": mi.k, "bins": list(mi.bins),
                "ordinals": ([f.ordinal for f in mi.fields]
                             if mi.fields is not None else None),
                "pairs": sorted(mi._pair)}
        arrays: Dict[str, object] = {}
        if mi.fields is not None:
            for i, fc in enumerate(mi._fc):
                arrays[f"fc_{i}"] = fc
            for (i, j) in mi._pair:
                arrays[f"pair_{i}_{j}"] = mi._pair[(i, j)]
                arrays[f"pairc_{i}_{j}"] = mi._pairc[(i, j)]
        return {"meta": np.array(json.dumps(meta)), **arrays}

    def load_state(self, state: Dict[str, object]) -> None:
        meta = json.loads(str(state["meta"]))
        if meta["ordinals"] is None:
            return                      # checkpoint taken before any chunk
        if self.schema is None:
            self.schema = _schema(self.cfg)
        mi = self.mi
        # the field set the first add() would have taken from the schema
        mi.fields = [f for f in self.schema.feature_fields
                     if f.num_bins() > 0]
        if [f.ordinal for f in mi.fields] != list(meta["ordinals"]):
            raise ValueError(
                "checkpointed MI field ordinals do not match the schema")
        mi.k = int(meta["k"])
        mi.bins = [int(b) for b in meta["bins"]]
        mi.n = int(meta["n"])
        mi._fc = [np.asarray(state[f"fc_{i}"], np.float64)
                  for i in range(len(mi.fields))]
        pairs = [tuple(p) for p in meta["pairs"]]
        mi._pair = {(i, j): np.asarray(state[f"pair_{i}_{j}"], np.float64)
                    for i, j in pairs}
        mi._pairc = {(i, j): np.asarray(state[f"pairc_{i}_{j}"], np.float64)
                     for i, j in pairs}

    def finish(self, output: str) -> JobResult:
        cfg, mi = self.cfg, self.mi
        if mi.fields is None:
            raise ValueError(f"mutualInformation: empty input "
                             f"(no records in {self.inputs})")
        mi.finalize()
        algos = cfg.get_list("mutual.info.score.algorithms", [])
        out = _out_file(output)
        delim = cfg.field_delim
        with open(out, "w") as fh:
            if cfg.get_bool("output.mutual.info", True):
                for f, fld in enumerate(mi.fields):
                    fh.write(f"featureClassMI{delim}{fld.ordinal}{delim}"
                             f"{mi.feature_class_mi[f]:.6f}\n")
            for algo in algos:
                scores = mi.score(algo,
                                  cfg.get_float("redundancy.factor", 1.0))
                for ordinal, s in scores:
                    fh.write(f"{algo}{delim}{ordinal}{delim}{s:.6f}\n")
        return JobResult("mutualInformation", {"Basic:Records": mi.n}, [out])


class _FisherFold:
    """fisherDiscriminant as a stream fold: per-class float64 moments
    folded a Dataset chunk at a time (FisherDiscriminant.accumulate)."""

    def __init__(self, cfg: JobConfig, inputs: Sequence[str],
                 schema: Optional[FeatureSchema], device: torch.device):
        from avenir_tpu_torch.models.discriminant import FisherDiscriminant

        self.cfg = cfg
        self.inputs = list(inputs)
        self.schema = schema
        self.fd = FisherDiscriminant()
        self.rows = 0

    def consume(self, ds: Dataset) -> None:
        self.fd.accumulate(ds)
        self.rows += len(ds)

    def merge(self, other: "_FisherFold") -> "_FisherFold":
        """Per-class (count, sum, sum-sq) moments are additive
        (FisherDiscriminant.merge)."""
        self.fd.merge(other.fd)
        self.rows += other.rows
        return self

    def state_dict(self) -> Dict[str, object]:
        fd = self.fd
        meta = {"rows": self.rows,
                "ordinals": ([f.ordinal for f in fd.fields]
                             if fd._cnt is not None else None)}
        arrays: Dict[str, object] = {}
        if fd._cnt is not None:
            arrays = {"cnt": fd._cnt, "s1": fd._s1, "s2": fd._s2}
        return {"meta": np.array(json.dumps(meta)), **arrays}

    def load_state(self, state: Dict[str, object]) -> None:
        meta = json.loads(str(state["meta"]))
        self.rows = int(meta["rows"])
        if meta["ordinals"] is None:
            return                      # checkpoint taken before any chunk
        if self.schema is None:
            self.schema = _schema(self.cfg)
        fd = self.fd
        fd.fields = [f for f in self.schema.feature_fields if f.is_numeric]
        if [f.ordinal for f in fd.fields] != list(meta["ordinals"]):
            raise ValueError(
                "checkpointed discriminant field ordinals do not match "
                "the schema")
        fd._cnt = np.asarray(state["cnt"], np.float64)
        fd._s1 = np.asarray(state["s1"], np.float64)
        fd._s2 = np.asarray(state["s2"], np.float64)

    def finish(self, output: str) -> JobResult:
        if self.rows == 0:
            raise ValueError(f"fisherDiscriminant: empty input "
                             f"(no records in {self.inputs})")
        self.fd.finalize()
        out = _out_file(output)
        self.fd.save(out, delim=self.cfg.field_delim)
        return JobResult("fisherDiscriminant", {}, [out])


# ----------------------------------------------------------- the miner fold
def _write_apriori_outputs(cfg: JobConfig, output: str, levels) -> List[str]:
    """The per-k itemset files `itemsets-<k>.txt` in the directory
    `output`, as a `job.finish` span."""
    t0 = obs.now()
    outs = []
    os.makedirs(output or ".", exist_ok=True)
    for k, isl in enumerate(levels, start=1):
        p = os.path.join(output, f"itemsets-{k}.txt")
        isl.save(p, delim=cfg.field_delim)
        outs.append(p)
    obs.record("job.finish", t0, job="frequentItemsApriori")
    return outs


def _write_gsp_outputs(cfg: JobConfig, output: str, levels) -> List[str]:
    """The per-k sequence files `sequences-<k>.txt` in the directory
    `output`: the sequences sorted, each with its support to six decimals,
    as a `job.finish` span."""
    t0 = obs.now()
    os.makedirs(output or ".", exist_ok=True)
    outs = []
    delim = cfg.field_delim
    for k, seqs in sorted(levels.items()):
        p = os.path.join(output, f"sequences-{k}.txt")
        with open(p, "w") as fh:
            for cand, support in sorted(seqs.items()):
                fh.write(delim.join([*cand, f"{support:.6f}"]) + "\n")
        outs.append(p)
    obs.record("job.finish", t0, job="candidateGenerationWithSelfJoin")
    return outs


_APRIORI, _GSP = "frequentItemsApriori", "candidateGenerationWithSelfJoin"


def _build_miner(canonical: str, cfg: JobConfig, device: torch.device):
    """The miner a `fia.*` or `cgs.*` conf describes: one constructor for
    the job and its fold."""
    if canonical == _APRIORI:
        from avenir_tpu_torch.models.association import FrequentItemsApriori

        return FrequentItemsApriori(
            support_threshold=cfg.assert_float("support.threshold"),
            max_length=cfg.get_int("item.set.length", 3),
            emit_trans_id=cfg.get_bool("emit.trans.id", False),
            device=device)
    if canonical == _GSP:
        from avenir_tpu_torch.models.sequence import GSPMiner

        return GSPMiner(
            support_threshold=cfg.assert_float("support.threshold"),
            max_length=cfg.get_int("item.set.length", 3), device=device)
    raise ValueError(f"job {canonical!r} is not a multi-pass miner")


def _cache_budget(cfg: JobConfig) -> int:
    """The encoded-block spill cache's byte budget,
    `stream.encoded.cache.budget.mb` (default
    native.ingest.DEFAULT_CACHE_BUDGET_BYTES): past it whole sources are
    evicted, re-parsed a round, and counted in Cache:EvictedBytes."""
    from avenir_tpu_torch.native.ingest import DEFAULT_CACHE_BUDGET_BYTES

    return int(cfg.get_float("stream.encoded.cache.budget.mb",
                             DEFAULT_CACHE_BUDGET_BYTES / (1 << 20))
               * (1 << 20))


def _cache_counters(src) -> Dict[str, float]:
    """A streamed miner's spill-cache counters: the bytes on disk
    (Cache:SpillBytes) and the bytes the budget evicted
    (Cache:EvictedBytes, 0 unless the corpus outgrew the budget)."""
    return {"Cache:SpillBytes": float(src.cache_nbytes),
            "Cache:EvictedBytes": float(src.cache_evicted_bytes)}


def _build_miner_source(canonical: str, cfg: JobConfig,
                        inputs: Sequence[str], spill: bool):
    """The streaming source a miner conf describes: the transaction reader
    (the key `tans.id.ord` is the reference's spelling) or the sequence
    reader, in `stream.block.size.mb` blocks (default 64), spilling its
    pass 1 to the encoded-block cache when `spill`, its own pass-1 read
    through the columnar sidecar unless `stream.sidecar=false`."""
    block = int(cfg.get_float("stream.block.size.mb", 64.0) * (1 << 20))
    skip = cfg.get_int("skip.field.count", 1)
    if canonical == _APRIORI:
        from avenir_tpu_torch.models.association import \
            StreamingTransactionSource

        src = StreamingTransactionSource(
            list(inputs), delim=cfg.field_delim_regex,
            trans_id_ord=cfg.get_int("tans.id.ord", 0),
            skip_field_count=skip, marker=cfg.get("infreq.item.marker"),
            block_bytes=block, spill_cache=spill,
            cache_budget_bytes=_cache_budget(cfg))
    else:
        from avenir_tpu_torch.models.sequence import StreamingSequenceSource

        src = StreamingSequenceSource(
            list(inputs), delim=cfg.field_delim_regex,
            skip_field_count=skip, block_bytes=block, spill_cache=spill,
            cache_budget_bytes=_cache_budget(cfg))
    _attach_sidecar_opts(src, cfg)
    return src


def _attach_sidecar_opts(src, cfg: JobConfig) -> None:
    """Point a miner source's own pass-1 read at the columnar sidecar
    (SpillScanMixin._scan_all); `stream.sidecar=false` leaves it None and
    the scan parses."""
    src.sidecar_opts = sidecar.opts_from_cfg(cfg)


def _source_rows(job: str, src) -> int:
    """The rows a miner's streaming source has scanned."""
    return src.n_trans if job == _APRIORI else src.n_rows


def finish_miner_levels(job: str, cfg: JobConfig, levels, n_rows: int,
                        seconds: float, output: str,
                        extra_counters: Optional[Dict[str, float]] = None
                        ) -> JobResult:
    """A miner's files and counters: `Apriori:MaxLength` (the itemset
    lists written) or `GSP:MaxLength` (the longest frequent sequence),
    the throughput counters, then `extra_counters` (the Cache:* pair of a
    streamed run). Every miner path ends here: the job, the fold sink and
    the sharded driver's per-k rounds."""
    if job == _APRIORI:
        counters = {"Apriori:MaxLength": len(levels)}
        outs = _write_apriori_outputs(cfg, output, levels)
    else:
        counters = {"GSP:MaxLength": max(levels) if levels else 0}
        outs = _write_gsp_outputs(cfg, output, levels)
    counters.update(throughput_counters(n_rows, seconds))
    counters.update(extra_counters or {})
    return JobResult(job, counters, outs)


class _MinerScanFold:
    """A multi-pass miner's pass 1 (vocabulary and k=1 supports; for GSP
    the longest sequence too) as a shared-scan sink of raw byte blocks;
    finish() runs the later rounds, which replay the encoded-block cache
    pass 1 spilled (`stream.encoded.cache`, default true) instead of
    re-reading the inputs. The port of `avenir_tpu/runner.py`
    `_MinerScanFold`. The job server sets `keep_sources` (through
    run_shared's `fold_hook`) to adopt the still-open source, and its
    committed encoded-block cache, after finish(): a repeat mining
    request then replays encoded blocks instead of parsing the CSV."""

    def __init__(self, cfg: JobConfig, inputs: Sequence[str],
                 device: torch.device, job: str):
        self.cfg = cfg
        self.job = job
        self.t0 = time.perf_counter()
        self.miner = _build_miner(job, cfg, device)
        self.src = _build_miner_source(
            job, cfg, inputs, cfg.get_bool("stream.encoded.cache", True))
        self._sink = self.src.scan_consumer()
        self._sealed = False
        self._shards: List["_MinerScanFold"] = []
        self.keep_sources = False

    def consume(self, data: bytes) -> None:
        self._sink.consume(data)

    def _seal(self) -> None:
        """Finish the pass-1 scan once, so merge() and finish() compose
        in any order."""
        if not self._sealed:
            self._sink.finish()
            self._sealed = True

    def _n_rows(self) -> int:
        return _source_rows(self.job, self.src)

    def finish(self, output: str) -> JobResult:
        self._seal()
        srcs = [self.src] + [f.src for f in self._shards]
        levels = (self.miner.mine_stream(self.src) if len(srcs) == 1
                  else self.miner.mine_stream_merged(srcs))
        n_rows = self._n_rows() + sum(f._n_rows() for f in self._shards)
        res = finish_miner_levels(self.job, self.cfg, levels, n_rows,
                                  time.perf_counter() - self.t0, output,
                                  _cache_counters(self.src))
        if not self.keep_sources:
            for src in srcs:
                src.close()
        return res

    def merge(self, other: "_MinerScanFold") -> "_MinerScanFold":
        """Seal both shards' pass 1 and keep their sources side by side;
        finish() then mines them with mine_stream_merged, which counts each
        candidate per shard and sums the supports."""
        if other.job != self.job:
            raise ValueError(
                f"cannot merge {other.job!r} fold into {self.job!r}")
        self._seal()
        other._seal()
        self._shards.append(other)
        self._shards.extend(other._shards)
        other._shards = []
        return self

    def state_dict(self) -> Dict[str, object]:
        """The reference's checkpoint: a JSON `meta` (`job`, `vocab`, `n`,
        `sealed`, `t_max`) and the int64 partial item counts `counts`."""
        if self._shards:
            raise ValueError(
                "checkpoint a miner fold before merging shards into it")
        src = self.src
        meta = {"job": self.job, "vocab": list(src.vocab),
                "n": self._n_rows(), "sealed": self._sealed,
                "t_max": getattr(src, "t_max", None)}
        return {"meta": np.array(json.dumps(meta)),
                "counts": np.asarray(src._scan_counts, np.int64)}

    def load_state(self, state: Dict[str, object]) -> None:
        meta = json.loads(str(state["meta"]))
        if meta["job"] != self.job:
            raise ValueError(
                f"checkpointed {meta['job']!r} state for a {self.job!r} "
                f"fold")
        src = self.src
        src.restore_scan_state(meta["vocab"], state["counts"])
        if self.job == _APRIORI:
            src.n_trans = int(meta["n"])
        else:
            src.n_rows = int(meta["n"])
            src.t_max = max(int(meta["t_max"] or 1), 1)
        if meta["sealed"]:
            self._seal()


def _apriori_fold(cfg: JobConfig, inputs: Sequence[str], schema,
                  device: torch.device) -> _MinerScanFold:
    return _MinerScanFold(cfg, inputs, device, _APRIORI)


def _gsp_fold(cfg: JobConfig, inputs: Sequence[str], schema,
              device: torch.device) -> _MinerScanFold:
    return _MinerScanFold(cfg, inputs, device, _GSP)


# ---------------------------------------------------------- the markov fold
_MARKOV = "markovStateTransitionModel"


class _MarkovPerClassFold:
    """markovStateTransitionModel (per-class mode) as a shared-scan sink of
    raw byte blocks: the native CSR encode and `fit_csr` a block when the
    encoder builds, the line decode and `fit` otherwise; the counts on
    `device`, and `consume_encoded` for a block the columnar sidecar
    replays. The port of `avenir_tpu/runner.py` `_MarkovPerClassFold`,
    with its checkpoint keys (`meta`, `counts`). The per-entity mode
    (`id.field.ordinals`) keeps its own scan: its open-vocabulary keys
    make no fan-out fold."""

    def __init__(self, cfg: JobConfig, inputs: Sequence[str],
                 device: torch.device):
        from avenir_tpu_torch.models.markov import MarkovStateTransitionModel
        from avenir_tpu_torch.native.ingest import native_seq_ready

        if cfg.get_int_list("id.field.ordinals") is not None:
            raise ValueError(
                "markovStateTransitionModel per-entity mode "
                "(id.field.ordinals) is not shared-scan fusable")
        self.cfg = cfg
        self.inputs = list(inputs)
        states = cfg.get_list("model.states") or cfg.assert_list("state.list")
        self.class_ord = cfg.get_int("class.label.field.ord")
        self.skip = cfg.get_int("skip.field.count", 1)
        self.class_labels = cfg.get_list("class.labels")
        self.model = MarkovStateTransitionModel(
            states, scale=cfg.get_int("trans.prob.scale", 1000),
            class_labels=self.class_labels, device=device)
        self.delim = cfg.field_delim_regex
        # one vocabulary: the states first (codes 0..S-1), then the class
        # labels that are not themselves state names
        vocab = list(states)
        for lab in self.class_labels or []:
            if lab not in vocab:
                vocab.append(lab)
        self.vocab = vocab
        self._index = {t: i for i, t in enumerate(vocab)}
        self.label_codes = np.asarray([vocab.index(lab)
                                       for lab in self.class_labels or []])
        self.native = native_seq_ready(self.delim)
        self.rows = 0

    def consume_encoded(self, blk) -> None:
        """Fold one block the sidecar replays (native.sidecar.
        SidecarBytesBlock): the CSR codes seq_encode_native would have
        made, rebuilt from the block (the meta columns encoded from their
        token buffers, the tail codes mapped from the sidecar's
        vocabulary to this one, an unknown and the empty token both -1 as
        in the cold encode), into `fit_csr`. No tokenizer, no parse
        span."""
        from avenir_tpu_torch.native.ingest import csr_region_mask

        lens = blk.counts + blk.skip
        offsets = np.zeros(blk.n + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        total = int(offsets[-1])
        codes = np.empty(total, np.int32)
        idx = self._index
        starts = offsets[:-1]
        for j in range(blk.skip):
            codes[starts + j] = [idx.get(t, -1) for t in blk.meta[j]]
        lut = np.full(blk.vocab_end + 1, -1, np.int32)
        for k in range(blk.vocab_end):
            lut[k + 1] = idx.get(blk.vocab[k], -1)
        if blk.skip:
            codes[csr_region_mask(offsets, blk.skip, total)] = lut[blk.codes]
        else:
            codes[:] = lut[blk.codes]
        self.model.fit_csr(
            codes, offsets, skip=self.skip,
            class_ord=self.class_ord if self.class_labels else None,
            label_codes=self.label_codes)
        self.rows += blk.n

    def consume(self, data) -> None:
        if not isinstance(data, (bytes, bytearray)):
            self.consume_encoded(data)
        elif self.native:
            from avenir_tpu_torch.native.ingest import seq_encode_native

            t0 = obs.now()
            enc = seq_encode_native(data, self.delim, self.vocab)
            obs.record("stream.parse", t0, sink="markov_csr",
                       nbytes=len(data), engine="native")
            self.model.fit_csr(
                *enc, skip=self.skip,
                class_ord=self.class_ord if self.class_labels else None,
                label_codes=self.label_codes)
            self.rows += enc[1].shape[0] - 1
        else:
            t0 = obs.now()
            lines = [ln.rstrip("\r")
                     for ln in data.decode("utf-8", "replace").split("\n")
                     if ln.strip()]
            _, seqs, labels = _parse_sequences(lines, self.delim, self.skip,
                                               self.class_ord)
            obs.record("stream.parse", t0, sink="markov_lines",
                       nbytes=len(data), engine="lines")
            self.model.fit(seqs, labels if self.class_labels else None)
            self.rows += len(seqs)

    def finish(self, output: str) -> JobResult:
        out = _out_file(output)
        self.model.save(out, delim=self.cfg.field_delim)
        return JobResult(_MARKOV, {"Basic:Records": self.rows}, [out])

    def merge(self, other: "_MarkovPerClassFold") -> "_MarkovPerClassFold":
        """Shard merge: per-class bigram counts add."""
        self.model.merge(other.model)
        self.rows += other.rows
        return self

    def state_dict(self) -> Dict[str, object]:
        """The reference's checkpoint: a JSON `meta` (`rows`, `states`,
        `class_labels`) and the float64 `counts`."""
        meta = {"rows": self.rows, "states": self.model.states,
                "class_labels": self.model.class_labels}
        return {"meta": np.array(json.dumps(meta)),
                "counts": self.model.counts}

    def load_state(self, state: Dict[str, object]) -> None:
        meta = json.loads(str(state["meta"]))
        if meta["states"] != self.model.states \
                or meta["class_labels"] != self.model.class_labels:
            raise ValueError(
                "checkpointed markov states/class labels do not match "
                "the job config")
        arr = np.asarray(state["counts"], np.float64)
        if arr.shape != self.model.counts.shape:
            raise ValueError(
                f"checkpointed markov counts shape {arr.shape} does not "
                f"match {self.model.counts.shape}")
        self.model.counts = arr
        self.rows = int(meta["rows"])


def _markov_fold(cfg: JobConfig, inputs: Sequence[str], schema,
                 device: torch.device) -> _MarkovPerClassFold:
    return _MarkovPerClassFold(cfg, inputs, device)


def _merge_folds(a, b):
    """The default merge_states: every fold sink merges in place."""
    return a.merge(b)


@dataclass(frozen=True)
class StreamFoldOps:
    """One streamed job's fold registration: the scan kind, the sink
    factory, and the ops that make its carry a mergeable, serializable
    state: merge_states(fold(A), fold(B)).finish() == fold(A ++ B).finish()
    byte for byte, and restore_state(serialize_state(fold)) resumes a
    carry taken mid-scan to the same bytes.

    `kind`: "dataset" folds consume schema-parsed Dataset chunks, "bytes"
    folds raw byte blocks (the per-class markov counts, and the miners'
    pass 1, Apriori's and GSP's). `factory(cfg, inputs, schema, device)`
    builds the sink;
    `merge_states` folds one sink's carry into another (default
    `a.merge(b)`)."""

    kind: str
    factory: Callable
    merge_states: Callable = _merge_folds

    def serialize_state(self, fold) -> bytes:
        """A fold's carry as an npz of its `state_dict()`: numpy arrays and
        one JSON `meta` entry, no pickle, so another process (or the JAX
        package) loads it without trusting the writer."""
        buf = io.BytesIO()
        np.savez(buf, **fold.state_dict())
        return buf.getvalue()

    def restore_state(self, cfg: JobConfig, inputs: Sequence[str],
                      blob: bytes, schema: Optional[FeatureSchema] = None,
                      device: DeviceLike = None):
        """A fresh factory sink with a checkpoint's carry loaded, ready to
        consume the remaining chunks."""
        if schema is None and self.kind == "dataset":
            schema = _schema(cfg)
        fold = self.factory(cfg, list(inputs), schema, resolve_device(device))
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            state = {k: z[k] for k in z.files}
        fold.load_state(state)
        return fold


#: canonical job name -> StreamFoldOps
_STREAM_FOLDS: Dict[str, StreamFoldOps] = {
    "bayesianDistr": StreamFoldOps("dataset", _NBDistrFold),
    "mutualInformation": StreamFoldOps("dataset", _MutualInfoFold),
    "fisherDiscriminant": StreamFoldOps("dataset", _FisherFold),
    _MARKOV: StreamFoldOps("bytes", _markov_fold),
    "frequentItemsApriori": StreamFoldOps("bytes", _apriori_fold),
    "candidateGenerationWithSelfJoin": StreamFoldOps("bytes", _gsp_fold),
}


def stream_fold_names() -> List[str]:
    """The jobs a shared scan can fuse."""
    return sorted(_STREAM_FOLDS)


def stream_fold_ops(job: str) -> StreamFoldOps:
    """The fold ops of a streamed job (or one of its aliases)."""
    canonical = _REGISTRY[job][0] if job in _REGISTRY else job
    if canonical not in _STREAM_FOLDS:
        raise KeyError(
            f"job {job!r} has no registered stream fold; streamed jobs: "
            f"{', '.join(stream_fold_names())}")
    return _STREAM_FOLDS[canonical]


def _stream_fold_job(name: str, cfg: JobConfig, inputs: List[str],
                     output: str, device: torch.device) -> JobResult:
    """A streamed job on its own scan: its fold driven over the chunks of
    its inputs, then finished."""
    from avenir_tpu_torch.core.stream import stream_job_inputs

    schema = _schema(cfg)
    fold = _STREAM_FOLDS[name].factory(cfg, inputs, schema, device)
    _drive_fold(fold, stream_job_inputs(cfg, inputs, schema), name)
    return _finish_fold(fold, output, name)


def _fused_specs(specs, jobs: str, group: str,
                 before_checks: Optional[Callable] = None):
    """(canonical, cfg, ops, output) of each spec of a fused run, its scan
    kind, and the schema its dataset-kind jobs share, after the checks
    every fused run makes: registered streamed jobs, each once, of one
    kind, one block size, one delimiter and one schema file. `jobs` and
    `group` name what is fused in the errors ("jobs" in one "scan",
    "refreshes" in one "refresh"). `before_checks(built)`, when given,
    runs between the first two checks and the others: the autotune
    overlay, so that the agreement checks judge the tuned values."""
    built = []
    for name, conf, output in specs:
        canonical, cfg = _job_cfg(name, conf)
        if canonical not in _STREAM_FOLDS:
            raise ValueError(
                f"job {name!r} is not shared-scan capable; fusable jobs: "
                f"{', '.join(stream_fold_names())}")
        if any(canonical == b[0] for b in built):
            raise ValueError(
                f"job {canonical!r} appears twice in one shared {group}")
        built.append((canonical, cfg, _STREAM_FOLDS[canonical], output))
    if before_checks is not None:
        before_checks(built)
    kinds = {ops.kind for _c, _cfg, ops, _o in built}
    if len(kinds) != 1:
        raise ValueError(f"cannot fuse {jobs} of mixed scan kinds {kinds}")
    blocks = {cfg.get_float("stream.block.size.mb", 64.0)
              for _c, cfg, _ops, _o in built}
    if len(blocks) != 1:
        raise ValueError(
            f"fused {jobs} disagree on stream.block.size.mb: {blocks}")
    delims = {cfg.field_delim_regex for _c, cfg, _ops, _o in built}
    if len(delims) != 1:
        raise ValueError(f"fused {jobs} disagree on field delimiter: {delims}")
    kind = kinds.pop()
    schema = None
    if kind == "dataset":
        spaths = {cfg.assert_get("feature.schema.file.path")
                  for _c, cfg, _ops, _o in built}
        if len(spaths) != 1:
            raise ValueError(
                f"fused {jobs} disagree on the schema file: {spaths}")
        schema = FeatureSchema.from_file(spaths.pop())
    return built, kind, schema


def run_shared(specs: Sequence[Tuple[str, object, str]],
               inputs: Sequence[str],
               device: DeviceLike = None,
               fold_hook: Optional[Callable] = None
               ) -> Dict[str, JobResult]:
    """Run N streamed jobs over the same inputs with one scan.

    `specs` is a sequence of (job name, conf, output path). Every job must
    be shared-scan capable (stream_fold_names()), and they must agree on
    the scan kind, `stream.block.size.mb` and the field delimiter, and
    dataset-kind jobs on the schema file: one read (and for Dataset folds
    one parse) a chunk, N folds. Each job reads its own prefixed config
    and writes its own outputs. Results come back keyed by canonical job
    name, byte-identical to running the jobs one scan each (run_job, the
    fallback and the oracle). The scan is the span `job.dispatch` (mode
    "shared").

    The feed goes through the columnar sidecar (bytes-kind jobs when they
    agree on `skip.field.count`, which the packed format is keyed to), and
    each result carries the delta-scan counters (DELTA_COUNTERS).
    `fold_hook(canonical, fold)`, when given, is called with each fold
    sink right after it is built: the job server's warm-state tap (it
    sets a miner fold's `keep_sources`). It must not consume chunks.

    Each result carries the memory counters (`_add_mem_counters`). With
    `stream.autotune` in the first job's config, the fused group's
    profile (the jobs' names joined by "+") overlays its knobs onto every
    member config before the agreement checks, and the run records its
    signals for the next (`tune.begin_run`)."""
    from avenir_tpu_torch.core.stream import (SharedScan,
                                              stream_job_byte_blocks,
                                              stream_job_inputs)

    if not specs:
        return {}
    dev = resolve_device(device)
    session = None
    rss0 = None

    def overlay(built):
        nonlocal session, rss0
        session = _autotune_begin([b[0] for b in built],
                                  [b[1] for b in built], inputs)
        rss0 = _rss_now()

    try:
        built, kind, schema = _fused_specs(specs, "jobs", "scan",
                                           before_checks=overlay)
        cfg0 = built[0][1]
        if kind == "dataset":
            chunks = stream_job_inputs(cfg0, list(inputs), schema)
        else:
            skips = {cfg.get_int("skip.field.count", 1)
                     for _c, cfg, _ops, _o in built}
            chunks = stream_job_byte_blocks(
                cfg0, list(inputs),
                sidecar_skip=skips.pop() if len(skips) == 1 else None)
        sc0 = sidecar.counters_snapshot()
        scan = SharedScan(chunks)
        folds = []
        for canonical, cfg, ops, output in built:
            fold = ops.factory(cfg, list(inputs), schema, dev)
            if fold_hook is not None:
                fold_hook(canonical, fold)
            folds.append((canonical, fold, output))
            scan.add_sink(fold, label=canonical)
        t0 = obs.now()
        n_chunks = scan.run()
        obs.record("job.dispatch", t0, mode="shared", chunks=n_chunks,
                   jobs=",".join(c for c, _f, _o in folds))
        results = {}
        for (canonical, fold, output), (_c, cfg, _ops, _o) in zip(folds,
                                                                  built):
            results[canonical] = _finish_fold(fold, output, canonical)
            _note_sidecar_counters(canonical, results[canonical], sc0)
            _add_mem_counters(canonical, cfg, inputs, results[canonical],
                              rss0=rss0)
    except BaseException:
        if session is not None:
            session.close()   # a leaked session would contaminate
        raise                 # every later one in this process
    if session is not None:
        session.finish(results)
    return results


def run_warm_miner(name: str, conf, inputs: Sequence[str], output: str,
                   src, device: DeviceLike = None) -> JobResult:
    """Serve a multi-pass miner from a warm streaming source whose pass 1
    already ran (`scan_items` / `scan` memoize the discovery counts): every
    per-k round replays the source's committed encoded-block cache, so an
    unchanged corpus serves with no CSV parse. The caller owns `src` and
    its validity (`SpillScanMixin.cache_ready`) and closes it; the mining
    parameters come from `conf`, which pass 1 does not depend on. The
    files are the cold `run_job`'s byte for byte; the throughput counters
    price the mining alone. Its caller is the job server's warm store
    (`server/jobserver.py`)."""
    canonical, cfg = _job_cfg(name, conf)
    if canonical not in (_APRIORI, _GSP):
        raise ValueError(
            f"job {name!r} has no warm-source path; warm-servable jobs: "
            f"{_APRIORI}, {_GSP}")
    t0 = time.perf_counter()
    miner = _build_miner(canonical, cfg, resolve_device(device))
    levels = miner.mine_stream(src)
    res = finish_miner_levels(canonical, cfg, levels,
                              _source_rows(canonical, src),
                              time.perf_counter() - t0, output,
                              extra_counters=_cache_counters(src))
    for key in DELTA_COUNTERS:
        res.counters.setdefault(key, 0.0)
    # no starting RSS: the warm path records no residual
    _add_mem_counters(canonical, cfg, inputs, res)
    return res


# ====================================================== incremental driver
# The port of the delta-scan driver of `avenir_tpu/runner.py`: a streamed
# job's carry is checkpointed (core/incremental.py) with the fingerprints of
# every block it covers, and a refresh restores it and folds only the blocks
# past the watermark, to the same bytes as a cold run_job (the merge algebra
# of StreamFoldOps). Each checkpoint's manifest holds the footprint
# model's `predicted_peak_bytes`, and the result its Mem:* counters.

#: the manifest layout the driver writes and restores
_INCR_FORMAT = 1


def _incremental_state_dir(cfg: JobConfig, canonical: str,
                           inputs: Sequence[str]) -> str:
    """Where a job's delta-scan state lives across runs: the
    `stream.incremental.state.dir` key, else
    `.avenir_incremental/<job>_<digest>` beside the first input, one
    directory a (job, input set), so a rerun finds its own state and two
    jobs over one corpus never collide."""
    from avenir_tpu_torch.core import keys

    explicit = cfg.get("stream.incremental.state.dir")
    if explicit:
        return explicit
    base = os.path.dirname(os.path.abspath(inputs[0]))
    return os.path.join(base, ".avenir_incremental",
                        f"{canonical}_{keys.state_digest(canonical, inputs)}")


def _conf_digest(cfg: JobConfig, canonical: str) -> str:
    """The digest of the conf view a carry was folded under
    (core.keys.conf_digest): every key but the view-neutral ones, and the
    schema file's bytes. The reference's job config also holds the key
    ``__job_name__`` (the canonical name), so it is folded in here too:
    both packages stamp one conf with one digest."""
    from avenir_tpu_torch.core import keys

    return keys.conf_digest(
        JobConfig(dict(cfg.props, __job_name__=canonical), cfg.prefix))


class _IncrementalPlan:
    """One job's restore plan and delta-fold state: the per-job half of an
    incremental run, shared by `run_incremental`, `run_incremental_shared`
    and `dist.run_sharded_refresh`, so they never disagree on the restore
    gate or the checkpoint layout."""

    def __init__(self, canonical: str, cfg: JobConfig, ops: "StreamFoldOps",
                 inputs: List[str], output: str, schema, store,
                 conf_digest: str):
        self.canonical = canonical
        self.cfg = cfg
        self.ops = ops
        self.inputs = inputs
        self.abs_inputs = [os.path.abspath(p) for p in inputs]
        self.output = output
        self.schema = schema
        self.store = store
        self.conf_digest = conf_digest
        self.block = int(cfg.get_float("stream.block.size.mb", 64.0)
                         * (1 << 20))
        self.interval = int(
            cfg.get_float("stream.checkpoint.interval.mb", 256.0)
            * (1 << 20))
        self.delim = cfg.field_delim_regex
        self.fold = None
        self.watermarks = [0] * len(inputs)
        self.fps: List[list] = [[] for _ in inputs]
        self.hit_blocks = 0
        self.skipped = 0
        self.seq = 0
        self.delta_blocks = 0
        self.since_ckpt = 0
        #: the footprint model's price of the scan (`_prepare_incremental`)
        self.predicted: Optional[int] = None
        self.rss0 = _rss_now()


def _restorable(meta: dict, plan: _IncrementalPlan) -> bool:
    """The manifest gates of a restore: the layout, the job, the conf view
    and the input list, which must be a prefix of the current one (a new
    source folds whole, like appended bytes)."""
    old_inputs = [str(p) for p in meta.get("inputs", [])]
    return (meta.get("format") == _INCR_FORMAT
            and meta.get("format_version", _INCR_FORMAT) == _INCR_FORMAT
            and meta.get("job") == plan.canonical
            and meta.get("conf_digest") == plan.conf_digest
            and old_inputs == plan.abs_inputs[:len(old_inputs)])


def _prepare_incremental(canonical: str, cfg: JobConfig, inputs: List[str],
                         output: str, state_dir: Optional[str],
                         device: torch.device,
                         schema=None) -> _IncrementalPlan:
    """One job's restore plan: load the newest checkpoint, verify its
    fingerprints against the current files, and restore the carry (on
    `device`) when, and only when, the covered prefix still matches.
    Anything else (a torn or truncated checkpoint, a version skew, an
    in-place edit, a changed job, conf or input list, a mid-line watermark
    on a grown file, an unloadable carry) leaves a fresh cold fold.
    `schema` hands every plan of a fused refresh one schema object."""
    from avenir_tpu_torch.core import incremental as incr

    ops = stream_fold_ops(canonical)
    if schema is None and ops.kind == "dataset":
        schema = _schema(cfg)
    store = incr.CheckpointStore(
        state_dir or _incremental_state_dir(cfg, canonical, inputs))
    plan = _IncrementalPlan(canonical, cfg, ops, inputs, output, schema,
                            store, _conf_digest(cfg, canonical))
    t_restore = obs.now()
    loaded = store.load()
    if loaded is not None:
        meta, blob = loaded
        plan.seq = int(meta.get("seq", 0))     # the sequence goes on
    if loaded is not None and _restorable(meta, plan):
        wm, kept = [], []
        for path, src_fps in zip(inputs, meta.get("fingerprints", [])):
            n, covered = incr.verified_prefix(path, src_fps)
            if n != len(src_fps):
                break                   # an in-place edit: cold
            if covered < os.path.getsize(path) \
                    and not incr.ends_at_newline(path, covered):
                # the last line had no newline, so the appended bytes
                # extend a row already folded: cold
                break
            wm.append(covered)
            kept.append(list(src_fps))
        else:
            try:
                plan.fold = ops.restore_state(cfg, inputs, blob,
                                              schema=schema, device=device)
            except Exception:
                plan.fold = None        # an unloadable carry: cold
            if plan.fold is not None:
                plan.watermarks[:len(wm)] = wm
                plan.fps[:len(kept)] = kept
                plan.hit_blocks = sum(len(x) for x in kept)
                plan.skipped = sum(wm)
    restored = plan.fold is not None
    if not restored:
        plan.fold = ops.factory(cfg, inputs, schema, device)
    obs.record("job.restore", t_restore, job=canonical, restored=restored,
               skipped_bytes=plan.skipped)
    # the checkpoint's footprint, priced by analysis/mem's model (the job
    # server's admission oracle); a failure to predict never fails a scan
    try:
        from avenir_tpu_torch.analysis.mem import (corpus_stats,
                                                   footprint_model)
        from avenir_tpu_torch.core.stream import prefetch_depth

        stats = corpus_stats([p for p in inputs if os.path.exists(p)],
                             delim=plan.delim)
        plan.predicted = int(footprint_model(
            canonical, plan.block, schema, stats,
            prefetch_depth=prefetch_depth(cfg)).total_bytes)
    except Exception:
        pass
    return plan


def _plan_checkpoint(plan: _IncrementalPlan, complete: bool) -> None:
    """Commit one checkpoint of a plan's carry and fingerprints."""
    from avenir_tpu_torch.core import incremental as incr

    t0 = obs.now()
    plan.seq += 1
    blob = plan.ops.serialize_state(plan.fold)
    meta = {"format": _INCR_FORMAT, "format_version": _INCR_FORMAT,
            "job": plan.canonical, "seq": plan.seq,
            "conf_digest": plan.conf_digest,
            "inputs": plan.abs_inputs, "block_bytes": plan.block,
            "watermarks": list(plan.watermarks),
            "fingerprints": plan.fps,
            "complete": complete,
            "predicted_peak_bytes": plan.predicted}
    saved = plan.store.save(meta, blob)
    obs.record("job.checkpoint", t0, job=plan.canonical, seq=plan.seq,
               complete=complete, nbytes=len(blob))
    if incr._checkpoint_hook is not None:
        incr._checkpoint_hook(saved)


def _plan_note_block(plan: _IncrementalPlan, si: int, off: int,
                     length: int, fp_hash: str) -> None:
    """Account one folded block of source `si`: its fingerprint, the
    watermark, and a mid-scan checkpoint every
    `stream.checkpoint.interval.mb` (after the fold, so the carry holds
    the block)."""
    plan.fps[si].append({"offset": int(off), "length": int(length),
                         "hash": fp_hash})
    plan.watermarks[si] = off + length
    plan.delta_blocks += 1
    plan.since_ckpt += length
    if plan.since_ckpt >= plan.interval:
        _plan_checkpoint(plan, complete=False)
        plan.since_ckpt = 0


def _plan_finish(plan: _IncrementalPlan,
                 checkpoint: bool = True) -> JobResult:
    """The final (complete) checkpoint, written before finish() so the carry
    never holds a finished fold, then the artifact and the delta counters.
    ``checkpoint=False`` (a sharded refresh whose worker fingerprints do
    not tile) writes the artifact and leaves the previous checkpoint the
    newest: its carry and fingerprints still agree, where this carry with
    partial fingerprints would make the next refresh fold bytes twice."""
    if checkpoint:
        _plan_checkpoint(plan, complete=True)
    if plan.output:
        os.makedirs(os.path.dirname(os.path.abspath(plan.output)),
                    exist_ok=True)
    res = _finish_fold(plan.fold, plan.output, plan.canonical)
    res.counters["Cache:HitBlocks"] = float(plan.hit_blocks)
    res.counters["Cache:DeltaBlocks"] = float(plan.delta_blocks)
    res.counters["Resume:SkippedBytes"] = float(plan.skipped)
    if plan.predicted is not None:
        res.counters["Mem:PredictedPeakBytes"] = float(plan.predicted)
    _add_mem_counters(plan.canonical, plan.cfg, plan.inputs, res,
                      rss0=plan.rss0)
    return res


def _cold_delta_feed(plan: _IncrementalPlan, path: str, start: int,
                     size: int):
    """The blocks of [start, size) of one source as (offset, length, hash,
    payload): raw blocks, a blank one with payload None, a dataset-kind
    block parsed (Dataset.from_csv's stream.parse span)."""
    from avenir_tpu_torch.core import incremental as incr
    from avenir_tpu_torch.core.stream import (csv_engine, is_blank_block,
                                              iter_byte_blocks, prefetched)

    engine = csv_engine(plan.cfg)
    feed = prefetched(iter_byte_blocks(path, plan.block,
                                       byte_range=(start, size),
                                       with_offsets=True), depth=1)
    try:
        for off, data in feed:
            fp = incr.block_fingerprint(off, data)
            if is_blank_block(data):
                payload = None
            elif plan.ops.kind == "dataset":
                payload = Dataset.from_csv(data, plan.schema,
                                           delim=plan.delim, engine=engine)
            else:
                payload = data
            yield off, len(data), fp["hash"], payload
    finally:
        feed.close()


def _delta_feed(plan: _IncrementalPlan, path: str, start: int, size: int,
                sidecar_ok: bool = True):
    """One source's delta range as a tuple feed, through the columnar
    sidecar when it engages: delta bytes a plain run (or the last refresh)
    already packed replay without a parse, and the new tail parses and
    extends the sidecar. Anything in doubt (no manifest, a boundary off
    the watermark, drift) falls back to the cold feed, to the same
    bytes."""
    feed = None
    if sidecar_ok:
        opts = sidecar.opts_from_cfg(plan.cfg)
        if plan.ops.kind == "dataset":
            feed = sidecar.dataset_blocks(opts, path, plan.schema,
                                          plan.delim, plan.block,
                                          byte_range=(start, size))
        else:
            feed = sidecar.byte_blocks(
                opts, path, plan.delim,
                plan.cfg.get_int("skip.field.count", 1), plan.block,
                byte_range=(start, size))
    return feed if feed is not None \
        else _cold_delta_feed(plan, path, start, size)


def run_incremental(name: str, conf, inputs: Sequence[str],
                    output: str = "", state_dir: Optional[str] = None,
                    device: DeviceLike = None) -> JobResult:
    """Run a streamed job incrementally on `device` (default cuda): restore
    the last checkpointed carry, fold only the blocks past its watermark,
    and re-emit the artifact, the same bytes as a cold `run_job`.

    A per-(job, corpus) CheckpointStore (`state_dir`, the
    `stream.incremental.state.dir` key, or `_incremental_state_dir`)
    holds the newest carry and the fingerprints of every block it covers.
    A verified prefix restores the carry and skips its bytes; anything
    else falls back to a cold scan, never to a wrong artifact. The carry
    is checkpointed again every `stream.checkpoint.interval.mb` (default
    256), so a killed scan resumes from its last watermark, and at the
    end (complete) for the next refresh.

    The result carries Cache:HitBlocks (restored, verified blocks),
    Cache:DeltaBlocks (blocks folded) and Resume:SkippedBytes (bytes the
    restored carry covered) beside the sidecar's and the memory
    counters. With `stream.autotune` the profile's knobs are overlaid
    before the restore plan: they enter the conf digest, so a knob change
    re-scans cold and the next refresh under the same knobs restores. It
    is the one path that records `job.checkpoint` spans, the checkpoint
    interval rule's signal."""
    canonical, cfg = _job_cfg(name, conf)
    inputs = [str(p) for p in inputs]
    dev = resolve_device(device)
    session = _autotune_begin([canonical], [cfg], inputs)
    try:
        plan = _prepare_incremental(canonical, cfg, inputs, output,
                                    state_dir, dev)
        sc0 = sidecar.counters_snapshot()
        for si, path in enumerate(inputs):
            size = os.path.getsize(path)
            start = plan.watermarks[si]
            if start >= size:
                continue
            feed = _delta_feed(plan, path, start, size)
            try:
                for off, length, fp_hash, payload in feed:
                    if payload is not None:
                        t0 = obs.now()
                        plan.fold.consume(payload)
                        obs.record("stream.fold", t0, sink=canonical)
                    _plan_note_block(plan, si, off, length, fp_hash)
            finally:
                feed.close()
        res = _plan_finish(plan)
        _note_sidecar_counters(canonical, res, sc0)
    except BaseException:
        if session is not None:
            session.close()   # a leaked session would contaminate
        raise                 # every later one in this process
    if session is not None:
        session.finish({canonical: res})
    return res


def run_incremental_shared(specs: Sequence[Tuple[str, object, str]],
                           inputs: Sequence[str],
                           state_dirs: Optional[Dict[str, str]] = None,
                           device: DeviceLike = None
                           ) -> Dict[str, JobResult]:
    """Refresh N streamed jobs over the same appended corpus with one delta
    scan: each job restores its own carry (`_prepare_incremental`, the
    solo gate), and the jobs whose verified watermarks agree fold the new
    blocks through one `SharedScan` (the span `job.dispatch`, mode
    "incremental_shared"). Jobs whose watermarks differ (seeded at another
    size, or fallen back cold) scan in a group of their own, so fusion
    never decides correctness. The results equal `run_incremental` a job.

    `specs` are (job name, conf, output) with `run_shared`'s contract;
    `state_dirs` maps canonical job names to checkpoint directories
    (others take their default)."""
    from avenir_tpu_torch.core.stream import SharedScan

    if not specs:
        return {}
    inputs = [str(p) for p in inputs]
    dev = resolve_device(device)
    built, kind, schema = _fused_specs(specs, "refreshes", "refresh")
    plans = [_prepare_incremental(canonical, cfg, inputs, output,
                                  (state_dirs or {}).get(canonical), dev,
                                  schema=schema)
             for canonical, cfg, _ops, output in built]
    groups: Dict[tuple, List[_IncrementalPlan]] = {}
    for plan in plans:
        groups.setdefault(tuple(plan.watermarks), []).append(plan)

    def delta_feed(group: List[_IncrementalPlan]):
        # the packed bytes format is keyed to the skip count: a bytes-kind
        # group that disagrees on it reads cold
        sidecar_ok = kind == "dataset" or len(
            {p.cfg.get_int("skip.field.count", 1) for p in group}) == 1
        for si, path in enumerate(inputs):
            size = os.path.getsize(path)
            start = group[0].watermarks[si]
            if start >= size:
                continue
            feed = _delta_feed(group[0], path, start, size, sidecar_ok)
            try:
                for off, length, fp_hash, payload in feed:
                    yield si, off, length, fp_hash, payload
            finally:
                feed.close()

    def fold_sink(plan: _IncrementalPlan):
        def consume(item) -> None:
            if item[4] is not None:
                plan.fold.consume(item[4])
        return consume

    def bookkeeper(group: List[_IncrementalPlan]):
        # after the folds (sink order), so a mid-scan checkpoint holds the
        # block, as in the solo driver
        def consume(item) -> None:
            si, off, length, fp_hash, _payload = item
            for plan in group:
                _plan_note_block(plan, si, off, length, fp_hash)
        return consume

    sc0 = sidecar.counters_snapshot()
    for group in groups.values():
        scan = SharedScan(delta_feed(group))
        for plan in group:
            scan.add_sink(fold_sink(plan), label=plan.canonical)
        scan.add_sink(bookkeeper(group), label="bookkeeper")
        t0 = obs.now()
        n_chunks = scan.run()
        obs.record("job.dispatch", t0, mode="incremental_shared",
                   chunks=n_chunks,
                   jobs=",".join(p.canonical for p in group))
    results: Dict[str, JobResult] = {}
    for plan in plans:
        res = _plan_finish(plan)
        _note_sidecar_counters(plan.canonical, res, sc0)
        results[plan.canonical] = res
    return results


# =================================================================== bayesian
@job("bayesianDistr", "bad", "org.avenir.bayesian.BayesianDistribution")
def bayesian_distribution(cfg: JobConfig, inputs: List[str], output: str,
                          device: torch.device) -> JobResult:
    """Naive Bayes sufficient statistics -> CSV model file and its stamp.
    Input blocks stream through `stream_job_inputs` (host memory O(block),
    `bad.stream.block.size.mb`); counts are additive, so the chunking
    cannot change the model. `bad.tabular.input=false` switches to the
    free-text mode: rows are `text,classVal`, each token contributes a
    (classVal, token) count (BayesianDistribution.mapText, :186-195)."""
    if not cfg.get_bool("tabular.input", True):
        return _text_distribution(cfg, inputs, output, device)
    return _stream_fold_job("bayesianDistr", cfg, inputs, output, device)


def _text_distribution(cfg: JobConfig, inputs: List[str], output: str,
                       device: torch.device) -> JobResult:
    """bayesianDistr's free-text mode: token counts folded a line block
    at a time (mapText's per-line contract), then the model CSV."""
    from avenir_tpu_torch.core.stream import iter_line_blocks, prefetched
    from avenir_tpu_torch.models.text import TextNaiveBayes

    tmodel = TextNaiveBayes(device=device)
    rows = 0
    block = int(cfg.get_float("stream.block.size.mb", 64.0) * (1 << 20))
    delim = cfg.field_delim_regex
    for path in inputs:
        lineno = 0
        for chunk, lines in enumerate(prefetched(iter_line_blocks(path,
                                                                  block))):
            t0 = obs.now()
            texts, labels = [], []
            for ln in lines:
                lineno += 1
                text, sep, cls = ln.rpartition(delim)
                if not sep:
                    raise ValueError(
                        f"{path}:{lineno}: text-mode row has no {delim!r} "
                        f"delimiter (want text,classVal)")
                texts.append(text)
                labels.append(cls.strip())
            obs.record("stream.parse", t0, nbytes=-1, engine="text")
            with obs.span("stream.fold", sink="bayesianDistr", chunk=chunk):
                tmodel.accumulate(texts, labels)
            rows += len(texts)
    with obs.span("job.finish", job="bayesianDistr"):
        out = _out_file(output)
        tmodel.finish()
        tmodel.save(out, delim=cfg.field_delim)
    return JobResult("bayesianDistr", {"Distribution Data:Records": rows},
                     [out])


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


# ==================================================================== explore
@job("mutualInformation", "mut", "org.avenir.explore.MutualInformation")
def mutual_information_job(cfg: JobConfig, inputs: List[str], output: str,
                           device: torch.device) -> JobResult:
    """Feature-class and feature-pair mutual information and the
    `mut.mutual.info.score.algorithms` selection scores. The count tables
    fold a chunk at a time (host memory O(block)), the mapper contract of
    MutualInformation.java:138-216."""
    return _stream_fold_job("mutualInformation", cfg, inputs, output, device)


@job("fisherDiscriminant", "fid",
     "org.avenir.discriminant.FisherDiscriminant")
def fisher_job(cfg: JobConfig, inputs: List[str], output: str,
               device: torch.device) -> JobResult:
    """Per-numeric-feature two-class boundary file (and its stamp) from
    float64 per-class moments folded a chunk at a time."""
    return _stream_fold_job("fisherDiscriminant", cfg, inputs, output, device)


def _contingency(name: str, cfg: JobConfig, inputs: List[str],
                 device: torch.device,
                 schema: Optional[FeatureSchema] = None):
    """The ContingencyAccumulator of every chunk of `inputs`, parsed
    against `schema` (the job's own by default), whose discovered
    vocabularies grow as the chunks arrive."""
    from avenir_tpu_torch.core.stream import stream_job_inputs
    from avenir_tpu_torch.models.explore import ContingencyAccumulator

    acc = ContingencyAccumulator(device)
    _drive_fold(acc.add, stream_job_inputs(cfg, inputs, schema or _schema(cfg)),
                name)
    if acc.n == 0:
        raise ValueError(f"{name}: empty input (no records in {inputs})")
    return acc


def _write_by_ordinal(name: str, cfg: JobConfig, output: str,
                      corr: Dict[int, float], rows: int) -> JobResult:
    """`ordinal,value` a field, in ordinal order."""
    with obs.span("job.finish", job=name):
        out = _out_file(output)
        delim = cfg.field_delim
        with open(out, "w") as fh:
            for ordinal, v in sorted(corr.items()):
                fh.write(f"{ordinal}{delim}{v:.6f}\n")
    return JobResult(name, {"Basic:Records": rows}, [out])


def _cramer(name: str, cfg: JobConfig, inputs: List[str], output: str,
            device: torch.device) -> JobResult:
    acc = _contingency(name, cfg, inputs, device)
    return _write_by_ordinal(name, cfg, output, acc.cramer(), acc.n)


@job("cramerCorrelation", "crc", "org.avenir.explore.CramerCorrelation")
def cramer_job(cfg: JobConfig, inputs: List[str], output: str,
               device: torch.device) -> JobResult:
    """Cramér index of each encodable feature against the class."""
    return _cramer("cramerCorrelation", cfg, inputs, output, device)


@job("categoricalCorrelation", "cac",
     "org.avenir.explore.CategoricalCorrelation")
def categorical_job(cfg: JobConfig, inputs: List[str], output: str,
                    device: torch.device) -> JobResult:
    """The cac.* job: the same contingency-table statistic as
    cramerCorrelation (CramerCorrelation.java:54)."""
    return _cramer("categoricalCorrelation", cfg, inputs, output, device)


@job("heterogeneityReduction", "hrc",
     "org.avenir.explore.HeterogeneityReductionCorrelation")
def heterogeneity_job(cfg: JobConfig, inputs: List[str], output: str,
                      device: torch.device) -> JobResult:
    """Proportional class impurity reduction by each feature, under
    `hrc.heterogeneity.algorithm` (entropy, else gini)."""
    acc = _contingency("heterogeneityReduction", cfg, inputs, device)
    corr = acc.heterogeneity(cfg.get("heterogeneity.algorithm", "entropy"))
    return _write_by_ordinal("heterogeneityReduction", cfg, output, corr,
                             acc.n)


@job("numericalCorrelation", "nuc",
     "org.avenir.explore.NumericalCorrelation")
def numerical_corr_job(cfg: JobConfig, inputs: List[str], output: str,
                       device: torch.device) -> JobResult:
    """Pearson correlation of each numeric feature pair and of each
    feature with the numeric-coded class, from float64 host moments."""
    from avenir_tpu_torch.core.stream import stream_job_inputs
    from avenir_tpu_torch.models.explore import NumericMomentAccumulator

    schema = _schema(cfg)
    acc = NumericMomentAccumulator()
    _drive_fold(acc.add, stream_job_inputs(cfg, inputs, schema),
                "numericalCorrelation")
    if acc.n == 0:
        raise ValueError(f"numericalCorrelation: empty input "
                         f"(no records in {inputs})")
    with obs.span("job.finish", job="numericalCorrelation"):
        corr = acc.correlation()       # [D+1, D+1]: the class is the last
        fields = [f.ordinal for f in schema.feature_fields if f.is_numeric]
        out = _out_file(output)
        delim = cfg.field_delim
        with open(out, "w") as fh:
            for i, oi in enumerate(fields):
                for j, oj in enumerate(fields):
                    if j > i:
                        fh.write(f"{oi}{delim}{oj}{delim}{corr[i, j]:.6f}\n")
                fh.write(f"{oi}{delim}class{delim}{corr[i, -1]:.6f}\n")
    return JobResult("numericalCorrelation", {"Basic:Records": acc.n}, [out])


@job("ruleEvaluator", "rue", "org.avenir.explore.RuleEvaluator")
def rule_evaluator(cfg: JobConfig, inputs: List[str], output: str,
                   device: torch.device) -> JobResult:
    """Support and confidence of each `rue.rule.<name>` definition
    `cond1 & cond2 => cons` (RuleEvaluator.java:48): every rule's
    (rows, cond, both) counts fold a chunk at a time on the host."""
    from avenir_tpu_torch.core.stream import stream_job_inputs
    from avenir_tpu_torch.models.explore import Rule

    names = cfg.assert_list("rule.names")
    cond_delim = cfg.get("cond.delim", "&")
    rules = {}
    for name in names:
        expr = cfg.assert_get(f"rule.{name}")
        if expr.count("=>") != 1:
            raise ValueError(
                f"{cfg.prefix}.rule.{name} must contain exactly one '=>' "
                f"(cond => cons), got: {expr!r}")
        cond_part, cons_part = expr.split("=>")
        rules[name] = Rule(
            [c.strip() for c in cond_part.split(cond_delim) if c.strip()],
            [c.strip() for c in cons_part.split(cond_delim) if c.strip()])
    totals = {name: [0, 0, 0] for name in names}

    def fold(chunk: Dataset) -> None:
        for name, rule in rules.items():
            for i, v in enumerate(rule.counts(chunk)):
                totals[name][i] += v

    _drive_fold(fold, stream_job_inputs(cfg, inputs, _schema(cfg)),
                "ruleEvaluator")
    rows = totals[names[0]][0]
    if rows == 0:
        raise ValueError(f"ruleEvaluator: empty input (no records in {inputs})")
    with obs.span("job.finish", job="ruleEvaluator"):
        out = _out_file(output)
        delim = cfg.field_delim
        with open(out, "w") as fh:
            for name in names:
                res = Rule.finalize(*totals[name])
                fh.write(f"{name}{delim}{res['support']:.6f}{delim}"
                         f"{res['confidence']:.6f}\n")
    return JobResult("ruleEvaluator", {"Basic:Records": rows}, [out])


@job("reliefFeatureRelevance", "ffr",
     "org.avenir.explore.ReliefFeatureRelevance")
def relief_job(cfg: JobConfig, inputs: List[str], output: str,
               device: torch.device) -> JobResult:
    """Relief relevance of each feature over `ffr.sample.size` seeded
    records (all of them by default), the nearest hits and misses found
    on the device."""
    from avenir_tpu_torch.core.stream import read_dataset
    from avenir_tpu_torch.models.explore import relief_relevance

    ds = read_dataset(cfg, inputs[0], _schema(cfg))
    with obs.span("stream.fold", sink="reliefFeatureRelevance"):
        rel = relief_relevance(ds, sample_size=cfg.get_int("sample.size"),
                               device=device)
    outputs = _write_by_ordinal("reliefFeatureRelevance", cfg, output, rel,
                                0).outputs
    return JobResult("reliefFeatureRelevance", {}, outputs)


def _categorical_tables(name: str, cfg: JobConfig, inputs: List[str],
                        output: str, device: torch.device, rows_of):
    """Each categorical field's contingency table folded over `inputs`,
    `rows_of(fld, table, class_values)` its output lines, written in
    ordinal order."""
    schema = _schema(cfg)
    acc = _contingency(name, cfg, inputs, device, schema)
    with obs.span("job.finish", job=name):
        out = _out_file(output)
        with open(out, "w") as fh:
            for fld in schema.feature_fields:
                if fld.is_categorical and fld.ordinal in acc.tables:
                    fh.writelines(rows_of(fld, acc.tables[fld.ordinal],
                                          schema.class_values()))
    return JobResult(name, {"Basic:Records": acc.n}, [out])


@job("categoricalClassAffinity", "cca",
     "org.avenir.explore.CategoricalClassAffinity")
def class_affinity_job(cfg: JobConfig, inputs: List[str], output: str,
                       device: torch.device) -> JobResult:
    """Per categorical field and class, the `cca.top.count` values (3 by
    default) most probable given the class."""
    from avenir_tpu_torch.models.explore import class_affinity_from_table

    top_n = cfg.get_int("top.count", 3)
    delim = cfg.field_delim

    def rows_of(fld, tab, classes):
        aff = class_affinity_from_table(tab, fld, classes, top_n)
        return [f"{fld.ordinal}{delim}{cv}{delim}{val}{delim}{score:.6f}\n"
                for cv, pairs in aff.items() for val, score in pairs]

    return _categorical_tables("categoricalClassAffinity", cfg, inputs,
                               output, device, rows_of)


@job("categoricalContinuousEncoding", "coe",
     "org.avenir.explore.CategoricalContinuousEncoding")
def supervised_encoding_job(cfg: JobConfig, inputs: List[str], output: str,
                            device: torch.device) -> JobResult:
    """Each categorical value's code under `coe.encoding.strategy`
    (supervisedRatio, or weightOfEvidence) against
    `coe.pos.class.attr.value` (the second class by default)."""
    from avenir_tpu_torch.models.explore import supervised_encoding_from_table

    strategy = cfg.get("encoding.strategy", "supervisedRatio")
    pos = cfg.get("pos.class.attr.value")
    delim = cfg.field_delim

    def rows_of(fld, tab, classes):
        enc = supervised_encoding_from_table(tab, fld, classes,
                                             strategy=strategy, pos_class=pos)
        return [f"{fld.ordinal}{delim}{val}{delim}{code:.6f}\n"
                for val, code in enc.items()]

    return _categorical_tables("categoricalContinuousEncoding", cfg, inputs,
                               output, device, rows_of)


@job("topMatchesByClass", "tmc", "org.avenir.explore.TopMatchesByClass")
def top_matches_job(cfg: JobConfig, inputs: List[str], output: str,
                    device: torch.device) -> JobResult:
    """Each record's `tmc.top.match.count` nearest same-class records
    (3 by default), `class,id,id:dist,...` with 4-decimal distances."""
    from avenir_tpu_torch.core.stream import read_dataset
    from avenir_tpu_torch.models.explore import top_matches_by_class

    ds = read_dataset(cfg, inputs[0], _schema(cfg))
    with obs.span("stream.fold", sink="topMatchesByClass"):
        matches = top_matches_by_class(
            ds, k=cfg.get_int("top.match.count", 3), device=device)
    n = 0
    with obs.span("job.finish", job="topMatchesByClass"):
        out = _out_file(output)
        delim = cfg.field_delim
        ids = ds.ids()
        y = ds.labels()
        cls_vals = ds.schema.class_values()
        with open(out, "w") as fh:
            for cv, (dist, idx) in matches.items():
                rows = np.flatnonzero(y == cls_vals.index(cv))
                for r in range(dist.shape[0]):
                    fh.write(delim.join(
                        [cv, str(ids[rows[r]])]
                        + [f"{ids[idx[r, j]]}:{dist[r, j]:.4f}"
                           for j in range(dist.shape[1])]) + "\n")
                    n += 1
    return JobResult("topMatchesByClass", {"Basic:Records": n}, [out])


def _sampler(name: str, cfg: JobConfig, inputs: List[str], output: str,
             draw) -> JobResult:
    """A map-only row sampler: the rows `draw` keeps, passed through
    byte-identical."""
    from avenir_tpu_torch.core.stream import read_dataset

    ds = read_dataset(cfg, inputs[0], _schema(cfg), keep_raw=True)
    sampled = draw(ds)
    with obs.span("job.finish", job=name):
        out = _out_file(output)
        with open(out, "w") as fh:
            fh.write(sampled.to_csv(cfg.field_delim) if len(sampled) else "")
    return JobResult(name, {"Basic:Records": len(sampled)}, [out])


@job("underSamplingBalancer", "usb",
     "org.avenir.explore.UnderSamplingBalancer")
def undersampling_job(cfg: JobConfig, inputs: List[str], output: str,
                      device: torch.device) -> JobResult:
    """Every class undersampled to the smallest one's count (`usb.seed`)."""
    from avenir_tpu_torch.models.explore import undersample_balance

    return _sampler("underSamplingBalancer", cfg, inputs, output,
                    lambda ds: undersample_balance(
                        ds, seed=cfg.get_int("seed", 0)))


@job("baggingSampler", "bas", "org.avenir.explore.BaggingSampler")
def bagging_job(cfg: JobConfig, inputs: List[str], output: str,
                device: torch.device) -> JobResult:
    """A bootstrap sample of `bas.sample.rate` x n rows (`bas.seed`)."""
    from avenir_tpu_torch.models.explore import bagging_sample

    return _sampler("baggingSampler", cfg, inputs, output,
                    lambda ds: bagging_sample(
                        ds, rate=cfg.get_float("sample.rate", 1.0),
                        seed=cfg.get_int("seed", 0)))


# ==================================================================== cluster
@job("agglomerativeGraphical", "agg",
     "org.avenir.cluster.AgglomerativeGraphical")
def agglomerative_job(cfg: JobConfig, inputs: List[str], output: str,
                      device: torch.device) -> JobResult:
    """Greedy agglomerative clustering over a pairwise-distance file
    (`agg.distance.file.path`, else the input; AgglomerativeGraphical.java:
    108): `id,cluster` a line in id order."""
    from avenir_tpu_torch.models.cluster import AgglomerativeGraphical
    from avenir_tpu_torch.models.similarity import (distance_matrix_from_file,
                                                    read_distance_file)

    dist_path = cfg.get("distance.file.path") or inputs[0]
    t0 = obs.now()
    pairs = read_distance_file(dist_path, delim=cfg.field_delim_regex,
                               scale=cfg.get_int("distance.scale", 1000))
    obs.record("stream.read", t0, path=dist_path)
    ids = sorted({a for a, _ in pairs})
    with obs.span("stream.fold", sink="agglomerativeGraphical"):
        model = AgglomerativeGraphical(
            num_clusters=cfg.get_int("num.clusters", 2),
            max_avg_distance=cfg.get_float("max.avg.distance"),
        ).fit(distance_matrix_from_file(dist_path, ids, pairs=pairs))
    with obs.span("job.finish", job="agglomerativeGraphical"):
        out = _out_file(output)
        delim = cfg.field_delim
        with open(out, "w") as fh:
            for i, rid in enumerate(ids):
                fh.write(f"{rid}{delim}{int(model.labels_[i])}\n")
    return JobResult("agglomerativeGraphical",
                     {"Cluster:Count": len(set(model.labels_.tolist()))},
                     [out])


@job("clusterTrain", "train", "kmeansCluster")
def cluster_train_job(cfg: JobConfig, inputs: List[str], output: str,
                      device: torch.device) -> JobResult:
    """k-means (`train.num.clusters`, `train.num.iters`) or DBSCAN
    (`train.eps`, `train.min.samples`) over the schema's numeric features
    (unsupv/cluster.py:24-60): `id,label` a row, and the cohesion of the
    labels as `Cluster:Cohesion`."""
    from avenir_tpu_torch.core.stream import read_dataset
    from avenir_tpu_torch.models.cluster import (DBSCAN, KMeans, cohesion,
                                                 dataset_distance_matrix)

    ds = read_dataset(cfg, inputs[0], _schema(cfg))
    x = ds.feature_matrix()
    algo = cfg.get("algo", "kmeans")
    with obs.span("stream.fold", sink="clusterTrain"):
        if algo == "kmeans":
            labels = KMeans(k=cfg.get_int("num.clusters", 3),
                            iters=cfg.get_int("num.iters", 100),
                            device=device).fit(x).labels_
        elif algo == "dbscan":
            labels = DBSCAN(eps=cfg.get_float("eps", 0.5),
                            min_samples=cfg.get_int("min.samples", 4)).fit(
                dataset_distance_matrix(ds, device=device)).labels_
        else:
            raise ValueError(f"unknown cluster algo {algo!r}")
    with obs.span("job.finish", job="clusterTrain"):
        out = _out_file(output)
        delim = cfg.field_delim
        with open(out, "w") as fh:
            for rid, lab in zip(ds.ids(), labels):
                fh.write(f"{rid}{delim}{int(lab)}\n")
        coh = (float(cohesion(x, np.asarray(labels)))
               if len(set(labels)) > 1 else 0.0)
    return JobResult("clusterTrain", {"Cluster:Cohesion": coh}, [out])


# ==================================================================== regress
@job("logisticRegression", "lrj", "org.avenir.regress.LogisticRegressionJob")
def logistic_regression_job(cfg: JobConfig, inputs: List[str], output: str,
                            device: torch.device) -> JobResult:
    """In-process epochs for the reference's loop of MR jobs
    (LogisticRegressionJob.java:95-119): the coefficient history goes to
    `lrj.coeff.file.path` (else `coeff.txt` in the output), and the
    CONVERGED (100) / NOT_CONVERGED (101) exit status to
    `Regression:ExitStatus`."""
    from avenir_tpu_torch.core.stream import read_dataset
    from avenir_tpu_torch.models.regress import LogisticRegression

    ds = read_dataset(cfg, inputs[0], _schema(cfg))
    with obs.span("stream.fold", sink="logisticRegression"):
        lr = LogisticRegression(
            iteration_limit=cfg.get_int("iteration.limit", 10),
            convergence_criteria=cfg.get("convergence.criteria", "iterLimit"),
            convergence_threshold=cfg.get_float("convergence.threshold", 5.0),
            pos_class=cfg.get("positive.class.value"),
            device=device).fit(ds)
    with obs.span("job.finish", job="logisticRegression"):
        coeff_path = cfg.get("coeff.file.path") or _out_file(output,
                                                             "coeff.txt")
        lr.save_coeff_history(coeff_path, delim=cfg.field_delim)
    return JobResult("logisticRegression",
                     {"Regression:ExitStatus": lr.check_convergence()},
                     [coeff_path])


# ======================================================================= tree
def _tree_builder(cfg: JobConfig, schema: FeatureSchema,
                  device: torch.device):
    from avenir_tpu_torch.models.tree import DecisionTreeBuilder

    return DecisionTreeBuilder(
        schema,
        split_algorithm=cfg.get("split.algorithm", "entropy"),
        max_depth=cfg.get_int("max.depth.limit", 3),
        min_info_gain=cfg.get_float("min.info.gain.limit", -1.0),
        min_population=cfg.get_int("min.population.limit", -1),
        stopping_strategy=cfg.get("path.stopping.strategy", "maxDepth"),
        attr_selection_strategy=cfg.get("split.attribute.selection.strategy",
                                        "notUsedYet"),
        device=device,
    )


@job("decTree", "dtb", "org.avenir.tree.DecisionTreeBuilder", "decisionTree")
def decision_tree(cfg: JobConfig, inputs: List[str], output: str,
                  device: torch.device) -> JobResult:
    """Decision-tree build; the reference's per-level MR iteration with
    decPathIn/decPathOut file rotation (resource/detr.sh:34-54) runs as an
    in-process level loop (each level a `stream.fold` span), and the
    DecisionPathList JSON lands at `dtb.decision.file.path.out`."""
    from avenir_tpu_torch.core.stream import read_dataset

    ds = read_dataset(cfg, inputs[0], _schema(cfg))
    # build against the dataset's OWN schema object: parsing may have
    # discovered vocabularies that a fresh load lacks
    paths = _tree_builder(cfg, ds.schema, device).fit(ds)
    with obs.span("job.finish", job="decTree"):
        out = (cfg.get("decision.file.path.out")
               or _out_file(output, "decPathOut.txt"))
        paths.save(out)
    return JobResult("decTree", {"Tree:Paths": len(paths.paths)}, [out],
                     paths)


@job("randomForest", "dtb", "org.avenir.tree.RandomForestBuilder")
def random_forest(cfg: JobConfig, inputs: List[str], output: str,
                  device: torch.device) -> JobResult:
    """A forest of `dtb.num.trees` trees over bootstrap (or sampled) row
    weights, grown together a level at a time; `tree-NNN.json` a tree
    under the output directory."""
    from avenir_tpu_torch.core.stream import read_dataset
    from avenir_tpu_torch.models.tree import RandomForestBuilder

    ds = read_dataset(cfg, inputs[0], _schema(cfg))
    forest = RandomForestBuilder(
        ds.schema,
        num_trees=cfg.get_int("num.trees", 10),
        sampling=cfg.get("sub.sampling.strategy", "withReplace"),
        sample_rate=cfg.get_float("sub.sampling.rate", 0.7),
        split_algorithm=cfg.get("split.algorithm", "entropy"),
        max_depth=cfg.get_int("max.depth.limit", 3),
        stopping_strategy=cfg.get("path.stopping.strategy", "maxDepth"),
        device=device,
    ).fit(ds)
    outs = []
    with obs.span("job.finish", job="randomForest"):
        if output:
            os.makedirs(output, exist_ok=True)
            for t, tree in enumerate(forest.trees):
                p = os.path.join(output, f"tree-{t:03d}.json")
                tree.save(p)
                outs.append(p)
    return JobResult("randomForest", {"Tree:Trees": len(forest.trees)}, outs,
                     forest)


@job("classPartitionGenerator", "cpg",
     "org.avenir.explore.ClassPartitionGenerator",
     "splitGenerator", "org.avenir.tree.SplitGenerator")
def class_partition_job(cfg: JobConfig, inputs: List[str], output: str,
                        device: torch.device) -> JobResult:
    """Candidate-split class-histogram stats (cpg.* keys; the reference's
    two-job tree flow stage, ClassPartitionGenerator.java:61): one
    `attribute,splitId,stat` line a candidate split. Also answers to
    org.avenir.tree.SplitGenerator, the tree package's candidate-split
    stats base job."""
    from avenir_tpu_torch.core.stream import read_dataset
    from avenir_tpu_torch.models.explore import ClassPartitionGenerator

    ds = read_dataset(cfg, inputs[0], _schema(cfg))
    with obs.span("stream.fold", sink="classPartitionGenerator"):
        cpg = ClassPartitionGenerator(
            ds, attributes=cfg.get_int_list("split.attributes"),
            algorithm=cfg.get("split.algorithm",
                              cfg.get("algorithm", "giniIndex")),
            device=device)
    with obs.span("job.finish", job="classPartitionGenerator"):
        out = _out_file(output)
        delim = cfg.field_delim
        with open(out, "w") as fh:
            for s, stat in cpg.split_stats():
                fh.write(f"{s.attribute}{delim}{s.split_id}{delim}"
                         f"{stat:.6f}\n")
    return JobResult("classPartitionGenerator",
                     {"Splits:Candidates": len(cpg.splits)}, [out], cpg)


@job("dataPartitioner", "dap", "org.avenir.tree.DataPartitioner")
def data_partitioner_job(cfg: JobConfig, inputs: List[str], output: str,
                         device: torch.device) -> JobResult:
    """The rows of each segment of the best split (of
    `dap.split.attribute`, else of any attribute) to
    `<dap.project.base.path or output>/split=<id>/segment=<j>/data`."""
    from avenir_tpu_torch.core.stream import read_dataset
    from avenir_tpu_torch.models.tree import DataPartitioner

    # keep_raw: partition output must pass rows through byte-identical
    # (reconstruction would reformat numerics and break on missing values)
    ds = read_dataset(cfg, inputs[0], _schema(cfg), keep_raw=True)
    dp = DataPartitioner(
        ds.schema,
        algorithm=cfg.get("split.algorithm", "giniIndex"),
        split_attribute=cfg.get_int("split.attribute"),
        device=device,
    )
    with obs.span("stream.fold", sink="dataPartitioner"):
        split, _ = dp.best_split(ds)
    with obs.span("job.finish", job="dataPartitioner"):
        paths = dp.partition(ds, cfg.get("project.base.path") or output,
                             delim=cfg.field_delim, split=split)
    return JobResult("dataPartitioner", {"Partition:Segments": len(paths)},
                     paths)


# ======================================================================= text
@job("wordCounter", "wco", "org.avenir.text.WordCounter",
     "org.avenir.sanity.WordCount")
def word_counter_job(cfg: JobConfig, inputs: List[str], output: str,
                     device: torch.device) -> JobResult:
    """Token counts of one CSV field (`wco.text.field.ordinal`) or of
    whole lines, folded a line block at a time (host memory O(block +
    vocabulary), WordCounter's mapper contract): `token,count` lines in
    token order. Host work only."""
    from avenir_tpu_torch.core.stream import stream_job_lines
    from avenir_tpu_torch.models.text import WordCounter

    wc = WordCounter(text_field_ordinal=cfg.get_int("text.field.ordinal", -1),
                     delim=cfg.field_delim_regex)
    counts: Dict[str, int] = {}
    for chunk, lines in enumerate(stream_job_lines(cfg, inputs)):
        with obs.span("stream.fold", sink="wordCounter", chunk=chunk):
            for word, c in wc.count(lines):
                counts[word] = counts.get(word, 0) + c
    with obs.span("job.finish", job="wordCounter"):
        out = _out_file(output)
        delim = cfg.field_delim
        with open(out, "w") as fh:
            for word in sorted(counts):
                fh.write(f"{word}{delim}{counts[word]}\n")
    return JobResult("wordCounter", {"Words:Unique": len(counts)}, [out])


# ================================================================ association
def _read_lines(path: str) -> List[str]:
    """The non-blank lines of a text file (universal newlines)."""
    with open(path) as fh:
        return [ln.rstrip("\n") for ln in fh if ln.strip()]


def _parse_sequences(lines: Sequence[str], delim: str, skip: int,
                     class_ord: Optional[int] = None):
    """Rows -> (ids, sequences, labels). The first `skip` fields are meta
    (id, class); `class_ord` points into the whole row. Tokens are trimmed
    of space, tab and CR, the native `seq_encode`'s trim, so the Python
    and native sequence routes tokenize alike."""
    ids, seqs, labels = [], [], []
    for ln in lines:
        toks = [t.strip(" \t\r") for t in ln.split(delim)]
        ids.append(toks[0] if skip > 0 else "")
        labels.append(toks[class_ord] if class_ord is not None else None)
        seqs.append(toks[skip:])
    return ids, seqs, labels


def _read_sequences(path: str, delim: str, skip: int,
                    class_ord: Optional[int] = None):
    return _parse_sequences(_read_lines(path), delim, skip, class_ord)


def _validate(class_values: Sequence[str], actual: np.ndarray,
              predicted: np.ndarray, pos_class: int) -> Dict[str, float]:
    """ConfusionMatrix.counters(): the reference's "Validation" counter
    group (BayesianPredictor.java:170-180, int-percent scaled)."""
    cm = ConfusionMatrix(class_values, pos_class=pos_class)
    cm.add(actual, predicted)
    return cm.counters()


def _miner_resident(job: str, cfg: JobConfig, rows: List[List[str]]):
    """The in-RAM set of a miner's split rows (Apriori's TransactionSet,
    GSP's SequenceSet), or None when its device matrix would reach 2 GiB:
    Apriori's [N, V] multi-hot matrix, which a wide item catalog can make
    far larger than the file, or GSP's padded int32 [N, T], which one
    long row can."""
    skip = cfg.get_int("skip.field.count", 1)
    if job == _APRIORI:
        from avenir_tpu_torch.models.association import TransactionSet

        marker = cfg.get("infreq.item.marker")
        vocab = {tok for row in rows for tok in row[skip:]
                 if tok and tok != marker}
        if len(rows) * max(len(vocab), 1) >= (2 << 30):
            return None
        return TransactionSet.from_rows(
            rows, trans_id_ord=cfg.get_int("tans.id.ord", 0),
            skip_field_count=skip, marker=marker)
    from avenir_tpu_torch.models.sequence import SequenceSet

    t_max = max((len(r) - skip for r in rows), default=1)
    if len(rows) * max(t_max, 1) * 4 >= (2 << 30):
        return None
    return SequenceSet.from_token_rows(rows, skip_field_count=skip)


def _miner_job(job: str, cfg: JobConfig, inputs: List[str], output: str,
               device: torch.device) -> JobResult:
    """A multi-pass miner's every round in one job. Inputs under 256 MB
    with no `stream.block.size.mb` whose device matrix stays under 2 GiB
    (`_miner_resident`) are mined in RAM: each file's read a
    `stream.read` span, the rows' split and encode a `stream.parse` span,
    the rounds a `stream.fold` span of sink `apriori_resident` or
    `gsp_resident`. The others are streamed."""
    miner = _build_miner(job, cfg, device)
    total_bytes = sum(os.path.getsize(p) for p in inputs
                      if os.path.exists(p))
    in_ram = (cfg.get("stream.block.size.mb") is None
              and total_bytes < (256 << 20))
    # the clock starts before the in-RAM read, so RowsPerSec prices both
    # routes' reads alike
    t0 = time.perf_counter()
    resident = None
    cache: Dict[str, float] = {}
    if in_ram:
        lines: List[str] = []
        for path in inputs:
            t_read = obs.now()
            lines.extend(_read_lines(path))
            obs.record("stream.read", t_read, path=path,
                       nbytes=os.path.getsize(path))
        t_parse = obs.now()
        delim = cfg.field_delim_regex
        rows = [[t.strip(" \t\r") for t in ln.split(delim)] for ln in lines]
        del lines
        resident = _miner_resident(job, cfg, rows)
    if resident is not None:
        obs.record("stream.parse", t_parse, sink=type(resident).__name__,
                   nbytes=total_bytes, engine="python")
        t_fold = obs.now()
        levels = miner.mine(resident)
        obs.record("stream.fold", t_fold,
                   sink="apriori_resident" if job == _APRIORI
                   else "gsp_resident")
        n_rows = len(rows)
    else:
        # streamed: the rounds after pass 1 replay its encoded-block cache
        src = _build_miner_source(job, cfg, inputs,
                                  cfg.get_bool("stream.encoded.cache", True))
        levels = miner.mine_stream(src)
        n_rows = _source_rows(job, src)
        cache = _cache_counters(src)
        src.close()
    return finish_miner_levels(job, cfg, levels, n_rows,
                               time.perf_counter() - t0, output, cache)


@job("frequentItemsApriori", "fia",
     "org.avenir.association.FrequentItemsApriori", "apriori")
def apriori_job(cfg: JobConfig, inputs: List[str], output: str,
                device: torch.device) -> JobResult:
    """Every round in one job (`_miner_job`); the per-k itemset files
    `itemsets-<k>.txt` in the directory `output`, as the reference's
    per-round outputs."""
    return _miner_job(_APRIORI, cfg, inputs, output, device)


# =================================================================== sequence
@job("candidateGenerationWithSelfJoin", "cgs",
     "org.avenir.sequence.CandidateGenerationWithSelfJoin", "gspMiner")
def gsp_job(cfg: JobConfig, inputs: List[str], output: str,
            device: torch.device) -> JobResult:
    """GSP frequent sequences: every round up to cgs.item.set.length in one
    job (CandidateGenerationWithSelfJoin.java:44-49; `_miner_job`), the
    per-k files `sequences-<k>.txt` in the directory `output`."""
    return _miner_job(_GSP, cfg, inputs, output, device)


@job("sequencePositionalCluster", "spc",
     "org.avenir.sequence.SequencePositionalCluster")
def positional_cluster_job(cfg: JobConfig, inputs: List[str], output: str,
                           device: torch.device) -> JobResult:
    """High-locality window positions of an event stream
    (SequencePositionalCluster.java:49): `position,score` a window, host
    float64."""
    from avenir_tpu_torch.models.sequence import (EventLocalityAnalyzer,
                                                  positional_cluster)

    analyzer = EventLocalityAnalyzer(
        window_time_span=cfg.assert_float("window.time.span"),
        time_step=cfg.get_float("window.time.step", 1.0),
        score_threshold=cfg.get_float("score.threshold", 0.5),
        min_occurence=cfg.get_int("min.occurence", 2))
    rows = [[t.strip() for t in ln.split(cfg.field_delim_regex)]
            for p in inputs for ln in _read_lines(p)]
    thresh = cfg.get_float("quant.threshold")
    cond = (lambda v: v >= thresh) if thresh is not None else \
        (lambda v: True)
    clusters = positional_cluster(rows, analyzer,
                                  cfg.get_int("quant.field.ordinal", 2),
                                  cfg.get_int("seq.num.field.ordinal", 1),
                                  cond)
    out = _out_file(output)
    delim = cfg.field_delim
    with obs.span("job.finish", job="sequencePositionalCluster"):
        with open(out, "w") as fh:
            for pos, score in clusters:
                fh.write(f"{pos:.4f}{delim}{score:.6f}\n")
    return JobResult("sequencePositionalCluster",
                     {"Windows:Found": len(clusters)}, [out])


def _sequence_sort_key(seq_field: int):
    """A value record's sort key: its seq field as a number, a NaN or a
    non-number after every number (then by its text)."""
    def key(rec: List[str]) -> Tuple[float, str]:
        v = rec[seq_field]
        try:
            f = float(v)
        except ValueError:
            return (float("inf"), v)
        return (float("inf"), v) if math.isnan(f) else (f, "")

    return key


@job("sequenceGenerator", "seg", "org.avenir.spark.sequence.SequenceGenerator")
def sequence_generator_job(cfg: JobConfig, inputs: List[str], output: str,
                           device: torch.device) -> JobResult:
    """Sequences from event rows (SequenceGenerator.scala:31): rows grouped
    by seg.id.field.ordinals, each row's seg.val.field.ordinals kept as a
    value record, a group's records sorted by seg.seq.field (an index
    into the record); one line an entity, sorted by key: the key fields,
    then the sorted records flattened."""
    key_ords = cfg.get_int_list("id.field.ordinals", [0])
    val_ords = [int(v) for v in cfg.assert_list("val.field.ordinals")]
    sort_key = _sequence_sort_key(cfg.assert_int("seq.field"))
    by_key: Dict[str, List[List[str]]] = {}
    for p in inputs:
        for ln in _read_lines(p):
            toks = [t.strip() for t in ln.split(cfg.field_delim_regex)]
            key = cfg.field_delim.join(toks[o] for o in key_ords)
            by_key.setdefault(key, []).append([toks[o] for o in val_ords])
    out = _out_file(output)
    delim = cfg.field_delim
    with obs.span("job.finish", job="sequenceGenerator"):
        with open(out, "w") as fh:
            for key, recs in sorted(by_key.items()):
                recs.sort(key=sort_key)
                flat = delim.join(tok for rec in recs for tok in rec)
                fh.write(f"{key}{delim}{flat}\n")
    return JobResult("sequenceGenerator", {"Basic:Entities": len(by_key)},
                     [out])


@job("associationRuleMiner", "arm",
     "org.avenir.association.AssociationRuleMiner")
def rule_miner_job(cfg: JobConfig, inputs: List[str], output: str,
                   device: torch.device) -> JobResult:
    """Rules over the per-k itemset files, in order k = 1, 2, ...:
    `ante:ante,cons:cons,confidence,support` a line, six decimals."""
    from avenir_tpu_torch.models.association import (AssociationRuleMiner,
                                                     ItemSetList)

    miner = AssociationRuleMiner(
        conf_threshold=cfg.assert_float("conf.threshold"),
        max_ante_size=cfg.get_int("max.ante.size", 3))
    levels = [ItemSetList.load(path, k, delim=cfg.field_delim)
              for k, path in enumerate(inputs, start=1)]
    rules = miner.mine(levels)
    out = _out_file(output)
    delim = cfg.field_delim
    with obs.span("job.finish", job="associationRuleMiner"):
        with open(out, "w") as fh:
            for r in rules:
                fh.write(f"{':'.join(r.antecedent)}{delim}"
                         f"{':'.join(r.consequent)}{delim}"
                         f"{r.confidence:.6f}{delim}{r.support:.6f}\n")
    return JobResult("associationRuleMiner", {"Rules:Count": len(rules)},
                     [out])


@job("infrequentItemMarker", "iim",
     "org.avenir.association.InfrequentItemMarker")
def infrequent_item_marker_job(cfg: JobConfig, inputs: List[str],
                               output: str, device: torch.device
                               ) -> JobResult:
    """Rows with the items not in the frequent 1-itemset file
    (`iim.item.set.file.path`, with transaction ids unless
    `iim.contains.trans.id=false`) replaced by `iim.infreq.item.marker`
    (default `*`), on the host (InfrequentItemMarker.java:41-46)."""
    from avenir_tpu_torch.models.association import (InfrequentItemMarker,
                                                     ItemSetList)

    length = cfg.get_int("item.set.length", 1)
    if length != 1:
        raise ValueError("expecting item set of length 1")
    isl = ItemSetList.load(
        cfg.assert_get("item.set.file.path"), length,
        with_trans_ids=cfg.get_bool("contains.trans.id", True),
        delim=cfg.get("itemset.delim", ","))
    marker = InfrequentItemMarker(
        frequent_items=(s.items[0] for s in isl.item_sets),
        marker=cfg.get("infreq.item.marker", "*"),
        skip_field_count=cfg.get_int("skip.field.count", 1))
    out = _out_file(output)
    delim = cfg.field_delim
    n = marked = 0
    with open(out, "w") as fh:
        for path in inputs:
            for ln in _read_lines(path):
                row = [t.strip() for t in ln.split(cfg.field_delim_regex)]
                marked_row = marker.mark_row(row)
                marked += sum(a != b for a, b in zip(row, marked_row))
                n += 1
                fh.write(delim.join(marked_row) + "\n")
    return JobResult("infrequentItemMarker",
                     {"Basic:Records": n, "Marker:Replaced": marked}, [out])


# ==================================================================== bandits
def build_bandit_job(name: str, conf, device: DeviceLike = None):
    """The round job (`models.bandits`) of the bandit job `name` under
    `conf` (a properties path, a dict or a JobConfig), as the job builds
    it: a fresh key from PRNGKey(0)."""
    from avenir_tpu_torch.models.bandits import make_bandit_job

    canonical, cfg = _job_cfg(name, conf)
    kw: Dict[str, object] = {}
    if canonical == "greedyRandomBandit":
        kw = {"random_selection_prob":
              cfg.get_float("random.selection.prob", 0.1),
              "prob_reduction_algorithm":
              cfg.get("prob.reduction.algorithm", "linear"),
              "prob_reduction_constant":
              cfg.get_float("prob.reduction.constant", 1.0),
              "auer_greedy_constant":
              cfg.get_float("auer.greedy.constant", 1.0),
              "selection_unique": cfg.get_bool("selection.unique", False)}
    elif canonical == "softMaxBandit":
        kw = {"temp_constant": cfg.get_float("temp.constant", 1.0)}
    return make_bandit_job(canonical, cfg.get_int("global.batch.size", 1),
                           device=device, **kw)


def _bandit_round(name: str, cfg: JobConfig, inputs: List[str], output: str,
                  device: torch.device) -> JobResult:
    """One decision round of a batch bandit (`avenir_tpu/runner.py`
    `bandit_job`): the group item stats rows `group,item,count,reward`
    (the chombo RunningAggregator output the tutorial loops back,
    resource/price_optimize_tutorial.txt:55-82) in, the round's selected
    items a group out. The job starts from PRNGKey(0) and splits its key
    once, as the reference's does."""
    from avenir_tpu_torch.models.bandits import GroupBanditData

    data = GroupBanditData.from_lines(
        (ln for p in inputs for ln in _read_lines(p)),
        cfg.field_delim_regex, count_ord=cfg.get_int("count.ordinal", 2),
        reward_ord=cfg.get_int("reward.ordinal", 3))
    sel = build_bandit_job(name, cfg, device).select(
        data, cfg.get_int("current.round.num", 1))
    out = _out_file(output)
    with obs.span("job.finish", job=name):
        with open(out, "w") as fh:
            data.write_selections(
                sel, fh, cfg.field_delim,
                output_decision_count=cfg.get_bool("output.decision.count",
                                                   False))
    return JobResult(name, {"Bandit:Groups": len(data.group_ids)}, [out])


@job("greedyRandomBandit", "grb", "org.avenir.reinforce.GreedyRandomBandit")
def greedy_random_bandit_job(cfg: JobConfig, inputs: List[str], output: str,
                             device: torch.device) -> JobResult:
    """Epsilon-greedy: linear, logLinear or auerGreedy decay."""
    return _bandit_round("greedyRandomBandit", cfg, inputs, output, device)


@job("auerDeterministic", "aue", "org.avenir.reinforce.AuerDeterministic")
def auer_deterministic_job(cfg: JobConfig, inputs: List[str], output: str,
                           device: torch.device) -> JobResult:
    """UCB1, untried items first."""
    return _bandit_round("auerDeterministic", cfg, inputs, output, device)


@job("randomFirstGreedyBandit", "rfg",
     "org.avenir.reinforce.RandomFirstGreedyBandit")
def random_first_greedy_job(cfg: JobConfig, inputs: List[str], output: str,
                            device: torch.device) -> JobResult:
    """Uniform exploration for the first rounds, then greedy."""
    return _bandit_round("randomFirstGreedyBandit", cfg, inputs, output,
                         device)


@job("softMaxBandit", "smb", "org.avenir.reinforce.SoftMaxBandit")
def softmax_bandit_job(cfg: JobConfig, inputs: List[str], output: str,
                       device: torch.device) -> JobResult:
    """Boltzmann draws at temperature smb.temp.constant."""
    return _bandit_round("softMaxBandit", cfg, inputs, output, device)


# ===================================================================== markov
def _entity_keys(data: bytes, delim: str, key_ords: List[int],
                 n_rows: int) -> np.ndarray:
    """The per-entity key of each row of a block (its key columns joined
    with ','), through the native column extractor."""
    from avenir_tpu_torch.native.ingest import extract_column_native

    if not key_ords:
        # degenerate config (no id or class column): one key
        return np.full(n_rows, "")
    cols = [extract_column_native(data, delim, o) for o in key_ords]
    keys = cols[0]
    for col in cols[1:]:
        keys = np.char.add(np.char.add(keys, ","), col)
    return keys


def _markov_entities(cfg: JobConfig, inputs: List[str], output: str,
                     device: torch.device, states: List[str], scale: int,
                     id_ords: List[int]) -> JobResult:
    """The per-entity mode (the Spark job's `id.field.ordinals`,
    MarkovStateTransitionModel.scala:51-52): one matrix an entity key, the
    state sequence from `seq.start.ordinal`, the key split by class when
    `class.attr.ordinal` is set; `entity:<key>` sections in first-seen
    order. Natively: the states CSR-encoded, only the key columns made
    strings; else the Python rows."""
    from avenir_tpu_torch.core.stream import (stream_job_byte_blocks,
                                              stream_job_lines)
    from avenir_tpu_torch.models.markov import MarkovStateTransitionModel
    from avenir_tpu_torch.native.ingest import (native_seq_ready,
                                                seq_encode_native)

    class_ord = cfg.get_int("class.attr.ordinal")
    # mandatory in the Spark reference (getMandatoryIntParam, :54); the
    # default start skips the class column too
    key_ords = list(id_ords) + ([class_ord] if class_ord is not None else [])
    seq_start = cfg.get_int("seq.start.ordinal",
                            max(key_ords) + 1 if key_ords else 0)
    delim = cfg.field_delim_regex
    model = MarkovStateTransitionModel(states, scale=scale, device=device)
    if native_seq_ready(delim):
        model.class_labels = []
        model.counts = np.zeros((0,) + model.counts.shape[1:], np.float64)
        index: Dict[str, int] = {}
        for data in stream_job_byte_blocks(cfg, inputs):
            t0 = obs.now()
            enc = seq_encode_native(data, delim, states)
            lens = np.diff(enc[1])
            if key_ords:
                short = lens <= max(key_ords)
                if short.any():
                    raise ValueError(
                        f"row {int(np.argmax(short))} has no "
                        f"id/class field (ordinal {max(key_ords)})")
            keys = _entity_keys(data, delim, key_ords, lens.shape[0])
            obs.record("stream.parse", t0, sink="markov_entities",
                       nbytes=len(data), engine="native")
            t0 = obs.now()
            # first-seen entity order: the unique keys ordered by their
            # first row, then every row's index
            uniq, first, inv = np.unique(keys, return_index=True,
                                         return_inverse=True)
            gidx = np.empty(uniq.shape[0], np.int64)
            for u in np.argsort(first):
                key = str(uniq[u])
                gi = index.get(key)
                if gi is None:
                    gi = len(index)
                    index[key] = gi
                    model.class_labels.append(key)
                gidx[u] = gi
            if len(index) > model.counts.shape[0]:
                model.counts = np.pad(
                    model.counts,
                    ((0, len(index) - model.counts.shape[0]), (0, 0),
                     (0, 0)))
            model.fit_csr(enc[0], enc[1], skip=seq_start,
                          y=gidx[inv.reshape(-1)])
            obs.record("stream.fold", t0, sink="markov_entities")
    else:
        for lines in stream_job_lines(cfg, inputs):
            seqs: List[List[str]] = []
            entity_of_row: List[str] = []
            for ln in lines:
                toks = [t.strip(" \t\r") for t in ln.split(delim)]
                if key_ords and len(toks) <= max(key_ords):
                    raise ValueError(
                        f"row {len(entity_of_row)} has no id/class "
                        f"field (ordinal {max(key_ords)})")
                key = ",".join(toks[o] for o in id_ords)
                if class_ord is not None:
                    key += f",{toks[class_ord]}"
                entity_of_row.append(key)
                seqs.append(toks[seq_start:])
            t0 = obs.now()
            model.fit_entities(seqs, entity_of_row)
            obs.record("stream.fold", t0, sink="markov_entities")
    entities = model.class_labels or []
    if not entities:
        raise ValueError(
            f"markovStateTransitionModel: empty input "
            f"(no records in {inputs})")
    out = _out_file(output)
    with obs.span("job.finish", job=_MARKOV):
        model.save(out, delim=cfg.field_delim, marker="entity")
    return JobResult(_MARKOV, {"Entities:Count": len(entities)}, [out])


@job(_MARKOV, "mst", "org.avenir.markov.MarkovStateTransitionModel",
     "org.avenir.spark.sequence.MarkovStateTransitionModel")
def markov_model_job(cfg: JobConfig, inputs: List[str], output: str,
                     device: torch.device) -> JobResult:
    """Per-class transition matrices (the Hadoop job's mst.* keys,
    MarkovStateTransitionModel.java:116-133), streamed in
    `stream.block.size.mb` byte blocks through `_MarkovPerClassFold`, the
    shared-scan sink; with `id.field.ordinals`, one matrix per entity key
    (`_markov_entities`). Both fold the counts on `device`."""
    states = cfg.get_list("model.states") or cfg.assert_list("state.list")
    id_ords = cfg.get_int_list("id.field.ordinals")
    if id_ords is not None:
        return _markov_entities(cfg, inputs, output, device, states,
                                cfg.get_int("trans.prob.scale", 1000),
                                id_ords)
    from avenir_tpu_torch.core.stream import stream_job_byte_blocks

    fold = _MarkovPerClassFold(cfg, inputs, device)
    # the fold takes a replayed SidecarBytesBlock too, so the feed opts in
    # to the bytes-kind sidecar at this job's skip count
    _drive_fold(fold, stream_job_byte_blocks(
        cfg, inputs, sidecar_skip=fold.skip if fold.native else None),
        _MARKOV)
    return _finish_fold(fold, output, _MARKOV)


@job("markovModelClassifier", "mmc",
     "org.avenir.markov.MarkovModelClassifier",
     "org.avenir.spark.sequence.MarkovModelClassifier")
def markov_classifier_job(cfg: JobConfig, inputs: List[str], output: str,
                          device: torch.device) -> JobResult:
    """`id,class,score` a row (MarkovModelClassifier.java:127-150): the
    log odds under `mm.model.path`'s two class matrices, scored a line
    block at a time on `device`; with `validation.mode`, the
    `Validation:*` counters against the row's `class.label.field.ord`."""
    from avenir_tpu_torch.core.stream import stream_job_lines
    from avenir_tpu_torch.models.markov import (MarkovModelClassifier,
                                                MarkovStateTransitionModel)

    model = MarkovStateTransitionModel.load(
        cfg.assert_get("mm.model.path"), delim=cfg.field_delim,
        device=device)
    pos, neg = cfg.assert_list("class.labels")
    clf = MarkovModelClassifier(
        model, pos, neg,
        threshold=cfg.get_float("log.odds.threshold", 0.0))
    skip = cfg.get_int("skip.field.count", 1)
    class_ord = cfg.get_int("class.label.field.ord") \
        if cfg.get_bool("validation.mode", False) else None
    out = _out_file(output)
    delim = cfg.field_delim
    # the validation counts fold a chunk at a time: O(classes), not O(rows)
    lab = [pos, neg]
    cm = ConfusionMatrix(lab, pos_class=0) if class_ord is not None else None
    with open(out, "w") as fh:
        for lines in stream_job_lines(cfg, inputs):
            t0 = obs.now()
            ids, seqs, labels = _parse_sequences(
                lines, cfg.field_delim_regex, skip, class_ord)
            obs.record("stream.parse", t0, nbytes=sum(map(len, lines)),
                       engine="python")
            t0 = obs.now()
            cls, scores = clf.predict(seqs)
            obs.record("stream.fold", t0, sink="markov_classify")
            t0 = obs.now()
            # a float32 score formats as the float it widens to exactly
            fh.write("".join(f"{rid}{delim}{c}{delim}{s:.6f}\n" for rid, c, s
                             in zip(ids, cls.tolist(), scores.tolist())))
            obs.record("job.finish", t0, job="markovModelClassifier")
            if cm is not None:
                cm.add(np.array([lab.index(a) for a in labels]),
                       np.array([lab.index(p) for p in cls]))
    counters: Dict[str, float] = (cm.counters()
                                  if cm is not None and cm.total else {})
    return JobResult("markovModelClassifier", counters, [out])


@job("hiddenMarkovModelBuilder", "hmmb",
     "org.avenir.markov.HiddenMarkovModelBuilder")
def hmm_builder_job(cfg: JobConfig, inputs: List[str], output: str,
                    device: torch.device) -> JobResult:
    """Fully tagged input: `obs<sub.field.delim>state` tokens after the
    skip fields (HiddenMarkovModelBuilder.java:136-153), counted on
    `device` (natively: whole pair tokens coded against the state-major
    pair vocabulary). With `partially.tagged=true` the tokens are bare
    observations but those that are model states, and `window.function`
    spreads the emission counts around each tagged position (:174-259,
    host Python)."""
    from avenir_tpu_torch.core.stream import (stream_job_byte_blocks,
                                              stream_job_lines)
    from avenir_tpu_torch.models.markov import HiddenMarkovModelBuilder
    from avenir_tpu_torch.native.ingest import (native_seq_ready,
                                                seq_encode_native)

    states = cfg.assert_list("model.states")
    obs_vals = cfg.assert_list("model.observations")
    sub = cfg.get("sub.field.delim", ":")
    skip = cfg.get_int("skip.field.count", 1)
    delim = cfg.field_delim_regex
    builder = HiddenMarkovModelBuilder(states, obs_vals, device=device)
    if cfg.get_bool("partially.tagged", False):
        wf = [int(v) for v in cfg.assert_list("window.function")]
        for lines in stream_job_lines(cfg, inputs):
            _, seqs, _ = _parse_sequences(lines, delim, skip)
            t0 = obs.now()
            for seq in seqs:
                builder.add_partially_tagged(seq, wf)
            obs.record("stream.fold", t0, sink="hmm_partial")
    elif native_seq_ready(delim):
        vocab = [f"{ov}{sub}{sv}" for sv in states for ov in obs_vals]
        for data in stream_job_byte_blocks(cfg, inputs):
            t0 = obs.now()
            enc = seq_encode_native(data, delim, vocab)
            obs.record("stream.parse", t0, sink="hmm_csr", nbytes=len(data),
                       engine="native")
            t0 = obs.now()
            builder.add_csr(*enc, skip=skip)
            obs.record("stream.fold", t0, sink="hmm_csr")
    else:
        for lines in stream_job_lines(cfg, inputs):
            _, seqs, _ = _parse_sequences(lines, delim, skip)
            t0 = obs.now()
            pairs = [[tok.split(sub) for tok in seq] for seq in seqs]
            builder.add_many([[p[1] for p in ps] for ps in pairs],
                             [[p[0] for p in ps] for ps in pairs])
            obs.record("stream.fold", t0, sink="hmm_lines")
    hmm = builder.finish()
    out = _out_file(output)
    with obs.span("job.finish", job="hiddenMarkovModelBuilder"):
        hmm.save(out, delim=cfg.field_delim)
    return JobResult("hiddenMarkovModelBuilder", {}, [out])


@job("viterbiStatePredictor", "vsp", "org.avenir.markov.ViterbiStatePredictor")
def viterbi_job(cfg: JobConfig, inputs: List[str], output: str,
                device: torch.device) -> JobResult:
    """`id,state,...` a row: each row's observations decoded under
    `hmm.model.path`'s HMM on `device` (ViterbiStatePredictor.java:45),
    an input file at a time."""
    from avenir_tpu_torch.models.markov import (HiddenMarkovModel,
                                                ViterbiDecoder)

    hmm = HiddenMarkovModel.load(cfg.assert_get("hmm.model.path"),
                                 delim=cfg.field_delim)
    decoder = ViterbiDecoder(hmm, device=device)
    skip = 1 if cfg.get_int("id.field.ordinal", 0) >= 0 else 0
    out = _out_file(output)
    delim = cfg.field_delim
    names = hmm.states
    with open(out, "w") as fh:
        for path in inputs:
            t0 = obs.now()
            lines = _read_lines(path)
            obs.record("stream.read", t0, path=path,
                       nbytes=os.path.getsize(path))
            t0 = obs.now()
            ids, seqs, _ = _parse_sequences(lines, cfg.field_delim_regex,
                                            skip)
            del lines
            obs.record("stream.parse", t0, nbytes=os.path.getsize(path),
                       engine="python")
            t0 = obs.now()
            paths, lens = decoder.decode_codes(seqs)
            obs.record("stream.fold", t0, sink="viterbi")
            t0 = obs.now()
            live = np.arange(paths.shape[1])[None, :] < lens[:, None]
            words = list(map(names.__getitem__, paths[live].tolist()))
            ends = np.cumsum(lens).tolist()
            fh.write("".join(
                delim.join([rid, *words[b - n:b]]) + "\n"
                for rid, b, n in zip(ids, ends, lens.tolist())))
            obs.record("job.finish", t0, job="viterbiStatePredictor")
    return JobResult("viterbiStatePredictor", {}, [out])


@job("probabilisticSuffixTree", "pstg",
     "org.avenir.markov.ProbabilisticSuffixTreeGenerator")
def pst_job(cfg: JobConfig, inputs: List[str], output: str,
            device: torch.device) -> JobResult:
    """`context,symbol,probability` a tracked (context, symbol) pair
    (ProbabilisticSuffixTreeGenerator.java:88-123), host Python; the empty
    context is written `$`."""
    from avenir_tpu_torch.models.markov import ProbabilisticSuffixTree

    skip = cfg.get_int("skip.field.count", 1)
    seqs: List[List[str]] = []
    for path in inputs:
        _, ss, _ = _read_sequences(path, cfg.field_delim_regex, skip)
        seqs += ss
    symbols = sorted({s for seq in seqs for s in seq})
    pst = ProbabilisticSuffixTree(
        symbols, max_depth=cfg.get_int("max.seq.length", 3)).fit(seqs)
    out = _out_file(output)
    delim = cfg.field_delim
    with obs.span("job.finish", job="probabilisticSuffixTree"):
        with open(out, "w") as fh:
            for ctx in sorted(pst.counts):
                counts = pst.counts[ctx]
                total = float(counts.sum()) or 1.0
                for si, sym in enumerate(pst.symbols):
                    if counts[si] > 0:
                        fh.write(f"{''.join(ctx) or '$'}{delim}{sym}{delim}"
                                 f"{counts[si] / total:.6f}\n")
    return JobResult("probabilisticSuffixTree", {}, [out])


@job("stateTransitionRate", "str", "org.avenir.spark.markov.StateTransitionRate")
def state_transition_rate_job(cfg: JobConfig, inputs: List[str], output: str,
                              device: torch.device) -> JobResult:
    """Per-entity CTMC rate matrices from timestamped state rows
    (StateTransitionRate.scala:30), host float64: rows grouped by
    `key.field.ordinals` and sorted by `time.field.ordinal`; rate(i -> j)
    = count(i -> j) / dwell(i), dwell in `rate.time.unit` (hour, day or
    week), the diagonal -sum(off-diagonal row); timestamps in ms, sec or s
    (`input.time.unit`). A row `key,state,r0,...` a state."""
    from avenir_tpu_torch.models.markov import StateTransitionRate

    key_ords = cfg.get_int_list("key.field.ordinals", [0])
    time_ord = cfg.assert_int("time.field.ordinal")
    state_ord = cfg.assert_int("state.field.ordinal")
    states = cfg.assert_list("state.values")
    in_unit = cfg.get("input.time.unit", "ms")
    try:
        to_ms = {"ms": 1.0, "sec": 1000.0, "s": 1000.0}[in_unit]
    except KeyError:
        raise ValueError(f"invalid input time unit {in_unit!r}")
    rate_unit = cfg.get("rate.time.unit", "hour")
    try:
        unit_ms = {"hour": 3.6e6, "day": 8.64e7, "week": 6.048e8}[rate_unit]
    except KeyError:
        raise ValueError(f"invalid rate time unit {rate_unit!r}")
    prec = cfg.get_int("trans.rate.output.precision", 6)
    by_key: Dict[str, List[Tuple[float, str]]] = {}
    for p in inputs:
        for ln in _read_lines(p):
            toks = [t.strip() for t in ln.split(cfg.field_delim_regex)]
            key = cfg.field_delim.join(toks[o] for o in key_ords)
            by_key.setdefault(key, []).append(
                (float(toks[time_ord]) * to_ms, toks[state_ord]))
    out = _out_file(output)
    delim = cfg.field_delim
    with obs.span("job.finish", job="stateTransitionRate"):
        with open(out, "w") as fh:
            for key, events in sorted(by_key.items()):
                events.sort(key=lambda e: e[0])
                seq = [(s, t / unit_ms) for t, s in events]
                q = StateTransitionRate(states).fit([seq]).rates()
                q = q - np.diag(q.sum(axis=1))
                for i, s in enumerate(states):
                    row = delim.join(f"{v:.{prec}f}" for v in q[i])
                    fh.write(f"{key}{delim}{s}{delim}{row}\n")
    return JobResult("stateTransitionRate", {"Basic:Entities": len(by_key)},
                     [out])


def _ctmc_rates(cfg: JobConfig, states: List[str], rate_path: str):
    """(one S x S rate matrix, None) for a plain matrix file, or (None,
    {entity: matrix}) for stateTransitionRate's per-entity rows
    (`key,state,r0,...,rS-1`, the supplier-fulfillment flow's hand-over),
    told apart by structure: a per-entity row has S + 2 tokens, the second
    a state label."""
    first = next(iter(_read_lines(rate_path)), "")
    ftoks = [t.strip() for t in first.split(cfg.field_delim_regex)]
    if not (len(ftoks) == len(states) + 2 and ftoks[1] in states):
        rates = np.loadtxt(rate_path, delimiter=cfg.field_delim_regex,
                           ndmin=2)
        if rates.shape != (len(states), len(states)):
            raise ValueError(
                f"rate matrix in {rate_path} has shape {rates.shape}; "
                f"expected {(len(states), len(states))} for state.values "
                f"{states} (or stateTransitionRate per-entity rows)")
        return rates, None
    rows: Dict[str, Dict[str, List[float]]] = {}
    for ln in _read_lines(rate_path):
        toks = [t.strip() for t in ln.split(cfg.field_delim_regex)]
        key, state, vals = toks[0], toks[1], [float(v) for v in toks[2:]]
        if state not in states or len(vals) != len(states):
            raise ValueError(
                f"rate file row for {key!r} does not match "
                f"state.values {states}")
        rows.setdefault(key, {})[state] = vals
    per_entity: Dict[str, np.ndarray] = {}
    for key, by_state in rows.items():
        missing = [s for s in states if s not in by_state]
        if missing:
            raise ValueError(
                f"entity {key!r} in {rate_path} has no rate row for "
                f"state(s) {missing}")
        per_entity[key] = np.array([by_state[s] for s in states])
    return None, per_entity


@job("contTimeStateTransitionStats", "cts",
     "org.avenir.spark.markov.ContTimeStateTransitionStats")
def ctmc_stats_job(cfg: JobConfig, inputs: List[str], output: str,
                   device: torch.device) -> JobResult:
    """CTMC statistics by uniformization
    (ContTimeStateTransitionStats.scala:34), host float64: rows
    `id,initState[,endState]`, the rates from `state.trans.file.path` (a
    plain matrix, or stateTransitionRate's per-entity rows looked up by
    the row's id); `state.trans.stat` stateDwellTime (target
    `target.states[0]`) or StateTransitionCount (targets 0 and 1). `id,v`
    a row. The model's two documented deviations from the Scala job hold
    here too (the transition count's inner bound, the conditional
    normalization)."""
    from avenir_tpu_torch.models.markov import ContTimeStateTransitionStats

    states = cfg.assert_list("state.values")
    horizon = cfg.assert_float("time.horizon")
    rate_path = cfg.assert_get("state.trans.file.path")
    rates, per_entity = _ctmc_rates(cfg, states, rate_path)
    stats_cache: Dict[str, ContTimeStateTransitionStats] = {}

    def stats_for(rid: str) -> ContTimeStateTransitionStats:
        if rates is not None:
            key = ""
        else:
            if rid not in per_entity:
                raise KeyError(f"no rate matrix for entity {rid!r} in "
                               f"{rate_path}")
            key = rid
        if key not in stats_cache:
            q = rates if rates is not None else per_entity[key]
            stats_cache[key] = ContTimeStateTransitionStats(q, states,
                                                            horizon)
        return stats_cache[key]

    stat_kind = cfg.get("state.trans.stat", "stateDwellTime")
    targets = cfg.assert_list("target.states")
    out = _out_file(output)
    delim = cfg.field_delim
    # a statistic depends on the row's rates, start and end state alone:
    # each one is computed once
    values: Dict[Tuple[int, str, Optional[str]], float] = {}
    with open(out, "w") as fh:
        for path in inputs:
            for ln in _read_lines(path):
                toks = [t.strip() for t in ln.split(cfg.field_delim_regex)]
                rid, init = toks[0], toks[1]
                end = toks[2] if len(toks) > 2 else None
                st = stats_for(rid)
                key = (id(st), init, end)
                if key not in values:
                    values[key] = (
                        st.dwell_time(init, targets[0], end)
                        if stat_kind == "stateDwellTime" else
                        st.transition_count(init, targets[0], targets[1],
                                            end))
                fh.write(f"{rid}{delim}{values[key]:.6f}\n")
    return JobResult("contTimeStateTransitionStats", {}, [out])


@job("eventTimeDistribution", "etd",
     "org.avenir.spark.sequence.EventTimeDistribution")
def event_time_job(cfg: JobConfig, inputs: List[str], output: str,
                   device: torch.device) -> JobResult:
    """Inter-arrival time histogram (EventTimeDistribution.scala:27): rows
    `id,timestamp...` grouped by id, `bucket,count` a bucket."""
    from avenir_tpu_torch.models.markov import event_time_distribution

    ts_ord = cfg.get_int("time.stamp.field.ordinal", 1)
    by_id: Dict[str, List[float]] = {}
    for p in inputs:
        for ln in _read_lines(p):
            toks = [t.strip() for t in ln.split(cfg.field_delim_regex)]
            by_id.setdefault(toks[0], []).append(float(toks[ts_ord]))
    hist = event_time_distribution(
        [sorted(v) for v in by_id.values()],
        num_buckets=cfg.get_int("num.buckets", 24),
        bucket_width=cfg.get_float("bucket.width", 3600.0))
    out = _out_file(output)
    delim = cfg.field_delim
    with open(out, "w") as fh:
        for b, c in enumerate(hist):
            fh.write(f"{b}{delim}{int(c)}\n")
    return JobResult("eventTimeDistribution", {"Basic:Entities": len(by_id)},
                     [out])


# =================================================================== pipeline
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

    def _fusable(self, st: Stage) -> bool:
        key = _REGISTRY.get(st.job)
        return key is not None and key[0] in _STREAM_FOLDS

    def run(self, only: Optional[str] = None,
            fuse: bool = False) -> Dict[str, JobResult]:
        """Run the stages in order (only the one named `only`, if given).
        With fuse=True, each maximal run of consecutive stages that read
        the same inputs and are shared-scan capable (stream_fold_names(),
        no job twice) runs as one scan through run_shared: N jobs, one
        read and one parse of the input. If the fused attempt fails,
        `on_retry("a+b+c", 1, exc)` is called and the group's stages run
        one scan each, with their usual retries: fusion never adds a
        failure."""
        stages = [st for st in self.stages if only is None or st.name == only]
        i = 0
        while i < len(stages):
            group = [stages[i]]
            if fuse and self._fusable(stages[i]):
                seen = {_REGISTRY[stages[i].job][0]}
                j = i + 1
                while (j < len(stages) and self._fusable(stages[j])
                       and stages[j].inputs == stages[i].inputs
                       and _REGISTRY[stages[j].job][0] not in seen):
                    group.append(stages[j])
                    seen.add(_REGISTRY[stages[j].job][0])
                    j += 1
            if len(group) >= 2:
                specs = [(st.job, self._stage_props(st), st.output)
                         for st in group]
                try:
                    shared = run_shared(specs, group[0].inputs,
                                        device=self.device)
                    for st in group:
                        self.results[st.name] = shared[_REGISTRY[st.job][0]]
                        self.attempts[st.name] = 1
                    i += len(group)
                    continue
                except Exception as exc:
                    if self.on_retry is not None:
                        self.on_retry("+".join(st.name for st in group), 1,
                                      exc)
            for st in group:
                self._run_stage(st)
            i += len(group)
        return self.results


def run_from_cli(argv: Sequence[str]) -> JobResult:
    """`python -m avenir_tpu_torch <jobName> --conf <props> IN... OUT
    [--device cpu] [--shard N] [--incremental] [--autotune]`; prints the
    result as one JSON line. `--shard N` runs a streamed job's scan across
    N worker processes (`dist.run_sharded`), and the line then also holds
    each worker's stats under "workers". `--incremental` refreshes a
    streamed job from its last checkpoint (`run_incremental`); with
    `--shard N`, across N workers (`dist.run_sharded_refresh`), which the
    miners refuse. `--autotune` sets `stream.autotune`: the run applies
    the profile store's knobs and records its signals for the next run
    (a HOCON `.conf` sets the key in its block instead; `--shard` refuses
    it).

    `python -m avenir_tpu_torch serve ...` starts the resident job
    server instead (server/spool.py: `--stdin`, `--spool DIR` or
    `--listen HOST:PORT` behind the HTTP edge of net/listener.py),
    `fleet --root DIR --hosts N` runs N servers behind the affinity
    router (net/fleet.py), and `stats <paths...>` renders one server's
    metrics.json or a fleet's, merged (obs/report.py), and `tune <dir>`
    the autotune profiles under a directory (tune/report.py). Each takes
    `--device cpu` but `stats` and `tune`, which read files only."""
    subcommands = {"serve": ("avenir_tpu_torch.server.spool", "serve_main"),
                   "fleet": ("avenir_tpu_torch.net.fleet", "fleet_main"),
                   "stats": ("avenir_tpu_torch.obs.report", "stats_main"),
                   "tune": ("avenir_tpu_torch.tune.report", "tune_main")}
    if argv and argv[0] in subcommands:
        import importlib

        mod, fn = subcommands[argv[0]]
        rc = getattr(importlib.import_module(mod), fn)(list(argv[1:]))
        if rc:
            sys.exit(rc)
        return JobResult(argv[0])
    ap = argparse.ArgumentParser(prog="avenir_tpu_torch")
    ap.add_argument("jobname", help="job name or reference Tool class")
    ap.add_argument("--conf", default=None,
                    help="properties file (the -Dconf.path analog), or a HOCON .conf "
                         "with a block named after the job")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--shard", type=int, default=0, metavar="N",
                    help="run a streamed job's scan across N worker "
                         "processes: over-partitioned byte-range blocks "
                         "claimed through the first-commit-wins block "
                         "ledger, merged by the registered fold-state "
                         "algebra (avenir_tpu_torch.dist.run_sharded); "
                         "byte-identical to the solo scan")
    ap.add_argument("--incremental", action="store_true",
                    help="delta-scan a streamed job: restore the last "
                         "fold-state checkpoint and fold only appended "
                         "blocks (run_incremental)")
    ap.add_argument("--autotune", action="store_true",
                    help="close the telemetry loop: apply the profile "
                         "store's tuned knobs to this run and record its "
                         "signals for the next (sets stream.autotune)")
    ap.add_argument("paths", nargs="*", help="input paths... output path")
    args = ap.parse_intermixed_args(argv)
    if not args.paths:
        ap.error("expected IN... OUT paths (at least an output path)")
    # a .conf path routes through the HOCON block loader in run_job
    props = args.conf if args.conf else {}
    if args.autotune:
        # a HOCON conf holds a block a job, which the flag cannot reach
        # into: the key goes in the job's block instead
        if isinstance(props, str):
            if props.endswith(".conf"):
                ap.error("--autotune cannot rewrite a HOCON .conf; set "
                         "stream.autotune = true in the job's block")
            props = dict(load_properties(props))
        else:
            props = dict(props)
        props["stream.autotune"] = "true"
    short = args.jobname.rsplit(".", 1)[-1]
    name = (args.jobname if args.jobname in _REGISTRY
            else short[0].lower() + short[1:])
    inputs, output = args.paths[:-1], args.paths[-1]
    if args.shard and args.incremental and (
            _REGISTRY[name][0] if name in _REGISTRY else name) in (
            _APRIORI, _GSP):
        # the miners' per-k rounds re-scan the whole corpus a candidate
        # length, so their refresh would be a full re-mine in disguise
        ap.error("--shard and --incremental cannot compose for the "
                 "miners: per-k candidate rounds re-scan the whole "
                 "corpus; run --shard (full re-mine) or --incremental "
                 "alone")
    if args.shard and args.autotune:
        # the sharded driver applies no tuned knobs: the flag would tune
        # nothing, so it is refused
        ap.error("--shard does not support --autotune yet; the sharded "
                 "driver applies no tuned knobs")
    if args.shard and args.incremental:
        from avenir_tpu_torch.dist.driver import run_sharded_refresh

        res = run_sharded_refresh(name, props, inputs, output,
                                  procs=args.shard, device=args.device)
    elif args.shard:
        from avenir_tpu_torch.dist import run_sharded

        res = run_sharded(name, props, inputs, output,
                          procs=args.shard, device=args.device)
    else:
        runner = run_incremental if args.incremental else run_job
        res = runner(name, props, inputs, output, device=args.device)
    row = {"job": res.name, "counters": res.counters, "outputs": res.outputs}
    if args.shard and res.payload:
        row["workers"] = res.payload["workers"]
    print(json.dumps(row))
    return res


if __name__ == "__main__":
    run_from_cli(sys.argv[1:])
