"""Canonical pipelines: the reference's tutorial shell flows as Pipelines.

The port of `knn_pipeline`, `decision_tree_pipeline`, `profile_pipeline`
and `association_pipeline` of `avenir_tpu/pipelines.py`: the stages that
resource/knn.sh ran by hand, resource/detr.sh's and rafo.sh's tree
builds, the corpus profiling every modelling run-book starts with, and
resource/carm.sh's association mining, against the same properties keys,
so a run-book translates 1:1: build the pipeline, call run(); and
`bandit_round`, one decision round of the price-optimization loop.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from avenir_tpu_torch.core.config import load_properties
from avenir_tpu_torch.runner import (JobResult, Pipeline, Stage, job_prefix,
                                     run_job)
from avenir_tpu_torch.utils.devices import DeviceLike


def _props(conf) -> Dict[str, str]:
    """Properties from a file path, a dict, or a JobConfig."""
    if isinstance(conf, str):
        return load_properties(conf)
    if hasattr(conf, "props"):
        return dict(conf.props)
    return dict(conf)


def knn_pipeline(conf, train_csv: str, test_csv: str, work_dir: str,
                 schema_path: Optional[str] = None,
                 device: DeviceLike = None) -> Pipeline:
    """The five stages of resource/knn.sh (SURVEY §3.3), on `device`
    (default cuda).

    (1) sifarish distances -> recordSimilarity (simi.txt); (2)-(3) NB
    distributions and feature posteriors -> bayesianDistr (distr.csv) and
    bayesianPredictor with bap.output.feature.prob.only (condProb.txt);
    (4) the join -> featureCondProbJoiner (join.txt); (5) nearestNeighbor
    (knn_out.txt), which computes its distances and, with
    nen.class.condtion.weighted, its weights itself: the files of stages
    (1)-(4) are written for the consumers that read them."""
    os.makedirs(work_dir, exist_ok=True)
    overrides: Dict[str, str] = {}
    if schema_path:
        for p in ("sts", "bad", "bap", "nen"):
            overrides[f"{p}.feature.schema.file.path"] = schema_path
    model_path = os.path.join(work_dir, "distr.csv")
    overrides.setdefault("bap.bayesian.model.file.path", model_path)
    simi = os.path.join(work_dir, "simi.txt")
    cond_prob = os.path.join(work_dir, "condProb.txt")
    return Pipeline(_props(conf), [
        Stage("similarity", "recordSimilarity", [train_csv, test_csv], simi,
              dict(overrides)),
        Stage("bayesianDistr", "bayesianDistr", [train_csv], model_path,
              dict(overrides)),
        Stage("featurePosterior", "bayesianPredictor", [train_csv],
              cond_prob,
              {**overrides, "bap.output.feature.prob.only": "true"}),
        Stage("join", "featureCondProbJoiner", [simi, cond_prob],
              os.path.join(work_dir, "join.txt"), dict(overrides)),
        Stage("nearestNeighbor", "nearestNeighbor", [train_csv, test_csv],
              os.path.join(work_dir, "knn_out.txt"), dict(overrides)),
    ], device=device)


def decision_tree_pipeline(conf, train_csv: str, work_dir: str,
                           schema_path: Optional[str] = None,
                           forest: bool = False,
                           device: DeviceLike = None) -> Pipeline:
    """resource/detr.sh / rafo.sh on `device` (default cuda): the
    per-level decTree + mvDecFiles rotation (SURVEY §3.4) as one job whose
    DecisionPathList JSON lands at dtb.decision.file.path.out
    (decPathOut.txt in work_dir by default); with forest=True rafo's
    randomForest, a `tree-NNN.json` a tree under work_dir/forest."""
    os.makedirs(work_dir, exist_ok=True)
    overrides: Dict[str, str] = {}
    if schema_path:
        overrides["dtb.feature.schema.file.path"] = schema_path
    overrides.setdefault(
        "dtb.decision.file.path.out", os.path.join(work_dir, "decPathOut.txt"))
    job = "randomForest" if forest else "decTree"
    return Pipeline(_props(conf), [
        Stage("decTree", job, [train_csv],
              os.path.join(work_dir, "forest") if forest else "",
              overrides),
    ], device=device)


def profile_pipeline(conf, train_csv: str, work_dir: str,
                     schema_path: Optional[str] = None,
                     device: DeviceLike = None) -> Pipeline:
    """Corpus profiling on `device` (default cuda): NB distributions
    (distr.csv), mutual information (mi.txt) and the Fisher discriminant
    (fisher.txt) over one labelled corpus. All three are stream folds, so
    `run(fuse=True)` runs them as one shared scan (one read and one parse
    a chunk, three fold sinks); `run()` scans once a job. The outputs are
    byte-identical either way."""
    os.makedirs(work_dir, exist_ok=True)
    overrides: Dict[str, str] = {}
    if schema_path:
        for p in ("bad", "mut", "fid"):
            overrides[f"{p}.feature.schema.file.path"] = schema_path
    return Pipeline(_props(conf), [
        Stage("bayesianDistr", "bayesianDistr", [train_csv],
              os.path.join(work_dir, "distr.csv"), dict(overrides)),
        Stage("mutualInformation", "mutualInformation", [train_csv],
              os.path.join(work_dir, "mi.txt"), dict(overrides)),
        Stage("fisherDiscriminant", "fisherDiscriminant", [train_csv],
              os.path.join(work_dir, "fisher.txt"), dict(overrides)),
    ], device=device)


class _AssociationPipeline(Pipeline):
    """carm.sh's two stages: the rules stage reads the files the apriori
    stage wrote, so it runs after that stage, never alone first."""

    def run(self, only: Optional[str] = None,
            fuse: bool = False) -> Dict[str, JobResult]:
        results: Dict[str, JobResult] = {}
        if only in (None, "apriori"):
            results.update(super().run("apriori", fuse))
        if only in (None, "rules"):
            ap = self.results.get("apriori")
            if ap is None:
                raise RuntimeError("run the apriori stage first")
            self.stages[1].inputs = list(ap.outputs)
            results.update(super().run("rules", fuse))
        return results


def association_pipeline(conf, trans_csv: str, work_dir: str,
                         device: DeviceLike = None) -> Pipeline:
    """resource/carm.sh on `device` (default cuda): frequent itemsets of
    every length (work_dir/itemsets/itemsets-<k>.txt), then association
    rules over those files (work_dir/rules.txt)."""
    os.makedirs(work_dir, exist_ok=True)
    return _AssociationPipeline(_props(conf), [
        Stage("apriori", "frequentItemsApriori", [trans_csv],
              os.path.join(work_dir, "itemsets")),
        # the rules stage's inputs are the apriori stage's outputs
        Stage("rules", "associationRuleMiner", [],
              os.path.join(work_dir, "rules.txt")),
    ], device=device)


def bandit_round(conf, stats_csv: str, out_path: str, round_num: int,
                 job: str = "greedyRandomBandit",
                 device: DeviceLike = None) -> JobResult:
    """One decision round of the price-optimization loop
    (resource/price_optimize_tutorial.txt:20-82) on `device` (default
    cuda): reward-aggregate rows in, the selected items out. The loop
    lives with the caller, as the tutorial's rounds did; aggregating the
    rewards between rounds is the caller's data pipeline."""
    props = _props(conf)
    props[f"{job_prefix(job)}.current.round.num"] = str(round_num)
    return run_job(job, props, [stats_csv], out_path, device=device)
