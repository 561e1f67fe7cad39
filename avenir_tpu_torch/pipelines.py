"""Canonical pipelines: the reference's tutorial shell flows as Pipelines.

The port of `knn_pipeline` of `avenir_tpu/pipelines.py`: the stages that
resource/knn.sh ran by hand, against the same properties keys, so its
run-book translates 1:1: build the pipeline, call run(). The other
factories of the JAX module wait for their jobs.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from avenir_tpu_torch.core.config import load_properties
from avenir_tpu_torch.runner import Pipeline, Stage
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
