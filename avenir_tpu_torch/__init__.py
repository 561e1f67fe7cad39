"""avenir_tpu_torch: the PyTorch + CUDA port of avenir_tpu for NVIDIA Hopper.

The JAX package `avenir_tpu` is the reference; this package runs the same
jobs on an H100. Host code (schema, config, CSV parsing, confusion matrix)
is kept here as its own copy, plain tensor code is PyTorch, and every TPU
kernel on a ported path is a CUDA kernel written by hand (`ops/csrc/`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU present and no device given they raise instead of degrading.

Ported so far: the `nearestNeighbor`, `bayesianDistr`, `bayesianPredictor`,
`recordSimilarity`, `groupedRecordSimilarity` and `featureCondProbJoiner`
jobs (`runner.run_job`, or
``python -m avenir_tpu_torch <job> --conf P IN... OUT``), `runner.Pipeline`
and `pipelines.knn_pipeline`, and the tools `kernel_check`, `knn_sweep` and
`bench` (`python -m avenir_tpu_torch.tools.<tool>`); since then all 45
jobs of the JAX package's runner, and its online half: the score plane
(`server.ScorePlane`) and the streaming learners (`models.reinforce`,
`streaming.LearnerStream`).
"""

__version__ = "0.1.0"
