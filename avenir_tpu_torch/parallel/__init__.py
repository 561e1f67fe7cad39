"""Parallel layer: meshes of `torch.distributed` ranks and their
collectives (the port of `avenir_tpu/parallel/`).

Rows shard over a 'data' axis of ranks, the train side of KNN over an
optional 'model' axis; small model tensors replicate, and aggregation is
an all-reduce (NCCL on cuda, gloo on the CPU) where the reference's
Hadoop job ran a shuffle.
"""

from avenir_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    data_mesh,
    replicated,
    row_mask,
    shard_rows,
    sharded_keyed_count,
)
from avenir_tpu_torch.parallel.distributed import (
    FAMILIES,
    distributed_apriori_support_fn,
    distributed_bandit_select_fn,
    distributed_crosscount_fn,
    distributed_lr_step_fn,
    distributed_markov_counts_fn,
    distributed_nb_train_fn,
    distributed_topk_fn,
    distributed_tree_level_fn,
)
from avenir_tpu_torch.parallel.multihost import initialize, shutdown

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "data_mesh", "replicated", "row_mask",
    "shard_rows", "sharded_keyed_count", "FAMILIES",
    "distributed_apriori_support_fn", "distributed_bandit_select_fn",
    "distributed_crosscount_fn", "distributed_lr_step_fn",
    "distributed_markov_counts_fn", "distributed_nb_train_fn",
    "distributed_topk_fn", "distributed_tree_level_fn", "initialize",
    "shutdown",
]
