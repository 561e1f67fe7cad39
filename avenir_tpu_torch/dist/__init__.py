"""Sharded streaming across worker processes, with straggler tolerance.

The port of `avenir_tpu/dist/`. A shard planner over-partitions the inputs
into newline-aligned byte-range blocks (:mod:`avenir_tpu_torch.dist.plan`);
workers claim them through a first-commit-wins block ledger
(:mod:`avenir_tpu_torch.dist.ledger`): fast workers steal the unclaimed
tail, and a straggler's claimed block is folded again past a threshold
their own telemetry sets (:mod:`avenir_tpu_torch.dist.detect`); the
coordinator merges the committed block states in plan order through the
registered fold-state algebra (:mod:`avenir_tpu_torch.dist.driver`), byte
for byte the solo job's artifact; `run_sharded_refresh` folds only an
append into a restored incremental checkpoint that way. The miners run their per-k rounds in the
workers too, against level-namespaced ledgers (``k<k>/b<id>``), each
worker replaying its own encoded-block caches. Every worker folds on the
plan's device (cuda unless the caller asks for the CPU). The collective
merge on `torch.distributed` is :mod:`avenir_tpu_torch.dist.collective`.
"""

from avenir_tpu_torch.dist.detect import (StragglerPolicy, mirror_after_s,
                                          mirror_after_wall_s)
from avenir_tpu_torch.dist.driver import (ShardError, merge_block_states,
                                          run_sharded, run_sharded_refresh)
from avenir_tpu_torch.dist.ledger import BlockLedger
from avenir_tpu_torch.dist.plan import (DEFAULT_FACTOR, PlanError,
                                        ShardBlock, ShardPlan, load_plan,
                                        plan_shards, write_json_atomic,
                                        write_plan)

__all__ = [
    "BlockLedger",
    "DEFAULT_FACTOR",
    "PlanError",
    "ShardBlock",
    "ShardError",
    "ShardPlan",
    "StragglerPolicy",
    "load_plan",
    "merge_block_states",
    "mirror_after_s",
    "mirror_after_wall_s",
    "plan_shards",
    "run_sharded",
    "run_sharded_refresh",
    "write_json_atomic",
    "write_plan",
]
