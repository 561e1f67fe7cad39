"""The port's share of `avenir_tpu/analysis/`: the AST rules and the
auditors.

- `engine.py`: findings, the allowlist (`audit_baseline.txt`, a
  justified line an entry), the AST context and the rule runner;
- `rules.py`: the AST rules that apply to torch and numpy source
  (``python -m avenir_tpu_torch.analysis <paths>``);
- `manifest.py`: the IR tier's seven op entries and eight family
  entries, and the eight stream entries the audits drive;
- `ir.py`: the IR rules over what the op and family entries dispatch,
  and the collective-payload audit of the families on a gloo world of
  eight CPU ranks;
- `flow.py`: the concurrency rules and the chunk-invariance audit;
- `mem.py`: the memory rules, the footprint model the job server admits
  by, its RSS audit and the memory manifest (with a row a CUDA kernel);
- `merge.py`: the merge-algebra rules and the shard-merge, resume,
  incremental and sharded-steal audit;
- `keys.py`: the cache-key rules and the perturbation audit of the key
  sites;
- `proto.py`: the shared-file protocol rules and the commit-point crash
  audit;
- `race.py`: the cross-process race rules and the interleaving audit;
- `cli.py`: ``python -m avenir_tpu_torch.analysis [paths] [--ir]
  [--flow] [--mem] [--merge] [--keys] [--proto] [--race] [--json]
  [--device cuda]``.

The span-coverage audit is `obs/coverage.py`. Nothing here imports
torch at import time.
"""

from avenir_tpu_torch.analysis.engine import (Finding, Report,
                                              default_baseline_path,
                                              load_baseline, run_paths)
from avenir_tpu_torch.analysis.ir import (ALL_IR_RULES, PAYLOAD_RULE,
                                          IRTraceError, check_capture,
                                          ir_rule_ids, run_ir)
from avenir_tpu_torch.analysis.keys import run_keys
from avenir_tpu_torch.analysis.proto import run_proto
from avenir_tpu_torch.analysis.race import run_race
from avenir_tpu_torch.analysis.rules import ALL_RULES, rule_ids, run_rules

__all__ = ["Finding", "Report", "run_paths", "load_baseline",
           "default_baseline_path", "ALL_RULES", "rule_ids", "run_rules",
           "run_keys", "run_proto", "run_race", "ALL_IR_RULES",
           "PAYLOAD_RULE", "IRTraceError", "check_capture", "ir_rule_ids",
           "run_ir"]
