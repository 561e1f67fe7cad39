"""The port's share of `avenir_tpu/analysis/`: the auditors.

- `engine.py`: findings, the allowlist (`audit_baseline.txt`, a
  justified line an entry), the AST context and the rule runner;
- `manifest.py`: the eight stream entries the audits drive (the stream
  half of the reference's manifest);
- `flow.py`: the concurrency rules and the chunk-invariance audit;
- `mem.py`: the memory rules, the footprint model the job server admits
  by, its RSS audit and the memory manifest (with a row a CUDA kernel);
- `merge.py`: the merge-algebra rules and the shard-merge, resume,
  incremental and sharded-steal audit;
- `cli.py`: ``python -m avenir_tpu_torch.analysis --flow --mem --merge
  [--json] [--device cuda]``.

The span-coverage audit is `obs/coverage.py`. The IR tier lowers jaxprs
and is never ported; the AST rules of `rules.py`, `keys.py`,
`proto.py` and `race.py` are not ported yet (`ROADMAP.md` item 8).
Nothing here imports torch at import time.
"""
