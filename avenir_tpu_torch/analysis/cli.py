"""The auditors' command line: ``python -m avenir_tpu_torch.analysis``.

The port of `avenir_tpu/analysis/cli.py`:

- paths and no tier: the AST rules (`rules.py`) over the paths;
- ``--ir``: the IR rules over what the kernel manifest's seven op
  entries run on ``--device`` and what the eight distributed families
  run on a gloo world of eight CPU ranks, and the collective-payload
  audit of the families (`ir.py`); it takes no paths;
- ``--flow``: the flow rules over the paths (default: the port's
  package and `chip_smoke.py`) and the chunk-invariance audit of the
  stream entries;
- ``--mem``: the mem rules and the footprint audit (sampled RSS against
  the model at two block sizes);
- ``--merge``: the merge rules and the shard-merge, resume, incremental
  and sharded-steal audit;
- ``--keys``: the keys rules over the cache surface and the
  perturbation audit of the 11 key sites;
- ``--proto``: the proto rules over the protocol surface and the
  commit-point crash audit of the 13 commit sites;
- ``--race``: the race rules over the multi-writer surface and the
  interleaving audit of the 8 interleave sites (``--depth`` two-way
  choices exhaustively, then ``--seeds`` seeded schedules; default 3
  and 64), or one replayed trace (``--schedule SITE:DIGITS``).

Two or more tiers together run one after another in one process and
print ``{"modes": {<tier>: <report>}, "clean": bool}`` with ``--json``
(one tier prints its report alone), exiting with the worst code. The
audits run on ``--device``: cuda unless the caller asks for the CPU, as
every entry point of the port (without a card, an audit then fails to
run and the exit is 2). ``--rules`` takes a subset of the tiers' rule
ids (an audit runs only when its rule id is named); ``--no-baseline``
ignores the allowlist (`analysis/audit_baseline.txt`).

Exit codes, the reference's: 0 clean (no finding, no stale allowlist
entry, no parse error); 1 findings; 2 a usage error, an audit that
failed to run or an IR entry that failed to build or run (a "trace
error", as too small a world of ranks or a missing device).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from avenir_tpu_torch.analysis.engine import (default_baseline_path,
                                              load_baseline)

#: the audit tiers, in the order they run
TIERS = ("ir", "flow", "mem", "merge", "keys", "proto", "race")

#: the tier of paths given with no tier flag
AST_TIER = "rules"

#: how a tier's failure to run is named on stderr
_FAILED = {"ir": "trace error"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m avenir_tpu_torch.analysis",
        description="the port's AST rules and auditors")
    p.add_argument("paths", nargs="*",
                   help=".py/.md files or directories: alone, for the AST "
                        "rules; with a tier, for its rules (default: the "
                        "tier's own surface)")
    for tier, what in (("ir", "the IR rules over the kernel manifest and "
                              "the collective-payload audit (no paths)"),
                       ("flow", "the flow rules and the chunk-invariance "
                                "audit"),
                       ("mem", "the mem rules and the footprint audit"),
                       ("merge", "the merge rules and the shard-merge, "
                                 "resume, incremental and sharded-steal "
                                 "audit"),
                       ("keys", "the keys rules and the key-site "
                                "perturbation audit"),
                       ("proto", "the proto rules and the commit-point "
                                 "crash audit"),
                       ("race", "the race rules and the interleaving "
                                "audit")):
        p.add_argument(f"--{tier}", action="store_true", help=what)
    p.add_argument("--schedule", default=None, metavar="SITE:DIGITS",
                   help="with --race: replay exactly one interleaving "
                        "trace, e.g. ledger.claim:01101")
    p.add_argument("--depth", type=int, default=3,
                   help="with --race: the two-way choices explored "
                        "exhaustively (default 3)")
    p.add_argument("--seeds", type=int, default=64,
                   help="with --race: the seeded schedules after them "
                        "(default 64)")
    p.add_argument("--device", default="cuda",
                   help="where the audits run the stream entries and the "
                        "IR op entries (cuda or cpu; default cuda)")
    p.add_argument("--baseline", default=None,
                   help="allowlist file (default: avenir_tpu_torch/"
                        "analysis/audit_baseline.txt)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, ignoring the allowlist")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print one JSON object instead of text")
    p.add_argument("--rules", default=None, metavar="ID[,ID...]",
                   help="a subset of the tiers' rule ids (an audit runs "
                        "only when its own id is named)")
    p.add_argument("--no-md", action="store_true",
                   help="skip ```python fences in .md files")
    p.add_argument("--allow-stale", action="store_true",
                   help="do not fail on allowlist entries that no longer "
                        "match")
    return p


def _report_root(args) -> Optional[str]:
    """The root finding keys are relative to: the checkout (where the
    default allowlist's keys point), an explicit allowlist's directory,
    or the working directory without one."""
    if args.baseline:
        return os.path.dirname(os.path.abspath(args.baseline))
    if args.no_baseline:
        return None
    return os.path.dirname(os.path.dirname(os.path.dirname(
        default_baseline_path())))


def _tiers():
    """tier -> (rule classes, audit rule id, audit error, runner)."""
    from avenir_tpu_torch.analysis import (flow, ir, keys, mem, merge, proto,
                                           race)

    def run_ir(paths, rules, baseline, root, include_md, audit, device):
        return ir.run_ir(rules=rules, baseline=baseline, audit=audit,
                         device=device)

    return {
        "ir": (ir.ALL_IR_RULES, ir.PAYLOAD_RULE, ir.IRTraceError, run_ir),
        "flow": (flow.ALL_FLOW_RULES, flow.FLOW_AUDIT_RULE,
                 flow.FlowAuditError, flow.run_flow),
        "mem": (mem.ALL_MEM_RULES, mem.MEM_AUDIT_RULE, mem.MemAuditError,
                mem.run_mem),
        "merge": (merge.ALL_MERGE_RULES, merge.MERGE_AUDIT_RULE,
                  merge.MergeAuditError, merge.run_merge),
        "keys": (keys.ALL_KEYS_RULES, keys.KEYS_AUDIT_RULE,
                 keys.KeysAuditError, keys.run_keys),
        "proto": (proto.ALL_PROTO_RULES, proto.PROTO_AUDIT_RULE,
                  proto.ProtoAuditError, proto.run_proto),
        "race": (race.ALL_RACE_RULES, race.RACE_AUDIT_RULE,
                 race.RaceAuditError, race.run_race),
    }


def _run_ast(args, baseline, wanted) -> int:
    """The AST tier: the rules of `rules.py` over the paths."""
    from avenir_tpu_torch.analysis.rules import ALL_RULES, run_rules

    rules = [c() for c in ALL_RULES if wanted is None or c.rule_id in wanted]
    try:
        report = run_rules(args.paths, rules=rules, baseline=baseline,
                           root=_report_root(args),
                           include_md=not args.no_md)
    except OSError as e:
        print(f"avenir_tpu_torch.analysis: cannot read input: {e}",
              file=sys.stderr)
        return 2
    if args.as_json:
        print(json.dumps(report.to_json(), indent=1))
    else:
        _print_report(AST_TIER, report)
    return _exit_code(report, args)


def _summary(name: str, report) -> str:
    tail = ""
    if report.payload_audit:
        ok = sum(1 for r in report.payload_audit
                 if r["payload_model_validated"])
        tail += (f", payload audit {ok}/{len(report.payload_audit)} "
                 f"families validated")
    for key, flag, what in (
            ("invariance_audit", "invariance_validated", "chunk-invariance"),
            ("footprint_audit", "footprint_model_validated", "footprint"),
            ("merge_audit", "merge_validated", "merge"),
            ("key_audit", "key_validated", "key-perturbation"),
            ("proto_audit", "commit_point_validated", "commit-point"),
            ("race_audit", "interleaving_validated", "interleaving")):
        rows = getattr(report, key)
        if rows:
            ok = sum(1 for r in rows if r[flag])
            tail += f", {what} audit {ok}/{len(rows)} validated"
    return (f"{name}: {len(report.scanned)} files, "
            f"{len(report.findings)} finding(s), "
            f"{len(report.suppressed)} allowlisted, "
            f"{len(report.stale)} stale allowlist entr(y/ies)"
            + (f", {len(report.errors)} parse error(s)"
               if report.errors else "") + tail)


def _print_report(name: str, report) -> None:
    for f in report.errors + report.findings:
        print(f.render())
    for e in report.stale:
        print(f"stale allowlist entry (line {e.lineno}): {e.key}: the "
              f"finding it excused is gone; delete it", file=sys.stderr)
    print(_summary(name, report))


def _exit_code(report, args) -> int:
    if report.findings or report.errors:
        return 1
    if report.stale and not args.allow_stale:
        return 1
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.ir and args.paths:
        print("avenir_tpu_torch.analysis: --ir records the kernel manifest; "
              "do not pass paths (run the two modes as two invocations)",
              file=sys.stderr)
        return 2
    chosen = [t for t in TIERS if getattr(args, t)]
    if args.schedule and not args.race:
        print("avenir_tpu_torch.analysis: --schedule replays an "
              "interleaving trace and needs --race", file=sys.stderr)
        return 2
    if not chosen and not args.paths:
        print("avenir_tpu_torch.analysis: pass paths for the AST rules, "
              "or --ir / --flow / --mem / --merge / --keys / --proto / "
              "--race for the audits", file=sys.stderr)
        return 2
    schedule = None
    if args.schedule:
        from avenir_tpu_torch.analysis.race import parse_schedule
        try:
            schedule = parse_schedule(args.schedule)
        except ValueError as e:
            print(f"avenir_tpu_torch.analysis: {e}", file=sys.stderr)
            return 2
    tiers = _tiers() if chosen else {}
    wanted = None
    if args.rules:
        from avenir_tpu_torch.analysis.rules import rule_ids

        wanted = [r.strip() for r in args.rules.split(",") if r.strip()]
        known = ({rid for t in chosen
                  for rid in [c.rule_id for c in tiers[t][0]]
                  + [tiers[t][1]]} if chosen else set(rule_ids()))
        unknown = set(wanted) - known
        if unknown:
            print(f"avenir_tpu_torch.analysis: unknown rule(s): "
                  f"{', '.join(sorted(unknown))}", file=sys.stderr)
            return 2
    try:
        baseline = ([] if args.no_baseline
                    else load_baseline(args.baseline))
    except ValueError as e:
        print(f"avenir_tpu_torch.analysis: {e}", file=sys.stderr)
        return 2

    if not chosen:
        return _run_ast(args, baseline, wanted)
    extra = {"race": {"depth": args.depth, "seeds": args.seeds,
                      "schedule": schedule}}
    modes = {}
    worst = 0
    for name in chosen:
        classes, audit_rule, err_cls, run = tiers[name]
        rules = [c() for c in classes
                 if wanted is None or c.rule_id in wanted]
        audit = wanted is None or audit_rule in wanted
        t0 = time.monotonic()
        try:
            report = run(paths=args.paths or None, rules=rules,
                         baseline=baseline, root=_report_root(args),
                         include_md=not args.no_md, audit=audit,
                         device=args.device, **extra.get(name, {}))
        except (err_cls, OSError) as e:
            print(f"avenir_tpu_torch.analysis [{name}]: "
                  f"{_FAILED.get(name, 'audit failed to run')}: {e}",
                  file=sys.stderr)
            modes[name] = {"error": str(e),
                           "wall_s": round(time.monotonic() - t0, 3)}
            worst = 2
            continue
        modes[name] = dict(report.to_json(),
                           wall_s=round(time.monotonic() - t0, 3))
        worst = max(worst, _exit_code(report, args))
        if not args.as_json:
            _print_report(name, report)
    if args.as_json:
        if len(chosen) == 1:        # the report alone: the reference's schema
            one = modes[chosen[0]]
            if "error" not in one:
                one = {k: v for k, v in one.items() if k != "wall_s"}
            print(json.dumps(one, indent=1))
        else:
            print(json.dumps({"modes": modes, "clean": worst == 0},
                             indent=1))
    return worst


if __name__ == "__main__":
    sys.exit(main())
