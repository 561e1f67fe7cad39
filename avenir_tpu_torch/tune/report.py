"""`python -m avenir_tpu_torch tune <dir>`: inspect and explain autotune
decisions.

The port's copy of `avenir_tpu/tune/report.py`, rendering the same text
on the same store. It lists every profile under an autotune directory
(the ``.avenir_tune/`` next to a corpus, or a ``stream.autotune.dir``):
the chosen knobs with the policy reasons that picked them, the latest
run's signal balance, the fold-cost mean the server's batch balancer
reads, and the residual-correction factor admission would apply.
"""

from __future__ import annotations

import json
from typing import Dict, List

from avenir_tpu_torch.tune.knobs import KNOBS
from avenir_tpu_torch.tune.policy import residual_factor
from avenir_tpu_torch.tune.store import ProfileStore


def profile_row(prof: Dict) -> Dict:
    """One profile's JSON summary row (pure function of the dict, so
    tests pin the rendering without a filesystem)."""
    runs = prof.get("runs") or []
    latest = runs[-1] if runs else {}
    sig = latest.get("signals") or {}
    residuals = prof.get("residuals") or []
    knobs = dict(prof.get("knobs") or {})
    return {
        "job": prof.get("job"),
        "corpus_digest": prof.get("corpus_digest"),
        "runs": len(runs),
        "knobs": knobs,
        "defaults_moved": sorted(
            k for k, v in knobs.items()
            if float(v) != float(KNOBS[k].default)),
        "reasons": list(prof.get("reasons") or []),
        "fold_cost_ms": prof.get("fold_cost_ms"),
        "residual_records": len(residuals),
        "residual_factor": round(residual_factor(residuals), 3),
        "latest_wall_s": latest.get("wall_s"),
        "latest_signals": sig,
    }


def render_profiles(rows: List[Dict]) -> str:
    lines: List[str] = []
    if not rows:
        return "no autotune profiles found"
    for row in rows:
        lines.append(f"{row['job']}  corpus={row['corpus_digest']}  "
                     f"runs={row['runs']}  "
                     f"residual_factor={row['residual_factor']}"
                     + (f"  fold_cost_ms={row['fold_cost_ms']}"
                        if row.get("fold_cost_ms") else ""))
        if row["knobs"]:
            lines.append("  knobs: " + ", ".join(
                f"{k}={v:g}" for k, v in sorted(row["knobs"].items())))
        else:
            lines.append("  knobs: (defaults)")
        for reason in row["reasons"]:
            lines.append(f"    - {reason}")
        sig = row.get("latest_signals") or {}
        if sig:
            lines.append(
                f"  last run: wall={sig.get('wall_s', 0)}s "
                f"read={sig.get('read_s', 0)}s "
                f"parse={sig.get('parse_s', 0)}s "
                f"fold={sig.get('fold_s', 0)}s "
                f"chunks={sig.get('chunks', 0)} "
                f"producer_bound={sig.get('producer_bound_s', 0)}s "
                f"consumer_bound={sig.get('consumer_bound_s', 0)}s")
    return "\n".join(lines)


def tune_main(argv) -> int:
    """CLI body for ``python -m avenir_tpu_torch tune <dir>``."""
    import argparse

    ap = argparse.ArgumentParser(prog="avenir_tpu_torch tune")
    ap.add_argument("path", help="autotune directory (.avenir_tune or "
                                 "a stream.autotune.dir)")
    ap.add_argument("--json", action="store_true",
                    help="emit the raw profile rows instead of the table")
    args = ap.parse_args(argv)
    try:
        profiles = ProfileStore(args.path).profiles()
    except Exception as e:                          # incl. KnobError: a
        print(f"cannot load autotune profiles from {args.path!r}: {e}")
        return 2                                    # bad profile is loud
    rows = [profile_row(p) for p in profiles]
    print(json.dumps(rows, indent=1) if args.json
          else render_profiles(rows))
    return 0
