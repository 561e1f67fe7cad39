"""Wall seconds of each phase of a checkout's `chip_smoke.py`.

    python3 avenir_tpu_torch/tools/smoke_clock.py [ROOT] [--out FILE]

loads ROOT/chip_smoke.py (by default this checkout's), wraps each of its
module-level `phase_*` functions in a wall clock, runs its `main()` and
then prints one JSON line, `{"root": ..., "rc": ..., "total_s": ...,
"phase_seconds": {name: seconds, ...}}`, the phases in the order they
ran (a phase that calls another is timed with it); FILE gets the same
object. Run it as a file, not with `-m`: ROOT's script then imports
ROOT's own package, so that two checkouts (a commit unpacked with `git
archive` and its change) are timed one after the other on the same card
in one call. It imports nothing of the port itself.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _clocked(name: str, fn, seconds: dict):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds[name] = round(seconds.get(name, 0.0)
                                  + time.perf_counter() - t0, 1)
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=str(HERE.parents[1]))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    # ROOT first; never this tools directory (its bench.py and others)
    sys.path[:] = [str(root)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != HERE]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    seconds: dict = {}
    for name in [n for n in vars(smoke) if n.startswith("phase_")]:
        fn = getattr(smoke, name)
        if callable(fn):
            setattr(smoke, name, _clocked(name, fn, seconds))
    rc, t0 = 0, time.perf_counter()
    try:
        smoke.main()
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    line = {"root": str(root), "rc": rc,
            "total_s": round(time.perf_counter() - t0, 1),
            "phase_seconds": seconds}
    print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(line, indent=1) + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
