"""`avenir_tpu_torch/tools/smoke_clock.py`: the wall seconds of each phase
of a checkout's `chip_smoke.py`, on stand-in checkouts (a `chip_smoke.py`
whose phases sleep), run as a file the way it is run on the card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TOOL = ROOT / "avenir_tpu_torch" / "tools" / "smoke_clock.py"

FAKE = '''
import sys, time

def phase_one():
    time.sleep(0.2)

def phase_two(fail):
    phase_one()
    if fail:
        print("FAIL: stand-in", flush=True)
        sys.exit(1)

def main():
    import bench_marker  # a module of this root, not of the tool's dir
    phase_one()
    phase_two({fail})
    print(bench_marker.NAME, flush=True)
'''


@pytest.mark.parametrize("fail", [False, True])
def test_phases_timed_in_order_with_the_script_rc(tmp_path, fail):
    (tmp_path / "chip_smoke.py").write_text(FAKE.format(fail=fail))
    (tmp_path / "bench_marker.py").write_text("NAME = 'stand-in root'\n")
    out = tmp_path / "clock.json"
    proc = subprocess.run([sys.executable, str(TOOL), str(tmp_path),
                           "--out", str(out)], capture_output=True,
                          text=True, timeout=60)
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert proc.returncode == line["rc"] == (1 if fail else 0)
    assert json.loads(out.read_text()) == line
    assert line["root"] == str(tmp_path.resolve())
    secs = line["phase_seconds"]
    # both calls of phase_one add up; phase_two holds its own call of it
    assert list(secs) == ["phase_one", "phase_two"]
    assert secs["phase_one"] >= 0.4 - 0.05
    assert secs["phase_two"] >= 0.2 - 0.05
    assert ("stand-in root" in proc.stdout) is not fail
