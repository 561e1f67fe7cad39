"""Make the JAX package's native CSV library ready before any comparison.

The port's tests hold its native route, and its footprint prediction
(`Mem:PredictedPeakBytes`), against the JAX package's. The reference
builds `avenir_tpu/native/libcsv_ingest.so` lazily: g++ writes straight
to the library's path with no lock and no rename, and one failed load
sets `_build_failed` for the life of the process. When several pytest
workers collect at once on a fresh checkout, one of them can lose that
race and run the reference's Python route, and then every comparison
with the native route in that process fails.

Importing this module settles it for the process: under an exclusive
`fcntl` lock on a file in the git-ignored `build/` directory, it builds
the library when it is missing, older than `csv_ingest.cpp` or fails to
load (the reference's own g++ command, into a sibling temporary name,
then `os.replace` onto the library's path), resets the reference
module's `_build_failed` and `_lib` in this process and calls its
`native_available()`. pytest-xdist collects every file on every worker
before it runs a test, so each worker has settled before any comparison
runs. Without g++ both packages take their Python route, and `STATUS`
says why.

Nothing in `avenir_tpu/` changes: the library is the reference's own
git-ignored build product, made by the reference's own command.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import warnings
from dataclasses import dataclass
from typing import Optional

from avenir_tpu.native import ingest as reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK_PATH = os.path.join(ROOT, "build", "avenir_tpu_torch",
                         "reference_native.lock")


@dataclass(frozen=True)
class Status:
    """What `ensure` found: whether the reference's native route is up in
    this process, whether this call built the library, and why not when
    it is down."""

    available: bool
    built: bool
    reason: Optional[str] = None


def _compile(src: str, lib: str) -> Optional[str]:
    """The reference's g++ command (`avenir_tpu/native/ingest.py`
    `_build`) into a temporary sibling, moved onto `lib` when it
    succeeds; the failure's text when it does not."""
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-pthread", "-o", tmp, src],
            check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        return f"g++ failed: {e}"
    os.replace(tmp, lib)
    return None


def _loads(lib: str) -> bool:
    try:
        ctypes.CDLL(lib)
    except OSError:
        return False
    return True


def ensure(module=reference) -> Status:
    """Build `module`'s library if it is missing, stale or corrupt, reset
    the module's `_build_failed` and `_lib`, and report whether its
    `native_available()` holds now."""
    os.makedirs(os.path.dirname(LOCK_PATH), exist_ok=True)
    with open(LOCK_PATH, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            lib, src = module._LIB, module._SRC
            built, reason = False, None
            if (not os.path.exists(lib)
                    or os.path.getmtime(lib) < os.path.getmtime(src)
                    or not _loads(lib)):
                reason = _compile(src, lib)
                built = reason is None
            with module._lock:
                module._build_failed = False
                module._lib = None
            available = module.native_available()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    if not available and reason is None:
        reason = f"{lib} does not load"
    return Status(available, built, None if available else reason)


STATUS = ensure()
if not STATUS.available:
    warnings.warn("the JAX package's native CSV route is down in this "
                  f"process, so both packages take the Python route: "
                  f"{STATUS.reason}")
