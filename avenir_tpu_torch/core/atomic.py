"""Atomic publish: a file commits whole or not at all.

The port's own copy of `avenir_tpu/core/atomic.py`. Every shared file
(shard plans, ledger claims and states, checkpoints, journals) commits by
one discipline: the complete payload goes to a uniquely named sibling tmp
file, one `os.replace` (or `os.link`, for first-commit-wins) commits it,
and the tmp is removed on every failure path. A reader sees either no file
or a complete one, two racing writers never collide on a tmp name, and the
rename never crosses a filesystem.

The test hooks keep the reference's environment contract, so one harness
can arm either package:

- :func:`crash_point`: with ``AVENIR_PROTO_CRASH=<site>:<stage>`` the
  process hard-exits (code 43) at that commit site, just before or just
  after its rename; unset, the hook is one environment lookup.
- :func:`sched_point`: with ``AVENIR_RACE_SCHED=<turnstile-dir>:<actor>``
  the process parks at each step until a scheduler grants it, through
  ``ready.<actor>.<seq>`` / ``go.<actor>.<seq>`` files.
- :func:`sweep_stale_tmps`: a writer's startup removes the tmp files a
  hard-killed writer left behind, older than five minutes, so a live
  writer's tmp is never swept.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import List, Optional

#: the kill-injection variable: "<site>:<stage>" hard-exits the process
#: at that commit point
CRASH_ENV = "AVENIR_PROTO_CRASH"

#: the interleaving variable: "<turnstile-dir>:<actor-idx>" parks the
#: process at every sched_point until its step is granted
SCHED_ENV = "AVENIR_RACE_SCHED"

#: how long a parked actor waits for a grant
SCHED_TIMEOUT_S = 120.0

#: the stages every commit site exposes
BEFORE_RENAME = "before-rename"
AFTER_RENAME = "after-rename"

#: the injected crash's exit code, apart from a real error's
CRASH_EXIT = 43

#: a tmp file untouched this long was left by a writer that died before
#: its rename: no publish holds a tmp open for minutes
STALE_TMP_AGE_S = 300.0


def crash_point(site: str, stage: str) -> None:
    """Hard-exit (`os._exit(CRASH_EXIT)`) when ``AVENIR_PROTO_CRASH`` names
    this `site:stage`; otherwise nothing. Each commit site calls it just
    before and just after its atomic rename."""
    if os.environ.get(CRASH_ENV, "") == f"{site}:{stage}":
        os._exit(CRASH_EXIT)


#: step counters of sched_point, keyed by the variable's value, so a
#: new turnstile directory restarts the sequence at 0
_SCHED_SEQ: dict = {}


def sched_point(name: str) -> None:
    """Park here until an interleaving scheduler grants the next step when
    ``AVENIR_RACE_SCHED`` is set; otherwise nothing. The process publishes
    ``ready.<actor>.<seq>`` (holding `name`) into the turnstile directory,
    then waits for ``go.<actor>.<seq>``."""
    spec = os.environ.get(SCHED_ENV, "")
    if not spec:
        return
    turnstile, _, actor = spec.rpartition(":")
    seq = _SCHED_SEQ.get(spec, 0)
    _SCHED_SEQ[spec] = seq + 1
    tag = f"{actor}.{seq:04d}"
    ready = os.path.join(turnstile, f"ready.{tag}")
    wip = ready + ".wip"
    with open(wip, "w") as fh:
        fh.write(name)
    os.replace(wip, ready)
    go = os.path.join(turnstile, f"go.{tag}")
    deadline = time.monotonic() + SCHED_TIMEOUT_S
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"sched_point({name!r}): no grant for step {tag} "
                f"within {SCHED_TIMEOUT_S:.0f}s (scheduler gone?)")
        time.sleep(0.0005)


def unique_tmp(path: str) -> str:
    """A uniquely named tmp path in the same directory as `path`, so the
    commit rename stays on one filesystem; dot-prefixed, so a scan for
    committed names skips it, and `.tmp`-suffixed, so sweep_stale_tmps
    can remove it if its writer dies."""
    head, base = os.path.split(path)
    return os.path.join(head, f".{base}.{uuid.uuid4().hex[:8]}.tmp")


def publish_bytes(payload: bytes, path: str, site: Optional[str] = None,
                  fsync: bool = False) -> str:
    """Atomically publish `payload` at `path`. `site` names a commit point
    whose crash hook fires on both sides of the rename; `fsync` flushes the
    payload to disk before the commit."""
    tmp = unique_tmp(path)
    try:
        with open(tmp, "wb") as fh:
            fh.write(payload)
            if fsync:
                fh.flush()
                os.fsync(fh.fileno())
        if site is not None:
            crash_point(site, BEFORE_RENAME)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    if site is not None:
        crash_point(site, AFTER_RENAME)
    return path


def publish_json(obj, path: str, site: Optional[str] = None,
                 indent: Optional[int] = None, fsync: bool = False) -> str:
    """:func:`publish_bytes` for one JSON document (`json.dumps`, no
    indent by default: the same bytes as the JAX package writes)."""
    return publish_bytes(json.dumps(obj, indent=indent).encode("utf-8"),
                         path, site=site, fsync=fsync)


def is_tmp_name(name: str) -> bool:
    """True when `name` follows the tmp naming convention: the only files
    sweep_stale_tmps may remove."""
    base = os.path.basename(name)
    return base.endswith(".tmp") or ".tmp." in base


def sweep_stale_tmps(root: str,
                     min_age_s: float = STALE_TMP_AGE_S) -> List[str]:
    """Remove every tmp file under `root` (recursively) whose mtime is
    older than `min_age_s`; returns the removed paths. A racing sweeper or
    a writer that commits first is survived."""
    removed: List[str] = []
    if not os.path.isdir(root):
        return removed
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(dirnames)
        for name in sorted(filenames):
            if not is_tmp_name(name):
                continue
            path = os.path.join(dirpath, name)
            try:
                if time.time() - os.stat(path).st_mtime <= min_age_s:
                    continue
                os.remove(path)
            except OSError:
                continue
            removed.append(path)
    return removed
