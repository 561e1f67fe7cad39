"""Atomic publish: a file commits whole or not at all.

The port's own copy of `publish_bytes` / `publish_json` of
`avenir_tpu/core/atomic.py`, without its crash and schedule hooks: the
payload goes to a uniquely named sibling tmp file, which one `os.replace`
commits, and the tmp is removed on every failure path. A reader sees
either no file or a complete one.
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Optional


def unique_tmp(path: str) -> str:
    """A uniquely named tmp path in the same directory as `path`, so the
    commit rename stays on one filesystem."""
    head, base = os.path.split(path)
    return os.path.join(head, f".{base}.{uuid.uuid4().hex[:8]}.tmp")


def publish_bytes(payload: bytes, path: str) -> str:
    """Atomically publish `payload` at `path`."""
    tmp = unique_tmp(path)
    try:
        with open(tmp, "wb") as fh:
            fh.write(payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return path


def publish_json(obj, path: str, indent: Optional[int] = None) -> str:
    """:func:`publish_bytes` for one JSON document (`json.dumps`, no
    indent by default: the same bytes as the JAX package writes)."""
    return publish_bytes(json.dumps(obj, indent=indent).encode("utf-8"), path)
