"""Format stamps for model artifacts.

The port's own copy of `avenir_tpu/models/artifact.py`'s stamp contract. A
trained artifact (the Naive Bayes distribution file) is a delimited text
file; its stamp rides in an atomic sidecar `<artifact>.stamp.json` holding
the format version and a sha1 digest of the artifact's bytes, written as
the JAX package writes it, so the two packages' sidecars are
byte-identical and each loads the other's.

- an artifact with no sidecar is a legacy artifact and loads unverified;
- a stamped artifact loads only if its digest still matches its bytes;
- a stamp naming another format version refuses with ModelFormatSkew.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

from avenir_tpu_torch.core.atomic import publish_json

#: layout generation of the delimited model artifacts this build writes
MODEL_FORMAT_VERSION = 1

_STAMP_SUFFIX = ".stamp.json"


class ModelFormatSkew(RuntimeError):
    """A model artifact's stamp names a format this build does not speak,
    or its digest no longer matches the bytes: the load refuses."""


def stamp_path(path: str) -> str:
    return path + _STAMP_SUFFIX


def file_digest(path: str) -> str:
    """Content digest of one artifact file (sha1, hex)."""
    h = hashlib.sha1()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_stamp(path: str) -> str:
    """Publish the sidecar stamp of an artifact that was just written."""
    return publish_json({"format_version": MODEL_FORMAT_VERSION,
                         "digest": file_digest(path)}, stamp_path(path))


def read_stamp(path: str) -> Optional[dict]:
    """The artifact's stamp document, or None when unstamped. A sidecar
    that cannot be read or parsed is skew, not absence."""
    try:
        with open(stamp_path(path)) as fh:
            return json.load(fh)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as exc:
        raise ModelFormatSkew(
            f"unreadable stamp beside {path}: {exc}") from exc


def stamp_version(path: str) -> int:
    """The stamped format version, 0 for an unstamped legacy artifact: a
    dimension of the score plane's cache key, so a restamp to a foreign
    version misses."""
    stamp = read_stamp(path)
    return int(stamp.get("format_version", 0)) if stamp else 0


def verify_stamp(path: str) -> Optional[dict]:
    """Digest-verified load gate: the stamp (None when unstamped); raises
    ModelFormatSkew when the stamp names a foreign format or no longer
    matches the artifact's bytes."""
    stamp = read_stamp(path)
    if stamp is None:
        return None
    version = stamp.get("format_version")
    if version != MODEL_FORMAT_VERSION:
        raise ModelFormatSkew(
            f"{path}: stamped format_version={version!r}, this build "
            f"speaks {MODEL_FORMAT_VERSION} — refusing to parse a "
            f"foreign layout (retrain or upgrade)")
    digest = file_digest(path)
    if stamp.get("digest") != digest:
        raise ModelFormatSkew(
            f"{path}: artifact digest {digest[:12]} does not match its "
            f"stamp {str(stamp.get('digest'))[:12]} — artifact changed "
            f"under its stamp")
    return stamp


def rm_stamp(path: str) -> None:
    """Drop the sidecar (an absent one is fine)."""
    try:
        os.remove(stamp_path(path))
    except FileNotFoundError:
        pass
