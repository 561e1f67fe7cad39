"""Canonical cache-key digests and the view-neutral key registry.

The port's own copy of `avenir_tpu/core/keys.py`, every recipe unchanged:
each digest and tuple here equals the JAX package's on the same inputs
(held by `tests/test_torch_score.py`), so a cache keyed by one package
is keyed the same by the other.

- :data:`VIEW_NEUTRAL_KEYS` — config-key substrings that never fold into
  a view digest (they name where a job's resumable state lives or
  whether the tuner records, not how bytes are parsed or folded).
- :func:`key_site` — the no-op annotation binding each key function to
  the name of the key site it implements.

The score plane (`server/score.py`) uses :func:`model_tuple`; the other
recipes serve the host services still to be ported (the sidecar, the
incremental checkpoint, the job server's batching and warm miners).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Sequence

#: Config-key SUBSTRINGS that are view-neutral by contract: matching
#: keys only name WHERE a job's resumable state lives / whether the
#: tuner records — never how bytes are parsed or folded. The autotune
#: control keys must be digest-neutral so a job server injecting its
#: profile dir (or an operator flipping recording on) does not
#: invalidate every checkpoint; the knob keys the tuner OVERLAYS (block
#: size etc.) are ordinary prefixed props and stay in the digest, which
#: is what re-scans cold exactly when a knob value actually changes.
VIEW_NEUTRAL_KEYS = (
    "incremental.state.dir",
    "stream.autotune",
)


def is_view_neutral(key: str) -> bool:
    """Whether a config key is declared view-neutral (substring match,
    the historical ``_conf_digest`` semantics)."""
    return any(frag in key for frag in VIEW_NEUTRAL_KEYS)


def key_site(name: str) -> str:
    """No-op marker binding a key function to its ``KEY_SITES`` entry.

    Purely declarative — returns its argument so the call is free of
    side effects; the keys auditor (`analysis/keys.py`) reads the names.
    """
    return name


# ===================================================== conf-view digest
def conf_digest(cfg) -> str:
    """Content digest of the configuration view a cached artifact was
    computed under: every prefixed property (minus the
    :data:`VIEW_NEUTRAL_KEYS` matches) plus the schema file's BYTES
    when one is configured. A restored carry must have parsed its
    prefix under the same view of the corpus the delta will be parsed
    under — any conf or schema-content change invalidates the cache.
    Deliberately conservative: a changed block size or checkpoint
    interval also re-scans cold (folds are proven chunk-invariant, but
    a rare cold refresh is cheaper than reasoning about which keys are
    view-affecting as the conf surface grows).

    key-covered: all — every non-neutral prefixed property folds in.
    """
    key_site("checkpoint.manifest")
    h = hashlib.sha1()
    for k in sorted(cfg.props):
        if is_view_neutral(k):
            continue
        h.update(f"{k}={cfg.props[k]}\n".encode())
    schema_path = cfg.get("feature.schema.file.path")
    if schema_path:
        try:
            with open(schema_path, "rb") as fh:
                h.update(fh.read())
        except OSError:
            h.update(b"<unreadable schema>")
    return h.hexdigest()


# ==================================================== corpus identities
def state_digest(canonical: str, inputs: Sequence[str]) -> str:
    """Stable identity of a (job, input set): blake2b over the job's
    canonical name and the absolute input paths. Names WHERE durable
    per-(job, corpus) state lives (incremental state dirs, server
    checkpoint dirs) — content-independent on purpose, the state is
    supposed to FOLLOW a corpus through appends; content validity is
    proven separately by the stored block fingerprints.

    normalization: abspath — paths fold as ``os.path.abspath``.
    """
    return hashlib.blake2b(
        "\0".join([canonical] + [os.path.abspath(p) for p in inputs])
        .encode(), digest_size=8).hexdigest()


def corpus_digest(inputs: Sequence[str]) -> str:
    """Stable identity of an input set: blake2b over the absolute paths
    (the incremental state-dir recipe, minus the job). Content-
    independent on purpose: an autotune profile is supposed to FOLLOW a
    corpus through appends — the signals it holds age out of the window
    naturally.

    normalization: abspath — paths fold as ``os.path.abspath``.
    """
    key_site("autotune.profile")
    return hashlib.blake2b(
        "\0".join(os.path.abspath(p) for p in inputs).encode(),
        digest_size=8).hexdigest()


# ================================================= sidecar directories
def sidecar_config_digest(format_version: int, kind: str, delim: str,
                          block_bytes: int, extra) -> str:
    """The sidecar directory's parse-view digest: format version, scan
    kind, delimiter, block size, and the kind-specific extra (dataset:
    the normalized schema digest; bytes: the skip count). Any change
    names a DIFFERENT directory — the sidecar never invalidates in
    place, stale views just stop being referenced and age out under
    the byte budget.

    normalization: json — the view folds as a sorted-keys JSON list.
    """
    return hashlib.sha1(json.dumps(
        [format_version, kind, delim, int(block_bytes), extra],
        sort_keys=True).encode()).hexdigest()


# ==================================================== job-server tuples
def compat_tuple(mode: str, inputs: Sequence[str], kind: str,
                 block_mb: float, delim: str, schema) -> tuple:
    """The batching key: two requests with EQUAL keys can ride one
    SharedScan pass (same mode, same corpus, same scan kind, same
    stream block size, same field delimiter, and — for Dataset folds —
    the same schema file: exactly the preconditions
    ``runner.run_shared`` / ``run_incremental_shared`` enforce).

    normalization: abspath — paths fold as ``os.path.abspath``;
    block size rounds to 6 decimals so float formatting cannot split a
    batch.
    """
    key_site("compat.batch")
    return (mode,
            tuple(os.path.abspath(p) for p in inputs),
            kind,
            round(float(block_mb), 6),
            delim,
            schema)


def source_tuple(canonical: str, inputs: Sequence[str], delim: str,
                 skip: int, marker, tid_ord: int) -> tuple:
    """Warm identity of a miner source: the scan-shaping config
    (delimiter, skipped meta fields, infrequent-item marker,
    transaction-id ordinal) plus the corpus paths. Mining parameters
    (support threshold, max length) deliberately EXCLUDED — pass 1
    does not depend on them, so one warm source serves any mining
    request over the corpus. Content validity is the cache's own
    per-block fingerprint gate, not this tuple.

    normalization: abspath — paths fold as ``os.path.abspath``.
    key-covered: fia.support.threshold fia.item.set.length
    fia.max.item.set.length — pass-1-independent mining parameters.
    """
    key_site("warm.miner")
    return (canonical,
            tuple(os.path.abspath(p) for p in inputs),
            delim,
            int(skip),
            marker,
            int(tid_ord))


def model_tuple(kind: str, path: str, artifact_digest: str,
                schema_digest: str, format_version: int,
                dims: Sequence) -> tuple:
    """Warm identity of a SERVED model (the score plane's model cache,
    server/score.py): the scoreable family, the artifact path and its
    CONTENT digest (a retrained artifact under the same path is a
    different model — the cache must miss, never serve the old fit),
    the schema digest shaping feature encoding ('' for families that
    parse without one), the artifact's stamped ``format_version`` (0
    when unstamped — a foreign restamp must miss, not hit a warm entry
    loaded under the old layout), and the kind dims: the loader/
    classifier config that shapes the in-memory object (delimiter,
    class labels, threshold, bandit journal digest, ...). Request-time
    parameters (the row, bandit round/algorithm) deliberately EXCLUDED
    — one warm model serves any request over the artifact.

    normalization: abspath — the artifact path folds as
    ``os.path.abspath``; dims fold as a tuple of strings.
    key-covered: score.batch.window.ms score.batch.max
    score.cache.budget.mb — dispatch shaping and cache budget knobs
    change HOW a model is served, never WHAT it computes.
    """
    key_site("score.model")
    return (kind,
            os.path.abspath(path),
            artifact_digest,
            schema_digest,
            int(format_version),
            tuple(str(d) for d in dims))
