"""Incremental delta-scan state: content block fingerprints and atomic
fold-state checkpoints.

The port's own copy of `avenir_tpu/core/incremental.py`, every format
unchanged. A corpus that only grows need not be re-scanned from byte 0:
the fold-state merge algebra (``merge(fold(A), fold(B)) == fold(A++B)``
byte for byte, `StreamFoldOps`) lets a refresh restore the carry of the
scanned prefix and fold only the delta. Two pieces of driver state make
that safe:

- **Block fingerprints**: every byte block a scan folds is recorded as
  ``(offset, length, content hash)``. Two files that agree on a
  fingerprint prefix agree byte for byte on the covered range, so an
  append invalidates nothing and an in-place edit invalidates exactly
  the blocks from the edit on. The incremental runner, the encoded-block
  cache's per-source segments and the columnar sidecar all trust a block
  by this triple, never by an mtime.
- **Checkpoints**: a scan's carry (``StreamFoldOps.serialize_state`` npz
  bytes) beside a JSON manifest naming the covered watermark and the
  fingerprints behind it, written so that a torn checkpoint never
  commits. ``runner.run_incremental`` restores the newest one, folds
  only the blocks past its watermark and re-emits the artifact: the same
  mechanism serves the append refresh (the watermark is the end of the
  previous corpus) and the resume of a killed scan (the watermark is its
  last periodic checkpoint).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional, Sequence, Tuple

from avenir_tpu_torch.core.atomic import (publish_bytes, sched_point,
                                          sweep_stale_tmps)

#: fingerprint hash: sha1, the reference's choice (a faster stream than
#: blake2b and 160 bits, where crc32 is 32); the same hash makes a
#: fingerprint table readable by either package
_HASH = hashlib.sha1

#: test hook: when set, called with the manifest dict right after every
#: committed checkpoint write; the crash tests install an os._exit here
#: to kill a scan just after a mid-scan checkpoint. None in production.
_checkpoint_hook = None


def block_hash(data: bytes) -> str:
    return _HASH(data).hexdigest()


def block_fingerprint(offset: int, data: bytes) -> Dict[str, object]:
    """The per-block validity unit of every delta scan: absolute file
    offset, byte length and content hash of one line-aligned block."""
    return {"offset": int(offset), "length": len(data),
            "hash": block_hash(data)}


def _fp_reads(path: str, fps: Sequence[dict]):
    """Sequential reads of the recorded block lengths — the producer
    half of verified_prefix, run in a prefetch thread so disk read and
    hashing overlap (hashlib releases the GIL for large buffers; the
    hash is the incremental driver's per-refresh floor, so halving its
    wall time is a direct speedup of every append-refresh)."""
    with open(path, "rb") as fh:
        fh.seek(int(fps[0]["offset"]))
        for fp in fps:
            yield fh.read(int(fp["length"]))


def verified_prefix(path: str, fps: Sequence[dict]) -> Tuple[int, int]:
    """(n_blocks, covered_end_offset) of the longest recorded-fingerprint
    prefix that still content-matches `path`.

    Offsets must tile gap-free from the first recorded offset and every
    block's bytes must re-hash to the recorded value — one sequential
    read of the covered range (prefetched, so IO overlaps the hash), no
    parse. Verification stops at the first mismatch: an in-place edit
    invalidates everything from the edited block on, while a pure
    append invalidates nothing (appended bytes sit past the last
    recorded block's end)."""
    from avenir_tpu_torch.core.stream import prefetched

    n = 0
    covered = 0
    if not fps:
        return 0, 0
    try:
        size = os.path.getsize(path)
        expect = int(fps[0]["offset"])
        feed = prefetched(_fp_reads(path, fps), depth=2)
        try:
            for fp, data in zip(fps, feed):
                off, length = int(fp["offset"]), int(fp["length"])
                # geometry first: the reader streams assuming contiguity,
                # so a gap means the bytes it handed over are untrusted
                if off != expect or off + length > size:
                    break
                if len(data) != length or block_hash(data) != fp["hash"]:
                    break
                expect = off + length
                n += 1
                covered = expect
        finally:
            feed.close()
    except OSError:
        return 0, 0
    return n, covered


def ends_at_newline(path: str, offset: int) -> bool:
    """True when a watermark at `offset` sits on a line boundary (the
    byte before it is ``\\n``, or it is the start of the file). A
    recorded coverage whose final block does NOT end at a newline came
    from a corpus whose last line had no terminator — the already-folded
    row and any appended bytes form ONE line, so resuming past the
    watermark would silently skip the row's continuation. Delta gates
    (run_incremental's restore plan, EncodedBlockCache.source_delta)
    treat a grown file behind a mid-line watermark as unusable: cold
    re-scan, never a spliced row."""
    if offset <= 0:
        return True
    try:
        with open(path, "rb") as fh:
            fh.seek(offset - 1)
            return fh.read(1) == b"\n"
    except OSError:
        return False


class CheckpointStore:
    """Atomic on-disk checkpoint of one incremental scan: a carry blob
    next to a JSON manifest, under a per-(job, corpus) state directory.

    Write protocol — a torn checkpoint must NEVER commit (the standing
    cache/checkpoint contract): the carry blob lands first under a
    unique name (write to ``.tmp``, rename), then the manifest — which
    records the carry's file name, byte length and content hash —
    replaces the previous one the same way. A killed process leaves
    either the previous consistent pair or the new one on disk, and
    ``load()`` re-verifies the referenced blob's length and hash,
    returning None for anything missing, truncated or unparsable — the
    driver then falls back to a cold scan instead of resuming from
    (and committing) a wrong carry. No fsync: the hash-verified load is
    what makes a torn pair a detected cold fallback rather than a wrong
    resume, so an unflushed page at power loss costs a re-scan, where an
    fsync would cost every checkpoint its flush (the reference's
    choice). Superseded carry files are removed only after the new
    manifest is in place.

    Single-writer: one incremental scan owns a state dir (the dir is
    keyed per (job, corpus)); concurrent SAVERS are out of contract.
    Concurrent READERS are in contract — the hash-verified load plus
    content-addressed carry names make every interleaving of save()
    and load() a consistent pair or a detected cold fallback (the
    `checkpoint.save` / `checkpoint.load` schedule points)."""

    MANIFEST = "MANIFEST.json"
    #: manifest layout version; a manifest stamped with a DIFFERENT
    #: version refuses to load (cold start) — old readers must never
    #: silently parse a newer layout. A MISSING stamp is a
    #: pre-versioning checkpoint and still loads.
    FORMAT_VERSION = 1

    def __init__(self, state_dir: str):
        self.dir = state_dir
        os.makedirs(state_dir, exist_ok=True)
        # startup GC: tmp files a hard-killed writer left behind (the
        # age gate keeps a concurrent writer's live tmp safe)
        sweep_stale_tmps(state_dir)

    def _write_atomic(self, path: str, payload: bytes,
                      site: Optional[str] = None) -> None:
        publish_bytes(payload, path, site=site)

    def save(self, meta: dict, blob: bytes) -> dict:
        """Commit one checkpoint; returns the manifest actually written
        (meta plus the carry bookkeeping fields)."""
        token = f"{int(meta.get('seq', 0)):06d}_{block_hash(blob)[:8]}"
        carry = f"carry_{token}.npz"
        meta = dict(meta, carry_file=carry, carry_bytes=len(blob),
                    carry_hash=block_hash(blob))
        meta.setdefault("format_version", self.FORMAT_VERSION)
        sched_point("checkpoint.save")
        self._write_atomic(os.path.join(self.dir, carry), blob)
        # the manifest replace IS the commit point — the carry above is
        # invisible until the manifest references it
        sched_point("checkpoint.save")
        self._write_atomic(os.path.join(self.dir, self.MANIFEST),
                           json.dumps(meta, indent=1).encode(),
                           site="checkpoint.save")
        # superseded-carry GC races a concurrent load() holding the OLD
        # manifest: the loader finds its carry gone and reports None —
        # the cold-fallback contract, never a wrong resume
        sched_point("checkpoint.save")
        for name in os.listdir(self.dir):
            if (name.startswith("carry_") and name != carry) \
                    or name.endswith(".tmp"):
                try:
                    os.remove(os.path.join(self.dir, name))
                except OSError:
                    pass
        return meta

    def load(self) -> Optional[Tuple[dict, bytes]]:
        """(manifest, carry blob) of the newest committed checkpoint, or
        None when there is none — or when what is on disk is torn
        (missing/short/corrupt carry, unparsable manifest). A None here
        is the cold-scan fallback signal, never an error."""
        try:
            sched_point("checkpoint.load")
            with open(os.path.join(self.dir, self.MANIFEST), "rb") as fh:
                meta = json.loads(fh.read().decode())
            sched_point("checkpoint.load")
            with open(os.path.join(self.dir, str(meta["carry_file"])),
                      "rb") as fh:
                blob = fh.read()
            if meta.get("format_version",
                        self.FORMAT_VERSION) != self.FORMAT_VERSION:
                return None           # version skew: refuse, go cold
            if len(blob) != int(meta["carry_bytes"]) \
                    or block_hash(blob) != meta["carry_hash"]:
                return None
            return meta, blob
        except (OSError, ValueError, KeyError):
            return None

    def clear(self) -> None:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        for name in names:
            if name == self.MANIFEST or name.startswith("carry_") \
                    or name.endswith(".tmp"):
                try:
                    os.remove(os.path.join(self.dir, name))
                except OSError:
                    pass
