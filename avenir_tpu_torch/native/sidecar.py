"""Block-aligned columnar sidecar: parse a corpus once, stream binary after.

The port's own copy of `avenir_tpu/native/sidecar.py`, in the same on-disk
format: for the same corpus, schema and block size the two packages write
the same `columns.bin` and the same `MANIFEST.json`, and either package
replays what the other packed. Every streamed job re-parses its CSV text
on every scan; the sidecar keeps what the first scan parsed, a block at a
time, beside the corpus:

    <dir>/.avenir_sidecar/<basename>.<digest8>/
        MANIFEST.json    written last (tmp and rename), content-fingerprinted
        columns.bin      the packed column segments of each block

Two kinds share one manifest and segment shape:

- ``dataset``: each newline-aligned block of a schema-typed CSV packs per
  column: numerics as float32 pages, categoricals with a declared
  vocabulary as codes in the narrowest dtype that holds it, and strings
  and discovered categoricals as the native parser's compact
  newline-joined token buffers. A replay rebuilds the Dataset chunk the
  native parser would have made (the schema discovery and the lazy string
  columns included) without reading the CSV text.
- ``bytes``: each block keeps each row's tail-token count, the tail codes
  against a vocabulary the sidecar discovers (code + 1, 0 the empty
  token) and the skipped meta columns as token buffers, so the CSR
  consumers (the per-class markov fold, the miners' pass 1) rebuild their
  arrays from codes alone.

Trust: a manifest serves only after a content re-proof. Every replayed
block's (offset, length, hash) fingerprint re-verifies against the
current file bytes (core.incremental.verified_prefix, memoized a file
snapshot), never an mtime. A verified proper prefix that ends on a
newline replays and only the tail is parsed (and packed); an in-place
edit invalidates from the edit on; a torn write never commits (the
manifest is last, a fresh segment lands by tmp and rename). Every failure
falls back to the cold parse: the sidecar can make a scan faster, never
wrong.

Concurrency: last write wins. Two packers of one corpus may each publish
a manifest and the later replace wins; the loser's work is lost, never
wrong, since every served manifest re-proves against the corpus. A
replay whose segment disappears under it (a directory removed mid-scan)
finishes cold from the last block it yielded.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from avenir_tpu_torch import obs as _obs
from avenir_tpu_torch.core.atomic import (publish_bytes, sched_point,
                                          sweep_stale_tmps)
from avenir_tpu_torch.core.incremental import (block_fingerprint,
                                               ends_at_newline,
                                               verified_prefix)

FORMAT = 1
MANIFEST = "MANIFEST.json"
SEGMENT = "columns.bin"
SIDECAR_DIRNAME = ".avenir_sidecar"
#: default on-disk budget per sidecar directory — like the miner cache's,
#: generous but FINITE (an unbudgeted spill is the mem-cache-spill-
#: unbudgeted hazard); `stream.sidecar.budget.mb` overrides per job
DEFAULT_BUDGET_BYTES = 4 << 30

_ENC_DTYPES = {0: np.uint8, 1: np.uint16, 2: np.uint32}


def _dtype_code(max_value: int) -> int:
    if max_value < (1 << 8):
        return 0
    if max_value < (1 << 16):
        return 1
    return 2


# --------------------------------------------------------------------------
# process-global hit/delta counters (JobResult counter surface)
# --------------------------------------------------------------------------
_count_lock = threading.Lock()
_counters = {"hit_blocks": 0, "delta_blocks": 0,
             "hit_bytes": 0, "parse_bytes": 0}


def _count(key: str, n: int = 1) -> None:
    with _count_lock:
        _counters[key] += n


def counters_snapshot() -> dict:
    """Snapshot of the process-global sidecar counters — the runner takes
    one before and one after a scan and reports the delta as the job's
    ``Sidecar:HitBlocks`` / ``Sidecar:DeltaBlocks`` counters."""
    with _count_lock:
        return dict(_counters)


# --------------------------------------------------------------------------
# config surface
# --------------------------------------------------------------------------
def opts_from_cfg(cfg) -> Optional[dict]:
    """The sidecar knobs of one job config, or None when the feature is
    off (`stream.sidecar=false`, the kill switch) or the job asks for the
    Python parser (`csv.engine=python`), which the sidecar's native
    packing would bypass."""
    if not cfg.get_bool("stream.sidecar", True):
        return None
    from avenir_tpu_torch.core.stream import csv_engine

    if csv_engine(cfg) == "python":
        return None
    return {"dir": cfg.get("stream.sidecar.dir"),
            "budget": int(cfg.get_float(
                "stream.sidecar.budget.mb",
                float(DEFAULT_BUDGET_BYTES >> 20)) * (1 << 20))}


# --------------------------------------------------------------------------
# digests and directory layout
# --------------------------------------------------------------------------
def schema_digest(schema) -> str:
    """Content digest of a FeatureSchema, NORMALIZED so data-discovery
    side effects don't shift it: a field whose cardinality / numeric max
    was discovered from data hashes as if still undiscovered — the same
    schema object before and after a scan (or a fresh reload of the same
    JSON) must land on the same sidecar."""
    fields = []
    for f in schema.to_json()["fields"]:
        f = dict(f)
        if f.pop("discoveredCardinality", False):
            f.pop("cardinality", None)
        if f.pop("discoveredRange", False):
            f.pop("max", None)
        fields.append(f)
    blob = json.dumps(fields, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()


def _config_digest(kind: str, delim: str, block_bytes: int,
                   extra: str) -> str:
    from avenir_tpu_torch.core.keys import sidecar_config_digest

    return sidecar_config_digest(FORMAT, kind, delim, block_bytes, extra)


def dataset_dir(opts: dict, path: str, schema, delim: str,
                block_bytes: int) -> str:
    """key-covered: all — the digest is the whole dataset parse view."""
    from avenir_tpu_torch.core.keys import key_site

    key_site("sidecar.dataset")
    return _dir_for(opts, path, _config_digest(
        "dataset", delim, block_bytes, schema_digest(schema)))


def bytes_dir(opts: dict, path: str, delim: str, skip: int,
              block_bytes: int) -> str:
    """key-covered: all — the digest is the whole bytes parse view."""
    from avenir_tpu_torch.core.keys import key_site

    key_site("sidecar.bytes")
    return _dir_for(opts, path, _config_digest(
        "bytes", delim, block_bytes, str(int(skip))))


def _dir_for(opts: dict, path: str, digest: str) -> str:
    path = os.path.abspath(path)
    base = opts.get("dir") if opts else None
    if base:
        # an override base pools many corpora: disambiguate same-named
        # files from different directories by a path hash
        tag = hashlib.sha1(path.encode()).hexdigest()[:8]
        return os.path.join(base,
                            f"{os.path.basename(path)}.{tag}.{digest[:8]}")
    return os.path.join(os.path.dirname(path), SIDECAR_DIRNAME,
                        f"{os.path.basename(path)}.{digest[:8]}")


# --------------------------------------------------------------------------
# manifest IO + content re-proof
# --------------------------------------------------------------------------
def _load_manifest(dirpath: str) -> Optional[dict]:
    try:
        with open(os.path.join(dirpath, MANIFEST)) as fh:
            man = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(man, dict) or man.get("format") != FORMAT \
            or not isinstance(man.get("blocks"), list):
        return None
    if man.get("format_version", FORMAT) != FORMAT:
        # version-skewed manifest: refuse to serve, go cold (a MISSING
        # stamp is a pre-versioning sidecar and still serves — the
        # "format" gate above already pins its layout)
        return None
    return man


def _write_manifest(dirpath: str, man: dict) -> None:
    # the manifest rename IS the sidecar commit point: the fsync'd
    # payload lands via unique sibling tmp + replace, so a reader sees
    # the old manifest or the new one, never a torn table
    sched_point("sidecar.manifest")
    publish_bytes(json.dumps(man).encode("utf-8"),
                  os.path.join(dirpath, MANIFEST),
                  site="sidecar.manifest", fsync=True)


_verify_lock = threading.Lock()
_verify_memo: dict = {}


def _verified_blocks(dirpath: str, man: dict, path: str
                     ) -> Tuple[int, int]:
    """(n_blocks, covered_end): how many of the manifest's blocks are a
    verified CONTENT prefix of the current file — re-hashed through
    core.incremental.verified_prefix, memoized per (manifest, file)
    snapshot so repeat scans prove once, not once per scan. Never an
    mtime-only shortcut: the memo key only short-circuits the re-hash
    while both the manifest and the file bytes' stat identity hold."""
    try:
        st = os.stat(path)
        mst = os.stat(os.path.join(dirpath, MANIFEST))
    except OSError:
        return 0, 0
    key = (dirpath, mst.st_mtime_ns, mst.st_size, st.st_size, st.st_mtime_ns)
    with _verify_lock:
        if key in _verify_memo:
            return _verify_memo[key]
    fps = [{"offset": b["offset"], "length": b["length"], "hash": b["hash"]}
           for b in man["blocks"]]
    n_ok, covered = verified_prefix(path, fps)
    # the segment must still hold every verified block's extent (a torn
    # or concurrently-rewritten segment reads as absent, not as garbage)
    need = 0
    for b in man["blocks"][:n_ok]:
        need = max(need, int(b["seg_off"]) + int(b["seg_len"]))
    try:
        if os.path.getsize(os.path.join(dirpath, SEGMENT)) < need:
            n_ok, covered = 0, 0
    except OSError:
        if need > 0:
            n_ok, covered = 0, 0
    with _verify_lock:
        if len(_verify_memo) > 512:
            _verify_memo.clear()
        _verify_memo[key] = (n_ok, covered)
    return n_ok, covered


def verified_offsets(dirpath: str, path: str,
                     block_bytes: int) -> List[int]:
    """Sorted block START offsets of the verified manifest prefix — the
    newline-aligned cut candidates the shard planner snaps its block
    boundaries to so workers can replay their claimed ranges."""
    man = _load_manifest(dirpath)
    if man is None or int(man.get("block_bytes", -1)) != int(block_bytes):
        return []
    n_ok, _cov = _verified_blocks(dirpath, man, path)
    return [int(b["offset"]) for b in man["blocks"][:n_ok]]


def sidecar_nbytes(dirpath: str) -> int:
    """On-disk footprint of one sidecar directory (manifest + segment)."""
    total = 0
    for name in (MANIFEST, SEGMENT):
        try:
            total += os.path.getsize(os.path.join(dirpath, name))
        except OSError:
            pass
    return total


# --------------------------------------------------------------------------
# dataset kind: pack / unpack one parsed block
# --------------------------------------------------------------------------
def _pack_dataset_block(data: bytes, ds, schema, delim: str, fh) -> Optional[list]:
    """Write one parsed block's columns to the open segment; returns the
    per-column layout list, or None when the native column extraction is
    unavailable (the caller aborts the sidecar, never the scan).

    Classification mirrors Dataset._from_native_data: numerics as raw
    float32 pages, categoricals with a DECLARED fixed vocabulary as
    narrowest-dtype codes, everything else (strings, ids, discovered
    categoricals) as the native parser's compact newline-joined token
    buffer extracted from the RAW block — so replay re-runs the same
    discovery/encode the cold parse would, against the reader's own
    schema object."""
    from avenir_tpu_torch.native.ingest import extract_column_raw

    cols = []
    for fld in schema.fields:
        o = fld.ordinal
        if fld.is_numeric:
            buf = np.ascontiguousarray(
                ds.column(o), dtype=np.float32).tobytes()
            kind, dt = "f", 0
        elif fld.is_categorical and fld.cardinality \
                and not fld.discovered_cardinality:
            dt = _dtype_code(max(len(fld.cardinality) - 1, 0))
            buf = np.ascontiguousarray(
                ds.column(o)).astype(_ENC_DTYPES[dt]).tobytes()
            kind = "c"
        else:
            raw = extract_column_raw(data, delim, o)
            if raw is None:
                return None
            buf, kind, dt = raw, "t", 0
        fh.write(buf)
        cols.append([o, kind, dt, len(buf)])
    return cols


def _unpack_dataset_block(buf: bytes, entry: dict, schema, delim: str):
    """Rebuild the Dataset chunk the native parser would have produced
    for this block — including the schema-discovery side effects
    (_discover_cardinality / _discover_numeric_range) and the lazy
    string-column thunks, so downstream folds are byte-identical."""
    from avenir_tpu_torch.core.dataset import (Dataset, _discover_cardinality,
                                         _discover_numeric_range)

    n = int(entry["rows"])
    columns, lazy = {}, {}
    pos = 0
    for o, kind, dt, nb in entry["cols"]:
        part = buf[pos:pos + nb]
        pos += nb
        if kind == "f":
            columns[o] = np.frombuffer(part, np.float32).copy()
        elif kind == "c":
            columns[o] = np.frombuffer(
                part, _ENC_DTYPES[int(dt)]).astype(np.int32)
        else:
            fld = schema.field_by_ordinal(o)
            if fld.is_categorical:
                toks = part.decode().split("\n")[:-1]
                _discover_cardinality(fld, toks)
                index = fld.cardinality_index()
                columns[o] = np.array([index[t] for t in toks], np.int32)
            else:
                lazy[o] = (lambda r=part: np.array(
                    r.decode().split("\n")[:-1], dtype=object))
    for fld in schema.fields:
        if fld.is_numeric and fld.ordinal in columns:
            _discover_numeric_range(fld, columns[fld.ordinal])
    return Dataset(schema, columns, n, lazy=lazy, engine="native")


# --------------------------------------------------------------------------
# bytes kind: pack / unpack one encoded block
# --------------------------------------------------------------------------
class SidecarBytesBlock:
    """One replayed bytes-kind block: per-row TAIL token counts, the tail
    codes against the manifest's sidecar vocabulary shifted by one
    (stored 0 = the empty token), the skipped meta columns as token
    lists, and the vocabulary watermark after this block (``vocab_end``,
    what makes first-seen-order vocabulary extension replayable). The
    CSR consumers (_MarkovPerClassFold.consume_encoded, the miners'
    SpillScanMixin._scan_encoded_block) dispatch on this type."""

    __slots__ = ("n", "counts", "codes", "meta", "vocab", "vocab_end",
                 "skip", "nbytes")

    def __init__(self, n, counts, codes, meta, vocab, vocab_end, skip,
                 nbytes):
        self.n = n
        self.counts = counts          # int64 [n] tail tokens per row
        self.codes = codes            # int32 [sum(counts)] code+1, 0=empty
        self.meta = meta              # list[skip] of token lists
        self.vocab = vocab            # the manifest's full vocab (shared)
        self.vocab_end = vocab_end    # vocab size after this block
        self.skip = skip
        self.nbytes = nbytes          # source-block byte length


class _SidecarAbort(Exception):
    """Internal: this file cannot be (further) packed — drop the writer,
    keep scanning cold."""


def _pack_bytes_block(data: bytes, enc, skip: int, delim: str,
                      fh) -> Tuple[dict, int]:
    """Encode one raw block with the sidecar-owned discovering encoder
    and write counts + shifted tail codes + raw meta columns; returns
    (entry extras, bytes written). Raises _SidecarAbort on rows shorter
    than the skip count or unresolvable tokens — shapes the compact
    format cannot represent losslessly."""
    from avenir_tpu_torch.native.ingest import (csr_region_mask,
                                          extract_column_raw)

    out = enc.encode(data)
    if out is None:
        return {"rows": 0, "vocab_end": len(enc.vocab)}, 0
    codes, offsets, _region, n = out
    lens = np.diff(offsets)
    if (lens < skip).any():
        raise _SidecarAbort("row shorter than the meta skip count")
    v = len(enc.vocab)
    tail_mask = csr_region_mask(offsets, skip, codes.shape[0]) \
        if skip else np.ones(codes.shape[0], bool)
    tail = codes[tail_mask]
    if (tail < 0).any():
        raise _SidecarAbort("unresolvable token")
    stored = np.where(tail >= v, 0, tail + 1)
    counts = (lens - skip).astype(np.int64)
    cd = _dtype_code(int(counts.max(initial=0)))
    kd = _dtype_code(int(stored.max(initial=0)))
    wrote = 0
    buf = counts.astype(_ENC_DTYPES[cd]).tobytes()
    fh.write(buf)
    wrote += len(buf)
    buf = stored.astype(_ENC_DTYPES[kd]).tobytes()
    fh.write(buf)
    wrote += len(buf)
    meta_lens = []
    for j in range(skip):
        raw = extract_column_raw(data, delim, j)
        if raw is None:
            raise _SidecarAbort("native column extraction unavailable")
        fh.write(raw)
        wrote += len(raw)
        meta_lens.append(len(raw))
    return {"rows": int(n), "vocab_end": int(v), "counts_dtype": cd,
            "codes_dtype": kd, "n_codes": int(stored.shape[0]),
            "meta_lens": meta_lens}, wrote


def _unpack_bytes_block(buf: bytes, entry: dict, vocab: List[str],
                        skip: int) -> SidecarBytesBlock:
    n = int(entry["rows"])
    pos = 0
    cd, kd = int(entry["counts_dtype"]), int(entry["codes_dtype"])
    nb = n * _ENC_DTYPES[cd]().itemsize
    counts = np.frombuffer(buf[pos:pos + nb], _ENC_DTYPES[cd]).astype(
        np.int64)
    pos += nb
    nk = int(entry["n_codes"])
    nb = nk * _ENC_DTYPES[kd]().itemsize
    codes = np.frombuffer(buf[pos:pos + nb], _ENC_DTYPES[kd]).astype(
        np.int32)
    pos += nb
    meta = []
    for ml in entry.get("meta_lens", []):
        meta.append(buf[pos:pos + ml].decode().split("\n")[:-1])
        pos += ml
    return SidecarBytesBlock(n, counts, codes, meta, vocab,
                             int(entry["vocab_end"]), skip,
                             int(entry["length"]))


# --------------------------------------------------------------------------
# the feeds
# --------------------------------------------------------------------------
def dataset_blocks(opts: Optional[dict], path: str, schema, delim: str,
                   block_bytes: int,
                   byte_range: Optional[Tuple[int, int]] = None,
                   write: bool = True):
    """Sidecar-aware block feed over a schema-typed CSV. Yields
    (offset, length, hash, payload) tuples tiling the range gap-free:
    payload is a parsed Dataset (replayed from the sidecar or parsed
    cold — cold blocks also PACK into the sidecar when `write`), or
    None for a whitespace-only block. Returns None when the sidecar
    machinery cannot engage at all (disabled, python-only parse path,
    multi-byte delimiter) — callers keep their historical cold feed.
    With write=False the feed engages only when the WHOLE range replays
    from verified sidecar blocks (the ranged shard-worker contract)."""
    from avenir_tpu_torch.native.ingest import native_available

    if opts is None or not native_available() \
            or len(delim.encode()) != 1:
        return None
    try:
        dirpath = dataset_dir(opts, path, schema, delim, block_bytes)
        return _feed(opts, "dataset", path, dirpath, block_bytes,
                     byte_range, write,
                     {"delim": delim, "schema": schema})
    except Exception:
        return None


def byte_blocks(opts: Optional[dict], path: str, delim: str, skip: int,
                block_bytes: int,
                byte_range: Optional[Tuple[int, int]] = None,
                write: bool = True):
    """Sidecar-aware raw-block feed for the CSR consumers. Same tuple
    contract as dataset_blocks, with payload a SidecarBytesBlock on
    replay and the RAW bytes on a cold block (consumers encode those
    themselves; the feed packs them into the sidecar when `write`)."""
    from avenir_tpu_torch.native.ingest import native_seq_ready

    if opts is None or skip < 0 or not native_seq_ready(delim):
        return None
    try:
        dirpath = bytes_dir(opts, path, delim, skip, block_bytes)
        return _feed(opts, "bytes", path, dirpath, block_bytes,
                     byte_range, write, {"delim": delim, "skip": skip})
    except Exception:
        return None


def _base_manifest(kind: str, path: str, block_bytes: int,
                   kp: dict) -> dict:
    man = {"format": FORMAT, "format_version": FORMAT, "kind": kind,
           "block_bytes": int(block_bytes), "delim": kp["delim"],
           "source": os.path.abspath(path)}
    if kind == "dataset":
        man["schema_digest"] = schema_digest(kp["schema"])
    else:
        man["skip"] = int(kp["skip"])
        man["vocab"] = []
    return man


def _manifest_matches(man: dict, kind: str, block_bytes: int,
                      kp: dict) -> bool:
    if man.get("kind") != kind or man.get("delim") != kp["delim"]:
        return False
    # the block-size gate: a sidecar only serves scans requesting the
    # layout it tiled — distinct stream.block.size.mb configs stay
    # distinct corpora
    if int(man.get("block_bytes", -1)) != int(block_bytes):
        return False
    if kind == "dataset":
        return man.get("schema_digest") == schema_digest(kp["schema"])
    return int(man.get("skip", -1)) == int(kp["skip"]) \
        and isinstance(man.get("vocab"), list)


def _feed(opts, kind, path, dirpath, block_bytes, byte_range, write, kp):
    size = os.path.getsize(path)
    start, end = byte_range if byte_range is not None else (0, size)
    end = min(end, size)
    man = _load_manifest(dirpath)
    if man is not None and not _manifest_matches(man, kind, block_bytes,
                                                 kp):
        man = None
    n_ok, covered = (0, 0)
    if man is not None:
        n_ok, covered = _verified_blocks(dirpath, man, path)
        if n_ok == 0:
            man = None
    # the entries replayable for [start, ...): a contiguous run of
    # verified blocks whose first entry starts EXACTLY at `start`
    replay: list = []
    if man is not None:
        ents = man["blocks"][:n_ok]
        i0 = next((i for i, b in enumerate(ents)
                   if int(b["offset"]) == start), None)
        if i0 is not None:
            for b in ents[i0:]:
                if int(b["offset"]) + int(b["length"]) > end:
                    break
                replay.append(b)
    rep_end = (int(replay[-1]["offset"]) + int(replay[-1]["length"])
               ) if replay else start
    if rep_end < end and replay:
        # a replay/parse splice point must sit on a line boundary, or
        # the first cold line would split in two
        if not ends_at_newline(path, rep_end):
            replay, rep_end = [], start
    if not write:
        if not replay or rep_end < end:
            return None            # ranged readers replay all or nothing
        return _replay_only(path, dirpath, man, replay, kind, kp,
                            block_bytes, end)
    # write mode: extension is legal only when the cold tail starts
    # exactly where verified coverage ends (manifest blocks must tile
    # gap-free from their first offset) and the range runs to EOF
    extend = None
    if rep_end >= end:
        pass                        # full replay, nothing to write
    elif man is None:
        if start == 0 and end == size:
            extend = "fresh"
    elif rep_end == covered and end == size:
        extend = "append"
    return _feed_gen(opts, kind, path, dirpath, man, replay, rep_end, end,
                     block_bytes, extend, kp)


def _replay_entries(path, dirpath, man, entries, kind, kp):
    """Yield the 4-tuples of a verified entry run, reading the segment
    sequentially. Blank (zero-row) entries yield payload None."""
    vocab = man.get("vocab") if kind == "bytes" else None
    seg = os.path.join(dirpath, SEGMENT)
    sched_point("sidecar.replay")
    fh = open(seg, "rb") if any(int(b["seg_len"]) for b in entries) \
        else None
    try:
        for b in entries:
            off, length = int(b["offset"]), int(b["length"])
            if int(b["rows"]) <= 0:
                yield off, length, b["hash"], None
                continue
            t0 = _obs.now()
            sched_point("sidecar.replay")
            fh.seek(int(b["seg_off"]))
            buf = fh.read(int(b["seg_len"]))
            if len(buf) != int(b["seg_len"]):
                raise RuntimeError(
                    f"sidecar segment truncated under replay: {seg}")
            if kind == "dataset":
                payload = _unpack_dataset_block(buf, b, kp["schema"],
                                                kp["delim"])
            else:
                payload = _unpack_bytes_block(buf, b, vocab, kp["skip"])
            _obs.record("stream.sidecar.replay", t0, path=path,
                        nbytes=length, rows=int(b["rows"]))
            _count("hit_blocks")
            _count("hit_bytes", length)
            yield off, length, b["hash"], payload
    finally:
        if fh is not None:
            fh.close()


def _replay_only(path, dirpath, man, entries, kind, kp, block_bytes,
                 end):
    """The write=False feed: a pure replay run — except that the warm
    store may EVICT the sidecar directory mid-replay (SidecarHandle
    eviction is whole-directory rmtree, racing any open scan). The
    replayed prefix stays valid — every yielded block was verified
    against the live corpus bytes — so the scan finishes COLD from the
    last yielded boundary instead of crashing the consumer."""
    cursor = int(entries[0]["offset"])
    try:
        for off, length, bhash, payload in _replay_entries(
                path, dirpath, man, entries, kind, kp):
            yield off, length, bhash, payload
            cursor = off + length
    except (OSError, RuntimeError):
        yield from _cold_tail(path, cursor, end, block_bytes, kind, kp,
                              None)


def _feed_gen(opts, kind, path, dirpath, man, replay, rep_end, end,
              block_bytes, extend, kp):
    """The full feed: verified replay prefix, then the cold tail —
    parsed (dataset) or raw (bytes) — packed into the sidecar when
    `extend` says the tiling stays gap-free. Writer failures abort the
    sidecar, never the scan; and a replay failure (this sidecar's
    directory removed under an open scan) degrades to a cold
    finish from the last yielded block boundary — entry boundaries
    come from the verified tiling, so the splice is newline-aligned by
    construction — never a consumer crash."""
    if replay:
        cursor = int(replay[0]["offset"])
        try:
            for off, length, bhash, payload in _replay_entries(
                    path, dirpath, man, replay, kind, kp):
                yield off, length, bhash, payload
                cursor = off + length
        except (OSError, RuntimeError):
            yield from _cold_tail(path, cursor, end, block_bytes, kind,
                                  kp, None)
            return
    if rep_end >= end:
        return
    writer = None
    if extend is not None:
        try:
            writer = _Writer(opts, kind, path, dirpath, man, block_bytes,
                             kp, fresh=extend == "fresh")
        except Exception:
            writer = None
    yield from _cold_tail(path, rep_end, end, block_bytes, kind, kp,
                          writer)


def _cold_tail(path, start, end, block_bytes, kind, kp, writer):
    """The cold half of a feed: every block in ``[start, end)`` parsed
    (dataset) or handed through raw (bytes), packed into `writer` when
    one is given. Writer failures abort the sidecar, never the scan."""
    from avenir_tpu_torch.core.dataset import Dataset
    from avenir_tpu_torch.core.stream import (is_blank_block, iter_byte_blocks,
                                        prefetched)

    if start >= end:
        return
    blocks = prefetched(iter_byte_blocks(path, block_bytes,
                                         byte_range=(start, end),
                                         with_offsets=True), depth=1)
    try:
        for off, data in blocks:
            fp = block_fingerprint(off, data)
            if is_blank_block(data):
                if writer is not None:
                    writer = writer.add_blank(fp)
                yield off, len(data), fp["hash"], None
                continue
            if kind == "dataset":
                # the parse is Dataset.from_csv's own stream.parse span
                payload = Dataset.from_csv(data, kp["schema"],
                                           delim=kp["delim"])
                if writer is not None:
                    writer = writer.add_dataset(fp, data, payload)
            else:
                payload = data
                if writer is not None:
                    writer = writer.add_bytes(fp, data)
            _count("delta_blocks")
            _count("parse_bytes", len(data))
            yield off, len(data), fp["hash"], payload
    except BaseException:
        if writer is not None:
            writer.abort()
            writer = None
        raise
    finally:
        blocks.close()
        if writer is not None:
            writer.commit()


class _Writer:
    """One write (or append) pass over a sidecar directory.

    Crash/abort safety: a FRESH write stages the segment as a temp file
    and deletes any stale manifest up front, so a torn pass leaves no
    manifest at all (cold next time); the manifest lands LAST, tmp+
    rename, after the finished segment is renamed into place. An APPEND
    truncates the segment back to the verified coverage point, extends
    it in place, and rewrites the manifest last — a crash mid-append
    leaves the OLD manifest, whose blocks still verify against their
    intact extents. Exceeding the byte budget kills the pass (the
    sidecar is a bounded cache, not a second corpus)."""

    def __init__(self, opts, kind, path, dirpath, man, block_bytes, kp,
                 fresh):
        os.makedirs(dirpath, exist_ok=True)
        # startup GC: tmp files a hard-killed writer left behind (the
        # age gate keeps a concurrent writer's live tmp safe)
        sweep_stale_tmps(dirpath)
        self.dirpath = dirpath
        self.kind = kind
        self.kp = kp
        self.budget = int(opts.get("budget") or DEFAULT_BUDGET_BYTES)
        self.encoder = None
        self._tmp = None
        if fresh:
            try:
                os.remove(os.path.join(dirpath, MANIFEST))
            except OSError:
                pass
            self.man = _base_manifest(kind, path, block_bytes, kp)
            self.entries: list = []
            self._tmp = os.path.join(dirpath,
                                     f"{SEGMENT}.tmp.{os.getpid()}")
            self._fh = open(self._tmp, "wb")
            self.seg_pos = 0
        else:
            self.man = dict(man)
            keep = self.man["blocks"][:len(man["blocks"])]
            # append resumes after the last entry the feed replayed /
            # verified — recompute from the replayed coverage point
            self.entries = []
            self._fh = None
            self._keep_source = keep
            self.seg_pos = 0
        if kind == "bytes":
            from avenir_tpu_torch.native.ingest import BlockScanEncoder

            vocab = list(self.man.get("vocab", []))
            self.man["vocab"] = vocab
            self.encoder = BlockScanEncoder(
                kp["delim"], kp["skip"], vocab,
                {t: i for i, t in enumerate(vocab)}, marker=None)

    def _open_append(self, first_offset: int) -> None:
        keep = [b for b in self._keep_source
                if int(b["offset"]) + int(b["length"]) <= first_offset]
        seg_end = 0
        for b in keep:
            seg_end = max(seg_end, int(b["seg_off"]) + int(b["seg_len"]))
        self.man["blocks"] = keep
        segp = os.path.join(self.dirpath, SEGMENT)
        self._fh = open(segp, "r+b" if os.path.exists(segp) else "w+b")
        self._fh.truncate(seg_end)
        self._fh.seek(seg_end)
        self.seg_pos = seg_end

    def _add(self, fp, extra, wrote) -> "_Writer":
        entry = dict(fp)
        entry["seg_off"] = self.seg_pos
        entry["seg_len"] = wrote
        entry.update(extra)
        self.seg_pos += wrote
        self.entries.append(entry)
        if self.seg_pos > self.budget:
            self.abort()
            return None
        return self

    def _ensure_open(self, fp) -> None:
        if self._fh is None:
            self._open_append(int(fp["offset"]))

    def add_blank(self, fp) -> Optional["_Writer"]:
        try:
            self._ensure_open(fp)
            extra = {"rows": 0}
            if self.kind == "bytes":
                extra["vocab_end"] = len(self.man["vocab"])
            return self._add(fp, extra, 0)
        except Exception:
            self.abort()
            return None

    def add_dataset(self, fp, data, ds) -> Optional["_Writer"]:
        try:
            self._ensure_open(fp)
            cols = _pack_dataset_block(data, ds, self.kp["schema"],
                                       self.kp["delim"], self._fh)
            if cols is None:
                self.abort()
                return None
            wrote = sum(c[3] for c in cols)
            return self._add(fp, {"rows": int(len(ds)), "cols": cols},
                             wrote)
        except Exception:
            self.abort()
            return None

    def add_bytes(self, fp, data) -> Optional["_Writer"]:
        try:
            self._ensure_open(fp)
            extra, wrote = _pack_bytes_block(data, self.encoder,
                                             self.kp["skip"],
                                             self.kp["delim"], self._fh)
            return self._add(fp, extra, wrote)
        except Exception:
            self.abort()
            return None

    def commit(self) -> bool:
        if self._fh is None:       # append pass that saw no blocks
            return False
        try:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None
            if self._tmp is not None:
                os.replace(self._tmp, os.path.join(self.dirpath, SEGMENT))
                self._tmp = None
            man = dict(self.man)
            man["blocks"] = list(self.man.get("blocks", [])) + self.entries
            man["segment_bytes"] = max(
                [self.seg_pos] + [int(b["seg_off"]) + int(b["seg_len"])
                                  for b in man["blocks"]])
            _write_manifest(self.dirpath, man)
            return True
        except Exception:
            self.abort()
            return False

    def abort(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except Exception:
                pass
            self._fh = None
        if self._tmp is not None:
            try:
                os.remove(self._tmp)
            except OSError:
                pass
            self._tmp = None


# --------------------------------------------------------------------------
# a handle on one sidecar directory
# --------------------------------------------------------------------------
class SidecarHandle:
    """A handle on one sidecar directory: ``cache_ready()`` re-proves the
    manifest against the current corpus bytes, ``cache_nbytes`` is its
    footprint on disk, and ``close()`` deletes the directory (a scan
    holding the open segment finishes unharmed; the next scan parses and
    packs again). The job server's warm store pins these under its byte
    budget, with the same protocol as the miners' streaming sources."""

    #: the pinned state is a cache on disk that outlives the process: the
    #: warm store drops the pin without close() at shutdown or when it
    #: pins the same directory again; only an eviction or a stale
    #: manifest deletes the directory
    cache_durable = True

    def __init__(self, path: str, dirpath: str):
        self.path = os.path.abspath(path)
        self.dirpath = dirpath

    def cache_ready(self) -> bool:
        man = _load_manifest(self.dirpath)
        if man is None:
            return False
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return False
        n_ok, covered = _verified_blocks(self.dirpath, man, self.path)
        return n_ok == len(man["blocks"]) and covered == size

    @property
    def cache_nbytes(self) -> int:
        return sidecar_nbytes(self.dirpath)

    def cache_evict_to(self, byte_budget: int) -> int:
        """A sidecar is one unit, so any budget below its size evicts it
        whole; the bytes evicted."""
        nb = self.cache_nbytes
        if nb <= byte_budget:
            return 0
        self.close()
        return nb

    def close(self) -> None:
        sched_point("warm.evict")
        shutil.rmtree(self.dirpath, ignore_errors=True)
