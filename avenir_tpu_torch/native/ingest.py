"""ctypes binding of the port's native CSV ingest (`csv_ingest.cpp`).

The port's own copy of the parse entry points of
`avenir_tpu/native/ingest.py`, and of the miners' ragged encoder: the
CSR encode (`seq_encode_native`), the pass-1 encoder that discovers the
vocabulary a block at a time (`BlockScanEncoder`), the scan lifecycle
of the miners' streaming sources (`SpillScanMixin`) and the encoded-block
spill cache their per-k rounds replay instead of re-reading the CSV
(`EncodedBlockCache`; pass 1 itself may read through the columnar
sidecar, `native/sidecar.py`, with `SpillScanMixin.sidecar_opts`).
The shared library builds with g++ at first
use (`g++ -O3 -march=native -shared -fPIC -pthread`) into
`build/avenir_tpu_torch/native/<hash>/` at the root of the checkout, keyed
on a hash of the source, the flags and the CPU that `-march=native`
resolves to, so a checkout copied to another machine builds anew. Several
processes may start at once on an empty build directory: each waits on
an `fcntl` lock, compiles to a temporary file and moves it into place with
`os.replace`, so no process loads a half-written library. A failed build
or load is retried at the next call, never remembered. Nothing here runs
at import time.

`native_available()` is False where there is no g++; `Dataset.from_csv`
then parses in Python under engine="auto", and raises under
engine="native".
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from avenir_tpu_torch import obs

SRC = Path(__file__).resolve().with_name("csv_ingest.cpp")
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "avenir_tpu_torch" / "native")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]
#: bytes a parse thread takes at least (csv_parse_mt's stripe)
STRIPE_BYTES = 4 << 20

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeParseError(ValueError):
    """A token the native parser refused: an invalid number (kind
    "numeric") or a value outside a declared vocabulary ("categorical"),
    at `row` of the buffer and field `ordinal`."""

    def __init__(self, kind: str, token: str, ordinal: int, row: int,
                 short: bool = False):
        self.kind, self.token, self.ordinal, self.row = kind, token, ordinal, row
        if kind == "numeric":
            msg = (f"could not convert string to float: {token!r} at "
                   f"ordinal {ordinal}")
        else:
            msg = (f"value {token!r} not in declared cardinality of ordinal "
                   f"{ordinal}" + (f" (row {row} is short)" if short else ""))
        super().__init__(msg)


def _gxx() -> Optional[str]:
    return shutil.which("g++")


def _march(gxx: str) -> str:
    """The CPU that -march=native names on this host (g++'s own answer)."""
    out = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, timeout=60).stdout
    return next((ln.split()[-1] for ln in out.splitlines()
                 if ln.strip().startswith("-march=")), "unknown")


def library_path(gxx: str) -> Path:
    """Where this source, these flags and this host's CPU build to."""
    h = hashlib.sha256(" ".join(GXX_FLAGS + [_march(gxx)]).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libcsv_ingest.so"


def _build(gxx: str, path: Path) -> None:
    """Compile to a temporary file and move it into place, under a file
    lock, unless another process built it while this one waited."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        try:
            subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_char_p = ctypes.c_char_p
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.csv_count_rows.restype = i64
    lib.csv_count_rows.argtypes = [c_char_p, i64]
    lib.csv_count_rows_mt.restype = i64
    lib.csv_count_rows_mt.argtypes = [c_char_p, i64, i32]
    lib.csv_parse.restype = i64
    lib.csv_parse.argtypes = [
        c_char_p, i64, ctypes.c_char, i32,
        p_i32, i32, p_f32,
        p_i32, i32, c_char_p, p_i32, p_i32, i64,
        ctypes.POINTER(i64), ctypes.POINTER(i32),
    ]
    lib.csv_parse_mt.restype = i64
    lib.csv_parse_mt.argtypes = lib.csv_parse.argtypes + [i32]
    lib.csv_column_bytes.restype = i64
    lib.csv_column_bytes.argtypes = [c_char_p, i64, ctypes.c_char, i32]
    lib.csv_extract_column.restype = i64
    lib.csv_extract_column.argtypes = [c_char_p, i64, ctypes.c_char, i32,
                                       c_char_p, i64]
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.seq_token_count.restype = i64
    lib.seq_token_count.argtypes = [c_char_p, i64, ctypes.c_char,
                                    ctypes.POINTER(i64)]
    lib.seq_encode.restype = i64
    lib.seq_encode.argtypes = [c_char_p, i64, ctypes.c_char, c_char_p, i32,
                               p_i32, i64, p_i64, i64]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """Build if needed and load; a library that will not load is removed
    and built once more. None when g++ is missing or both tries fail."""
    gxx = _gxx()
    if gxx is None:
        return None
    try:
        path = library_path(gxx)
    except (OSError, subprocess.SubprocessError):
        return None
    for attempt in range(2):
        try:
            if not path.exists():
                _build(gxx, path)
            return _bind(ctypes.CDLL(str(path)))
        except (OSError, subprocess.SubprocessError):
            if attempt == 0:
                path.unlink(missing_ok=True)
    return None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _load()
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def parse_threads(nbytes: int, threads: int = 0) -> int:
    """Threads csv_parse_mt parses `nbytes` with: `threads` (0: every
    CPU the machine reports), at most one a STRIPE_BYTES stripe, at
    least one."""
    n = threads if threads > 0 else (os.cpu_count() or 1)
    return max(1, min(n, nbytes // STRIPE_BYTES))


def parse_csv_native(
    data: bytes,
    delim: str,
    numeric_ordinals: List[int],
    categorical: List[Tuple[int, List[str]]],   # (ordinal, cardinality)
    string_ordinals: List[int],
    lazy_strings: bool = False,
    threads: int = 0,
) -> Tuple[int, Dict[int, np.ndarray], Dict[int, object]]:
    """One native pass: (n_rows, {ordinal: column array}, {ordinal: thunk}).

    Numeric columns come back float32 (missing -> NaN), categorical int32
    codes against the given cardinalities, string/id columns as numpy
    object arrays of trimmed tokens, or with lazy_strings as zero-arg
    thunks in the third value (their bytes extracted now, the Python
    strings made when first read). An invalid number, an unknown value or
    a row too short for a categorical raises NativeParseError, the first
    row's first. threads=0 parses on every CPU, one thread a 4 MB stripe
    (parse_threads)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native CSV ingest unavailable (no g++?)")
    d = delim.encode()
    if len(d) != 1:
        raise ValueError(f"the native parser takes a one-byte delimiter, "
                         f"not {delim!r}")
    n = int(lib.csv_count_rows_mt(data, len(data), threads))
    num_ords = np.asarray(numeric_ordinals, np.int32)
    cat_ords = np.asarray([o for o, _ in categorical], np.int32)
    vocab_blob = b"".join(v.encode() + b"\0"
                          for _, card in categorical for v in card)
    vocab_counts = np.asarray([len(card) for _, card in categorical], np.int32)
    all_ords = [*numeric_ordinals, *cat_ords.tolist(), *string_ordinals]
    max_ord = max(all_ords) if all_ords else 0
    # rows shorter than the schema leave numeric NaN (as the Python parser
    # does) and categorical -1 (checked below)
    num_out = np.full((len(num_ords), n), np.nan, np.float32)
    cat_out = np.full((len(cat_ords), n), -1, np.int32)
    err_row, err_ord = ctypes.c_int64(-1), ctypes.c_int32(-1)
    got = int(lib.csv_parse_mt(
        data, len(data), d, max_ord, num_ords, len(num_ords), num_out,
        cat_ords, len(cat_ords), vocab_blob, vocab_counts, cat_out, n,
        ctypes.byref(err_row), ctypes.byref(err_ord), threads))
    if got < 0:
        toks = _column(lib, data, d, err_ord.value)
        tok = toks[err_row.value] if err_row.value < len(toks) else "?"
        raise NativeParseError("numeric" if got == -2 else "categorical",
                               tok, err_ord.value, err_row.value)
    columns: Dict[int, np.ndarray] = {}
    for i, o in enumerate(numeric_ordinals):
        columns[o] = num_out[i]
    for i, (o, _) in enumerate(categorical):
        short = cat_out[i] < 0
        if short.any():
            raise NativeParseError("categorical", "", o,
                                   int(np.argmax(short)), short=True)
        columns[o] = cat_out[i]
    lazy: Dict[int, object] = {}
    for o in string_ordinals:
        raw = _column_bytes(lib, data, d, o)
        if lazy_strings:
            # the thunk holds this column's compact bytes, not the block
            lazy[o] = (lambda r=raw: np.array(r.decode().split("\n")[:-1],
                                              dtype=object))
        else:
            columns[o] = np.array(raw.decode().split("\n")[:-1], dtype=object)
    return got, columns, lazy


def _column_bytes(lib, data: bytes, d: bytes, ordinal: int) -> bytes:
    cap = int(lib.csv_column_bytes(data, len(data), d, ordinal))
    buf = ctypes.create_string_buffer(max(cap, 1))
    w = int(lib.csv_extract_column(data, len(data), d, ordinal, buf, cap))
    return buf.raw[:w] if w > 0 else b""


def _column(lib, data: bytes, d: bytes, ordinal: int) -> List[str]:
    return _column_bytes(lib, data, d, ordinal).decode().split("\n")[:-1]


def extract_column_raw(data: bytes, delim: str, ordinal: int
                       ) -> Optional[bytes]:
    """One column's trimmed tokens as the native parser's compact
    newline-joined buffer (a newline after each token, an empty token for
    a short row): the bytes a lazy string column is made from. None when
    the library is not available or the delimiter is not one byte."""
    lib = _get_lib()
    d = delim.encode()
    if lib is None or len(d) != 1:
        return None
    return _column_bytes(lib, data, d, ordinal)


def extract_column_native(data: bytes, delim: str, ordinal: int
                          ) -> Optional[np.ndarray]:
    """One column's trimmed tokens for every row of a raw text block (a
    short row gives ''), as a numpy unicode array: the open-vocabulary
    companion of seq_encode_native (entity keys, which no vocabulary
    codes). None when the library is not available or the delimiter is
    not one byte."""
    raw = extract_column_raw(data, delim, ordinal)
    if raw is None:
        return None
    return np.array(raw.decode("utf-8", "replace").split("\n")[:-1])


# -------------------------------------------------------------- the miners
def seq_encode_native(data: bytes, delim: str, vocab: List[str]
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Ragged tokenize and dictionary-encode a text block against one
    vocabulary: (codes int32 [total_tokens], offsets int64 [rows+1]) in
    CSR form, token t of row r at codes[offsets[r] + t]; an unknown token
    is -1. Tokens are trimmed of space, tab and CR; a line of only those
    is no row. None when the library is not available or the delimiter is
    not one byte."""
    lib = _get_lib()
    d = delim.encode()
    if lib is None or len(d) != 1:
        return None
    n_tokens = ctypes.c_int64(0)
    n_rows = int(lib.seq_token_count(data, len(data), d,
                                     ctypes.byref(n_tokens)))
    codes = np.empty(max(n_tokens.value, 1), np.int32)
    offsets = np.empty(n_rows + 1, np.int64)
    blob = b"".join(v.encode() + b"\0" for v in vocab)
    got = int(lib.seq_encode(data, len(data), d, blob, len(vocab),
                             codes, codes.shape[0], offsets, n_rows + 1))
    if got != n_rows:
        raise RuntimeError(f"seq_encode row mismatch: {got} != {n_rows}")
    return codes[:int(offsets[n_rows])], offsets


def native_seq_ready(delim: str) -> bool:
    """True when the native encoder takes this delimiter (one byte) and
    the library is built: the gate of every CSR consumer."""
    return len(delim.encode()) == 1 and native_available()


def csr_rows(offsets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(row_of int32 [total_tokens], starts [n_rows]) of a CSR offsets
    array."""
    return (np.repeat(np.arange(offsets.shape[0] - 1, dtype=np.int32),
                      np.diff(offsets)),
            offsets[:-1])


def csr_region_mask(offsets: np.ndarray, skip: int, n_tokens: int
                    ) -> np.ndarray:
    """bool [n_tokens]: True where a token sits at position >= skip of its
    row (the item region past the meta fields), built by unmarking the
    first `skip` positions of each row."""
    region = np.ones(n_tokens, bool)
    starts, ends = offsets[:-1], offsets[1:]
    for j in range(skip):
        pos = starts + j
        region[pos[pos < ends]] = False
    return region


# --------------------------------------------------------------------------
# Encoded-block spill cache
# --------------------------------------------------------------------------
_ENC_MAGIC = b"AVNRENC1"
_ENC_DTYPES = {0: np.uint8, 1: np.uint16, 2: np.uint32}

#: the cache's default on-disk byte budget: generous, but finite, so
#: every spill can be evicted
DEFAULT_CACHE_BUDGET_BYTES = 1 << 30


def _enc_dtype_code(max_value: int) -> int:
    """The narrowest of uint8 (0), uint16 (1) and uint32 (2) that holds
    `max_value`."""
    if max_value < (1 << 8):
        return 0
    if max_value < (1 << 16):
        return 1
    return 2


class EncodedBlockCache:
    """On-disk spill cache of each block's region-compacted codes.

    The port of `avenir_tpu/native/ingest.py` EncodedBlockCache, byte for
    byte in its format. The multi-pass miners (Apriori, GSP) re-scan their
    input once per itemset length k, and pass 1 already produces every
    later pass's input: each block's vocabulary codes of its item region,
    in row order. The cache spills exactly that, a record a block:

        header  <q n_rows> <q n_tokens> <B counts_dtype> <B codes_dtype>
        counts  n_rows elements: the region tokens of each row
        codes   n_tokens elements: their codes, row after row

    each in the narrowest dtype that fits (`_enc_dtype_code`), after the
    magic ``AVNRENC1`` that starts a segment file, so a replay reads a
    fraction of the CSV's bytes and tokenizes nothing.

    Byte budget: `byte_budget` (default DEFAULT_CACHE_BUDGET_BYTES; the
    jobs' key ``stream.encoded.cache.budget.mb``). Blocks land in one
    segment a source (``set_source``; a writer that cannot attribute
    blocks, the shared-scan feed, writes one combined segment). Past the
    budget whole segments are evicted, least recently replayed first
    (never replayed ones in write order), and counted in
    ``evicted_bytes``; a consumer re-parses an evicted source and replays
    the rest (``source_valid(i)``, ``blocks(i)``), so a tight budget costs
    time, never correctness.

    Validity is per block, not per file. The own-read scan records a
    content fingerprint (offset, length, sha1, ``note_block``) of every
    raw block it encodes; at replay a source whose (size, mtime_ns) moved
    is proved again by re-hashing the recorded ranges (memoized a file
    snapshot). An appended source so stays replayable: its committed
    blocks still match the file's prefix, ``source_delta`` gives the
    offset where the coverage ends, and only the tail re-parses. An
    in-place edit, or a writer that never saw raw blocks (the shared-scan
    feed records no fingerprints), falls back to the whole-file stat gate
    and a full re-parse. commit() still refuses a source that changed
    while the scan ran: a torn cache never commits. The cache
    directory belongs to this object (a tempdir unless `cache_dir` is
    given) and is removed on close() or collection: it is a spill within
    one job."""

    #: segment key of the combined (source-unattributed) write stream
    _COMBINED = None

    #: sentinel: no segment can serve the requested source
    _NO_SEGMENT = object()

    def __init__(self, sources: Sequence[str],
                 cache_dir: Optional[str] = None,
                 byte_budget: Optional[int] = None):
        import tempfile

        self.sources = list(sources)
        self.byte_budget = (DEFAULT_CACHE_BUDGET_BYTES
                            if byte_budget is None else int(byte_budget))
        self._own_dir = cache_dir is None
        self._dir = cache_dir or tempfile.mkdtemp(prefix="avenir_encblk_")
        os.makedirs(self._dir, exist_ok=True)
        self._fh = None
        self._cur = self._COMBINED        # segment being written
        self._seg_order: list = []        # segment keys in write order
        self._seg_bytes: dict = {}        # segment key -> bytes written
        self._evicted: set = set()
        self._last_replay: dict = {}      # segment key -> replay clock
        self._replay_clock = 0
        self._fingerprint = None
        self._block_fps: dict = {}        # segment key -> [(off, len, hash)]
        self._delta_memo: dict = {}       # (src, size, mtime) -> end | None
        self._committed = False
        self.n_blocks = 0
        self.evicted_bytes = 0
        self.replays = 0          # completed replay passes

    def _seg_path(self, key) -> str:
        name = ("encoded_blocks.bin" if key is self._COMBINED
                else f"encoded_blocks_s{key}.bin")
        return os.path.join(self._dir, name)

    # ------------------------------------------------------------- write
    def _current_fingerprint(self):
        """The stat identity (path, size, mtime_ns) of every source: the
        begin/commit torn-write gate only (a scan whose sources changed
        under it never commits). Replay validity is the per-block content
        proof (``_content_coverage``), never this tuple.

        key-covered: all — replay identity is the content fingerprints.
        """
        from avenir_tpu_torch.core.keys import key_site

        key_site("cache.fingerprint")
        out = []
        for p in self.sources:
            try:
                st = os.stat(p)
                out.append((p, st.st_size, st.st_mtime_ns))
            except OSError:
                out.append((p, -1, -1))
        return tuple(out)

    def begin(self) -> None:
        """Start (or restart) a write pass; any prior content is gone."""
        self.abort()
        for key in self._seg_order:
            try:
                os.remove(self._seg_path(key))
            except OSError:
                pass
        self._fingerprint = self._current_fingerprint()
        self._seg_order = []
        self._seg_bytes = {}
        self._evicted = set()
        self._last_replay = {}
        self._block_fps = {}
        self._delta_memo = {}
        self._cur = self._COMBINED
        self.n_blocks = 0
        self.evicted_bytes = 0

    def note_block(self, offset: int, data: bytes) -> None:
        """Record the content fingerprint (offset, length, hash) of one raw
        byte block of the source being written, whether or not the block
        spills a record (a blank block covers bytes but adds no rows).
        Per-block fingerprints turn an appended source from a total
        invalidation into a delta (source_delta). A writer that sees no
        raw blocks (the shared-scan feed) never calls this and keeps the
        whole-file gate."""
        from avenir_tpu_torch.core.incremental import block_hash

        self.note_fingerprint(offset, len(data), block_hash(data))

    def note_fingerprint(self, offset: int, length: int,
                         hash_: str) -> None:
        """note_block for a writer that already holds the block's hash (the
        sidecar feed hashes each block for its own manifest): the same
        record, no second hash."""
        if self._fingerprint is None:
            raise RuntimeError("note_block() before begin()")
        if self._committed:
            raise RuntimeError("note_block() after commit()")
        self._block_fps.setdefault(self._cur, []).append(
            (int(offset), int(length), hash_))

    def set_source(self, index: int) -> None:
        """Attribute subsequent add_block() calls to source `index` —
        per-source segments are what make partial eviction (and partial
        replay) possible. Writers that cannot attribute blocks simply
        never call this and get one combined segment."""
        if self._cur == index:
            return
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._cur = index

    def _open_segment(self) -> None:
        path = self._seg_path(self._cur)
        if self._cur in self._seg_order and os.path.exists(path):
            # a writer returning to an earlier source (interleaved
            # set_source calls) must EXTEND its segment — "wb" here
            # would silently truncate committed blocks and replay a
            # partial segment as if it were whole
            self._fh = open(path, "ab")
            return
        self._fh = open(path, "wb")
        self._fh.write(_ENC_MAGIC)
        self._seg_bytes[self._cur] = len(_ENC_MAGIC)
        if self._cur not in self._seg_order:
            self._seg_order.append(self._cur)

    def _spilled_bytes(self) -> int:
        """Live spill size from the per-segment byte counters — O(live
        segments) arithmetic, no flush/stat per call (add_block calls
        this once per block)."""
        return sum(n for k, n in self._seg_bytes.items()
                   if k not in self._evicted)

    def _evict_segment(self, key) -> None:
        if key == self._cur and self._fh is not None:
            self._fh.close()
            self._fh = None
        try:
            os.remove(self._seg_path(key))
        except OSError:
            pass
        self.evicted_bytes += self._seg_bytes.get(key, 0)
        self._evicted.add(key)

    def evict_to(self, byte_budget: int) -> int:
        """Evict whole segments, least-recently-replayed first (never-
        replayed segments in write order before any replayed one), until
        the spill fits `byte_budget`. The currently-written segment goes
        last — but it too is evicted when it alone exceeds the budget
        (the cache then quietly disables itself for that source and the
        consumer re-parses). Returns the bytes evicted by this call."""
        before = self.evicted_bytes
        order = {k: i for i, k in enumerate(self._seg_order)}
        live = [k for k in self._seg_order if k not in self._evicted]
        live.sort(key=lambda k: (k == self._cur,
                                 self._last_replay.get(k, -1), order[k]))
        spilled = self._spilled_bytes()
        for key in live:
            if spilled <= byte_budget:
                break
            spilled -= self._seg_bytes.get(key, 0)
            self._evict_segment(key)
        return self.evicted_bytes - before

    def add_block(self, counts: np.ndarray, codes: np.ndarray) -> None:
        """Append one block: per-row region token counts + the region
        token codes (row-major). Narrowest-dtype encoding per block; a
        write that pushes the spill past the byte budget triggers
        whole-segment eviction. Blocks for an already-evicted segment
        are dropped (and counted) — the budget is a hard bound."""
        import struct

        if self._fingerprint is None:
            raise RuntimeError("add_block() before begin()")
        if self._committed:
            raise RuntimeError(
                "add_block() after commit(): a sealed cache never grows "
                "— call begin() to rewrite it")
        counts = np.ascontiguousarray(counts)
        codes = np.ascontiguousarray(codes)
        cd = _enc_dtype_code(int(counts.max(initial=0)))
        kd = _enc_dtype_code(int(codes.max(initial=0)))
        size = (18 + counts.shape[0] * _ENC_DTYPES[cd]().itemsize
                + codes.shape[0] * _ENC_DTYPES[kd]().itemsize)
        if self._cur in self._evicted:
            self.evicted_bytes += size
            return
        if self._fh is None:
            self._open_segment()
        self._fh.write(struct.pack("<qqBB", counts.shape[0],
                                   codes.shape[0], cd, kd))
        counts.astype(_ENC_DTYPES[cd]).tofile(self._fh)
        codes.astype(_ENC_DTYPES[kd]).tofile(self._fh)
        self.n_blocks += 1
        self._seg_bytes[self._cur] = self._seg_bytes.get(self._cur, 0) + size
        if self._spilled_bytes() > self.byte_budget:
            self.evict_to(self.byte_budget)

    def commit(self) -> bool:
        """Seal the write pass. Returns False (and stays invalid) when a
        source changed while the scan ran — a torn cache must never be
        replayed. Segments evicted by the budget stay evicted; the
        surviving ones replay."""
        if self._fingerprint is None:
            return False
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._committed = self._fingerprint == self._current_fingerprint()
        return self._committed

    def abort(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._fingerprint = None     # a new begin() must precede writes
        self._committed = False

    # ------------------------------------------------------------ replay
    def _segment_key(self, index: int):
        """Segment key serving source `index` (its own segment, or the
        combined one when it is the only source), else _NO_SEGMENT."""
        if index in self._seg_order:
            return index
        if self._COMBINED in self._seg_order and len(self.sources) == 1 \
                and index == 0:
            return self._COMBINED
        return self._NO_SEGMENT

    def _content_coverage(self, index: int) -> Optional[int]:
        """The offset up to which source `index`'s recorded fingerprints
        still match the file, proved by re-hashing the recorded ranges
        (memoized a (size, mtime_ns) snapshot, so the per-k rounds prove
        once). None when no fingerprints were recorded, the serving
        segment is evicted or absent, or any recorded block mismatches:
        a source replays all of its committed blocks or none."""
        if not self._committed:
            return None
        key = self._segment_key(index)
        if key is self._NO_SEGMENT or key in self._evicted \
                or not os.path.exists(self._seg_path(key)):
            return None
        fps = self._block_fps.get(key)
        if not fps:
            return None
        path = self.sources[index]
        try:
            st = os.stat(path)
        except OSError:
            return None
        memo = (index, st.st_size, st.st_mtime_ns)
        if memo not in self._delta_memo:
            from avenir_tpu_torch.core.incremental import verified_prefix

            n, covered = verified_prefix(
                path, [{"offset": o, "length": ln, "hash": h}
                       for o, ln, h in fps])
            self._delta_memo[memo] = covered if n == len(fps) else None
        return self._delta_memo[memo]

    def source_delta(self, index: int) -> Optional[int]:
        """The offset at which source `index`'s cached coverage ends, when
        its committed blocks are still a verified content prefix of the
        file: the appended-source gate, where a consumer replays
        ``blocks(index, prefix=True)`` and re-parses only
        ``[delta, size)``. None when the prefix no longer matches (an
        in-place edit), the segment was evicted, the writer recorded no
        fingerprints, or the coverage ends mid-line on a grown file (the
        last line had no newline, so the appended bytes extend a row
        already encoded)."""
        cov = self._content_coverage(index)
        if cov is None:
            return None
        path = self.sources[index]
        try:
            size = os.path.getsize(path)
        except OSError:
            return None
        if cov < size:
            from avenir_tpu_torch.core.incremental import ends_at_newline

            if not ends_at_newline(path, cov):
                return None
        return cov

    def _source_unchanged(self, index: int) -> bool:
        rec = self._fingerprint[index]
        path = self.sources[index]
        try:
            st = os.stat(path)
            cur = (path, st.st_size, st.st_mtime_ns)
        except OSError:
            cur = (path, -1, -1)
        if cur == rec:
            return True
        # an mtime-only change (a touch, a copy back) keeps the cache: the
        # content fingerprints prove the bytes, end to end
        cov = self._content_coverage(index)
        return cov is not None and cov == cur[1]

    def _fingerprint_ok(self) -> bool:
        if not self._committed or self._fingerprint is None:
            return False
        if self._fingerprint == self._current_fingerprint():
            return True
        return all(self._source_unchanged(i)
                   for i in range(len(self.sources)))

    @property
    def valid(self) -> bool:
        """True when a committed cache exists, the sources are
        byte-for-byte the ones it encoded (size+mtime fingerprint), AND
        no segment was evicted — the all-or-nothing replay gate. With
        evictions, consumers use the per-source gate below."""
        return (self._fingerprint_ok() and not self._evicted
                and all(os.path.exists(self._seg_path(k))
                        for k in self._seg_order))

    def source_valid(self, index: int) -> bool:
        """True when source `index`'s blocks can replay in full (the file
        is covered end to end): its own segment survives, or the cache
        wrote one combined segment for a single source. A multi-source
        combined segment cannot split, so it replays only through the
        all-or-nothing `valid` gate. An appended source fails this gate
        and keeps the prefix gate (source_delta)."""
        if not self._fingerprint_ok():
            return False
        key = self._segment_key(index)
        if key is self._NO_SEGMENT:
            return False
        return (key not in self._evicted
                and os.path.exists(self._seg_path(key)))

    def _read_segment(self, key):
        import struct

        path = self._seg_path(key)
        with open(path, "rb") as fh:
            if fh.read(len(_ENC_MAGIC)) != _ENC_MAGIC:
                raise RuntimeError("encoded-block cache is corrupt")
            while True:
                head = fh.read(18)
                if not head:
                    break
                n_rows, n_tok, cd, kd = struct.unpack("<qqBB", head)
                counts = np.fromfile(fh, _ENC_DTYPES[cd], n_rows)
                codes = np.fromfile(fh, _ENC_DTYPES[kd], n_tok)
                if counts.shape[0] != n_rows or codes.shape[0] != n_tok:
                    raise RuntimeError("encoded-block cache is truncated")
                # int32 both ways: per-row region counts are bounded by
                # tokens-per-row and codes by the vocab — widening the
                # block-proportional arrays to int64 here was exactly the
                # mem-dtype-expansion-at-parse shape this tier flags
                yield counts.astype(np.int32), codes.astype(np.int32)
        self._replay_clock += 1
        self._last_replay[key] = self._replay_clock

    def blocks(self, source: Optional[int] = None, prefix: bool = False):
        """Yield (counts int32 [n_rows], codes int32 [n_tokens]) per
        cached block — all segments in write order by default, one
        source's segment with `source=i`. With ``prefix=True`` the
        source's gate relaxes from full coverage to the verified content
        prefix (source_delta): the appended-source replay, whose caller
        re-parses the tail. Raises RuntimeError when the requested scope
        is not replayable — callers check `valid` / `source_valid(i)` /
        `source_delta(i)` and fall back to the re-parse path."""
        if source is not None:
            if not (self.source_valid(source) or (
                    prefix and self.source_delta(source) is not None)):
                raise RuntimeError(
                    f"encoded-block segment for source {source} is "
                    f"stale, evicted or absent")
            key = source if source in self._seg_order else self._COMBINED
            yield from self._read_segment(key)
            live = [k for k in self._seg_order if k not in self._evicted]
            if live and key == live[-1]:
                self.replays += 1
            return
        if not self.valid:
            raise RuntimeError("encoded-block cache is stale or absent")
        for key in self._seg_order:
            yield from self._read_segment(key)
        self.replays += 1

    def nbytes(self) -> int:
        try:
            return self._spilled_bytes()
        except OSError:
            return 0

    # ----------------------------------------------------------- cleanup
    def close(self) -> None:
        import shutil

        self.abort()
        if self._own_dir:
            shutil.rmtree(self._dir, ignore_errors=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def distinct_row_code_counts(row_of: np.ndarray, codes: np.ndarray,
                             region: np.ndarray, v: int) -> np.ndarray:
    """counts[c] = the rows whose region tokens include code c, a row
    counted once however often it repeats c (the k=1 support of a
    multi-hot matrix): a sort of row * v + code and a dedup of equal
    neighbours."""
    keys = row_of[region].astype(np.int64) * v + codes[region]
    keys.sort()
    if not keys.shape[0]:
        return np.zeros(v, np.int64)
    uniq = np.empty(keys.shape[0], bool)
    uniq[0] = True
    np.not_equal(keys[1:], keys[:-1], out=uniq[1:])
    return np.bincount((keys[uniq] % v).astype(np.intp), minlength=v)


class BlockScanEncoder:
    """The per-block body of the vocabulary-discovering pass 1 of the
    streaming miners.

    Each block encodes against the current vocabulary plus two sentinels
    that drop (the infrequent-item marker and the empty token, which would
    otherwise read as unknown on every block of a CSV with a trailing
    delimiter). A block with tokens still unknown takes one Python pass
    that appends them to `vocab` and `index` in place, then encodes again
    (only if the pass added one); a block of known tokens runs no Python
    a row. `region` is True exactly where an item position holds a
    vocabulary code (not a sentinel, an id or past a short row's end).
    Codes are append-only, so a code given against an earlier vocabulary
    holds against the final one."""

    def __init__(self, delim: str, skip: int, vocab: List[str],
                 index: Dict[str, int], marker: Optional[str] = None):
        self.delim = delim
        self.skip = skip
        self.vocab = vocab
        self.index = index
        self.marker = marker
        self._sentinels = ([marker] if marker is not None else []) + [""]

    def encode(self, data: bytes):
        """(codes, offsets, region, n_rows) of one raw byte block, or None
        for a block with no rows."""
        codes, offsets = seq_encode_native(data, self.delim,
                                           self.vocab + self._sentinels)
        n = offsets.shape[0] - 1
        if n <= 0:
            return None
        region = csr_region_mask(offsets, self.skip, codes.shape[0])
        if (codes[region] < 0).any():
            added = False
            for ln in data.decode("utf-8", "replace").split("\n"):
                if not ln.strip():
                    continue
                for tok in [t.strip(" \t\r")
                            for t in ln.split(self.delim)][self.skip:]:
                    if tok and tok != self.marker and tok not in self.index:
                        self.index[tok] = len(self.vocab)
                        self.vocab.append(tok)
                        added = True
            if added:
                codes, offsets = seq_encode_native(
                    data, self.delim, self.vocab + self._sentinels)
        v = len(self.vocab)
        np.logical_and(region, codes >= 0, out=region)
        np.logical_and(region, codes < v, out=region)     # sentinels drop
        return codes, offsets, region, n


def scan_encode_blocks(paths, delim: str, skip: int, vocab: List[str],
                       index: Dict[str, int], block_bytes: int,
                       marker: Optional[str] = None):
    """The vocabulary-discovering native scan of whole files: (codes,
    offsets, region, n_rows) a byte block (BlockScanEncoder's contract),
    the blocks read a block ahead on a worker thread."""
    from avenir_tpu_torch.core.stream import iter_byte_blocks, prefetched

    enc = BlockScanEncoder(delim, skip, vocab, index, marker)
    for path in paths:
        for data in prefetched(iter_byte_blocks(path, block_bytes), depth=1):
            out = enc.encode(data)
            if out is not None:
                yield out


class SpillScanMixin:
    """Pass 1 of a streaming miner source: the scan lifecycle (begin, a
    block at a time, finish and commit), its adapter as a shared-scan
    sink, the restore of a checkpoint taken mid-scan, and the ownership of
    the encoded-block spill cache that the per-k rounds replay.

    The port of `avenir_tpu/native/ingest.py` SpillScanMixin. A source
    with `sidecar_opts` (set by the runner from the job's conf) reads its
    own pass 1 through the columnar sidecar (native/sidecar.py).

    A subclass has `paths`, `delim`, `skip`, `block_bytes`, `spill_cache`,
    `cache_budget_bytes` (None: the cache's default), `vocab`, `index`,
    `_cache`, `_item_counts`, `_scan_counts` and `_scan_encoder`, and
    implements `_scan_block(data)` (fold one raw byte block into
    `_scan_counts` through `_grow_counts`, spilling its codes to `_cache`
    when there is one), `_note_encoded_rows(per_row, n)` (its row
    counters for one replayed sidecar block), `_reset_scan_state()` (zero
    its row counters) and `_scan_result()` (what its scan returns).
    `_scan_marker` is the infrequent-item sentinel given to the
    encoder."""

    _scan_marker: Optional[str] = None
    #: the columnar sidecar's knobs (native.sidecar.opts_from_cfg); None
    #: reads pass 1 from the text
    sidecar_opts: Optional[dict] = None

    def _scan_begin(self) -> None:
        self._reset_scan_state()
        self._scan_counts = np.zeros(0, np.int64)
        self._sidecar_vocab_src = None
        self._sidecar_vocab_done = 0
        self._scan_encoder = (
            BlockScanEncoder(self.delim, self.skip, self.vocab, self.index,
                             marker=self._scan_marker)
            if native_seq_ready(self.delim) else None)
        if self.spill_cache:
            if self._cache is not None:
                self._cache.close()
            self._cache = EncodedBlockCache(
                self.paths, byte_budget=self.cache_budget_bytes)
            self._cache.begin()

    def _grow_counts(self) -> None:
        v = len(self.vocab)
        if self._scan_counts.shape[0] < v:
            self._scan_counts = np.concatenate(
                [self._scan_counts,
                 np.zeros(v - self._scan_counts.shape[0], np.int64)])

    def _parse_block(self, data: bytes, label: str) -> None:
        """_scan_block(data) as a `stream.parse` span."""
        t0 = obs.now()
        self._scan_block(data)
        obs.record("stream.parse", t0, sink=label, nbytes=len(data),
                   engine="python" if self._scan_encoder is None
                   else "native")

    def _scan_all(self):
        """Pass 1 over every path's byte blocks, read a block ahead on a
        worker thread, then sealed. With the cache on, each path's blocks
        spill to a segment of its own (so a budget eviction drops a source,
        not the cache), and every block's fingerprint is recorded
        (note_block), so an appended source later replays its committed
        prefix and re-parses only the tail.

        With `sidecar_opts`, each path goes through the columnar sidecar
        first: verified blocks replay as SidecarBytesBlock
        (`_scan_encoded_block`: no tokenizer, no parse span), cold blocks
        come raw and are folded and packed, so the next run's pass 1
        parses nothing either. The spill cache sits on top either way."""
        from avenir_tpu_torch.core.stream import (is_blank_block,
                                                  iter_byte_blocks, prefetched)

        self._scan_begin()
        label = type(self).__name__
        opts = self.sidecar_opts
        for si, path in enumerate(self.paths):
            feed = None
            if opts is not None:
                from avenir_tpu_torch.native import sidecar

                feed = sidecar.byte_blocks(opts, path, self.delim,
                                           self.skip, self.block_bytes)
            if self._cache is not None:
                self._cache.set_source(si)
            if feed is not None:
                for off, length, hsh, payload in feed:
                    if self._cache is not None:
                        self._cache.note_fingerprint(off, length, hsh)
                    if payload is None:
                        continue
                    if isinstance(payload, (bytes, bytearray)):
                        self._parse_block(payload, label)
                    else:
                        self._scan_encoded_block(payload)
            elif self._cache is not None:
                for off, data in prefetched(
                        iter_byte_blocks(path, self.block_bytes,
                                         with_offsets=True), depth=1):
                    self._cache.note_block(off, data)
                    if not is_blank_block(data):
                        self._parse_block(data, label)
            else:
                for data in prefetched(
                        iter_byte_blocks(path, self.block_bytes), depth=1):
                    self._parse_block(data, label)
        return self._scan_finish()

    def _scan_encoded_block(self, blk) -> None:
        """Fold one replayed sidecar block (native.sidecar.
        SidecarBytesBlock), the parse-free twin of `_scan_block`. The
        sidecar's vocabulary extends this source's in first-seen order
        (less the infrequent-item marker, which the sidecar keeps and the
        miners drop), the order a cold scan assigns, so the codes, counts
        and spill cache equal a cold pass over the same bytes."""
        if blk.skip != self.skip:
            raise ValueError(
                f"sidecar block packed at skip={blk.skip} fed to a "
                f"skip={self.skip} scan")
        # the merge watermark is per sidecar: each source's manifest has a
        # vocabulary of its own (one list a feed), so it is keyed on that
        # list's identity and restarts at 0 for the next source
        if self._sidecar_vocab_src is not blk.vocab:
            self._sidecar_vocab_src = blk.vocab
            self._sidecar_vocab_done = 0
        done = self._sidecar_vocab_done
        for tok in blk.vocab[done:blk.vocab_end]:
            if tok != self._scan_marker and tok not in self.index:
                self.index[tok] = len(self.vocab)
                self.vocab.append(tok)
        self._sidecar_vocab_done = max(done, blk.vocab_end)
        self._grow_counts()
        # a stored code is the vocabulary code + 1, 0 the empty token: a
        # lookup table maps them onto this source's codes, -1 dropping the
        # empties and the marker as the cold region mask does
        lut = np.full(blk.vocab_end + 1, -1, np.int32)
        for k in range(blk.vocab_end):
            tok = blk.vocab[k]
            if tok != self._scan_marker:
                lut[k + 1] = self.index[tok]
        mapped = lut[blk.codes]
        region = mapped >= 0
        row_of = np.repeat(np.arange(blk.n, dtype=np.int32), blk.counts)
        self._scan_counts += distinct_row_code_counts(
            row_of, mapped, region, len(self.vocab))
        per_row = np.bincount(row_of[region].astype(np.intp),
                              minlength=blk.n)
        if self._cache is not None:
            self._cache.add_block(per_row, mapped[region])
        self._note_encoded_rows(per_row, blk.n)

    def _note_encoded_rows(self, per_row: np.ndarray, n: int) -> None:
        """The subclass's row counters for one replayed block (the
        transaction count; the row count and longest row)."""
        raise NotImplementedError

    def scan_consumer(self):
        """Pass 1 as a shared-scan sink of blocks read elsewhere
        (core.stream.SharedScan): consume() a raw byte block, or a
        replayed SidecarBytesBlock from a sidecar feed, finish() seals the
        scan (and commits the cache) and returns what the source's own
        scan would."""
        self._scan_begin()
        src = self
        label = type(self).__name__

        class _ScanSink:
            def consume(self, data) -> None:
                if isinstance(data, (bytes, bytearray)):
                    src._parse_block(data, label)
                else:
                    src._scan_encoded_block(data)

            def finish(self):
                return src._scan_finish()

        return _ScanSink()

    def _scan_finish(self):
        self._item_counts = self._scan_counts
        self._scan_encoder = None
        if self._cache is not None and not self._cache.commit():
            # a source changed under the scan: a torn cache never replays
            self._cache.close()
            self._cache = None
        return self._scan_result()

    def restore_scan_state(self, vocab, counts) -> None:
        """Install a mid-scan checkpoint into a scan just begun: the
        discovered vocabulary and the partial per-item counts, in place
        (the encoder holds `vocab` and `index`, so they mutate and are
        never rebound), and a new encoder over them. The cache is dropped
        and stays off: begun after the restore, it would hold only the
        later blocks yet commit as whole, so a restored scan re-parses its
        sources a round. The caller restores its own row counters."""
        self.vocab[:] = list(vocab)
        self.index.clear()
        self.index.update({t: i for i, t in enumerate(self.vocab)})
        self._scan_counts = np.asarray(counts, np.int64).copy()
        if self._scan_encoder is not None:
            self._scan_encoder = BlockScanEncoder(
                self.delim, self.skip, self.vocab, self.index,
                marker=self._scan_marker)
        if self._cache is not None:
            self._cache.close()
            self._cache = None
        self.spill_cache = False

    def _cache_pages(self, replay_pages, parse_pages):
        """The per-k feed of the pages of every source: the committed cache
        replayed when it is whole; otherwise a source at a time, its
        segment replayed when it covers the file, its committed prefix
        replayed and the appended tail re-parsed when the file grew
        (`source_delta`), else the file re-parsed
        (`parse_pages(path, byte_range)`)."""
        if self._cache is not None and self._cache.valid:
            yield from replay_pages(self._cache.blocks())
            return
        for si, path in enumerate(self.paths):
            if self._cache is None:
                yield from parse_pages(path)
                continue
            if self._cache.source_valid(si):
                yield from replay_pages(self._cache.blocks(si))
                continue
            delta = self._cache.source_delta(si)
            if delta is not None:
                yield from replay_pages(self._cache.blocks(si, prefix=True))
                yield from parse_pages(path, (delta, os.path.getsize(path)))
            else:
                yield from parse_pages(path)

    @property
    def cache_replays(self) -> int:
        """Completed replay passes of the spill cache."""
        return self._cache.replays if self._cache is not None else 0

    def cache_ready(self) -> bool:
        """True when pass 1 ran, its spill cache committed, and every
        source's segment can still replay in full: the precondition of
        serving a repeat mining request from this source with no CSV
        parse (runner.run_warm_miner). Any change to the corpus fails
        it. Its caller is the job server's warm store."""
        c = self._cache
        if c is None or self._item_counts is None:
            return False
        return all(c.source_valid(i) for i in range(len(self.paths)))

    def cache_evict_to(self, byte_budget: int) -> int:
        """Trim the spill toward `byte_budget` through the cache's own
        segment eviction (`EncodedBlockCache.evict_to`); the bytes
        evicted, 0 when the cache is off."""
        return (self._cache.evict_to(byte_budget)
                if self._cache is not None else 0)

    @property
    def cache_nbytes(self) -> int:
        """On-disk size of the spill cache (0 when off)."""
        return self._cache.nbytes() if self._cache is not None else 0

    @property
    def cache_evicted_bytes(self) -> int:
        """Bytes the cache evicted or dropped to hold its budget: the
        Cache:EvictedBytes counter."""
        return (self._cache.evicted_bytes
                if self._cache is not None else 0)

    def close(self) -> None:
        if self._cache is not None:
            self._cache.close()
            self._cache = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
