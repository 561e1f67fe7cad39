"""ctypes binding of the port's native CSV ingest (`csv_ingest.cpp`).

The port's own copy of the parse entry points of
`avenir_tpu/native/ingest.py`, and of the miners' ragged encoder: the
CSR encode (`seq_encode_native`), the pass-1 encoder that discovers the
vocabulary a block at a time (`BlockScanEncoder`) and the scan lifecycle
of the miners' streaming sources (`SpillScanMixin`, without the
reference's encoded-block spill cache and columnar sidecar: a per-k
re-scan here re-reads and re-encodes the CSV). The shared library builds with g++ at first
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
    block at a time, finish), its adapter as a shared-scan sink, and the
    restore of a checkpoint taken mid-scan.

    The port of `avenir_tpu/native/ingest.py` SpillScanMixin cut to that
    lifecycle: the reference's encoded-block spill cache and columnar
    sidecar are not ported.

    A subclass has `paths`, `delim`, `skip`, `block_bytes`, `vocab`,
    `index`, `_item_counts`, `_scan_counts` and `_scan_encoder`, and
    implements `_scan_block(data)` (fold one raw byte block into
    `_scan_counts` through `_grow_counts`), `_reset_scan_state()` (zero its
    row counters) and `_scan_result()` (what its scan returns).
    `_scan_marker` is the infrequent-item sentinel given to the encoder."""

    _scan_marker: Optional[str] = None

    def _scan_begin(self) -> None:
        self._reset_scan_state()
        self._scan_counts = np.zeros(0, np.int64)
        self._scan_encoder = (
            BlockScanEncoder(self.delim, self.skip, self.vocab, self.index,
                             marker=self._scan_marker)
            if native_seq_ready(self.delim) else None)

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
        worker thread, then sealed."""
        from avenir_tpu_torch.core.stream import iter_byte_blocks, prefetched

        self._scan_begin()
        label = type(self).__name__
        for path in self.paths:
            for data in prefetched(iter_byte_blocks(path, self.block_bytes),
                                   depth=1):
                self._parse_block(data, label)
        return self._scan_finish()

    def scan_consumer(self):
        """Pass 1 as a shared-scan sink of raw byte blocks read elsewhere
        (core.stream.SharedScan): consume() a block, finish() seals the
        scan and returns what the source's own scan would."""
        self._scan_begin()
        src = self
        label = type(self).__name__

        class _ScanSink:
            def consume(self, data: bytes) -> None:
                src._parse_block(data, label)

            def finish(self):
                return src._scan_finish()

        return _ScanSink()

    def _scan_finish(self):
        self._item_counts = self._scan_counts
        self._scan_encoder = None
        return self._scan_result()

    def restore_scan_state(self, vocab, counts) -> None:
        """Install a mid-scan checkpoint into a scan just begun: the
        discovered vocabulary and the partial per-item counts, in place
        (the encoder holds `vocab` and `index`, so they mutate and are
        never rebound), and a new encoder over them. The caller restores
        its own row counters."""
        self.vocab[:] = list(vocab)
        self.index.clear()
        self.index.update({t: i for i, t in enumerate(self.vocab)})
        self._scan_counts = np.asarray(counts, np.int64).copy()
        if self._scan_encoder is not None:
            self._scan_encoder = BlockScanEncoder(
                self.delim, self.skip, self.vocab, self.index,
                marker=self._scan_marker)
