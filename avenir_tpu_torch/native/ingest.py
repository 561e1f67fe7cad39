"""ctypes binding of the port's native CSV ingest (`csv_ingest.cpp`).

The port's own copy of the parse entry points of
`avenir_tpu/native/ingest.py`. The shared library builds with g++ at first
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
