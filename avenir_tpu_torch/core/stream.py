"""Chunked streaming CSV ingest, its prefetch threads, and the scan
shared by several folds.

The port's own copy of the stream layer of `avenir_tpu/core/stream.py`:
the block readers (byte blocks, line blocks for free text, and
`CsvBlockReader` / `iter_csv_chunks` for Dataset chunks), the prefetch
thread (`prefetched`, `double_buffered`, the `stream.prefetch.depth`
key), `SharedScan`, the input splits of one file (`byte_range=` under
Hadoop's LineRecordReader contract, `split_byte_ranges`), and the job
feeds' route through the columnar sidecar (`native/sidecar.py`), without
the autotune hooks. The reference streams unbounded
files through mappers one line at a time; here the unit is a byte block
of a fixed size cut at the last newline, parsed into a Dataset chunk
against one shared schema, so host memory stays O(block) however large
the file.

Every job feed runs on threads: one reads byte blocks a block ahead
(`stream.read` spans), one parses them (`stream.parse`), and the job's
own thread folds (`stream.fold`), so the read, the parse and the
device's work on the block before overlap. The native parser is a
ctypes call, which releases the GIL; the Python parser does not, so it
overlaps little. A worker makes host arrays only: every host-to-device
copy and kernel launch stays on the consumer's thread. Time a consumer
waits on an empty queue is the span `stream.stall.consumer`, time a
worker waits on a full one `stream.stall.producer` (each recorded from
1 ms up).

A parse may grow a data-discovered vocabulary of the shared schema
while the folds still work on earlier chunks; each chunk carries the
bins its own parse left (`Dataset.num_bins`), and the folds read those.

The `csv.engine` key (auto, native or python; default auto) picks the
parser of every Dataset a job reads, as Dataset.from_csv's `engine`.
"""

from __future__ import annotations

import os
import queue
import re
import threading
from typing import Iterable, Iterator, List, Optional, Tuple, TypeVar

from avenir_tpu_torch import obs
from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.native import sidecar

DEFAULT_BLOCK_BYTES = 64 << 20
#: items queued ahead of the consumer in the job feeds; the
#: `stream.prefetch.depth` key overrides it a job (prefetch_depth)
DEFAULT_PREFETCH_DEPTH = 2

T = TypeVar("T")
# the first byte that is not whitespace, searched for in place
_NONWS = re.compile(rb"\S")

#: called with no argument for every block `iter_byte_blocks` yields, when
#: set (on the thread that reads): a test counts the blocks a run reads
#: (one scan or three). None in production, where the check is one load a
#: block.
_produce_hook = None

#: called with the byte size of every item a prefetched() worker produces
#: (`_nbytes`: a raw block's, 0 for a parsed chunk or an encoded page,
#: which the footprint model prices by their own terms), when set: the
#: memory auditor (`analysis/mem.py`) holds the model's block term
#: against the blocks that flowed. None in production.
_bytes_hook = None


def iter_byte_blocks(path: str, block_bytes: int = DEFAULT_BLOCK_BYTES,
                     byte_range: Optional[Tuple[int, int]] = None,
                     with_offsets: bool = False) -> Iterator:
    """Yield ~block_bytes raw byte blocks of `path`, each ending at a line
    boundary (the last block may lack its final newline). Blocks holding
    only whitespace are dropped. The reading of each block is a
    `stream.read` span.

    byte_range=(start, end) restricts the blocks to one input split under
    Hadoop's LineRecordReader contract: a split that starts mid-line skips
    past its first newline (the split before owns that line), and a split
    owns every line that starts before `end`, reading past `end` to finish
    it. Disjoint ranges covering [0, size) so yield every line once.

    with_offsets=True yields (offset, block) pairs, `offset` the file
    offset of the block's first byte, and keeps the blank blocks, so the
    blocks tile the covered range without a gap (`is_blank_block` tells a
    consumer which to skip)."""
    blocks = _offset_byte_blocks(path, block_bytes, byte_range)
    if with_offsets:
        return _counted(blocks)
    return _blank_filtered(blocks)


def _counted(blocks: Iterator[Tuple[int, bytes]]
             ) -> Iterator[Tuple[int, bytes]]:
    try:
        for item in blocks:
            _produced()
            yield item
    finally:
        blocks.close()


def _blank_filtered(blocks: Iterator[Tuple[int, bytes]]) -> Iterator[bytes]:
    try:
        for _off, blk in blocks:
            if not is_blank_block(blk):
                _produced()
                yield blk
    finally:
        blocks.close()          # an abandoned scan closes the file at once


def _offset_byte_blocks(path: str, block_bytes: int,
                        byte_range: Optional[Tuple[int, int]]
                        ) -> Iterator[Tuple[int, bytes]]:
    """(file offset, block) pairs tiling the byte range without a gap: the
    one copy of the block cutter behind both `iter_byte_blocks` modes."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no such input file: {path!r}")
    if block_bytes < 1:
        raise ValueError(f"block_bytes must be positive, got {block_bytes}")
    _check_range(byte_range)
    size = os.path.getsize(path)
    start, end = byte_range if byte_range else (0, size)
    end = min(end, size)
    with open(path, "rb") as fh:
        if start > 0:
            fh.seek(start - 1)
            if fh.read(1) != b"\n":
                fh.readline()
        pos = fh.tell()
        emit = pos               # offset of the next byte not yet yielded
        carry = b""
        t0 = obs.now()
        while pos < end:
            block = fh.read(block_bytes)
            if not block:
                break
            pos += len(block)
            if pos >= end:
                # finish the line holding byte end-1 (the split owns every
                # line that starts before `end`), reading past `end` if its
                # newline is not read yet
                data = carry + block if carry else block
                carry = b""
                b = len(data) - (pos - end)
                if b > 0 and data[b - 1:b] == b"\n":
                    cut = b
                else:
                    nl = data.find(b"\n", b)
                    while nl < 0:
                        extra = fh.read(block_bytes)
                        if not extra:
                            break
                        off = len(data)
                        data += extra
                        nl = data.find(b"\n", off)
                    cut = (nl + 1) if nl >= 0 else len(data)
                obs.record("stream.read", t0, path=path, offset=emit,
                           nbytes=cut)
                yield emit, data[:cut]
                return
            # carry holds no newline, so the cut in `block` is the cut in
            # carry + block
            cut = block.rfind(b"\n")
            if cut < 0:
                carry += block
                continue
            out = carry + block[:cut + 1] if carry else block[:cut + 1]
            carry = block[cut + 1:]
            obs.record("stream.read", t0, path=path, offset=emit,
                       nbytes=len(out))
            yield emit, out
            emit += len(out)
            t0 = obs.now()
        if carry:
            obs.record("stream.read", t0, path=path, offset=emit,
                       nbytes=len(carry))
            yield emit, carry


def _check_range(byte_range: Optional[Tuple[int, int]]) -> None:
    if byte_range is not None:
        s, e = byte_range
        if s < 0 or e < s:
            raise ValueError(f"invalid byte_range {byte_range}")


def split_byte_ranges(total: int, n: int) -> List[Tuple[int, int]]:
    """`n` contiguous [lo, hi) ranges tiling [0, total) without a gap: the
    one copy of the input-split arithmetic (`parallel.multihost`'s
    `host_shard_bounds`). The sizes are ceil(total / n), so a total
    smaller than n leaves trailing empty ranges (total, total), which
    still tile: a reader under the LineRecordReader contract sees no line
    there, never a line twice."""
    if n < 1:
        raise ValueError(f"split count must be positive, got {n}")
    if total < 0:
        raise ValueError(f"total must be non-negative, got {total}")
    per = (total + n - 1) // n
    ranges = []
    for i in range(n):
        lo = min(i * per, total)
        ranges.append((lo, min(lo + per, total)))
    return ranges


def is_blank_block(data: bytes) -> bool:
    """True when a byte block holds no byte but whitespace (searched in
    place, without the copy `bytes.strip()` makes)."""
    return _NONWS.search(data) is None


def _produced() -> None:
    hook = _produce_hook
    if hook is not None:
        hook()


def read_file(path: str) -> bytes:
    """The whole of `path`, for a job that parses a file at once (a train
    set, a similarity input): one `stream.read` span."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no such input file: {path!r}")
    t0 = obs.now()
    with open(path, "rb") as fh:
        data = fh.read()
    obs.record("stream.read", t0, path=path, nbytes=len(data))
    return data


def csv_engine(cfg) -> str:
    """The parser a job's `csv.engine` key asks for (default auto)."""
    return cfg.get("csv.engine", "auto")


def read_dataset(cfg, path: str, schema: FeatureSchema,
                 keep_raw: bool = False) -> Dataset:
    """A whole CSV file as one Dataset, with the job's delimiter and
    engine: its `stream.read` and `stream.parse` spans. keep_raw keeps
    the row tokens, which the Python parser alone can."""
    return Dataset.from_csv(read_file(path), schema,
                            delim=cfg.field_delim_regex, keep_raw=keep_raw,
                            engine=csv_engine(cfg))


class CsvBlockReader:
    """Dataset chunks of a CSV file, never the whole file at once.

    A chunk is a byte block (`iter_byte_blocks`) parsed against the one
    shared schema, so dictionary codes agree across chunks (a discovered
    vocabulary grows in place, and each chunk keeps the bins its parse
    left). The blocks are read a block ahead on a thread of their own
    (depth 1), so the file's reading overlaps the parse; each parse is
    Dataset.from_csv's `stream.parse` span."""

    def __init__(self, path: str, schema: FeatureSchema, delim: str = ",",
                 block_bytes: int = DEFAULT_BLOCK_BYTES, engine: str = "auto",
                 keep_raw: bool = False,
                 byte_range: Optional[Tuple[int, int]] = None):
        """byte_range=(start, end) reads one input split of the file, under
        `iter_byte_blocks`' LineRecordReader contract: disjoint ranges
        covering the file give every line once."""
        if not os.path.exists(path):
            raise FileNotFoundError(f"no such CSV file: {path!r}")
        if block_bytes < 1:
            raise ValueError(f"block_bytes must be positive, got {block_bytes}")
        _check_range(byte_range)
        self.path = path
        self.schema = schema
        self.delim = delim
        self.block_bytes = block_bytes
        self.engine = engine
        self.keep_raw = keep_raw
        self.byte_range = byte_range

    def __iter__(self) -> Iterator[Dataset]:
        # depth 1: one block ahead is all the read/parse overlap needs, and
        # it caps the raw bytes in flight at about two blocks (a job feed
        # queues parsed chunks on top of this)
        feed = prefetched(iter_byte_blocks(self.path, self.block_bytes,
                                           self.byte_range), depth=1)
        try:
            for blk in feed:
                yield Dataset.from_csv(blk, self.schema, delim=self.delim,
                                       keep_raw=self.keep_raw,
                                       engine=self.engine)
        finally:
            # joined at once when the consumer stops early or a parse
            # raises; a read error behind that parse error is dropped
            feed.close(_suppress=True)


def iter_csv_chunks(path: str, schema: FeatureSchema, delim: str = ",",
                    block_bytes: int = DEFAULT_BLOCK_BYTES,
                    engine: str = "auto",
                    keep_raw: bool = False) -> Iterator[Dataset]:
    """Dataset chunks of `path` (CsvBlockReader); a small file gives one."""
    return iter(CsvBlockReader(path, schema, delim, block_bytes, engine,
                               keep_raw))


# ------------------------------------------------------------- prefetch
_DONE = object()

#: how long a consumer's pull blocks before it checks that the worker is
#: still alive: a dead worker with an empty queue fails the pull instead
#: of hanging it
_GET_POLL_SECS = 0.5
#: how long close() waits to join the worker; one still alive after it is
#: stuck inside its source and is reported
_JOIN_SECS = 10.0


def _nbytes(item) -> int:
    """The bytes of a raw byte block, bare or as the (offset, block) pair
    of `iter_byte_blocks(with_offsets=True)`; 0 for any other item (a
    parsed chunk, an encoded page): the stall spans' `nbytes` and the
    byte hook's count."""
    if isinstance(item, tuple) and len(item) == 2:
        item = item[1]
    return len(item) if isinstance(item, (bytes, bytearray)) else 0


def _prefetch_worker(items: Iterable, q: "queue.Queue",
                     cancel: threading.Event, error_cell: list) -> None:
    """The worker's body. A module function taking its state as arguments:
    a bound method as the thread's target would keep its _Prefetcher
    alive while the worker ran, so an abandoned iterator could never be
    collected and its worker never cancelled."""

    def put(item) -> bool:
        # time blocked on a full queue: the consumer is the slower stage
        t0 = obs.now()
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.1)
                obs.record_min("stream.stall.producer", t0,
                               nbytes=_nbytes(item))
                return True
            except queue.Full:
                continue
        return False

    it = iter(items)
    try:
        for item in it:
            bhook = _bytes_hook
            if bhook is not None:
                bhook(_nbytes(item))
            if not put(item):
                break
        else:
            put(_DONE)
    except BaseException as exc:   # re-raised on the consumer's side
        error_cell[0] = exc        # kept even if the put loses a race
        put(exc)                   # with close(): never dropped
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


class _Prefetcher(Iterator[T]):
    """An iterator over `items` produced by a worker thread.

    Its contract: order is kept; a worker's exception re-raises at the
    consumer's next pull; close() (explicit, by `yield from` delegation,
    at the end, or at garbage collection) cancels the worker and joins it
    within _JOIN_SECS, so neither its thread nor a file open inside
    `items` outlives the consumer; a worker exception the consumer never
    pulled re-raises from an explicit close(), never from GC; and a pull
    that finds the worker dead and the queue empty fails after
    _GET_POLL_SECS instead of hanging."""

    def __init__(self, items: Iterable[T], depth: int):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._cancel = threading.Event()
        self._error_cell: list = [None]
        self._thread: Optional[threading.Thread] = threading.Thread(
            target=_prefetch_worker,
            args=(items, self._q, self._cancel, self._error_cell),
            daemon=True)
        self._thread.start()

    def __iter__(self) -> "_Prefetcher":
        return self

    def __next__(self) -> T:
        if self._thread is None:
            raise StopIteration
        # time blocked on an empty queue: the worker is the slower stage
        t0 = obs.now()
        while True:
            try:
                item = self._q.get(timeout=_GET_POLL_SECS)
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    # every exit of the worker posts _DONE or an exception:
                    # an empty queue under a dead worker means the process
                    # is going down
                    self.close()
                    raise RuntimeError(
                        "prefetch worker exited without a result")
                continue
            if item is _DONE:
                self.close()
                raise StopIteration
            if isinstance(item, BaseException):
                self._error_cell[0] = None    # delivered: close() must
                self.close(_suppress=True)    # not raise it again
                raise item
            obs.record_min("stream.stall.consumer", t0, nbytes=_nbytes(item))
            return item

    def close(self, _suppress: bool = False) -> None:
        """Cancel the worker, join it, and re-raise a worker exception the
        consumer never pulled (unless `_suppress`: the paths where an
        exception is already on its way)."""
        thread, self._thread = self._thread, None
        if thread is None:
            return
        self._cancel.set()
        # drain, so a worker blocked on a full queue sees the cancel soon
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        thread.join(_JOIN_SECS)
        if thread.is_alive():
            raise RuntimeError(
                f"prefetch worker failed to stop within {_JOIN_SECS}s "
                f"(stuck inside its source iterable?)")
        pending, self._error_cell[0] = self._error_cell[0], None
        if pending is not None and not _suppress:
            raise pending

    def __del__(self):
        try:
            self.close(_suppress=True)    # a GC close never raises
        except Exception:
            pass


def prefetched(items: Iterable[T], depth: int = DEFAULT_PREFETCH_DEPTH
               ) -> Iterator[T]:
    """`items` produced on a worker thread, up to `depth` of them queued
    ahead of the consumer (the _Prefetcher contract: order kept, errors
    re-raised at the next pull, close() cancels and joins the worker)."""
    return _Prefetcher(items, depth)


def double_buffered(items: Iterable[T]) -> Iterator[T]:
    """prefetched at depth 1: producing block k+1 on the host overlaps the
    device's work on block k, and at most one finished block waits. The
    miners' count loops put it between a block's encode and its fold;
    stacked on the inner byte-block prefetch, one block is read, one
    encoded and one counted at a time."""
    return prefetched(items, depth=1)


def prefetch_depth(cfg) -> int:
    """The `stream.prefetch.depth` key (default 2, at least 1): the items
    the job feeds below queue ahead of their consumer. Each queued item is
    a parsed chunk or a raw block held in memory."""
    return max(int(cfg.get_float("stream.prefetch.depth",
                                 float(DEFAULT_PREFETCH_DEPTH))), 1)


def _block_bytes(cfg) -> int:
    """The `stream.block.size.mb` key (default 64) in bytes."""
    return int(cfg.get_float("stream.block.size.mb", 64.0) * (1 << 20))


def _sidecar_payloads(feed) -> Iterator:
    """A sidecar feed's payloads, without its (offset, length, hash)
    bookkeeping and its blank-block placeholders: what a job folds."""
    for _off, _length, _hash, payload in feed:
        if payload is not None:
            yield payload


def stream_job_inputs(cfg, inputs: Iterable[str], schema: FeatureSchema,
                      keep_raw: bool = False) -> Iterator[Dataset]:
    """Dataset chunks of every input path, sized by the
    `stream.block.size.mb` key (default 64) and queued
    `stream.prefetch.depth` deep: one thread reads, one parses
    (iter_csv_chunks), the caller folds. keep_raw keeps each chunk's row
    tokens (`Dataset.raw_rows`) for jobs that echo the row, which the
    Python parser alone can.

    Where the columnar sidecar engages (the native parser, a one-byte
    delimiter, `stream.sidecar` not off, no keep_raw), each path streams
    through native.sidecar.dataset_blocks instead: a verified repeat scan
    replays packed columns without parsing, a first scan parses and
    packs, and anything in doubt falls back to the chunks below, to the
    same bytes."""
    block, depth = _block_bytes(cfg), prefetch_depth(cfg)
    opts = None if keep_raw else sidecar.opts_from_cfg(cfg)
    for path in inputs:
        feed = None
        if opts is not None:
            feed = sidecar.dataset_blocks(opts, path, schema,
                                          cfg.field_delim_regex, block)
        if feed is not None:
            yield from prefetched(_sidecar_payloads(feed), depth=depth)
        else:
            yield from prefetched(iter_csv_chunks(
                path, schema, cfg.field_delim_regex, block, csv_engine(cfg),
                keep_raw), depth=depth)


def iter_line_blocks(path: str, block_bytes: int = DEFAULT_BLOCK_BYTES
                     ) -> Iterator[List[str]]:
    """Lists of the non-blank text lines of about block_bytes of `path`
    each, for the jobs whose input is not schema-typed CSV (free text):
    the reference streams them one line at a time through the mapper
    contract, here a block at a time, so host memory stays O(block).
    Each block's decode and split is a `stream.parse` span."""
    for blk in iter_byte_blocks(path, block_bytes):
        t0 = obs.now()
        lines = [ln.rstrip("\r")
                 for ln in blk.decode("utf-8", "replace").split("\n")
                 if ln.strip()]
        obs.record("stream.parse", t0, nbytes=len(blk), engine="lines")
        if lines:
            yield lines


def stream_job_lines(cfg, inputs: Iterable[str]) -> Iterator[List[str]]:
    """Line blocks of every input path, sized by the same
    `stream.block.size.mb` key as stream_job_inputs, read and split on a
    worker thread and queued `stream.prefetch.depth` deep."""
    block, depth = _block_bytes(cfg), prefetch_depth(cfg)
    for path in inputs:
        yield from prefetched(iter_line_blocks(path, block), depth=depth)


def stream_job_byte_blocks(cfg, inputs: Iterable[str],
                           sidecar_skip: Optional[int] = None
                           ) -> Iterator[bytes]:
    """Raw byte blocks of every input path (the feed of the miners' native
    encoder), sized by the same `stream.block.size.mb` key, read on a
    worker thread and queued `stream.prefetch.depth` deep.

    `sidecar_skip` opts in to the bytes-kind columnar sidecar: a caller
    whose consumers take a native.sidecar.SidecarBytesBlock as well as raw
    bytes (the per-class markov fold, the miners' pass 1) passes its meta
    skip count, and a verified repeat scan then replays packed codes
    instead of text. None keeps the raw feed."""
    block, depth = _block_bytes(cfg), prefetch_depth(cfg)
    opts = None if sidecar_skip is None else sidecar.opts_from_cfg(cfg)
    for path in inputs:
        feed = None
        if opts is not None:
            feed = sidecar.byte_blocks(opts, path, cfg.field_delim_regex,
                                       int(sidecar_skip), block)
        if feed is not None:
            yield from prefetched(_sidecar_payloads(feed), depth=depth)
        else:
            yield from prefetched(iter_byte_blocks(path, block), depth=depth)


class SharedScan:
    """One read and one parse a chunk, handed to N fold sinks.

    The chunk iterator (a `stream_job_inputs` feed) runs once, and each
    chunk goes to every registered sink in registration order, one after
    another: each sink sees its chunks in the order its own one-job scan
    would, which is what makes a shared scan's outputs byte-identical to
    per-job scans.

    Error contract: a sink that raises closes the chunk iterator before
    the exception propagates, so a prefetched feed's worker is cancelled
    and joined and its open file closes. A worker error that close()
    would re-raise is dropped there: the sink's exception is the one on
    its way."""

    def __init__(self, chunks: Iterable):
        self._chunks = chunks
        self._sinks: list = []

    def add_sink(self, sink, label: Optional[str] = None) -> None:
        """Register a per-chunk consumer: a callable taking one chunk, or
        an object with a `consume` method. `label` names the sink in its
        `stream.fold` spans (default: its class or function name)."""
        fn = getattr(sink, "consume", sink)
        if label is None:
            label = (type(sink).__name__ if hasattr(sink, "consume")
                     else getattr(sink, "__name__", "sink"))
        self._sinks.append((fn, label))

    def run(self) -> int:
        """Drive the scan and return the number of chunks. Each sink call
        is a `stream.fold` span (attributes `sink` and `chunk`), and each
        chunk's whole fan-out adds one value to the `chunk_latency_ms`
        histogram."""
        n = 0
        it = iter(self._chunks)
        close = getattr(it, "close", None)
        try:
            for chunk in it:
                t_chunk = obs.now()
                for sink, label in self._sinks:
                    t0 = obs.now()
                    sink(chunk)
                    obs.record("stream.fold", t0, sink=label, chunk=n)
                obs.observe("chunk_latency_ms", (obs.now() - t_chunk) * 1e3)
                n += 1
        except BaseException:
            if close is not None:
                try:
                    close()        # joins the worker; the exception on
                except Exception:  # its way is the one to see
                    pass
            raise
        if close is not None:
            close()
        return n
