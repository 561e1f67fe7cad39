"""Chunked streaming CSV ingest, and the scan shared by several folds.

The port's own copy of the block readers (byte blocks, and line blocks
for free text) and `SharedScan` of `avenir_tpu/core/stream.py`, without
its columnar sidecar and prefetch thread. The reference streams
unbounded files through mappers one line at a time; here the unit is a
byte block of a fixed size cut at the last newline, parsed into a Dataset
chunk against one shared schema, so host memory stays O(block) however
large the file. Each block read is the span `stream.read`, each parse
`stream.parse` (Dataset.from_csv).

The `csv.engine` key (auto, native or python; default auto) picks the
parser of every Dataset a job reads, as Dataset.from_csv's `engine`.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Optional

from avenir_tpu_torch import obs
from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.core.schema import FeatureSchema

DEFAULT_BLOCK_BYTES = 64 << 20

#: called with no argument for every block `iter_byte_blocks` yields, when
#: set: a test counts the blocks a run reads (one scan or three). None in
#: production, where the check is one load a block.
_produce_hook = None


def iter_byte_blocks(path: str, block_bytes: int = DEFAULT_BLOCK_BYTES
                     ) -> Iterator[bytes]:
    """Yield ~block_bytes raw byte blocks of `path`, each ending at a line
    boundary (the last block may lack its final newline). Blocks holding
    only whitespace are dropped. The reading of each block yielded is a
    `stream.read` span."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no such input file: {path!r}")
    if block_bytes < 1:
        raise ValueError(f"block_bytes must be positive, got {block_bytes}")
    with open(path, "rb") as fh:
        carry = b""
        t0 = obs.now()
        while True:
            block = fh.read(block_bytes)
            if not block:
                break
            data = carry + block if carry else block
            cut = data.rfind(b"\n")
            if cut < 0:
                carry = data
                continue
            carry = data[cut + 1:]
            if data[:cut + 1].strip():
                obs.record("stream.read", t0, path=path, nbytes=cut + 1)
                _produced()
                yield data[:cut + 1]
                t0 = obs.now()
        if carry.strip():
            obs.record("stream.read", t0, path=path, nbytes=len(carry))
            _produced()
            yield carry


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


def stream_job_inputs(cfg, inputs: Iterable[str], schema: FeatureSchema,
                      keep_raw: bool = False) -> Iterator[Dataset]:
    """Dataset chunks of every input path, sized by the
    `stream.block.size.mb` config key (default 64); keep_raw keeps each
    chunk's row tokens (`Dataset.raw_rows`) for jobs that echo the row,
    which the Python parser alone can."""
    block = int(cfg.get_float("stream.block.size.mb", 64.0) * (1 << 20))
    engine = csv_engine(cfg)
    for path in inputs:
        for blk in iter_byte_blocks(path, block):
            yield Dataset.from_csv(blk, schema, delim=cfg.field_delim_regex,
                                   keep_raw=keep_raw, engine=engine)


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
    `stream.block.size.mb` key (default 64) as stream_job_inputs. The
    JAX package reads them ahead on a thread; here they are read in turn
    (the port has no prefetch thread yet)."""
    block = int(cfg.get_float("stream.block.size.mb", 64.0) * (1 << 20))
    for path in inputs:
        yield from iter_line_blocks(path, block)


def stream_job_byte_blocks(cfg, inputs: Iterable[str]) -> Iterator[bytes]:
    """Raw byte blocks of every input path (the feed of the miners' native
    encoder), sized by the same `stream.block.size.mb` key (default 64),
    read in turn."""
    block = int(cfg.get_float("stream.block.size.mb", 64.0) * (1 << 20))
    for path in inputs:
        yield from iter_byte_blocks(path, block)


class SharedScan:
    """One read and one parse a chunk, handed to N fold sinks.

    The chunk iterator (a `stream_job_inputs` feed) runs once, and each
    chunk goes to every registered sink in registration order, one after
    another: each sink sees its chunks in the order its own one-job scan
    would, which is what makes a shared scan's outputs byte-identical to
    per-job scans.

    Error contract: a sink that raises closes the chunk iterator before
    the exception propagates, so a generator feed runs its `finally`
    blocks (its open file closes) and is not left suspended."""

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
        try:
            for chunk in it:
                t_chunk = obs.now()
                for sink, label in self._sinks:
                    t0 = obs.now()
                    sink(chunk)
                    obs.record("stream.fold", t0, sink=label, chunk=n)
                obs.observe("chunk_latency_ms", (obs.now() - t_chunk) * 1e3)
                n += 1
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
        return n
