"""Chunked streaming CSV ingest.

The port's own copy of the block reader of `avenir_tpu/core/stream.py`,
without its columnar sidecar and prefetch thread. The reference streams
unbounded files through mappers one line at a time; here the unit is a
byte block of a fixed size cut at the last newline, parsed into a Dataset
chunk against one shared schema, so host memory stays O(block) however
large the file.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator

from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.core.schema import FeatureSchema

DEFAULT_BLOCK_BYTES = 64 << 20


def iter_byte_blocks(path: str, block_bytes: int = DEFAULT_BLOCK_BYTES
                     ) -> Iterator[bytes]:
    """Yield ~block_bytes raw byte blocks of `path`, each ending at a line
    boundary (the last block may lack its final newline). Blocks holding
    only whitespace are dropped."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no such input file: {path!r}")
    if block_bytes < 1:
        raise ValueError(f"block_bytes must be positive, got {block_bytes}")
    with open(path, "rb") as fh:
        carry = b""
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
                yield data[:cut + 1]
        if carry.strip():
            yield carry


def stream_job_inputs(cfg, inputs: Iterable[str], schema: FeatureSchema,
                      keep_raw: bool = False) -> Iterator[Dataset]:
    """Dataset chunks of every input path, sized by the
    `stream.block.size.mb` config key (default 64); keep_raw keeps each
    chunk's row tokens (`Dataset.raw_rows`) for jobs that echo the row."""
    block = int(cfg.get_float("stream.block.size.mb", 64.0) * (1 << 20))
    for path in inputs:
        for blk in iter_byte_blocks(path, block):
            yield Dataset.from_csv(blk, schema, delim=cfg.field_delim_regex,
                                   keep_raw=keep_raw)
