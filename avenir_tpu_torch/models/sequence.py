"""Sequence mining: GSP candidate generation and support, positional clusters.

The port of `avenir_tpu/models/sequence.py`. The reference
(org/avenir/sequence/) runs one MR job per sequence length k:
CandidateGenerationWithSelfJoin.java:44-200 joins the frequent
(k-1)-sequences (a + [b[-1]] where a[1:] == b[:-1], and the all-same-token
self-join), and a pass over the data counts how many sequences hold each
candidate as an order-preserving, not necessarily contiguous,
subsequence. Here the join is host code over the frequent set and the
count, the work that grows with the rows, runs on `device` through
`ops.sequence_kernels.subseq_support_fold`: the CUDA kernel
`csrc/subseq_support.cu` on the card, its plain version on the CPU.

- in RAM (`GSPMiner.mine`): the padded [N, T] token matrix goes to the
  device once, and a round counts every block of `block` rows into one
  int32 carry there, read by the host once;
- streamed (`mine_stream`): pass 1 finds the vocabulary, the k=1
  supports and the longest sequence (`StreamingSequenceSource.scan`,
  natively when the encoder builds); the frequent-token mask then drops
  the other tokens at ingest, and each round replays pass 1's
  encoded-block spill cache (or, where it cannot, re-reads the CSV) into
  padded [bucket(rows, 1024), bucket(t, 16)] blocks folded into one int32
  carry on the device.

A round's count is the profiler range `sequence::support_count`. A
candidate is kept when its count is above `support_threshold * n`, and
written with the support `count / n` to six decimals.

SequencePositionalCluster.java:49 (`EventLocalityAnalyzer`,
`positional_cluster`) scores a sliding time window of events, host numpy
in float64 as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from avenir_tpu_torch import obs
from avenir_tpu_torch.core.stream import double_buffered
from avenir_tpu_torch.native.ingest import SpillScanMixin
from avenir_tpu_torch.ops.sequence_kernels import subseq_support_fold
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device

#: the profiler range of one round's support count
SUPPORT_RANGE = "sequence::support_count"

Levels = Dict[int, Dict[Tuple[str, ...], float]]


# --------------------------------------------------------------------------
# GSP candidate generation (host)
# --------------------------------------------------------------------------
def join_sequences(this_seq: Sequence[str], that_seq: Sequence[str]
                   ) -> Optional[List[str]]:
    """The GSP join (CandidateGenerationWithSelfJoin.joinSquences:174-200):
    this + [that[-1]] if this[1:] == that[:-1], else that + [this[-1]] if
    that[1:] == this[:-1], else None."""
    if list(this_seq[1:]) == list(that_seq[:-1]):
        return list(this_seq) + [that_seq[-1]]
    if list(that_seq[1:]) == list(this_seq[:-1]):
        return list(that_seq) + [this_seq[-1]]
    return None


def self_join_sequence(seq: Sequence[str]) -> Optional[List[str]]:
    """A sequence of one repeated token extends itself
    (selfJoinSequence:156-172)."""
    if all(t == seq[0] for t in seq):
        return list(seq) + [seq[0]]
    return None


def generate_sequence_candidates(frequent: Iterable[Sequence[str]]
                                 ) -> List[Tuple[str, ...]]:
    """Every GSP k-candidate of the frequent (k-1)-sequences, deduplicated
    and sorted: each sequence meets only the sequences whose prefix is its
    suffix (the in-process form of the MR job's hashed bucket pairs)."""
    freq = [tuple(s) for s in frequent]
    by_prefix: Dict[Tuple[str, ...], List[Tuple[str, ...]]] = {}
    for s in freq:
        by_prefix.setdefault(s[:-1], []).append(s)
    out = set()
    for s in freq:
        sj = self_join_sequence(s)
        if sj is not None:
            out.add(tuple(sj))
        for t in by_prefix.get(s[1:], ()):
            j = join_sequences(s, t)
            if j is not None:
                out.add(tuple(j))
    return sorted(out)


# --------------------------------------------------------------------------
# Support counting on the device
# --------------------------------------------------------------------------
def _subseq_support(rows: torch.Tensor, cands: torch.Tensor,
                    k_vec: torch.Tensor, n_codes: int) -> torch.Tensor:
    """counts int32 [C]: the rows of int32 [N, T] `rows` (pad -1) holding
    candidate c of `cands` int32 [C, K] (pad -2) of length k_vec[c] as a
    subsequence (`_subseq_support_kernel`, sequence.py:84); n_codes is 1 +
    the largest code of `cands`, known on the host."""
    return _subseq_fold(torch.zeros(cands.shape[0], dtype=torch.int32,
                                    device=rows.device), rows, cands, k_vec,
                        n_codes)


def _subseq_fold(acc: torch.Tensor, rows: torch.Tensor, cands: torch.Tensor,
                 k_vec: torch.Tensor, n_codes: int) -> torch.Tensor:
    """acc += _subseq_support(rows, cands, k_vec, n_codes), in place: the
    streamed round's carry (`_subseq_fold_kernel`, sequence.py:114)."""
    return subseq_support_fold(acc, rows, cands, k_vec, n_codes)


def stream_candidate_support(src: "StreamingSequenceSource",
                             cands: List[Tuple[str, ...]], c_pad: int,
                             block: int = 65536,
                             device: DeviceLike = None) -> np.ndarray:
    """One streamed support pass over one source: the token-space
    candidates encoded through src.token_code (-2 for a token the source
    never saw or masked out, which matches nothing), each block folded
    into one int32 [c_pad] carry on `device`, read once at the end (int64
    [c_pad]). Only the real candidates are folded: the pad rows (length
    0) count nowhere, so their counts stay 0 with no work spent on them.
    mine_stream and mine_stream_merged both count through it. Each
    block's fold is a `stream.fold` span (sink `gsp_support`): its copy
    and dispatch, not its device time."""
    dev = resolve_device(device)
    n = len(cands)
    with record_function(SUPPORT_RANGE):
        cand_d, kv, n_codes = GSPMiner._cand_arrays(cands, src.token_code,
                                                    c_pad, dev)
        counts = torch.zeros(c_pad, dtype=torch.int32, device=dev)
        # the next block is encoded and paged on a worker thread while
        # this one is copied and counted here
        for blk in double_buffered(src.chunks(block)):
            t0 = obs.now()
            _subseq_fold(counts[:n], torch.from_numpy(blk).to(dev),
                         cand_d[:n], kv[:n], n_codes)
            obs.record("stream.fold", t0, sink="gsp_support")
        return counts.cpu().numpy().astype(np.int64)


def count_token_supports(src: "StreamingSequenceSource",
                         cands: List[Tuple[str, ...]], c_pad: int,
                         block: int = 65536,
                         device: DeviceLike = None) -> np.ndarray:
    """Support counts of token-space candidates over one source, aligned
    to `cands` (a token absent from the source codes -2 and counts 0)."""
    return stream_candidate_support(src, cands, c_pad, block,
                                    device)[:len(cands)]


# --------------------------------------------------------------------------
# Sequence ingest
# --------------------------------------------------------------------------
@dataclass
class SequenceSet:
    """Dictionary-encoded sequences in RAM: int32 [N, T] padded with -1,
    token ids in order of first appearance, empty tokens dropped."""
    rows: np.ndarray                 # int32 [N, T]
    lengths: np.ndarray              # int32 [N]
    vocab: List[str]
    index: Dict[str, int]

    @classmethod
    def from_token_rows(cls, token_rows: Sequence[Sequence[str]],
                        skip_field_count: int = 1) -> "SequenceSet":
        vocab: List[str] = []
        index: Dict[str, int] = {}
        flat: List[int] = []
        lengths: List[int] = []
        for r in token_rows:
            k0 = len(flat)
            for tok in r[skip_field_count:]:
                if tok == "":
                    continue
                i = index.get(tok)
                if i is None:
                    i = index[tok] = len(vocab)
                    vocab.append(tok)
                flat.append(i)
            lengths.append(len(flat) - k0)
        lens = np.asarray(lengths, np.int32)
        t = max(int(lens.max(initial=0)), 1)
        rows = np.full((len(lengths), t), -1, np.int32)
        row_of = np.repeat(np.arange(len(lengths)), lens)
        starts = np.cumsum(lens) - lens
        rows[row_of, np.arange(len(flat)) - np.repeat(starts, lens)] = flat
        return cls(rows, lens, vocab, index)

    def __len__(self) -> int:
        return self.rows.shape[0]


def _bucket(x: int, lo: int) -> int:
    """x rounded up to a power of two, at least lo."""
    return max(lo, 1 << (max(x, 1) - 1).bit_length())


class StreamingSequenceSource(SpillScanMixin):
    """Re-readable sequence files in blocks, for mining at any size.

    GSP is multi-pass (the reference runs one MR job a sequence length k
    over the same input): pass 1 (`scan`) fixes the vocabulary, the row
    count and the longest sequence; `chunks` then yields padded int32
    blocks encoded against that vocabulary. Pass 1 spills each block's
    codes to the encoded-block cache (`spill_cache`, bounded by
    `cache_budget_bytes`), which the later rounds replay; without it, or
    for a source it cannot serve, a round re-reads the files (the native
    `seq_encode` when it builds, the Python split otherwise)."""

    def __init__(self, paths: Sequence[str], delim: str = ",",
                 skip_field_count: int = 1, block_bytes: int = 64 << 20,
                 spill_cache: bool = True,
                 cache_budget_bytes: Optional[int] = None):
        self.paths = list(paths)
        self.delim = delim
        self.skip = skip_field_count
        self.block_bytes = block_bytes
        self.spill_cache = spill_cache
        self.cache_budget_bytes = cache_budget_bytes
        self._cache = None            # EncodedBlockCache once pass 1 ran
        self.vocab: List[str] = []
        self.index: Dict[str, int] = {}
        self.n_rows = 0
        self.t_max = 1
        self._item_counts: Optional[np.ndarray] = None
        self._kept_ids: Optional[np.ndarray] = None   # original ids, ascending
        self._remap: Optional[np.ndarray] = None      # original id -> masked|-1
        self._scan_counts: Optional[np.ndarray] = None
        self._scan_encoder = None

    # ----------------------------------------------------- frequent mask
    def mask_tokens(self, keep_ids: Sequence[int]) -> int:
        """Install the frequent-token mask after the k=1 scan: chunks()
        then drops the other tokens and closes each sequence's gaps (every
        element of a frequent sequence is a frequent 1-sequence, so no
        candidate needs a dropped token). Masked ids are the ranks of the
        ascending original ids. Returns the masked vocabulary size."""
        kept = np.asarray(sorted(keep_ids), np.int32)
        remap = np.full(max(len(self.vocab), 1), -1, np.int32)
        remap[kept] = np.arange(kept.shape[0], dtype=np.int32)
        self._kept_ids, self._remap = kept, remap
        return int(kept.shape[0])

    def token_code(self, tok: str) -> int:
        """A token's id in the chunks() id space (masked when a mask is
        installed); -2, which matches nothing, for a token this source
        never saw or masked out."""
        i = self.index.get(tok)
        if i is None:
            return -2
        if self._remap is not None:
            i = int(self._remap[i])
            if i < 0:
                return -2
        return i

    # ------------------------------------------------------------ pass 1
    def _reset_scan_state(self) -> None:
        self.n_rows = 0
        self.t_max = 1

    def _note_encoded_rows(self, per_row: np.ndarray, n: int) -> None:
        self.t_max = max(self.t_max, int(per_row.max(initial=0)))
        self.n_rows += n

    def _scan_result(self) -> Tuple[List[str], np.ndarray, int]:
        return self.vocab, self._item_counts, self.n_rows

    def scan(self) -> Tuple[List[str], np.ndarray, int]:
        """Pass 1: (vocab, per-token row-presence counts, n_rows), the k=1
        supports; also records t_max."""
        if self._item_counts is not None:
            return self.vocab, self._item_counts, self.n_rows
        return self._scan_all()

    def _scan_block(self, data: bytes) -> None:
        from avenir_tpu_torch.native.ingest import (csr_rows,
                                                    distinct_row_code_counts)

        if self._scan_encoder is not None:
            out = self._scan_encoder.encode(data)
            if out is None:
                return
            codes, offsets, region, n = out
            self._grow_counts()
            row_of, _ = csr_rows(offsets)
            per_row = np.bincount(row_of[region].astype(np.intp),
                                  minlength=n)
            self.t_max = max(self.t_max, int(per_row.max(initial=0)))
            self._scan_counts += distinct_row_code_counts(
                row_of, codes, region, len(self.vocab))
            if self._cache is not None:
                self._cache.add_block(per_row, codes[region])
            self.n_rows += n
            return
        lines = [ln for ln in data.decode("utf-8", "replace").split("\n")
                 if ln.strip()]
        if not lines:
            return
        blk_counts = np.zeros(len(lines), np.int64)
        blk_codes: List[int] = []
        for r, ln in enumerate(lines):
            k0 = len(blk_codes)
            for tok in [t.strip(" \t\r")
                        for t in ln.split(self.delim)][self.skip:]:
                if tok == "":
                    continue
                i = self.index.get(tok)
                if i is None:
                    i = len(self.vocab)
                    self.index[tok] = i
                    self.vocab.append(tok)
                blk_codes.append(i)
            blk_counts[r] = len(blk_codes) - k0
            self.t_max = max(self.t_max, int(blk_counts[r]))
        codes = np.asarray(blk_codes, np.int32)
        self._grow_counts()
        row_of = np.repeat(np.arange(len(lines), dtype=np.int32), blk_counts)
        region = np.ones(codes.shape[0], bool)
        self._scan_counts += distinct_row_code_counts(
            row_of, codes, region, len(self.vocab))
        if self._cache is not None:
            self._cache.add_block(blk_counts, codes)
        self.n_rows += len(lines)

    # ------------------------------------------------------- chunk feed
    def chunks(self, block_rows: int = 65536):
        """Padded int32 [bucket(rows, 1024), bucket(t, 16)] blocks, pad -1
        (a row of pads holds no candidate). Both axes round up to a power
        of two a block, not to the global maxima, so one long line does
        not widen every block. The pass-1 cache replays when it can serve
        (no span: nothing is parsed); a re-read byte block's encode and
        paging is a `stream.parse` span."""
        from avenir_tpu_torch.core.stream import (iter_byte_blocks,
                                                  iter_line_blocks,
                                                  prefetched)
        from avenir_tpu_torch.native.ingest import (csr_region_mask,
                                                    csr_rows,
                                                    native_seq_ready,
                                                    seq_encode_native)

        def pages(rows_v, pos, enc, n):
            bounds = np.searchsorted(
                rows_v, np.arange(0, n + block_rows, block_rows,
                                  dtype=np.int32))
            out = []
            for page, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
                rows_here = min(block_rows, n - page * block_rows)
                t_here = int(pos[lo:hi].max(initial=0)) + 1
                blk = np.full((_bucket(rows_here, 1024),
                               _bucket(t_here, 16)), -1, np.int32)
                blk[rows_v[lo:hi] - page * block_rows,
                    pos[lo:hi]] = enc[lo:hi]
                out.append(blk)
            return out

        def positions(valid, row_of, starts, n):
            # each surviving token's rank in its row: one cumsum over the
            # valid mask
            cs = np.cumsum(valid, dtype=np.int32)
            base = np.zeros(n, np.int32)
            nz = starts > 0
            base[nz] = cs[starts[nz] - 1]
            rows_v = row_of[valid]
            return rows_v, cs[valid] - 1 - base[rows_v]

        def replay_pages(blk_iter):
            # a cached block holds each row's region tokens (a count a row,
            # then the codes): mask, compact the positions, page. No CSV
            # read and no tokenizer.
            for counts, codes in prefetched(blk_iter, depth=1):
                n = counts.shape[0]
                if n <= 0:
                    continue
                starts = np.zeros(n, np.int64)
                starts[1:] = np.cumsum(counts[:-1], dtype=np.int64)
                row_of = np.repeat(np.arange(n, dtype=np.int32), counts)
                if self._remap is not None:
                    enc = self._remap[codes]
                    valid = enc >= 0
                else:
                    enc = codes
                    valid = np.ones(codes.shape[0], bool)
                rows_v, pos = positions(valid, row_of, starts, n)
                yield from pages(rows_v, pos, enc[valid], n)

        label = type(self).__name__

        def parse_pages(path, byte_range=None):
            for data in prefetched(iter_byte_blocks(path, self.block_bytes,
                                                    byte_range), depth=1):
                t0 = obs.now()
                codes, offsets = seq_encode_native(data, self.delim,
                                                   self.vocab)
                n = offsets.shape[0] - 1
                if n <= 0:
                    continue
                # the sequence region; unknown tokens (-1: ids, empties)
                # drop as in the Python path
                valid = csr_region_mask(offsets, self.skip, codes.shape[0])
                np.logical_and(valid, codes >= 0, out=valid)
                if self._remap is not None:
                    codes = np.where(valid, self._remap[
                        np.clip(codes, 0, None)], -1)
                    np.logical_and(valid, codes >= 0, out=valid)
                row_of, starts = csr_rows(offsets)
                rows_v, pos = positions(valid, row_of, starts, n)
                blocks = pages(rows_v, pos, codes[valid], n)
                obs.record("stream.parse", t0, sink=label,
                           nbytes=len(data), engine="native")
                yield from blocks

        if ((self._cache is not None and self._cache.valid)
                or native_seq_ready(self.delim)):
            yield from self._cache_pages(replay_pages, parse_pages)
            return

        def emit(rows_enc):
            t_here = max((len(r) for r in rows_enc), default=1)
            blk = np.full((_bucket(len(rows_enc), 1024),
                           _bucket(t_here, 16)), -1, np.int32)
            for r, row in enumerate(rows_enc):
                blk[r, :len(row)] = row
            return blk

        buf: List[List[int]] = []
        for path in self.paths:
            for lines in prefetched(
                    iter_line_blocks(path, self.block_bytes), depth=1):
                for ln in lines:
                    toks = [t.strip(" \t\r")
                            for t in ln.split(self.delim)][self.skip:]
                    enc = [self.index[t] for t in toks if t != ""]
                    if self._remap is not None:
                        enc = [m for m in
                               (int(self._remap[i]) for i in enc) if m >= 0]
                    buf.append(enc)
                    if len(buf) >= block_rows:
                        yield emit(buf)
                        buf = []
        if buf:
            yield emit(buf)


# --------------------------------------------------------------------------
# The GSP miner
# --------------------------------------------------------------------------
def _c_pad(n_cands: int) -> int:
    """The streamed rounds' candidate axis: a power of two, at least 16."""
    return max(16, 1 << (n_cands - 1).bit_length())


class GSPMiner:
    """Frequent-sequence miner: host GSP joins a round around support
    counts on `device` (default cuda). cgs.support.threshold is
    support_threshold (a fraction), cgs.item.set.length max_length; the
    loop runs every round up to it."""

    def __init__(self, support_threshold: float, max_length: int = 3,
                 block: int = 65536, device: DeviceLike = None):
        self.support_threshold = support_threshold
        self.max_length = max_length
        self.block = block
        self.device = resolve_device(device)

    @staticmethod
    def _cand_arrays(cands: List[Tuple[str, ...]], code_of, c_pad: int,
                     device: DeviceLike = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(cands int32 [c_pad, k_bucket], k_vec int32 [c_pad], n_codes)
        on `device`: each candidate's codes padded with -2, the pad rows
        of length 0 (never counted); k_bucket is a power of two, at least
        4; n_codes is 1 + the largest code (0 if none is a token's), the
        count kernel's code range, known here on the host."""
        k_max = max((len(cd) for cd in cands), default=1)
        k_max = max(4, 1 << (k_max - 1).bit_length())
        arr = np.full((c_pad, k_max), -2, np.int32)
        kv = np.zeros(c_pad, np.int32)
        for ci, cd in enumerate(cands):
            arr[ci, :len(cd)] = [code_of(tok) for tok in cd]
            kv[ci] = len(cd)
        dev = resolve_device(device)
        return (torch.from_numpy(arr).to(dev), torch.from_numpy(kv).to(dev),
                max(int(arr.max(initial=-1)) + 1, 0))

    def _count(self, rows: torch.Tensor, index: Dict[str, int],
               cands: List[Tuple[str, ...]]) -> np.ndarray:
        """One in-RAM round: every block of the device-resident rows
        folded into one carry, read once (int64 [len(cands)])."""
        with record_function(SUPPORT_RANGE):
            cand_d, kv, n_codes = self._cand_arrays(
                cands, lambda tok: index.get(tok, -2), len(cands),
                self.device)
            counts = torch.zeros(len(cands), dtype=torch.int32,
                                 device=self.device)
            for s in range(0, rows.shape[0], self.block):
                _subseq_fold(counts, rows[s:s + self.block], cand_d, kv,
                             n_codes)
            return counts.cpu().numpy().astype(np.int64)

    def mine(self, ss: SequenceSet) -> Levels:
        """Every round over sequences in RAM: the rows go to the device
        once; a round's candidates are not padded."""
        n = len(ss)
        min_count = self.support_threshold * n
        out: Levels = {}
        rows = torch.from_numpy(ss.rows).to(self.device)
        cands1 = [(tok,) for tok in ss.vocab]
        counts = self._count(rows, ss.index, cands1)
        freq = {c: cnt / n for c, cnt in zip(cands1, counts)
                if cnt > min_count}
        out[1] = freq
        for k in range(2, self.max_length + 1):
            cands = generate_sequence_candidates(list(freq))
            if not cands:
                break
            counts = self._count(rows, ss.index, cands)
            freq = {c: cnt / n for c, cnt in zip(cands, counts)
                    if cnt > min_count}
            if not freq:
                break
            out[k] = freq
        return out

    def mine_stream(self, src: StreamingSequenceSource) -> Levels:
        """mine() at any input size: a streamed scan a round (the
        reference's MR job a k) over blocks of the frequent tokens only,
        each round's candidates padded to _c_pad."""
        vocab, counts1, n = src.scan()
        min_count = self.support_threshold * n
        out: Levels = {}
        freq = {(tok,): cnt / n for tok, cnt in zip(vocab, counts1)
                if cnt > min_count}
        out[1] = freq
        src.mask_tokens([src.index[tok] for (tok,) in freq])
        for k in range(2, self.max_length + 1):
            cands = generate_sequence_candidates(list(freq))
            if not cands:
                break
            counts = stream_candidate_support(
                src, cands, _c_pad(len(cands)), self.block, self.device)
            freq = {c: cnt / n
                    for c, cnt in zip(cands, counts[:len(cands)])
                    if cnt > min_count}
            if not freq:
                break
            out[k] = freq
        return out

    def _merged_rounds(self, support1: Dict, n: int, count_fn) -> Levels:
        """The per-k loop of the merged miner: threshold the merged k=1
        supports, generate each level's candidates, count them through
        `count_fn(k, cands, c_pad)` (int64 [len(cands)]), prune, stop on
        an empty frontier."""
        min_count = self.support_threshold * n
        out: Levels = {}
        freq = {(tok,): cnt / n for tok, cnt in sorted(support1.items())
                if cnt > min_count}
        out[1] = freq
        for k in range(2, self.max_length + 1):
            cands = generate_sequence_candidates(list(freq))
            if not cands:
                break
            counts = count_fn(k, cands, _c_pad(len(cands)))
            freq = {c: cnt / n for c, cnt in zip(cands, counts)
                    if cnt > min_count}
            if not freq:
                break
            out[k] = freq
        return out

    def mine_stream_merged(self, sources: Sequence[StreamingSequenceSource]
                           ) -> Levels:
        """mine_stream() over shard sources: each round counts every
        candidate per shard (the one stream_candidate_support fold) and
        sums the counts (association.merge_support_counts), thresholded
        against the global row count, so the output equals one
        mine_stream over the shards in order."""
        from avenir_tpu_torch.models.association import merge_support_counts

        srcs = list(sources)
        if len(srcs) == 1:
            return self.mine_stream(srcs[0])
        scans = [src.scan() for src in srcs]
        n = sum(s[2] for s in scans)
        min_count = self.support_threshold * n
        support1 = merge_support_counts(
            *[{vocab[i]: int(counts[i]) for i in range(len(vocab))}
              for vocab, counts, _n in scans])
        freq_toks = [tok for tok, cnt in sorted(support1.items())
                     if cnt > min_count]
        for src in srcs:
            src.mask_tokens([src.index[tok] for tok in freq_toks
                             if tok in src.index])

        def count_level(k, cands, c_pad):
            counts = np.zeros(len(cands), np.int64)
            for src in srcs:
                counts += count_token_supports(src, cands, c_pad,
                                               self.block, self.device)
            return counts

        return self._merged_rounds(support1, n, count_level)


# --------------------------------------------------------------------------
# Positional clustering of event sequences
# --------------------------------------------------------------------------
class EventLocalityAnalyzer:
    """Sliding-window event-locality scoring
    (SequencePositionalCluster.java:49, hoidla
    TimeBoundEventLocalityAnalyzer), host numpy in float64.

    Events are (timestamp, value) rows; an event fires when its value
    meets the condition. A window's score comes from the strategies over
    its firing events' timestamps:

      numOccurence     events / window capacity
      averageInterval  1 - mean gap / window span
      maxInterval      1 - largest gap / window span

    `weighted_strategies` mixes the scores by weight; otherwise the
    preferred strategies are threshold conditions (min_occurence,
    max_interval_average, max_interval_max) joined by any or all
    (`any_cond`)."""

    STRATEGIES = ("numOccurence", "averageInterval", "maxInterval")

    def __init__(self, window_time_span: float, time_step: float,
                 score_threshold: float,
                 weighted_strategies: Optional[Dict[str, float]] = None,
                 preferred_strategies: Sequence[str] = ("numOccurence",),
                 min_occurence: int = 2,
                 max_interval_average: float = float("inf"),
                 max_interval_max: float = float("inf"),
                 any_cond: bool = True,
                 min_event_time_interval: float = 0.0):
        self.window = window_time_span
        self.step = time_step
        self.threshold = score_threshold
        self.weighted = weighted_strategies
        self.preferred = list(preferred_strategies)
        self.min_occurence = min_occurence
        self.max_interval_average = max_interval_average
        self.max_interval_max = max_interval_max
        self.any_cond = any_cond
        self.min_gap = min_event_time_interval

    def _window_score(self, times: np.ndarray) -> float:
        if len(times) == 0:
            return 0.0
        gaps = np.diff(times) if len(times) > 1 else np.array([self.window])
        gaps = gaps[gaps >= self.min_gap] if self.min_gap > 0 else gaps
        cap = max(self.window / max(self.step, 1e-9), 1.0)
        occ = min(len(times) / cap, 1.0)
        avg_gap = float(gaps.mean()) if len(gaps) else self.window
        max_gap = float(gaps.max()) if len(gaps) else self.window
        scores = {
            "numOccurence": occ,
            "averageInterval": max(1.0 - avg_gap / self.window, 0.0),
            "maxInterval": max(1.0 - max_gap / self.window, 0.0),
        }
        if self.weighted:
            tot_w = sum(self.weighted.values()) or 1.0
            return sum(scores[s] * w for s, w in self.weighted.items()) / tot_w
        conds = []
        for s in self.preferred:
            if s == "numOccurence":
                conds.append(len(times) >= self.min_occurence)
            elif s == "averageInterval":
                conds.append(avg_gap <= self.max_interval_average)
            elif s == "maxInterval":
                conds.append(max_gap <= self.max_interval_max)
        ok = any(conds) if self.any_cond else all(conds)
        return max(scores[s] for s in self.preferred) if ok else 0.0

    def score_events(self, timestamps: np.ndarray, fired: np.ndarray
                     ) -> List[Tuple[float, float]]:
        """Slide the window over the sorted timestamps: (window end time,
        score) of each window whose score is above the threshold, the
        rows the reference's mapper emits."""
        ts = np.asarray(timestamps, np.float64)
        f = np.asarray(fired, bool)
        out = []
        if len(ts) == 0:
            return out
        t = ts.min() + self.window
        t_end = ts.max()
        while t <= t_end + self.step / 2:
            in_win = (ts > t - self.window) & (ts <= t) & f
            score = self._window_score(ts[in_win])
            if score > self.threshold:
                out.append((float(t), float(score)))
            t += self.step
        return out


def positional_cluster(rows: Sequence[Sequence[str]],
                       analyzer: EventLocalityAnalyzer,
                       quant_field_ordinal: int,
                       seq_num_field_ordinal: int,
                       condition=lambda v: True
                       ) -> List[Tuple[float, float]]:
    """The SequencePositionalCluster job's body: CSV rows with a timestamp
    and a quantity field, the high-locality window positions out."""
    ts = np.array([float(r[seq_num_field_ordinal]) for r in rows])
    vals = np.array([float(r[quant_field_ordinal]) for r in rows])
    order = np.argsort(ts)
    fired = np.array([condition(v) for v in vals[order]])
    return analyzer.score_events(ts[order], fired)
