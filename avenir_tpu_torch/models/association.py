"""Association mining: Apriori frequent itemsets and rule generation.

The port of `avenir_tpu/models/association.py`. The reference
(org/avenir/association/) runs one MR job per itemset length k; here the
per-k loop is a host loop, candidate generation (the Apriori join and
subset prune) stays on the host, and the support count, the work that
grows with the rows, runs on `device`:

- in RAM (`FrequentItemsApriori.mine`): the uint8 multi-hot matrix
  [N, V] goes to the device once, and a round is one count over
  device-resident tiles, `(tile @ cand.T) >= k` in float32 (exact: 0/1
  products, integer sums far below 2^24), read by the host once;
- streamed (`mine_stream`): pass 1 finds the vocabulary and the k=1
  supports (`StreamingTransactionSource.scan_items`, natively when the
  encoder builds), the frequent-item mask then shrinks the vocabulary,
  and each round replays pass 1's encoded-block spill cache (or, where it
  cannot, re-reads the CSV) into bit-packed blocks folded into one int32
  carry on the device (`ops.bitset.bitset_fold_counts`). Pass 1 reads
  through the columnar sidecar (`native/sidecar.py`) when the job's conf
  leaves it on, and a repeat run replays it instead of parsing.

A round's count is the profiler range `association::support_count`.
Between rounds the state is the per-k itemset file (`ItemSetList`), as in
the reference. Thresholds are Python floats: a candidate is kept when its
count is above `support_threshold * n`, and a support is written as
`count / n` to six decimals.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from itertools import combinations
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from avenir_tpu_torch import obs
from avenir_tpu_torch.core.stream import double_buffered
from avenir_tpu_torch.native.ingest import SpillScanMixin
from avenir_tpu_torch.ops.bitset import (as_words, bitset_contain_mask,
                                         bitset_fold_counts,
                                         pack_index_rows_u32, pack_rows_u32)
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device

#: the profiler range of one round's support count
SUPPORT_RANGE = "association::support_count"


def _c_pad(n_cands: int) -> int:
    """The candidate axis padded to a power of two, at least 64."""
    return max(64, 1 << (n_cands - 1).bit_length())


# --------------------------------------------------------------------------
# The merge algebra of sharded mining
# --------------------------------------------------------------------------
def merge_support_counts(*states: Dict) -> Dict:
    """Sum support counts keyed by candidate identity (a token or a
    sorted token tuple, never a shard's own masked id) across shard
    states, as unbounded Python ints. A candidate absent from a shard
    adds nothing."""
    out: Dict = {}
    for state in states:
        for cand, cnt in state.items():
            out[cand] = out.get(cand, 0) + int(cnt)
    return out


def frequent_tokens(support1: Dict, min_count: float) -> List[str]:
    """The tokens whose merged k=1 support is above min_count, sorted: the
    one order every merged run derives candidates and masks from."""
    return sorted(t for t, cnt in support1.items() if cnt > min_count)


def stream_candidate_support(src: "StreamingTransactionSource",
                             cand_ids: List[Tuple[int, ...]], c_pad: int,
                             block: int = 8192,
                             device: DeviceLike = None) -> np.ndarray:
    """One streamed support pass over one source: the candidates (masked
    item-id tuples of `src`) packed into a [c_pad, words] bitset on
    `device`, each packed block folded into one int32 carry there, read
    once at the end (int64 [c_pad]). mine_stream and mine_stream_merged
    both count through it. Each block's fold is a `stream.fold` span
    (sink `apriori_support`): its copy and dispatch, not its device
    time."""
    dev = resolve_device(device)
    with record_function(SUPPORT_RANGE):
        cand = as_words(pack_index_rows_u32(cand_ids, src.masked_width,
                                            c_pad), dev)
        counts = torch.zeros(c_pad, dtype=torch.int32, device=dev)
        # the next block is encoded and packed on a worker thread while
        # this one is copied and counted here
        for packed in double_buffered(src.packed_chunks(block)):
            t0 = obs.now()
            bitset_fold_counts(counts, as_words(packed, dev), cand)
            obs.record("stream.fold", t0, sink="apriori_support")
        return counts.cpu().numpy().astype(np.int64)


def count_token_supports(src: "StreamingTransactionSource",
                         cands: List[Tuple[str, ...]], c_pad: int,
                         block: int = 8192,
                         device: DeviceLike = None) -> np.ndarray:
    """Support counts of token-space candidates over one source, aligned
    to `cands`: a candidate with a token the source never saw (or masked
    out) counts 0 there without a scan; the others count through
    stream_candidate_support."""
    ids = [tuple(src.token_code(t) for t in cd) for cd in cands]
    present = [ci for ci, m in enumerate(ids) if all(i >= 0 for i in m)]
    counts = np.zeros(len(cands), np.int64)
    if present:
        shard = stream_candidate_support(
            src, [ids[ci] for ci in present], c_pad, block, device)
        counts[present] = shard[:len(present)]
    return counts


def collect_token_trans_ids(src: "StreamingTransactionSource",
                            all_sets: List[Tuple[str, ...]], c_pad: int,
                            block: int = 8192,
                            device: DeviceLike = None) -> List[List[str]]:
    """The transaction ids of each token-space set over one source, in its
    row order, from the id-bearing Python feed `src.chunks`."""
    dev = resolve_device(device)
    tids: List[List[str]] = [[] for _ in all_sets]
    ids = [tuple(src.token_code(t) for t in cd) for cd in all_sets]
    present = [ci for ci, m in enumerate(ids) if all(i >= 0 for i in m)]
    if not present:
        return tids
    cand = as_words(pack_index_rows_u32([ids[ci] for ci in present],
                                        src.masked_width, c_pad), dev)
    for mh, row_ids in src.chunks(block, with_ids=True):
        m = bitset_contain_mask(as_words(pack_rows_u32(mh), dev),
                                cand).cpu().numpy()
        for pi, ci in enumerate(present):
            for r in np.flatnonzero(m[:len(row_ids), pi]):
                tids[ci].append(str(row_ids[r]))
    return tids


# --------------------------------------------------------------------------
# Transaction ingest
# --------------------------------------------------------------------------
class TransactionSet:
    """Dictionary-encoded transactions in RAM: multi-hot uint8 [N, V] and
    the id column. A row is an id at `trans_id_ord`, `skip_field_count`
    leading non-item fields, and item tokens; the empty token and a
    `marker` token (InfrequentItemMarker's output) are dropped. The
    vocabulary is in first-seen order."""

    def __init__(self, multihot: np.ndarray, vocab: List[str],
                 trans_ids: np.ndarray):
        self.multihot = multihot            # uint8 [N, V]
        self.vocab = vocab                  # item id -> token
        self.index = {t: i for i, t in enumerate(vocab)}
        self.trans_ids = trans_ids          # object [N]

    @classmethod
    def from_rows(cls, rows: Sequence[Sequence[str]], trans_id_ord: int = 0,
                  skip_field_count: int = 1,
                  marker: Optional[str] = None) -> "TransactionSet":
        """Encode split rows: the reference's per-token loop, the multi-hot
        matrix then set in one scatter."""
        vocab: List[str] = []
        index: Dict[str, int] = {}
        flat: List[int] = []
        per_row: List[int] = []
        ids: List[str] = []
        for row in rows:
            ids.append(row[trans_id_ord])
            k0 = len(flat)
            for tok in row[skip_field_count:]:
                if tok == "" or (marker is not None and tok == marker):
                    continue
                i = index.get(tok)
                if i is None:
                    i = index[tok] = len(vocab)
                    vocab.append(tok)
                flat.append(i)
            per_row.append(len(flat) - k0)
        mh = np.zeros((len(rows), max(len(vocab), 1)), dtype=np.uint8)
        mh[np.repeat(np.arange(len(rows)), per_row),
           np.asarray(flat, dtype=np.intp)] = 1
        return cls(mh, vocab, np.array(ids, dtype=object))

    def __len__(self) -> int:
        return self.multihot.shape[0]


class StreamingTransactionSource(SpillScanMixin):
    """Re-readable transaction files in blocks, for mining at any size.

    Pass 1 (`scan_items`) finds the vocabulary and the per-item supports,
    natively when the encoder builds (a block of known tokens runs no
    Python a row). After the k=1 round the miner installs the
    frequent-item mask (`mask_items`, the ingest form of the reference's
    InfrequentItemMarker), and `packed_chunks` then yields uint32 bitset
    blocks over the frequent items only. Pass 1 spills each block's codes
    to the encoded-block cache (`spill_cache`, bounded by
    `cache_budget_bytes`), which the later rounds replay; without it, or
    for a source it cannot serve, a round re-reads the files."""

    def __init__(self, paths: Sequence[str], delim: str = ",",
                 trans_id_ord: int = 0, skip_field_count: int = 1,
                 marker: Optional[str] = None,
                 block_bytes: int = 64 << 20,
                 spill_cache: bool = True,
                 cache_budget_bytes: Optional[int] = None):
        self.paths = list(paths)
        self.delim = delim
        self.trans_id_ord = trans_id_ord
        self.skip = skip_field_count
        self.marker = marker
        self.block_bytes = block_bytes
        self.spill_cache = spill_cache
        self.cache_budget_bytes = cache_budget_bytes
        self._cache = None            # EncodedBlockCache once pass 1 ran
        self.vocab: List[str] = []
        self.index: Dict[str, int] = {}
        self.n_trans = 0
        self._item_counts: Optional[np.ndarray] = None
        self._kept_ids: Optional[np.ndarray] = None   # original ids, ascending
        self._remap: Optional[np.ndarray] = None      # original id -> masked|-1
        self._scan_counts: Optional[np.ndarray] = None
        self._scan_encoder = None

    def _row_blocks(self):
        """The token lists of the rows of each byte block, trimmed as the
        native encoder trims; each block's decode and split is a
        `stream.parse` span."""
        from avenir_tpu_torch.core.stream import iter_byte_blocks, prefetched

        label = type(self).__name__
        for path in self.paths:
            for blk in prefetched(iter_byte_blocks(path, self.block_bytes),
                                  depth=1):
                t0 = obs.now()
                rows = [[t.strip(" \t\r") for t in ln.rstrip("\r").split(
                    self.delim)]
                    for ln in blk.decode("utf-8", "replace").split("\n")
                    if ln.strip()]
                obs.record("stream.parse", t0, sink=label, nbytes=len(blk),
                           engine="python")
                if rows:
                    yield rows

    # ------------------------------------------------------------ pass 1
    @property
    def _scan_marker(self) -> Optional[str]:
        return self.marker

    def _reset_scan_state(self) -> None:
        self.n_trans = 0

    def _note_encoded_rows(self, per_row: np.ndarray, n: int) -> None:
        self.n_trans += n

    def _scan_result(self) -> Tuple[List[str], np.ndarray, int]:
        return self.vocab, self._item_counts, self.n_trans

    def scan_items(self) -> Tuple[List[str], np.ndarray, int]:
        """Pass 1: (vocab, per-item transaction counts, n_trans). An item
        repeated within one transaction counts once."""
        if self._item_counts is not None:
            return self.vocab, self._item_counts, self.n_trans
        return self._scan_all()

    def _scan_block(self, data: bytes) -> None:
        """Fold one raw byte block into the pass-1 state: the native
        encoder when built, the Python tokenizer otherwise."""
        from avenir_tpu_torch.native.ingest import (csr_rows,
                                                    distinct_row_code_counts)

        if self._scan_encoder is not None:
            out = self._scan_encoder.encode(data)
            if out is None:
                return
            codes, offsets, region, n = out
            self._grow_counts()
            row_of, _ = csr_rows(offsets)
            self._scan_counts += distinct_row_code_counts(
                row_of, codes, region, len(self.vocab))
            if self._cache is not None:
                blk_counts = np.bincount(row_of[region].astype(np.intp),
                                         minlength=n)
                self._cache.add_block(blk_counts, codes[region])
            self.n_trans += n
            return
        rows = [[t.strip(" \t\r") for t in ln.split(self.delim)]
                for ln in data.decode("utf-8", "replace").split("\n")
                if ln.strip()]
        if not rows:
            return
        blk_counts = np.zeros(len(rows), np.int64)
        blk_codes: List[int] = []
        for r, row in enumerate(rows):
            k0 = len(blk_codes)
            for tok in row[self.skip:]:
                if tok == "" or tok == self.marker:
                    continue
                i = self.index.get(tok)
                if i is None:
                    i = len(self.vocab)
                    self.index[tok] = i
                    self.vocab.append(tok)
                blk_codes.append(i)
            blk_counts[r] = len(blk_codes) - k0
        codes = np.asarray(blk_codes, np.int32)
        self._grow_counts()
        row_of = np.repeat(np.arange(len(rows), dtype=np.int32), blk_counts)
        region = np.ones(codes.shape[0], bool)
        self._scan_counts += distinct_row_code_counts(
            row_of, codes, region, len(self.vocab))
        if self._cache is not None:
            self._cache.add_block(blk_counts, codes)
        self.n_trans += len(rows)

    # ----------------------------------------------------- frequent mask
    def mask_items(self, keep_ids: Sequence[int]) -> int:
        """Install the frequent-item mask: packed_chunks() then encodes
        over only these items, in masked ids 0..len(keep)-1 (ranks of the
        ascending original ids, so sorted tuples stay sorted). Returns the
        masked width."""
        kept = np.asarray(sorted(keep_ids), np.int32)
        remap = np.full(max(len(self.vocab), 1), -1, np.int32)
        remap[kept] = np.arange(kept.shape[0], dtype=np.int32)
        self._kept_ids, self._remap = kept, remap
        return int(kept.shape[0])

    @property
    def masked_width(self) -> int:
        return (len(self.vocab) if self._kept_ids is None
                else int(self._kept_ids.shape[0]))

    def masked_token(self, masked_id: int) -> str:
        """The token of a masked item id (of an id, with no mask)."""
        if self._kept_ids is None:
            return self.vocab[masked_id]
        return self.vocab[int(self._kept_ids[masked_id])]

    def token_code(self, tok: str) -> int:
        """A token's id in the packed_chunks() id space; -2 for a token
        this source never saw or masked out."""
        i = self.index.get(tok)
        if i is None:
            return -2
        if self._remap is not None:
            i = int(self._remap[i])
            if i < 0:
                return -2
        return i

    def _apply_mask(self, r: np.ndarray, c: np.ndarray):
        if self._remap is None:
            return r, c
        m = self._remap[c]
        ok = m >= 0
        return r[ok], m[ok]

    # ------------------------------------------------------- chunk feeds
    def packed_chunks(self, block_rows: int = 8192):
        """uint32 bitset blocks [block_rows, words(V_masked)] over the
        masked vocabulary, a page of a byte block's rows each (a page's
        tail rows are zero: they contain no candidate). The pass-1 cache
        replays when it can serve (no span: nothing is parsed); otherwise
        the native encoder re-encodes each byte block when it builds (a
        `stream.parse` span with the packing), else the Python rows are
        packed."""
        from avenir_tpu_torch.core.stream import iter_byte_blocks, prefetched
        from avenir_tpu_torch.native.ingest import (csr_region_mask,
                                                    csr_rows,
                                                    native_seq_ready,
                                                    seq_encode_native)

        vm = max(self.masked_width, 1)
        label = type(self).__name__

        def pages(r, c, n):
            # r is sorted: each page is a searchsorted slice
            bounds = np.searchsorted(
                r, np.arange(0, n + block_rows, block_rows, dtype=np.int32))
            out = []
            for page, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
                mh = np.zeros((block_rows, vm), np.uint8)
                mh[r[lo:hi] - page * block_rows, c[lo:hi]] = 1
                out.append(pack_rows_u32(mh))
            return out

        def replay_pages(blk_iter):
            for counts, codes in prefetched(blk_iter, depth=1):
                n = counts.shape[0]
                if n <= 0:
                    continue
                row_of = np.repeat(np.arange(n, dtype=np.int32), counts)
                yield from pages(*self._apply_mask(row_of, codes), n)

        def parse_pages(path, byte_range=None):
            for data in prefetched(iter_byte_blocks(path, self.block_bytes,
                                                    byte_range), depth=1):
                t0 = obs.now()
                codes, offsets = seq_encode_native(data, self.delim,
                                                   self.vocab)
                n = offsets.shape[0] - 1
                if n <= 0:
                    continue
                # the item region only; unknown tokens (-1: ids, the
                # marker, empties) drop as in the Python path
                valid = csr_region_mask(offsets, self.skip, codes.shape[0])
                np.logical_and(valid, codes >= 0, out=valid)
                row_of, _ = csr_rows(offsets)
                blocks = pages(*self._apply_mask(row_of[valid],
                                                 codes[valid]), n)
                obs.record("stream.parse", t0, sink=label, nbytes=len(data),
                           engine="native")
                yield from blocks

        if ((self._cache is not None and self._cache.valid)
                or native_seq_ready(self.delim)):
            yield from self._cache_pages(replay_pages, parse_pages)
            return
        for mh, _ids in self.chunks(block_rows):
            yield pack_rows_u32(mh)

    def chunks(self, block_rows: int = 8192, with_ids: bool = False):
        """(multi-hot uint8 [block_rows, V_masked], ids) blocks from the
        Python rows: the feed that carries each row's id (the
        transaction-id pass needs them; the native encode drops them)
        and the feed when the encoder does not build."""
        vm = max(self.masked_width, 1)

        def emit(rows):
            mh = np.zeros((block_rows, vm), np.uint8)
            ids = []
            for r, row in enumerate(rows):
                if with_ids:
                    ids.append(row[self.trans_id_ord])
                for tok in row[self.skip:]:
                    i = self.index.get(tok)
                    if i is None:
                        continue
                    if self._remap is not None:
                        i = int(self._remap[i])
                        if i < 0:
                            continue
                    mh[r, i] = 1
            return mh, ids

        buf: List[List[str]] = []
        for rows in self._row_blocks():
            buf.extend(rows)
            while len(buf) >= block_rows:
                yield emit(buf[:block_rows])
                buf = buf[block_rows:]
        if buf:
            yield emit(buf)


# --------------------------------------------------------------------------
# Itemset containers (the state between rounds)
# --------------------------------------------------------------------------
@dataclass
class ItemSet:
    items: Tuple[str, ...]          # sorted item tokens
    support: float                  # fraction of transactions
    count: int
    trans_ids: Optional[List[str]] = None

    def line(self, delim: str = ",") -> str:
        parts = list(self.items) + [f"{self.support:.6f}"]
        if self.trans_ids is not None:
            parts += list(self.trans_ids)
        return delim.join(parts)


@dataclass
class ItemSetList:
    """The frequent itemsets of one length k (association/ItemSetList.java):
    the file handed from round k to round k+1."""
    length: int
    item_sets: List[ItemSet] = field(default_factory=list)

    def save(self, path: str, delim: str = ",") -> None:
        with open(path, "w") as fh:
            for s in self.item_sets:
                fh.write(s.line(delim) + "\n")

    @classmethod
    def load(cls, path: str, length: int, with_trans_ids: bool = False,
             delim: str = ",") -> "ItemSetList":
        sets = []
        with open(path) as fh:
            for ln in fh:
                toks = [t.strip() for t in ln.rstrip("\n").split(delim)]
                if not toks or toks == [""]:
                    continue
                items = tuple(toks[:length])
                support = float(toks[length])
                tids = toks[length + 1:] if with_trans_ids else None
                sets.append(ItemSet(items, support, 0, tids))
        return cls(length, sets)

    def supports(self) -> Dict[Tuple[str, ...], float]:
        return {s.items: s.support for s in self.item_sets}

    def __len__(self) -> int:
        return len(self.item_sets)


# --------------------------------------------------------------------------
# Support counting on the device
# --------------------------------------------------------------------------
def _contain_counts_resident(trans: torch.Tensor, cand: torch.Tensor,
                             k: int, block: int) -> torch.Tensor:
    """counts[c] = the rows of the device-resident uint8 multi-hot `trans`
    that hold all k items of float32 multi-hot candidate c, int32 [C]:
    one float32 matmul a tile of `block` rows, the carry kept on the
    device. An all-zero row has overlap 0 < k and counts nowhere."""
    counts = torch.zeros(cand.shape[0], dtype=torch.int32,
                         device=trans.device)
    for s in range(0, trans.shape[0], block):
        overlap = trans[s:s + block].to(torch.float32) @ cand.T
        counts += (overlap >= k).sum(dim=0, dtype=torch.int32)
    return counts


def _contain_mask_resident(trans: torch.Tensor, cand: torch.Tensor,
                           k: int, block: int) -> np.ndarray:
    """bool [N, C] on the host: row n holds all k items of candidate c,
    a tile of `block` rows at a time."""
    return np.concatenate([
        ((trans[s:s + block].to(torch.float32) @ cand.T) >= k).cpu().numpy()
        for s in range(0, trans.shape[0], block)], axis=0)


def _cand_rows(cands: List[Tuple[int, ...]], n_rows: int, v: int,
               device: torch.device) -> torch.Tensor:
    """float32 multi-hot [n_rows, v] of candidate id tuples, on device."""
    rows = np.zeros((n_rows, v), dtype=np.float32)
    for ci, items in enumerate(cands):
        rows[ci, list(items)] = 1.0
    return torch.from_numpy(rows).to(device)


# --------------------------------------------------------------------------
# The Apriori miner
# --------------------------------------------------------------------------
def _generate_candidates(freq_prev: List[Tuple], k: int) -> List[Tuple]:
    """The classical Apriori join and prune over the frequent (k-1)-sets
    (item-id or token tuples), on the host."""
    prev_set = set(freq_prev)
    freq_sorted = sorted(freq_prev)
    cands = []
    for i, a in enumerate(freq_sorted):
        for b in freq_sorted[i + 1:]:
            if a[:-1] != b[:-1]:
                break               # sorted: no more shared (k-2)-prefix
            cand = a + (b[-1],)
            # prune: all (k-1)-subsets must be frequent
            if all(cand[:j] + cand[j + 1:] in prev_set for j in range(k)):
                cands.append(cand)
    return cands


class FrequentItemsApriori:
    """Frequent itemset miner: a host loop over k around support counts on
    `device` (default cuda). The parameters are the reference's fia.*
    keys: support_threshold (fia.support.threshold, a fraction),
    max_length (fia.item.set.length) and emit_trans_id
    (fia.emit.trans.id: each set's transaction ids in the output)."""

    def __init__(self, support_threshold: float, max_length: int = 3,
                 emit_trans_id: bool = False, block: int = 8192,
                 device: DeviceLike = None):
        self.support_threshold = support_threshold
        self.max_length = max_length
        self.emit_trans_id = emit_trans_id
        self.block = block
        self.device = resolve_device(device)

    def mine(self, tx: TransactionSet) -> List[ItemSetList]:
        """All rounds over transactions in RAM: the multi-hot matrix goes
        to the device once."""
        n = len(tx)
        min_count = self.support_threshold * n
        v = tx.multihot.shape[1]
        col_counts = self.multihot_item_counts(tx)
        freq_ids: List[Tuple[int, ...]] = [
            (i,) for i in range(len(tx.vocab)) if col_counts[i] > min_count]
        trans = torch.from_numpy(tx.multihot).to(self.device)
        out = [self._pack(tx, trans, freq_ids, 1,
                          [int(col_counts[i]) for (i,) in freq_ids])]
        for k in range(2, self.max_length + 1):
            cands = _generate_candidates(freq_ids, k)
            if not cands:
                break
            with record_function(SUPPORT_RANGE):
                counts = _contain_counts_resident(
                    trans, _cand_rows(cands, _c_pad(len(cands)), v,
                                      self.device),
                    k, self.block).cpu().numpy()[:len(cands)]
            kept = [(c, int(cnt)) for c, cnt in zip(cands, counts)
                    if cnt > min_count]
            if not kept:
                break
            freq_ids = [c for c, _ in kept]
            out.append(self._pack(tx, trans, freq_ids, k,
                                  [cnt for _, cnt in kept]))
        return out

    def mine_stream(self, src: StreamingTransactionSource
                    ) -> List[ItemSetList]:
        """mine() at any input size: a streamed scan a round (the
        reference's MR job a k), bit-packed over the frequent items after
        the k=1 pass; with emit_trans_id, one more scan finds the ids of
        the kept sets of every length at once."""
        vocab, col_counts, n = src.scan_items()
        min_count = self.support_threshold * n
        freq1 = [i for i in range(len(vocab)) if col_counts[i] > min_count]
        vm = src.mask_items(freq1)
        rounds: List[Tuple[int, List[Tuple[int, ...]], List[int]]] = [
            (1, [(m,) for m in range(vm)],
             [int(col_counts[i]) for i in freq1])]
        freq_ids: List[Tuple[int, ...]] = rounds[0][1]
        for k in range(2, self.max_length + 1):
            cands = _generate_candidates(freq_ids, k)
            if not cands:
                break
            counts = stream_candidate_support(
                src, cands, _c_pad(len(cands)), self.block, self.device)
            kept = [(c, int(cnt)) for c, cnt in zip(cands, counts[:len(cands)])
                    if cnt > min_count]
            if not kept:
                break
            freq_ids = [c for c, _ in kept]
            rounds.append((k, freq_ids, [cnt for _, cnt in kept]))

        tids = self._collect_trans_ids(src, rounds) \
            if self.emit_trans_id else None
        out: List[ItemSetList] = []
        at = 0
        for k, ids_k, counts_k in rounds:
            out.append(self._pack_stream(
                src, ids_k, k, counts_k,
                tids[at:at + len(ids_k)] if tids is not None else None))
            at += len(ids_k)
        return out

    def _merged_rounds(self, support1: Dict, n: int, count_fn):
        """The per-k loop of the merged miner over token-space candidates:
        threshold the merged k=1 supports, then generate each level's
        candidates, count them through `count_fn(k, cands, c_pad)`
        (int64 [len(cands)]), prune, and stop on an empty frontier."""
        min_count = self.support_threshold * n
        freq_toks = frequent_tokens(support1, min_count)
        rounds: List[Tuple[int, List[Tuple[str, ...]], List[int]]] = [
            (1, [(t,) for t in freq_toks],
             [int(support1[t]) for t in freq_toks])]
        freq_sets: List[Tuple[str, ...]] = rounds[0][1]
        for k in range(2, self.max_length + 1):
            cands = _generate_candidates(freq_sets, k)
            if not cands:
                break
            counts = count_fn(k, cands, _c_pad(len(cands)))
            kept = [(cd, int(cnt)) for cd, cnt in zip(cands, counts)
                    if cnt > min_count]
            if not kept:
                break
            freq_sets = [cd for cd, _ in kept]
            rounds.append((k, freq_sets, [cnt for _, cnt in kept]))
        return rounds

    def _pack_merged_rounds(self, rounds, n: int,
                            tids: Optional[List[List[str]]] = None
                            ) -> List[ItemSetList]:
        """Merged rounds -> an ItemSetList a length (sorted sets, supports
        over the global count)."""
        out: List[ItemSetList] = []
        at = 0
        for k, sets_k, counts_k in rounds:
            sets = [ItemSet(tuple(sorted(cd)), counts_k[ci] / n,
                            int(counts_k[ci]),
                            tids[at + ci] if tids is not None else None)
                    for ci, cd in enumerate(sets_k)]
            sets.sort(key=lambda s: s.items)
            out.append(ItemSetList(k, sets))
            at += len(sets_k)
        return out

    def mine_stream_merged(self, sources: Sequence[StreamingTransactionSource]
                           ) -> List[ItemSetList]:
        """mine_stream() over shard sources: each round counts every
        candidate per shard (the one stream_candidate_support fold) and
        sums the counts (merge_support_counts), thresholded against the
        global count, so the output is byte-identical to one mine_stream
        over the shards in order. Candidates live in token space (a
        shard's masked ids are its own); transaction ids are concatenated
        in shard order."""
        srcs = list(sources)
        if len(srcs) == 1:
            return self.mine_stream(srcs[0])
        scans = [src.scan_items() for src in srcs]
        n = sum(s[2] for s in scans)
        min_count = self.support_threshold * n
        support1 = merge_support_counts(
            *[{vocab[i]: int(counts[i]) for i in range(len(vocab))}
              for vocab, counts, _n in scans])
        freq_toks = frequent_tokens(support1, min_count)
        for src in srcs:
            src.mask_items([src.index[t] for t in freq_toks
                            if t in src.index])

        def count_level(k, cands, c_pad):
            counts = np.zeros(len(cands), np.int64)
            for src in srcs:
                counts += count_token_supports(src, cands, c_pad,
                                               self.block, self.device)
            return counts

        rounds = self._merged_rounds(support1, n, count_level)
        tids = self._collect_trans_ids_merged(srcs, rounds) \
            if self.emit_trans_id else None
        return self._pack_merged_rounds(rounds, n, tids)

    def _collect_trans_ids_merged(self, srcs, rounds) -> List[List[str]]:
        """The transaction-id pass of the merged miner: one scan a shard
        over the kept sets of every length, ids concatenated in shard
        order."""
        all_sets = [cd for _k, sets_k, _c in rounds for cd in sets_k]
        tids: List[List[str]] = [[] for _ in all_sets]
        if not all_sets:
            return tids
        c_pad = _c_pad(len(all_sets))
        for src in srcs:
            shard = collect_token_trans_ids(src, all_sets, c_pad,
                                            self.block, self.device)
            for ci in range(len(all_sets)):
                tids[ci].extend(shard[ci])
        return tids

    def _collect_trans_ids(self, src: StreamingTransactionSource,
                           rounds) -> List[List[str]]:
        """One more streamed pass for emit_trans_id: the kept sets of every
        length in one packed candidate matrix (their tokens map back to
        the same masked ids)."""
        all_sets = [tuple(src.masked_token(i) for i in ids_t)
                    for _k, ids_k, _c in rounds for ids_t in ids_k]
        if not all_sets:
            return []
        return collect_token_trans_ids(src, all_sets, _c_pad(len(all_sets)),
                                       self.block, self.device)

    def _pack_stream(self, src: StreamingTransactionSource,
                     freq_ids: List[Tuple[int, ...]], k: int,
                     counts: List[int],
                     tids: Optional[List[List[str]]] = None) -> ItemSetList:
        if not freq_ids:
            return ItemSetList(k, [])
        n = src.n_trans
        sets = []
        for ci, ids_t in enumerate(freq_ids):
            tokens = tuple(sorted(src.masked_token(i) for i in ids_t))
            sets.append(ItemSet(tokens, counts[ci] / n, int(counts[ci]),
                                tids[ci] if tids is not None else None))
        sets.sort(key=lambda s: s.items)
        return ItemSetList(k, sets)

    def _pack(self, tx: TransactionSet, trans: torch.Tensor,
              freq_ids: List[Tuple[int, ...]], k: int,
              counts: List[int]) -> ItemSetList:
        """One round's ItemSetList; with emit_trans_id, each set's
        transaction ids from a membership mask over the device-resident
        rows."""
        if not freq_ids:
            return ItemSetList(k, [])
        n = len(tx)
        mask = None
        if self.emit_trans_id:
            mask = _contain_mask_resident(
                trans, _cand_rows(freq_ids, len(freq_ids),
                                  tx.multihot.shape[1], self.device),
                k, self.block)
        sets = []
        for ci, ids in enumerate(freq_ids):
            tokens = tuple(sorted(tx.vocab[i] for i in ids))
            tids = ([str(t) for t in tx.trans_ids[mask[:, ci]]]
                    if self.emit_trans_id else None)
            sets.append(ItemSet(tokens, counts[ci] / n, int(counts[ci]), tids))
        sets.sort(key=lambda s: s.items)
        return ItemSetList(k, sets)

    @staticmethod
    def multihot_item_counts(tx: TransactionSet) -> np.ndarray:
        """The k=1 supports: the column sums of the multi-hot matrix."""
        return tx.multihot.sum(axis=0, dtype=np.int64)


# --------------------------------------------------------------------------
# Infrequent item marker
# --------------------------------------------------------------------------
class InfrequentItemMarker:
    """Replace infrequent items with a marker token after the k=1 round
    (InfrequentItemMarker.java:41-46) so later scans shrink."""

    def __init__(self, frequent_items: Iterable[str], marker: str = "*",
                 skip_field_count: int = 1):
        self.frequent = set(frequent_items)
        self.marker = marker
        self.skip = skip_field_count

    def mark_row(self, row: Sequence[str]) -> List[str]:
        out = list(row[:self.skip])
        for tok in row[self.skip:]:
            out.append(tok if tok in self.frequent else self.marker)
        return out

    def mark(self, rows: Iterable[Sequence[str]]) -> List[List[str]]:
        return [self.mark_row(r) for r in rows]


# --------------------------------------------------------------------------
# Rule mining
# --------------------------------------------------------------------------
@dataclass
class AssociationRule:
    antecedent: Tuple[str, ...]
    consequent: Tuple[str, ...]
    confidence: float
    support: float                  # support of the full itemset
    lift: float = float("nan")

    def line(self) -> str:
        return (",".join(self.antecedent) + " -> " + ",".join(self.consequent)
                + f" ({self.confidence:.4f})")


class AssociationRuleMiner:
    """Rules from frequent itemsets (AssociationRuleMiner.java:94-190):
    each sublist up to max_ante_size is an antecedent, confidence =
    support(itemset) / support(antecedent) in float64 on the host, kept
    when above conf_threshold (arm.conf.threshold); lift against the
    consequent's support where it is known. Sorted by (-confidence,
    antecedent, consequent)."""

    def __init__(self, conf_threshold: float, max_ante_size: int = 3):
        self.conf_threshold = conf_threshold
        self.max_ante_size = max_ante_size

    def mine(self, item_set_lists: Sequence[ItemSetList]
             ) -> List[AssociationRule]:
        supports: Dict[Tuple[str, ...], float] = {}
        for isl in item_set_lists:
            supports.update(isl.supports())
        rules: List[AssociationRule] = []
        for isl in item_set_lists:
            if isl.length < 2:
                continue
            for s in isl.item_sets:
                items = s.items
                for size in range(1, min(self.max_ante_size,
                                         len(items) - 1) + 1):
                    for ante in combinations(items, size):
                        ante_sup = supports.get(tuple(sorted(ante)))
                        if ante_sup is None or ante_sup <= 0:
                            continue
                        conf = s.support / ante_sup
                        if conf > self.conf_threshold:
                            cons = tuple(t for t in items if t not in ante)
                            cons_sup = supports.get(tuple(sorted(cons)))
                            lift = (conf / cons_sup) if cons_sup \
                                else float("nan")
                            rules.append(AssociationRule(
                                ante, cons, conf, s.support, lift))
        rules.sort(key=lambda r: (-r.confidence, r.antecedent, r.consequent))
        return rules
