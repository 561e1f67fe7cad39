"""Bit-packed set containment: the streamed miners' support count.

The port of `avenir_tpu/ops/bitset.py`. Transaction rows are packed 32
vocabulary bits to a uint32 word (`pack_rows_u32`, numpy, as the
reference), candidates the same way (`pack_index_rows_u32`), and

    overlap[b, c] = sum_w popcount(trans[b, w] & cand[c, w])
    contained     = overlap == popcount(cand[c])  and  popcount(cand[c]) > 0

so one call counts candidates of every itemset length, and an all-zero
candidate row (bucket padding) counts 0.

PyTorch has no popcount, and its CPU build shifts no uint32, so the words
travel as int32 (the same bits) and the overlap takes one of two forms:

- `_overlap_fold` (the one the miners run): the words unpacked into 0/1
  bits, `[B, 32 W]` in float32 on the device, and one `torch.matmul`
  against the unpacked candidates. Exact: each product is 0 or 1 and
  each overlap an integer at most 32 W, far below 2^24; 0 and 1 are
  exact in TF32 and bfloat16 too.
- `_overlap_fold_words`, the reference's word-by-word fold: a popcount of
  `trans[:, w] & cand[:, w]` by SWAR on int64 (`popcount32`), summed over
  the words. It keeps a `[B, C]` int64 temporary or more a word alive and
  stays as the plain version the tests and `chip_smoke.py` hold the first
  form to.

Both give the same int32 counts, whatever the block layout.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

WORD_BITS = 32


def words_for(n_bits: int) -> int:
    """uint32 words for n_bits vocabulary bits, at least 1."""
    return max((max(n_bits, 0) + WORD_BITS - 1) // WORD_BITS, 1)


def pack_rows_u32(multihot: np.ndarray) -> np.ndarray:
    """uint8/bool multi-hot [N, V] -> uint32 bitset [N, words_for(V)].

    Bit b of word w holds vocabulary column w*32 + b (little-endian bit
    order)."""
    mh = np.ascontiguousarray(multihot, dtype=np.uint8)
    n, v = mh.shape
    w = words_for(v)
    pad_cols = w * WORD_BITS - v
    if pad_cols:
        mh = np.pad(mh, ((0, 0), (0, pad_cols)))
    packed = np.packbits(mh, axis=1, bitorder="little")
    return packed.view(np.uint32).reshape(n, w)


def pack_index_rows_u32(item_rows: Sequence[Sequence[int]], n_bits: int,
                        n_rows: int = 0) -> np.ndarray:
    """Candidate index tuples -> uint32 bitset [max(n_rows, len), W]; the
    rows past len(item_rows) stay all-zero (bucket padding)."""
    rows = max(n_rows, len(item_rows))
    out = np.zeros((rows, words_for(n_bits)), np.uint32)
    for r, items in enumerate(item_rows):
        for i in items:
            out[r, i // WORD_BITS] |= np.uint32(1) << np.uint32(i % WORD_BITS)
    return out


def as_words(packed: np.ndarray, device) -> torch.Tensor:
    """A uint32 bitset as the int32 tensor of the same bits on `device`."""
    return torch.from_numpy(
        np.ascontiguousarray(packed).view(np.int32)).to(device)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """The set bits of each 32-bit word of an int32 tensor, as int32: SWAR
    on int64, where the shifts are logical."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """int32 words [N, W] -> float32 0/1 bits [N, 32 W], column w*32 + b
    from bit b of word w (an arithmetic shift of bit 31 still ends in 1)."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(words.shape[0], -1).to(torch.float32)


def _overlap_fold(trans: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """popcount(t & c) summed over words, int32 [B, C]: unpacked bits and
    one float32 matmul."""
    return torch.matmul(unpack_bits(trans),
                        unpack_bits(cand).T).to(torch.int32)


def _overlap_fold_words(trans: torch.Tensor, cand: torch.Tensor
                        ) -> torch.Tensor:
    """The same overlap word by word (the reference's lax.scan over the
    word axis): int32 [B, C]."""
    acc = torch.zeros((trans.shape[0], cand.shape[0]), dtype=torch.int32,
                      device=trans.device)
    for w in range(trans.shape[1]):
        acc += popcount32(trans[:, w, None] & cand[None, :, w])
    return acc


def _contained(trans: torch.Tensor, cand: torch.Tensor,
               words: bool = False) -> torch.Tensor:
    """bool [B, C]: row b holds every bit of candidate c, and c has one."""
    weight = popcount32(cand).sum(dim=1, dtype=torch.int32)
    fold = _overlap_fold_words if words else _overlap_fold
    return (fold(trans, cand) == weight[None, :]) & (weight > 0)[None, :]


def bitset_contain_counts(trans: torch.Tensor, cand: torch.Tensor,
                          words: bool = False) -> torch.Tensor:
    """counts[c] = the rows of `trans` whose bitset is a superset of
    cand[c], int32 [C]. trans int32 [B, W], cand int32 [C, W] (uint32
    bits): candidates of mixed lengths share one call, and all-zero
    candidate rows count 0. words=True takes the word-by-word form."""
    return _contained(trans, cand, words).sum(dim=0, dtype=torch.int32)


def bitset_fold_counts(acc: torch.Tensor, trans: torch.Tensor,
                       cand: torch.Tensor) -> torch.Tensor:
    """acc += bitset_contain_counts(trans, cand), in place: the per-block
    carry of the streamed miners, one int32 [C] buffer on the device that
    the host reads once a round. Exact int32 sums, so the fold does not
    depend on how the rows fall into blocks."""
    return acc.add_(bitset_contain_counts(trans, cand))


def bitset_contain_mask(trans: torch.Tensor, cand: torch.Tensor
                        ) -> torch.Tensor:
    """bool [B, C]: row b contains candidate c (zero-weight rows False),
    for the transaction-id pass over kept sets of every length."""
    return _contained(trans, cand)


def packed_block_nbytes(block_rows: int, n_bits: int) -> Tuple[int, int]:
    """(packed, dense) byte sizes of one block of `block_rows` rows over
    `n_bits` items: uint32 words against the uint8 multi-hot, the memory
    the packed route saves."""
    return (block_rows * words_for(n_bits) * 4, block_rows * max(n_bits, 1))
