"""Wrappers of the four KNN top-k kernels, their plain versions, launch counts.

Ports the four TPU kernels of `avenir_tpu/ops/pallas_knn.py`:

| wrapper              | CUDA source              | TPU kernel                    |
|----------------------|--------------------------|-------------------------------|
| `knn_topk`           | `csrc/knn_topk.cu`       | `_knn_kernel` (exact)         |
| `knn_topk_packed`    | `csrc/knn_topk.cu`       | `_knn_kernel_packed`          |
| `knn_topk_lanes`     | `csrc/knn_topk.cu`       | `_knn_kernel_lanes`           |
| `knn_classify_lanes` | `csrc/knn_classify.cu`   | `_knn_kernel_lanes_vote`      |

A wrapper given CPU tensors computes its plain PyTorch version; given CUDA
tensors it launches its kernel or raises — there is no fallback. Each
wrapper counts its kernel launches in its `launches` attribute. Euclidean
calls first launch `knn_prepass` (`csrc/knn_prepass.cu`, counted on its
own): row norms and, for bfloat16, the operands rounded to bf16 rows
zero-padded to a multiple of 16 features, which the four kernels take
inside each tile on the TPU (`pallas_knn.py:54-70`).

All four select on an int32 key built from a non-negative fp32 distance
d (squared for euclidean): the exact kernel on bits(d), the packed kernel
on bits(d) & ~0xFFF, the lane kernel on bits(d) & ~mask | column // 128
with mask = 2**pack_bits - 1, and the vote kernel on bits(d) & ~mask |
label. Ties go to the lower train column. The plain versions use the same
keys, masking and tie rule: they scan the train rows 4096 at a time and
fold each block into the running top-k with a stable sort.

A NaN distance (a NaN feature: a missing value parses to NaN) follows
each TPU kernel. The exact kernel takes it first: its argmin returns the
first NaN, so NaNs come before every number in column order and finish
as (NaN, column); its key is NAN_KEY, a sign-bit NaN below every other
key. The other three keep a NaN's bits, above their empty key: a NaN
distance is an empty slot there, and a query whose every distance is NaN
votes all zeros.

compute_dtype="bfloat16" rounds the operands of the euclidean cross term
q.t to bfloat16 (nearest even) and keeps fp32 products and sums; the
norms |q|^2 and |t|^2 stay those of the fp32 values, and manhattan
ignores the dtype. That is the TPU kernels' bf16 dot_general with fp32
accumulation. On the card the partial kernel has two forms: every call
but one runs the CUDA-core form (`csrc/knn_tile.cuh`, fp32 fmaf chains),
and euclidean bfloat16 runs the tensor-core form (`csrc/knn_tile_mma.cuh`,
`wgmma` bf16 products fed by TMA, fp32 accumulators, the keys and the
selection in registers) on the pre-pass's bf16 rows, counted on
`knn_partial_mma`. Its keys are not bit-equal to the plain version's (the
fp32 sums run in another order); the CUDA-core form's are.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from avenir_tpu_torch.ops import _build

#: largest k the kernels' carries take (knn_tile.cuh carry_width)
KMAX = 64
SENTINEL = 0x7F700000           # empty packed slot: a huge finite float
INF_BITS = 0x7F800000           # empty exact slot: +inf
NAN_KEY = -0x400000             # exact key of a NaN distance (0xFFC00000)
_INT_MAX = 2 ** 31 - 1
LANES = 128                     # column // 128 is the lane kernel's chunk id
LANE_CORPUS_CAP = LANES * (1 << 12)   # chunk ids fit 12 mantissa bits
PACK_BITS = 12                  # packed kernel's masked bits (pallas _PACK_BITS)
#: knn_tile.cuh Mode of each top-k selection
MODES = {"exact": 0, "lanes": 1, "labels": 2, "packed": 3}
COMPUTE_DTYPES = ("float32", "bfloat16")
#: knn_tile.cuh: threads a block, train rows a tile, shared memory cap
THREADS, TT, SMEM_LIMIT = 128, 32, 232448


def _block_queries(k: int) -> int:
    """Queries of a partial block at carry width k (knn_tile.cuh
    block_queries): 32 rows of threads, each owning 4, 2 or 1 queries."""
    return 32 * (4 if k <= 8 else 2 if k <= 16 else 1)


def _row_stride4(d: int) -> int:
    """float4s between staged rows (knn_tile.cuh row_stride4)."""
    d4 = (d + 3) // 4
    return d4 if d4 % 4 else d4 + 1


#: bytes of train rows a stage of the partial kernel's ring holds
STAGE_BYTES = 16384


def _stage_plan(d: int, k: int) -> Tuple[int, int, int]:
    """(rows a stage, stages, dynamic shared-memory bytes) of a partial
    block (knn_tile.cuh stage_plan): stages of whole 32-row tiles filling
    STAGE_BYTES (rows at the padded stride, their norms and labels), two
    where they fit beside the block's queries, else one."""
    row = 16 * _row_stride4(d) + 8
    rows = max(1, STAGE_BYTES // (row * TT)) * TT
    queries = 16 * _row_stride4(d) * _block_queries(k)
    stages = 2 if queries + 2 * rows * row <= SMEM_LIMIT else 1
    return rows, stages, queries + stages * rows * row


def _smem_bytes(d: int, k: int) -> int:
    return _stage_plan(d, k)[2]


#: knn_tile_mma.cuh: queries a block (two consumer warpgroups of 64),
#: bytes of a stage's norms and labels, most stages of the ring
MMA_BQ, MMA_AUX, MMA_MAX_STAGES = 128, 1024, 8


def _depth16(d: int) -> int:
    """D rounded up to the wgmma's k-step of 16 (knn_tile_mma.cuh
    depth16): the pre-pass's bf16 rows are zero past D, and the
    tensor-core form multiplies the zeros."""
    return -(-d // 16) * 16


def _mma_bn(k: int) -> int:
    """Train rows a stage of the tensor-core form at carry width k (the
    wgmma's N; knn_tile_mma.cuh mma_bn)."""
    return 64 if _carry_width(k) >= 32 else 128


def _mma_smem(d: int, k: int, stages: int) -> int:
    """Shared-memory bytes of a block of the tensor-core form
    (knn_tile_mma.cuh mma_smem): 1024 to align, the queries as bf16 rows
    at depth16(d), `stages` stages of BN rows and MMA_AUX bytes, and
    2 * stages + 2 mbarriers."""
    row = 2 * _depth16(d)
    return (1024 + row * MMA_BQ + stages * (row * _mma_bn(k) + MMA_AUX)
            + (2 * stages + 2) * 8)


def _mma_stage_plan(d: int, k: int) -> Tuple[int, int, int]:
    """(rows a stage, stages, dynamic shared-memory bytes) of a block of
    the tensor-core form (knn_tile_mma.cuh mma_stage_plan): the most
    stages, up to MMA_MAX_STAGES, that fit SMEM_LIMIT beside the block's
    queries (0 where none does)."""
    stages = MMA_MAX_STAGES
    while stages > 0 and _mma_smem(d, k, stages) > SMEM_LIMIT:
        stages -= 1
    return _mma_bn(k), stages, _mma_smem(d, k, stages)


def mma_schedule(nq: int, n_valid: int, k: int, blocks: int
                 ) -> Tuple[int, int]:
    """(blocks, segments) of the tensor-core form's persistent schedule
    (knn_tile_mma.cuh MmaSchedule, mma_segments): the (query tile of
    MMA_BQ, train tile of BN) pairs, query-tile major, cut into min(blocks,
    pairs) contiguous ranges, block b taking [b * pairs // blocks, (b + 1)
    * pairs // blocks); segments, the most blocks that meet one query
    tile, is the count of split lists a query takes."""
    bn = _mma_bn(k)
    tiles = -(-n_valid // bn) if n_valid > 0 else 1
    q_tiles = -(-nq // MMA_BQ)
    pairs = q_tiles * tiles
    blocks = min(blocks, pairs)

    def block_of(p):            # the block whose range holds pair p
        b = p * blocks // pairs
        while b > 0 and b * pairs // blocks > p:
            b -= 1
        while (b + 1) * pairs // blocks <= p:
            b += 1
        return b
    segments = max(block_of((qt + 1) * tiles - 1) - block_of(qt * tiles) + 1
                   for qt in range(q_tiles))
    return blocks, segments


#: queries of the widest block (k <= 8)
BQ = _block_queries(8)
#: most features the partial kernel stages in shared memory: every D up
#: to it fits at every carry width
MAX_D = next(d for d in range(1, 4096)
             if any(_smem_bytes(d + 1, k) > SMEM_LIMIT for k in (8, 16, 32, 64)))
KERNEL_FNS = ("none", "linearMultiplicative", "linearAdditive", "gaussian")
PLAIN_BLOCK = 4096
#: fewest train rows a split takes when there are that many
MIN_SPLIT_ROWS = 256
#: a block's fixed work (staging its queries, writing its carries, the
#: merge reading them) counted as train rows scanned: an estimate from
#: those byte counts, not tuned on the card
SPLIT_COST_ROWS = 64


def lane_pack_bits(nt: int) -> int:
    """Mantissa bits that carry a 128-column chunk id of an nt-row
    (padded) corpus — pallas_knn._lane_pack_bits."""
    n_chunks = (nt + LANES - 1) // LANES
    return max(1, (n_chunks - 1).bit_length())


def label_bits(n_classes: int) -> int:
    return max(1, (n_classes - 1).bit_length())


def kernel_score(dist: torch.Tensor, kernel: str, kernel_param: float
                 ) -> torch.Tensor:
    """Reference vote score (Neighborhood.java:150-218, KERNEL_SCALE=100)
    of attribute-averaged distances."""
    d = torch.floor(dist * 100.0)
    if kernel == "none":
        return torch.ones_like(d)
    if kernel == "linearMultiplicative":
        return torch.where(d == 0, 200.0,
                           torch.floor(100.0 / torch.clamp(d, min=1.0)))
    if kernel == "linearAdditive":
        return torch.clamp(100.0 - d, min=0.0)
    if kernel == "gaussian":
        u = d / kernel_param
        return torch.floor(100.0 * torch.exp(-0.5 * u * u))
    raise ValueError(f"unknown kernel {kernel}")


# ------------------------------------------------------------------ checks
def _check(q: torch.Tensor, t: torch.Tensor, k: int, metric: str,
           n_valid: Optional[int]) -> int:
    for name, x in (("q", q), ("t", t)):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 \
                or x.dim() != 2:
            raise TypeError(f"{name} must be a 2-D float32 tensor")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device != t.device:
        raise ValueError(f"q on {q.device} but t on {t.device}")
    if q.shape[1] != t.shape[1]:
        raise ValueError(f"q has {q.shape[1]} features, t {t.shape[1]}")
    if q.is_cuda and q.shape[1] > MAX_D:
        raise ValueError(f"{q.shape[1]} features; the kernels stage at most "
                         f"{MAX_D} in shared memory")
    if not 1 <= k <= KMAX:
        raise ValueError(f"k={k}; the kernels take 1 <= k <= {KMAX}")
    if metric not in ("euclidean", "manhattan"):
        raise ValueError(f"unsupported metric {metric!r}")
    nv = t.shape[0] if n_valid is None else int(n_valid)
    if not 0 <= nv <= t.shape[0]:
        raise ValueError(f"n_valid={nv} outside [0, {t.shape[0]}]")
    return nv


def _bf16(compute_dtype, metric: str) -> bool:
    """Whether the euclidean cross term runs on bfloat16-rounded operands;
    compute_dtype is "float32" or "bfloat16" (or the torch dtype)."""
    name = str(compute_dtype).removeprefix("torch.")
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r}; the kernels take "
                         f"{COMPUTE_DTYPES}")
    return name == "bfloat16" and metric == "euclidean"


def _check_lanes(t: torch.Tensor) -> int:
    bits = lane_pack_bits(t.shape[0])
    if bits > 12:
        raise ValueError(
            f"corpus {t.shape[0]} needs {bits} chunk-id bits; cap is 12 "
            f"(<= {LANE_CORPUS_CAP} rows) to keep quantization <= 2^-11")
    return bits


def _check_labels(t: torch.Tensor, t_labels: torch.Tensor, n_classes: int,
                  kernel_fn: str) -> None:
    if t_labels.dtype != torch.int32 or t_labels.dim() != 1 \
            or t_labels.shape[0] != t.shape[0]:
        raise TypeError("t_labels must be int32 [nt]")
    if not t_labels.is_contiguous() or t_labels.device != t.device:
        raise ValueError("t_labels must be contiguous and on t's device")
    if not 1 <= n_classes <= 64:
        raise ValueError(f"{n_classes} classes need > 6 label bits")
    if kernel_fn not in KERNEL_FNS:
        raise ValueError(f"unknown kernel {kernel_fn}")


# ------------------------------------------------------------- epilogues
def _finish(key: torch.Tensor, idx: torch.Tensor, metric: str,
            n_attrs: int, pack_mask: int, empty: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keys -> (attribute-averaged distance, index), as pallas_knn's
    wrappers finish: sqrt(d/n_attrs) or d/n_attrs; empty slots and
    infinite distances become (+inf, -1). NAN_KEY decodes to NaN and
    keeps its index, as the wrappers set -1 only where the distance is
    infinite."""
    bits = key & ~pack_mask
    dist = torch.where(key >= empty, float("inf"),
                       bits.view(torch.float32))
    return _average(dist, metric, n_attrs), torch.where(torch.isinf(dist), -1, idx)


def _average(d: torch.Tensor, metric: str, n_attrs: int) -> torch.Tensor:
    """Squared or absolute sums -> attribute-averaged distance. The
    reference divides by the constant attribute count, which XLA compiles
    to a multiply by its fp32 reciprocal; so does this, to the same bits."""
    inv = 1.0 / max(n_attrs, 1)
    if metric == "euclidean":
        return torch.sqrt(torch.clamp(d, min=0.0) * inv)
    return d * inv


def _vote(key: torch.Tensor, label_mask: int, n_classes: int, n_attrs: int,
          metric: str, kernel_fn: str, kernel_param: float) -> torch.Tensor:
    """Class scores [nq, C] of the k smallest label keys [nq, k] — the
    epilogue of _knn_kernel_lanes_vote (pallas_knn.py:500-537)."""
    scores = torch.zeros((key.shape[0], n_classes), dtype=torch.float32,
                         device=key.device)
    classes = torch.arange(n_classes, device=key.device, dtype=torch.int32)
    for j in range(key.shape[1]):
        m = key[:, j]
        valid = m < SENTINEL
        dist = _average((m & ~label_mask).view(torch.float32), metric, n_attrs)
        # select, don't multiply: an empty slot's bits may decode to NaN
        s = torch.where(valid, kernel_score(dist, kernel_fn, kernel_param), 0.0)
        hit = valid[:, None] & ((m & label_mask)[:, None] == classes[None, :])
        scores = scores + torch.where(hit, s[:, None], 0.0)
    return scores


# ---------------------------------------------------------- plain versions
def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c) of float32 tensors, rounded once as the card's fmaf
    rounds: a*b is exact in float64; hi + lo = a*b + c exactly (TwoSum);
    rounding hi to float32 is right unless hi lies exactly halfway between
    two float32 values, where the sign of lo picks the side."""
    p = a.double() * b.double()
    c64 = c.double()
    hi = p + c64
    bb = hi - p
    lo = (p - (hi - bb)) + (c64 - bb)
    r = hi.float()
    other = torch.nextafter(r, torch.where(hi > r.double(), float("inf"),
                                           float("-inf")).float())
    mid = hi == (r.double() + other.double()) / 2
    up = lo > 0
    pick_other = mid & (lo != 0) & ((other > r) == up) & torch.isfinite(hi)
    return torch.where(pick_other, other, r)


def bf16_rows(x: torch.Tensor) -> torch.Tensor:
    """x [n, d] float32 rounded to bfloat16 (nearest even) as [n,
    depth16(d)] bfloat16 rows, zero past d: the tensor-core form's
    operand layout."""
    pad = _depth16(x.shape[1]) - x.shape[1]
    return torch.nn.functional.pad(x.to(torch.bfloat16), (0, pad))


def knn_prepass_plain(q: torch.Tensor, t: torch.Tensor, bf16: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """The plain version of knn_prepass: the same fmaf chains, bit for
    bit, of the float32 values, and with bf16 their bf16_rows."""
    out = []
    for x in (q, t):
        s = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        for f in range(x.shape[1]):
            s = _fmaf(x[:, f], x[:, f], s)
        out.append(s)
    return (*out, *((bf16_rows(q), bf16_rows(t)) if bf16 else (q, t)))


def _cross(q: torch.Tensor, tb: torch.Tensor, bf16: bool) -> torch.Tensor:
    """The cross term q.t [nq, m] in fp32, of bfloat16-rounded operands
    when bf16 (fp32 products of them are exact)."""
    if bf16:
        q, tb = _round_bf16(q), _round_bf16(tb)
    return q @ tb.T


def _tile_plain(q: torch.Tensor, tb: torch.Tensor, metric: str,
                qn: Optional[torch.Tensor], bf16: bool = False
                ) -> torch.Tensor:
    """[nq, m] distances (squared for euclidean) with the kernels' formula:
    euclidean (|q|^2 + |t|^2) - 2 q.t clamped at +0 in fp32, q.t of
    bfloat16-rounded operands when bf16 (the norms never are); manhattan
    features 0..D-1 summed from 0.0."""
    if metric == "euclidean":
        tn = (tb * tb).sum(1)
        v = (qn[:, None] + tn[None, :]) - 2.0 * _cross(q, tb, bf16)
        # jnp.maximum(v, 0): NaN stays NaN, -0 becomes +0
        return torch.where(v <= 0, 0.0, v)
    acc = torch.zeros((q.shape[0], tb.shape[0]), dtype=torch.float32,
                      device=q.device)
    for f in range(q.shape[1]):
        acc = acc + (q[:, f, None] - tb[None, :, f]).abs()
    return acc


def _select_plain(q: torch.Tensor, t: torch.Tensor, k: int, metric: str,
                  n_valid: int, mode: str, pack_mask: int, empty: int,
                  bf16: bool = False, labels: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest (key, column) pairs per query, ascending, over train
    rows [0, n_valid), on the key of `mode` (see MODES): the masked bits
    of bits(d) carry column // 128 ("lanes"), the label ("labels") or
    nothing ("packed"); "exact" takes a zero mask."""
    nq, dev = q.shape[0], q.device
    best_k = torch.full((nq, k), empty, dtype=torch.int32, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    qn = (q * q).sum(1) if metric == "euclidean" else None
    for start in range(0, n_valid, PLAIN_BLOCK):
        stop = min(start + PLAIN_BLOCK, n_valid)
        d = _tile_plain(q, t[start:stop], metric, qn, bf16)
        # a NaN distance: NAN_KEY in exact mode, else the card's NaN, the
        # positive 0x7FFFFFFF (the CPU's may hold the sign bit)
        key = torch.where(d.isnan(), NAN_KEY if mode == "exact" else _INT_MAX,
                          d.view(torch.int32))
        col = torch.arange(start, stop, dtype=torch.int32, device=dev)
        if mode == "labels":
            key = (key & ~pack_mask) | labels[start:stop][None, :]
        elif mode == "lanes":
            key = (key & ~pack_mask) | (col >> 7)[None, :]
        elif mode == "packed":
            key = key & ~pack_mask
        all_k = torch.cat([best_k, key], 1)
        all_i = torch.cat([best_i, col.expand(nq, -1)], 1)
        order = torch.sort(all_k, dim=1, stable=True).indices[:, :k]
        best_k, best_i = all_k.gather(1, order), all_i.gather(1, order)
    return best_k, best_i


def merge_splits_plain(part_key: torch.Tensor, part_idx: torch.Tensor,
                       nq: int, splits: int, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the merge kernels' split merge (knn_merge.cuh
    merge_lists): the partial kernel's lists [splits][nq][K], each sorted
    by (key, column) with the splits in column order, merged into each
    query's k smallest (key, column) pairs [nq, k]. A stable sort on the
    key, splits in order, keeps the lower column first among equal keys."""
    key = part_key.view(splits, nq, -1).permute(1, 0, 2).reshape(nq, -1)
    idx = part_idx.view(splits, nq, -1).permute(1, 0, 2).reshape(nq, -1)
    order = torch.sort(key, dim=1, stable=True).indices[:, :k]
    return key.gather(1, order), idx.gather(1, order)


#: knn_merge.cuh MERGE_OWN: lists a lane holds at once in a group of 32
#: (one in a group of 8 or 16); chip_smoke.py holds it to the kernels'
#: merge_layout on the card
MERGE_OWN = 2


def merge_splits_group_plain(part_key: torch.Tensor, part_idx: torch.Tensor,
                             nq: int, splits: int, k: int, group: int,
                             empty: int = INF_BITS
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A model of the merge kernels' algorithm (knn_merge.cuh merge_lists)
    on the lists merge_splits_plain takes, as the partial kernel leaves
    them (a key >= empty only as an empty slot at a list's end): `group`
    lanes a query, lane l owning splits l, l + group, ...; k rounds in
    which each lane offers the least head of its lists by (key, split),
    the group takes the least offer, and its list steps; a head >= empty
    is exhausted, and a round with every head exhausted gives (empty, -1).
    A lane holds MERGE_OWN lists at once in a group of 32, else one; past
    group * that many splits the lists go in batches of that many, the
    answer of the batches before taking part as one more list that wins
    ties. Returns (key, index) [nq, k] int32."""
    own = MERGE_OWN if group == 32 else 1
    width = part_key.numel() // max(1, splits * nq)
    keys = part_key.view(splits, nq, width).tolist()
    idxs = part_idx.view(splits, nq, width).tolist()
    out = []
    for q in range(nq):
        answer = []
        for b0 in range(0, splits, group * own):
            carry, p, answer = answer, 0, []
            stop = min(splits, b0 + group * own)
            pos = {s: 0 for s in range(b0, stop)}

            def head(s):
                return keys[s][q][pos[s]] if pos[s] < width else _INT_MAX
            for _ in range(k):
                offers = [min((head(s), s) for s in
                              range(b0 + lane, stop, group))
                          for lane in range(min(group, stop - b0))]
                bk, bs = min(offers)
                hk = carry[p][0] if p < len(carry) else _INT_MAX
                if hk <= bk:
                    if hk < empty:
                        answer.append(carry[p])
                        p += 1
                    else:
                        answer.append((empty, -1))
                elif bk < empty:
                    answer.append((bk, idxs[bs][q][pos[bs]]))
                    pos[bs] += 1
                else:
                    answer.append((empty, -1))
        answer += [(empty, -1)] * (k - len(answer))
        out.append(answer)
    t = torch.tensor(out, dtype=torch.int32).view(nq, k, 2)
    return t[:, :, 0].contiguous(), t[:, :, 1].contiguous()


def _key_spec(mode: str, t: torch.Tensor) -> Tuple[int, int, int]:
    """(pack_bits, pack_mask, empty key) of a top-k mode on corpus t."""
    bits = (0 if mode == "exact" else PACK_BITS if mode == "packed"
            else _check_lanes(t))
    return bits, (1 << bits) - 1, SENTINEL if mode == "lanes" else INF_BITS


def _topk_plain(mode, q, t, k, metric, n_valid, n_attrs, compute_dtype):
    nv = _check(q, t, k, metric, n_valid)
    bf16 = _bf16(compute_dtype, metric)
    _, mask, empty = _key_spec(mode, t)
    key, idx = _select_plain(q, t, k, metric, nv, mode, mask, empty, bf16)
    return _finish(key, idx, metric, q.shape[1] if n_attrs is None else n_attrs,
                   mask, empty)


def knn_topk_plain(q, t, k=8, metric="euclidean", n_valid=None, n_attrs=None,
                   compute_dtype="float32"):
    return _topk_plain("exact", q, t, k, metric, n_valid, n_attrs,
                       compute_dtype)


def knn_topk_packed_plain(q, t, k=8, metric="euclidean", n_valid=None,
                          n_attrs=None, compute_dtype="float32"):
    return _topk_plain("packed", q, t, k, metric, n_valid, n_attrs,
                       compute_dtype)


def knn_topk_lanes_plain(q, t, k=8, metric="euclidean", n_valid=None,
                         n_attrs=None, compute_dtype="float32"):
    return _topk_plain("lanes", q, t, k, metric, n_valid, n_attrs,
                       compute_dtype)


def knn_classify_lanes_plain(q, t, t_labels, k=8, n_classes=2, n_attrs=None,
                             kernel_fn="none", kernel_param=1.0,
                             metric="euclidean", n_valid=None,
                             compute_dtype="float32"):
    nv = _check(q, t, k, metric, n_valid)
    _check_labels(t, t_labels, n_classes, kernel_fn)
    bf16 = _bf16(compute_dtype, metric)
    mask = (1 << label_bits(n_classes)) - 1
    key, _ = _select_plain(q, t, k, metric, nv, "labels", mask, SENTINEL,
                           bf16, t_labels)
    return _vote(key, mask, n_classes,
                 q.shape[1] if n_attrs is None else n_attrs, metric,
                 kernel_fn, float(kernel_param))


# ---------------------------------------------------------------- launches
@functools.lru_cache(maxsize=256)
def _splits(nq: int, n_valid: int, sms: int, blocks_per_sm: int,
            stage: int = TT, bq: int = BQ) -> Tuple[int, int]:
    """(splits, rows_per_split) of the train axis for a grid of
    ceil(nq / bq) x splits blocks, blocks_per_sm of which run at once on
    each of sms SMs. Picks the split count whose grid, run in whole waves
    of sms * blocks_per_sm blocks, ends soonest: waves x (rows_per_split +
    SPLIT_COST_ROWS) smallest, the fewer splits on a tie. rows_per_split
    is a multiple of `stage` and at least MIN_SPLIT_ROWS where n_valid
    allows."""
    if n_valid == 0:
        return 1, stage
    blocks_x = (nq + bq - 1) // bq
    slots = max(1, sms * blocks_per_sm)
    best = None
    for want in range(1, max(1, n_valid // MIN_SPLIT_ROWS) + 1):
        rows = math.ceil(math.ceil(n_valid / want) / stage) * stage
        splits = math.ceil(n_valid / rows)
        cost = math.ceil(blocks_x * splits / slots) * (rows + SPLIT_COST_ROWS)
        if best is None or cost < best[0]:
            best = (cost, splits, rows)
    return best[1], best[2]


def _waves(nq: int, splits: int, sms: int, blocks_per_sm: int,
           bq: int = BQ) -> float:
    """Waves of a grid of ceil(nq / bq) x splits blocks (a fraction: the
    last wave's share of its slots is after the point)."""
    return (nq + bq - 1) // bq * splits / max(1, sms * blocks_per_sm)


def _carry_width(k: int) -> int:
    """Slots of the kernels' sorted carry for k (knn_tile.cuh carry_width)."""
    return 8 if k <= 8 else 16 if k <= 16 else 32 if k <= 32 else 64


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else 0


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


_INFO: dict = {}


def _mma(euclid: bool, bf16: bool) -> bool:
    """Whether a CUDA launch takes the tensor-core form of the partial
    kernel: euclidean with compute_dtype="bfloat16", and nothing else."""
    return euclid and bf16


def partial_info(k: int, euclid: bool, mode: str, d: int, lib=None,
                 bf16: bool = False) -> Tuple[int, ...]:
    """(blocks per SM, registers a thread, local bytes a thread, rows a
    stage, stages, shared-memory bytes) of the partial instance a CUDA
    launch of `mode` takes at d features, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor, cudaFuncGetAttributes
    and the kernel's stage plan on the current device (cached per device,
    form, instance and d; `lib` is another build of the library). With
    euclid and bf16 it is the tensor-core instance's, else the CUDA-core
    one's, which serves float32 and manhattan bfloat16 alike."""
    lib_name = "knn_classify" if mode == "labels" else "knn_topk"
    lib = lib or _build.load(lib_name)
    mma = _mma(euclid, bf16)
    key = (lib._name, torch.cuda.current_device(), mma, _carry_width(k),
           euclid, mode, d)
    if key not in _INFO:
        info = (ctypes.c_int * 6)()
        form = "mma" if mma else "partial"
        if mode == "labels":
            err = getattr(lib, f"knn_classify_{form}_info")(
                k, int(euclid), d, info)
        else:
            err = getattr(lib, f"knn_topk_{form}_info")(
                k, int(euclid), MODES[mode], d, info)
        _raise_on(err, f"{lib_name} {form}_info")
        _INFO[key] = tuple(info)
    return _INFO[key]


def _grid(q: torch.Tensor, k: int, euclid: bool, mode: str, n_valid: int,
          lib=None, bf16: bool = False) -> Tuple[int, int, int, int]:
    """(SMs, blocks per SM, splits, rows_per_split) of a CUDA launch of
    `mode` over n_valid train rows: the instance's occupancy and stage
    rows on q's device (the current one), then the whole-wave split of
    _splits. The tensor-core form (`bf16`) gives (SMs, blocks per SM,
    segments, blocks) of its persistent schedule (mma_schedule), which its
    launch takes in place of (splits, rows_per_split)."""
    nq, d = q.shape
    sms = _sm_count(q.device)
    info = partial_info(k, euclid, mode, d, lib, bf16)
    if _mma(euclid, bf16) and _persistent(lib, mode):
        blocks, segments = mma_schedule(nq, n_valid, k, sms * info[0])
        return sms, info[0], segments, blocks
    # an earlier tensor-core form split the train axis as the CUDA-core
    # form does, in blocks of MMA_BQ queries
    splits, rows = _splits(nq, n_valid, sms, info[0], info[3],
                           MMA_BQ if _mma(euclid, bf16) else _block_queries(k))
    return sms, info[0], splits, rows


def _persistent(lib, mode: str) -> bool:
    """Whether the tensor-core form of `lib` (this checkout's when None)
    runs the persistent schedule, whose launch takes (segments, blocks)
    where an earlier form took (splits, rows_per_split): this checkout's
    library has the schedule's plan entry."""
    name = "knn_classify" if mode == "labels" else "knn_topk"
    return lib is None or hasattr(lib, f"{name}_mma_plan")


def merge_info(k: int, vote: bool = False, lib=None) -> Tuple[int, int, int]:
    """(blocks per SM, registers a thread, local bytes a thread) of the
    merge instance a CUDA launch at carry width _carry_width(k) takes:
    knn_classify.cu's merge and vote with vote, else knn_topk.cu's merge
    (`lib`: another build of that library)."""
    name = "knn_classify" if vote else "knn_topk"
    lib = lib or _build.load(name)
    info = (ctypes.c_int * 3)()
    _raise_on(getattr(lib, f"{name}_merge_info")(k, info), f"{name}_merge_info")
    return tuple(info)


def merge_layout(nq: int, splits: int, lib=None) -> dict:
    """The layout both merge kernels launch for nq queries' splits lists,
    as the kernels' library picks it (knn_merge_layout): lanes a query's
    group, blocks, threads a block, and lists a lane holds at once."""
    lib = lib or _build.load("knn_topk")
    out = (ctypes.c_int * 4)()
    _raise_on(lib.knn_merge_layout(nq, splits, out), "knn_merge_layout")
    return dict(zip(("group", "blocks", "threads", "own"), out))


def _partial_buffers(q: torch.Tensor, k: int, splits: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partial kernel's (key, index) scratch on q's device."""
    part_k = torch.empty(splits * q.shape[0] * _carry_width(k),
                         dtype=torch.int32, device=q.device)
    return part_k, torch.empty_like(part_k)


def launch_plan(q: torch.Tensor, t: torch.Tensor, k: int, metric: str,
                mode: str, n_valid: Optional[int] = None,
                compute_dtype: str = "float32") -> dict:
    """The grid a CUDA launch of `mode` ("exact", "lanes", "packed" or
    "labels") takes on these tensors: blocks per SM, splits (the split
    lists a query takes), rows_per_split (None for the tensor-core form,
    whose persistent blocks take ranges of (query tile, train tile)
    pairs), grid blocks and waves."""
    nv = _check(q, t, k, metric, n_valid)
    mma = _mma(metric == "euclidean", _bf16(compute_dtype, metric))
    with torch.cuda.device(q.device):
        sms, per_sm, splits, rows = _grid(q, k, metric == "euclidean", mode,
                                          nv, bf16=mma)
    if mma:
        return {"blocks_per_sm": per_sm, "splits": splits,
                "rows_per_split": None, "grid": rows,
                "waves": rows / max(1, sms * per_sm)}
    bq = _block_queries(k)
    return {"blocks_per_sm": per_sm, "splits": splits, "rows_per_split": rows,
            "grid": (q.shape[0] + bq - 1) // bq * splits,
            "waves": _waves(q.shape[0], splits, sms, per_sm, bq)}


def _operands(q, t, euclid: bool, bf16: bool, n_valid: int,
              mma: bool = True):
    """(q, t, qn, tn) as the partial kernel takes them: euclidean runs the
    pre-pass over q and the first n_valid rows of t for their norms and,
    with bf16, their bf16 rows for the tensor-core form; manhattan takes q
    and t as they are and no norms. With bf16 and not mma (the CUDA-core
    form on bfloat16 operands, which no wrapper call takes: a cross-check
    of the two forms) the operands are the fp32 values of the bf16 rows."""
    if t.data_ptr() % 16:              # the kernel copies rows in 16-byte pieces
        t = t.clone()
    if not euclid:
        return q, t, None, None
    qn, tn, qx, tx = knn_prepass(q, t[:n_valid], bf16)
    if bf16 and not mma:
        d = q.shape[1]
        qx, tx = (x[:, :d].float().contiguous() for x in (qx, tx))
    return qx, tx, qn, tn


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def _launch(lib, name: str, mma: bool, what: str, *args) -> None:
    """Call `lib`'s C entry `<name>_launch`, or `<name>_mma_launch` when
    mma (counted on knn_partial_mma), with args; raise on a CUDA error."""
    if mma:
        knn_partial_mma(getattr(lib, f"{name}_mma_launch"), *args)
    else:
        _raise_on(getattr(lib, f"{name}_launch")(*args), what)


def knn_partial_mma(entry, *args) -> None:
    """One launch of the tensor-core form of the partial kernel
    (`csrc/knn_tile_mma.cuh`, euclidean bfloat16: wgmma fed by TMA) and
    its merge, through `entry`, a built library's `knn_topk_mma_launch`
    or `knn_classify_mma_launch`, with the arguments of the CUDA-core
    entry (q and t the pre-pass's bf16 rows); counted in `launches`.
    There is no other route for these calls: a missing
    cuTensorMapEncodeTiled, a refused encode or a refused launch
    raises."""
    _raise_on(entry(*args), entry.__name__)
    knn_partial_mma.launches += 1


def _topk_keys(mode, q, t, k, euclid, bf16, n_valid, lib=None,
               operands=None, mma=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The raw (key, index) [nq, k] of `mode` from the CUDA kernels: the
    pre-pass where euclidean (or `operands`, (q', t', qn, tn) made
    already), then knn_topk.cu (or `lib`, a build of another version of
    it) in the form _mma picks (or `mma`); buffers on q's device."""
    nq, d = q.shape
    bits = _key_spec(mode, t)[0]
    mma = _mma(euclid, bf16) if mma is None else mma
    qx, tx, qn, tn = operands or _operands(q, t, euclid, bf16, n_valid, mma)
    _, _, splits, rows = _grid(q, k, euclid, mode, n_valid, lib, mma)
    part_k, part_i = _partial_buffers(q, k, splits)
    out_k = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    out_i = torch.empty_like(out_k)
    _launch(lib or _build.load("knn_topk"), "knn_topk", mma,
            f"knn_topk ({mode})", qx.data_ptr(), tx.data_ptr(), _ptr(qn),
            _ptr(tn), nq, d, n_valid, k, int(euclid), MODES[mode], bits,
            splits, rows, part_k.data_ptr(), part_i.data_ptr(),
            out_k.data_ptr(), out_i.data_ptr(), _stream(q.device))
    return out_k, out_i


def _classify_scores(q, t, t_labels, k, euclid, bf16, n_classes, n_attrs,
                     kernel_fn, kernel_param, n_valid, lib=None,
                     operands=None, mma=None) -> torch.Tensor:
    """The vote's scores [nq, n_classes] from the CUDA kernels: the
    pre-pass where euclidean (or `operands`), then knn_classify.cu (or
    `lib`, a build of another version of it) in the form _mma picks (or
    `mma`); buffers on q's device."""
    nq, d = q.shape
    mma = _mma(euclid, bf16) if mma is None else mma
    qx, tx, qn, tn = operands or _operands(q, t, euclid, bf16, n_valid, mma)
    if mma and t_labels.data_ptr() % 16:   # TMA copies 16-byte-aligned words
        t_labels = t_labels.clone()
    _, _, splits, rows = _grid(q, k, euclid, "labels", n_valid, lib, mma)
    part_k, part_i = _partial_buffers(q, k, splits)
    scores = torch.empty((nq, n_classes), dtype=torch.float32, device=q.device)
    _launch(lib or _build.load("knn_classify"), "knn_classify", mma,
            "knn_classify_lanes", qx.data_ptr(), tx.data_ptr(), _ptr(qn),
            _ptr(tn), t_labels.data_ptr(), nq, d, n_valid, k, int(euclid),
            label_bits(n_classes), n_classes, 1.0 / max(n_attrs, 1),
            KERNEL_FNS.index(kernel_fn), float(kernel_param), splits, rows,
            part_k.data_ptr(), part_i.data_ptr(), scores.data_ptr(),
            _stream(q.device))
    return scores


def _topk(wrapper, mode, q, t, k, metric, n_valid, n_attrs, compute_dtype
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k of `mode`: the plain version for CPU tensors, else one
    launch of knn_topk.cu (after the pre-pass where euclidean), counted on
    `wrapper`."""
    if not q.is_cuda:
        return _topk_plain(mode, q, t, k, metric, n_valid, n_attrs,
                           compute_dtype)
    nv = _check(q, t, k, metric, n_valid)
    bf16 = _bf16(compute_dtype, metric)
    _, mask, empty = _key_spec(mode, t)
    na = q.shape[1] if n_attrs is None else n_attrs
    if q.shape[0] == 0:
        return _finish(*_empty(q, k), metric, na, mask, empty)
    with torch.cuda.device(q.device):
        key, idx = _topk_keys(mode, q, t, k, metric == "euclidean", bf16, nv)
    wrapper.launches += 1
    return _finish(key, idx, metric, na, mask, empty)


#: clock64() sections of the tensor-core form's diagnostic instance
#: (knn_tile_mma.cuh SECTIONS), in its order
MMA_SECTIONS = ("stage wait", "query load", "wgmma", "key epilogue",
                "selection and insert", "lane merge")


def mma_sections(q: torch.Tensor, t: torch.Tensor, mode: str = "lanes",
                 labels: Optional[torch.Tensor] = None) -> dict:
    """{section: share of the warps' cycles} of one launch of the
    tensor-core partial kernel's diagnostic instance (K=8, the keys of
    `mode`, clock64() around each of MMA_SECTIONS) on CUDA tensors q and
    t (and int32 `labels` [nt] for "labels", 2 classes), after the
    bfloat16 pre-pass (counted as any). A measurement only: the
    diagnostic launch is not counted and its lists are dropped."""
    nq, d = q.shape
    nt = t.shape[0]
    bits = label_bits(2) if mode == "labels" else _key_spec(mode, t)[0]
    with torch.cuda.device(q.device):
        qx, tx, qn, tn = _operands(q, t, True, True, nt)
        _, _, splits, rows = _grid(q, 8, True, mode, nt, bf16=True)
        part_k, part_i = _partial_buffers(q, 8, splits)
        cycles = torch.zeros(len(MMA_SECTIONS), dtype=torch.int64,
                             device=q.device)
        _raise_on(_build.load("knn_topk").knn_topk_mma_profile(
            qx.data_ptr(), tx.data_ptr(), qn.data_ptr(), tn.data_ptr(),
            _ptr(labels), nq, d, nt, MODES[mode], bits, splits, rows,
            part_k.data_ptr(), part_i.data_ptr(), cycles.data_ptr(),
            _stream(q.device)), "knn_topk_mma_profile")
        total = cycles.sum().item()
    return {name: c / max(total, 1)
            for name, c in zip(MMA_SECTIONS, cycles.tolist())}


def knn_prepass(q: torch.Tensor, t: torch.Tensor, bf16: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """(|q|^2 [nq], |t|^2 [nt], q', t') of the euclidean kernels: each
    norm an fmaf chain over the features in order from 0.0, of the fp32
    values; q', t' the operands' bf16_rows (bfloat16 [n, depth16(D)],
    nearest even, zero past D) when bf16, else q and t themselves. Part
    of the port of the euclidean Pallas kernels (pallas_knn.py:54-70),
    which take the norms and round the operands inside each tile; one
    launch of knn_prepass.cu over both, or the plain version for CPU
    tensors."""
    if not q.is_cuda:
        return knn_prepass_plain(q, t, bf16)
    if q.dtype != torch.float32 or t.dtype != torch.float32:
        raise TypeError("q and t must be float32")
    if q.device != t.device or q.shape[1] != t.shape[1]:
        raise ValueError("q and t must share a device and a feature count")
    q, t = q.contiguous(), t.contiguous()
    (nq, d), nt = q.shape, t.shape[0]
    qn = torch.empty(nq, dtype=torch.float32, device=q.device)
    tn = torch.empty(nt, dtype=torch.float32, device=q.device)
    dp = _depth16(d)
    qx = torch.empty((nq, dp), dtype=torch.bfloat16, device=q.device) \
        if bf16 else q
    tx = torch.empty((nt, dp), dtype=torch.bfloat16, device=q.device) \
        if bf16 else t
    with torch.cuda.device(q.device):
        _raise_on(_build.load("knn_prepass").knn_prepass_launch(
            q.data_ptr(), nq, t.data_ptr(), nt, d, int(bf16), qn.data_ptr(),
            tn.data_ptr(), _ptr(qx) if bf16 else None,
            _ptr(tx) if bf16 else None, _stream(q.device)), "knn_prepass")
    knn_prepass.launches += 1
    return qn, tn, qx, tx


# ----------------------------------------------------------------- wrappers
def knn_topk(q: torch.Tensor, t: torch.Tensor, k: int = 8,
             metric: str = "euclidean", n_valid: Optional[int] = None,
             n_attrs: Optional[int] = None, *, packed: bool = False,
             compute_dtype: str = "float32"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist [nq, k] float32 ascending, index [nq, k] int32) of the k
    nearest of the first n_valid rows of t, by attribute-averaged distance
    (euclidean: sqrt of the mean squared term; manhattan: the mean absolute
    one, over n_attrs attributes, default the column count). Ties go to the
    lower index; unfillable slots are (+inf, -1). Port of
    pallas_knn.knn_topk_pallas: packed=True is knn_topk_packed."""
    if packed:
        return knn_topk_packed(q, t, k, metric, n_valid, n_attrs,
                               compute_dtype)
    return _topk(knn_topk, "exact", q, t, k, metric, n_valid, n_attrs,
                 compute_dtype)


def knn_topk_packed(q: torch.Tensor, t: torch.Tensor, k: int = 8,
                    metric: str = "euclidean", n_valid: Optional[int] = None,
                    n_attrs: Optional[int] = None,
                    compute_dtype: str = "float32"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """As knn_topk, but selecting on (bits(d) & ~0xFFF, index), d the
    squared or absolute sum: distances come back truncated to 2^-11
    relative on the sum (2^-12 after the euclidean sqrt), and ties on that
    grid go to the lower index. Port of pallas_knn.knn_topk_pallas
    (packed=True), whose in-tile column bits and first-argmin tile merge
    give this order; the port carries the index beside the key, so no
    tile size applies."""
    return _topk(knn_topk_packed, "packed", q, t, k, metric, n_valid,
                 n_attrs, compute_dtype)


def knn_topk_lanes(q: torch.Tensor, t: torch.Tensor, k: int = 8,
                   metric: str = "euclidean", n_valid: Optional[int] = None,
                   n_attrs: Optional[int] = None,
                   compute_dtype: str = "float32"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """As knn_topk, but selecting on the lane kernel's packed key, so the
    distances are quantized to 2^-(23 - pack_bits) relative, with
    pack_bits = lane_pack_bits(t.shape[0]) of the PADDED corpus (t is
    capped at LANE_CORPUS_CAP rows). Port of pallas_knn.knn_topk_lanes."""
    return _topk(knn_topk_lanes, "lanes", q, t, k, metric, n_valid, n_attrs,
                 compute_dtype)


def knn_classify_lanes(q: torch.Tensor, t: torch.Tensor,
                       t_labels: torch.Tensor, k: int = 8,
                       n_classes: int = 2, n_attrs: Optional[int] = None,
                       kernel_fn: str = "none", kernel_param: float = 1.0,
                       metric: str = "euclidean",
                       n_valid: Optional[int] = None,
                       compute_dtype: str = "float32") -> torch.Tensor:
    """Class scores [nq, n_classes] float32 of the kernel-weighted vote of
    the k nearest rows, on keys that carry the class label in their low
    label_bits(n_classes) bits. Port of pallas_knn.knn_classify_lanes."""
    if not q.is_cuda:
        return knn_classify_lanes_plain(q, t, t_labels, k, n_classes,
                                        n_attrs, kernel_fn, kernel_param,
                                        metric, n_valid, compute_dtype)
    nv = _check(q, t, k, metric, n_valid)
    _check_labels(t, t_labels, n_classes, kernel_fn)
    bf16 = _bf16(compute_dtype, metric)
    na = q.shape[1] if n_attrs is None else n_attrs
    if q.shape[0] == 0:
        return torch.zeros((0, n_classes), dtype=torch.float32,
                           device=q.device)
    with torch.cuda.device(q.device):
        scores = _classify_scores(q, t, t_labels, k, metric == "euclidean",
                                  bf16, n_classes, na, kernel_fn,
                                  kernel_param, nv)
    knn_classify_lanes.launches += 1
    return scores


def _empty(q: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    z = torch.zeros((0, k), dtype=torch.int32, device=q.device)
    return z, z


#: the four top-k entries, each a port of one Pallas kernel
KERNEL_WRAPPERS = (knn_topk, knn_topk_packed, knn_topk_lanes,
                   knn_classify_lanes)
#: every wrapper that counts launches: the top-k entries, the euclidean
#: pre-pass they launch first, and the tensor-core form of their partial
#: kernel, which euclidean bfloat16 launches take
COUNTED_WRAPPERS = KERNEL_WRAPPERS + (knn_prepass, knn_partial_mma)


def reset_launches() -> None:
    for fn in COUNTED_WRAPPERS:
        fn.launches = 0


reset_launches()
