// Shared body of the KNN top-k kernels for Hopper (sm_90a).
//
// One partial kernel serves all four TPU kernels of
// avenir_tpu/ops/pallas_knn.py: it computes the distance of each query to
// each train row and keeps, per query, the K smallest int32 selection keys
// in a sorted register carry. Only the key differs by MODE:
//   EXACT   key = bits(d)                                  (_knn_kernel)
//   LANES   key = bits(d) & ~mask | column/128             (_knn_kernel_lanes)
//   LABELS  key = bits(d) & ~mask | label[column]          (_knn_kernel_lanes_vote)
//   PACKED  key = bits(d) & ~0xFFF                         (_knn_kernel_packed)
// d is non-negative, so its bit pattern orders like the float; a NaN d is
// NAN_KEY in EXACT (first) and an empty slot in the other modes, as in
// the TPU kernels. Ties in key go to the lower train column, as the TPU
// kernels' first-argmin does. The
// carry holds the column beside each key, so PACKED needs no column bits
// in the key and no tile cap: it selects on (bits(d) & ~0xFFF, column).
//
// Euclidean reads the norms |q|^2 and |t|^2 from the pre-pass
// (knn_prepass.cu), which takes them from the fp32 values. With
// compute_dtype="bfloat16" the pre-pass also rounds q and t to bfloat16
// rows, nearest even, as the TPU kernels' bf16 cross term does; the
// wrapper then runs the tensor-core form of this kernel (knn_tile_mma.cuh)
// on those rows, which reuses the carry below. These fp32 instances run
// every other call.
//
// What bounds it: instruction issue on the CUDA cores. The work is nq*nt*D
// fp32 FMAs (euclidean) or D subtract and abs-add pairs (manhattan: two
// instructions a feature, so 75% of the stated 3D+1 bound is its floor),
// plus a few selection instructions a pair; the bytes read are a few MB.
// Every shared load, index, barrier and carry insert takes an issue slot
// from the arithmetic, so the design spends as few as it can per pair:
// - Register blocking. A block is 128 threads, 4 lanes to a query row;
//   each thread owns QPT queries (4 at K=8, 2 at K=16, 1 above, so the
//   2K-register carries fit without spilling) and 8 of a 32-row tile's
//   train rows, so one LDS.128 of a train row feeds 4*QPT FMAs. Query and
//   train rows sit at a float4 stride that is no multiple of 4
//   (row_stride4), so the rows an LDS.128 phase reads fall on distinct
//   banks.
// - A shared bound. The 4 lanes of a query keep carries over interleaved
//   columns and, after each tile, share the least of their worst keys; a
//   candidate above it cannot make the query's K and costs one compare.
//   At the end of a split the 4 carries merge by warp shuffles (a bitonic
//   merge on (key, column)), so the split's list is the K smallest by
//   (key, column), bit for bit what one thread over all columns keeps.
// - Staged train rows. cp.async copies a split's rows, unpadded as they
//   lie in t, into a ring of two stages of about STAGE_BYTES (384 rows at
//   D=6, 32 at D=128), so the next stage lands during this one's
//   arithmetic and one barrier serves many rows at small D; features run
//   in order as float4s, then a float2 and a float, never on padding. The
//   column bound is checked only in a split's ragged last tile.
// - Whole waves. blockIdx.y splits the train axis; the wrapper picks the
//   split count from the instance's blocks per SM so the grid fills whole
//   waves. A second small kernel merges the splits in column order
//   (knn_merge.cuh).
// Plain fp32 FMA, never TF32 (the TPU reference measured ~4e-3 relative
// error without full-precision products).
#pragma once

#include <cuda_runtime.h>

namespace knn {

constexpr int THREADS = 128;            // threads of a partial block
constexpr int TC = 4;                   // threads that share a query
constexpr int TR = THREADS / TC;        // rows of threads, one query each
constexpr int TPT = 8;                  // train rows a thread takes per tile
constexpr int TT = TC * TPT;            // train rows per shared-memory tile
constexpr int SENTINEL = 0x7F700000;    // empty packed slot (pallas_knn._SENTINEL)
constexpr int INF_BITS = 0x7F800000;    // empty exact slot: +inf
// EXACT's key of a NaN distance: a NaN with the sign bit, below every
// other key as an int32, so NaNs come first in column order, as the
// reference's first-NaN argmin takes them (pallas_knn._knn_kernel). The
// other modes keep a NaN's bits: the card's NaN is positive, above the
// empty key, so a NaN distance is an empty slot there, as in theirs.
constexpr int NAN_KEY = (int)0xFFC00000u;

enum Mode { EXACT = 0, LANES = 1, LABELS = 2, PACKED = 3 };
enum Metric { L1 = 0, L2 = 1 };

// K smallest (key, column) pairs, ascending, in registers (K is a
// compile-time constant, so every index below is static).
template <int K>
struct Carry {
  int key[K];
  int idx[K];

  __device__ __forceinline__ void init(int empty) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      key[s] = empty;
      idx[s] = -1;
    }
  }

  __device__ __forceinline__ int worst() const { return key[K - 1]; }

  // Caller has checked key < worst(). Equal keys never swap, so an entry
  // that arrives later (a higher column) stays behind its equals.
  __device__ __forceinline__ void insert(int k, int i) {
    key[K - 1] = k;
    idx[K - 1] = i;
#pragma unroll
    for (int s = K - 1; s > 0; --s) {
      if (key[s] < key[s - 1]) {
        const int tk = key[s], ti = idx[s];
        key[s] = key[s - 1];
        idx[s] = idx[s - 1];
        key[s - 1] = tk;
        idx[s - 1] = ti;
      }
    }
  }
};

// Queries each thread owns, a carry of 2K registers each: 4 at K=8, 2 at
// K=16, 1 above; and the queries of a block, TR of them per thread slot.
template <int K>
__host__ __device__ constexpr int qpt() {
  return K <= 8 ? 4 : K <= 16 ? 2 : 1;
}
template <int K>
__host__ __device__ constexpr int block_queries() {
  return TR * qpt<K>();
}

// float4s between staged rows: D/4 rounded up, one more where that is a
// multiple of 4, so the rows that one phase of an LDS.128 reads (2
// queries, or 4 consecutive train rows) fall on distinct bank groups.
__host__ __device__ inline int row_stride4(int d) {
  const int d4 = (d + 3) / 4;
  return d4 % 4 ? d4 : d4 + 1;
}

constexpr int SMEM_LIMIT = 232448;      // dynamic shared memory a block may take
constexpr int STAGE_BYTES = 16384;      // train rows a stage holds, in bytes

// The ring of train-row stages at D features: `rows` a stage (a multiple
// of TT, as many as fit STAGE_BYTES), `stages` of them (2 where they fit
// beside the block's queries, else 1), and the block's dynamic shared
// memory: queries, then the stages' rows, norms and labels.
struct StagePlan {
  int rows;
  int stages;
  size_t smem;
};

template <int K>
inline StagePlan stage_plan(int d) {
  const size_t row = sizeof(float4) * row_stride4(d) + 2 * sizeof(int);
  const int tiles = (int)(STAGE_BYTES / (row * TT));
  const int rows = (tiles > 1 ? tiles : 1) * TT;
  const size_t queries = sizeof(float4) * row_stride4(d) * block_queries<K>();
  const int stages = queries + 2 * rows * row <= SMEM_LIMIT ? 2 : 1;
  return {rows, stages, queries + stages * rows * row};
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copy of train rows [base, base + rows) of t [*, d], their
// norms and labels into one stage: rows at a stride of sf floats, unpadded
// (a tile of rows is contiguous in t), in 16-, 8- or 4-byte pieces as the
// row width allows (t's rows are then aligned to them).
template <bool EUCLID, int MODE>
__device__ __forceinline__ void load_stage(float* ts, float* tns, int* labs,
                                           const float* t, const float* tn,
                                           const int* labels, int d, int sf,
                                           int base, int rows) {
  const int tid = threadIdx.x;
  const float* src = t + (size_t)base * d;
  if ((d & 3) == 0) {
    const int n = d >> 2;
    for (int e = tid; e < rows * n; e += THREADS) {
      const int j = e / n;
      const int c = e - j * n;
      cp_async16(ts + j * sf + 4 * c, src + (size_t)j * d + 4 * c);
    }
  } else if ((d & 1) == 0) {
    const int n = d >> 1;
    for (int e = tid; e < rows * n; e += THREADS) {
      const int j = e / n;
      const int c = e - j * n;
      cp_async8(ts + j * sf + 2 * c, src + (size_t)j * d + 2 * c);
    }
  } else {
    for (int e = tid; e < rows * d; e += THREADS) {
      const int j = e / d;
      const int c = e - j * d;
      cp_async4(ts + j * sf + c, src + (size_t)j * d + c);
    }
  }
  for (int e = tid; e < rows; e += THREADS) {
    if (EUCLID) cp_async4(tns + e, tn + base + e);
    if (MODE == LABELS) cp_async4(labs + e, labels + base + e);
  }
}

__device__ __forceinline__ bool before(int ka, int ia, int kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// The TC lanes that share a query (lanes 4r..4r+3 of a warp) hold carries
// over disjoint column sets. Afterwards each holds the K smallest (key,
// column) pairs of their union, ascending: the carry one thread would
// have built over all the columns in order. Two butterfly rounds, each the
// first step of a bitonic merge (the smaller of A[s] and the partner's
// B[K-1-s]) and a bitonic sort of the result; every index is static.
template <int K>
__device__ __forceinline__ void merge_lanes(Carry<K>& c) {
#pragma unroll
  for (int m = 1; m < TC; m <<= 1) {
#pragma unroll
    for (int s = 0; s < K / 2; ++s) {
      const int r = K - 1 - s;
      const int bkr = __shfl_xor_sync(0xffffffffu, c.key[r], m);
      const int bir = __shfl_xor_sync(0xffffffffu, c.idx[r], m);
      const int bks = __shfl_xor_sync(0xffffffffu, c.key[s], m);
      const int bis = __shfl_xor_sync(0xffffffffu, c.idx[s], m);
      if (before(bkr, bir, c.key[s], c.idx[s])) {
        c.key[s] = bkr;
        c.idx[s] = bir;
      }
      if (before(bks, bis, c.key[r], c.idx[r])) {
        c.key[r] = bks;
        c.idx[r] = bis;
      }
    }
#pragma unroll
    for (int h = K / 2; h > 0; h >>= 1) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if ((s & h) == 0 && before(c.key[s + h], c.idx[s + h], c.key[s],
                                   c.idx[s])) {
          const int tk = c.key[s], ti = c.idx[s];
          c.key[s] = c.key[s + h];
          c.idx[s] = c.idx[s + h];
          c.key[s + h] = tk;
          c.idx[s + h] = ti;
        }
      }
    }
  }
}

// The selection of one tile: each of the thread's QPT queries against its
// TPT columns base + tc + TC*j, in ascending column order. CHECK masks
// the columns at and past row_end; only a split's last tile needs it.
// lim[i] bounds query i's keys that can still make its K: the least of
// the worst keys of the TC carries that share it, an upper bound on the
// K-th smallest key of their union. A key above it is dropped unseen by
// the carry; a key equal to it may still enter on the column order.
// The keys that pass are marked in a bit mask and inserted after, lowest
// column first, so a query's insert network is compiled once, not once a
// column: the unrolled selection stays small enough for the instruction
// cache.
template <bool CHECK, bool EUCLID, int MODE, int K, int QPT>
__device__ __forceinline__ void select_tile(
    Carry<K> (&best)[QPT], const float (&acc)[QPT][TPT],
    const float (&qn)[QPT], const int (&lim)[QPT], const float* tn_s,
    const int* lab_s, int tc, int base, int row_end, int pack_mask) {
  float tn[TPT];
  int lab[TPT];
#pragma unroll
  for (int j = 0; j < TPT; ++j) {
    tn[j] = EUCLID ? tn_s[tc + TC * j] : 0.f;
    lab[j] = MODE == LABELS ? lab_s[tc + TC * j] : 0;
  }
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    int key[TPT];
    unsigned hit = 0;
#pragma unroll
    for (int j = 0; j < TPT; ++j) {
      const int col = base + tc + TC * j;
      float v = acc[i][j];
      if (EUCLID) {
        v = (qn[i] + tn[j]) - 2.f * v;
        // the reference's jnp.maximum(v, 0): NaN stays NaN, -0 becomes +0
        v = v <= 0.f ? 0.f : v;
      }
      key[j] = __float_as_int(v);
      if (MODE == EXACT && v != v) key[j] = NAN_KEY;
      if (MODE == LANES) key[j] = (key[j] & ~pack_mask) | (col >> 7);
      if (MODE == LABELS) key[j] = (key[j] & ~pack_mask) | lab[j];
      if (MODE == PACKED) key[j] &= ~pack_mask;
      if ((!CHECK || col < row_end) && key[j] <= lim[i] &&
          key[j] < best[i].worst())
        hit |= 1u << j;
    }
    while (hit) {
      const int j = __ffs(hit) - 1;
      hit &= hit - 1;
      int k = key[0];
#pragma unroll
      for (int jj = 1; jj < TPT; ++jj) k = jj == j ? key[jj] : k;
      if (k < best[i].worst()) best[i].insert(k, base + tc + TC * j);
    }
  }
}

// Per split (blockIdx.y) and query: the K smallest keys over train rows
// [split*rows_per_split, min((split+1)*rows_per_split, n_valid)).
// rows_per_split is a multiple of stage_rows. Outputs part_key/part_idx
// [splits][nq][K].
template <int K, int METRIC, int MODE>
__global__ void __launch_bounds__(THREADS)
partial_topk_kernel(const float* __restrict__ q, const float* __restrict__ t,
                    const float* __restrict__ qn_g,
                    const float* __restrict__ tn_g,
                    const int* __restrict__ labels, int nq, int d,
                    int n_valid, int rows_per_split, int stage_rows,
                    int stages, int pack_mask, int empty_key,
                    int* __restrict__ part_key, int* __restrict__ part_idx) {
  constexpr bool EUCLID = METRIC == L2;
  constexpr int QPT = qpt<K>();
  constexpr int BQK = block_queries<K>();
  extern __shared__ float4 smem[];
  const int sf = 4 * row_stride4(d);       // floats between staged rows
  float* q_s = reinterpret_cast<float*>(smem);             // [BQK][sf]
  float* t_s = q_s + (size_t)BQK * sf;     // [stages][stage_rows][sf]
  float* tn_s = t_s + (size_t)stages * stage_rows * sf;    // [stages][rows]
  int* lab_s = reinterpret_cast<int*>(tn_s + stages * stage_rows);

  const int tid = threadIdx.x;
  const int tc = tid % TC;
  const int tr = tid / TC;
  const int q0 = blockIdx.x * BQK;
  const int row0 = blockIdx.y * rows_per_split;
  const int row_end = min(row0 + rows_per_split, n_valid);
  const int n_stages = (row_end - row0 + stage_rows - 1) / stage_rows;

  if (stages == 2 && n_stages > 0) {       // the first stage's copy flies
    load_stage<EUCLID, MODE>(t_s, tn_s, lab_s, t, tn_g, labels, d, sf, row0,
                             min(stage_rows, row_end - row0));
    cp_async_commit();
  }
  // this block's queries, unpadded: no feature past d is ever read
  for (int e = tid; e < BQK * d; e += THREADS) {
    const int r = e / d;
    const int f = e - r * d;
    q_s[r * sf + f] = q0 + r < nq ? q[(size_t)(q0 + r) * d + f] : 0.f;
  }
  float qn[QPT];
  int lim[QPT];
  Carry<K> best[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int qi = q0 + tr + TR * i;
    qn[i] = EUCLID && qi < nq ? qn_g[qi] : 0.f;
    lim[i] = empty_key;
    best[i].init(empty_key);
  }

  const int d4 = d >> 2;
  for (int it = 0; it < n_stages; ++it) {
    const int sbase = row0 + it * stage_rows;
    const int srows = min(stage_rows, row_end - sbase);
    const int slot = stages == 2 ? (it & 1) : 0;
    if (stages == 1) {                     // the stage is free once all read it
      __syncthreads();
      load_stage<EUCLID, MODE>(t_s, tn_s, lab_s, t, tn_g, labels, d, sf,
                               sbase, srows);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();                       // every thread's copies landed
    if (stages == 2 && it + 1 < n_stages) {
      // the other slot was read in the last stage, which all have left
      const int nb = sbase + stage_rows;
      const int o = (it + 1) & 1;
      load_stage<EUCLID, MODE>(t_s + (size_t)o * stage_rows * sf,
                               tn_s + o * stage_rows, lab_s + o * stage_rows,
                               t, tn_g, labels, d, sf, nb,
                               min(stage_rows, row_end - nb));
      cp_async_commit();
    }
    const float* ts = t_s + (size_t)slot * stage_rows * sf;
    const float* tns = tn_s + slot * stage_rows;
    const int* labs = lab_s + slot * stage_rows;
    for (int tb = 0; tb < srows; tb += TT) {
      const float* tt = ts + tb * sf;
      float acc[QPT][TPT];
#pragma unroll
      for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int j = 0; j < TPT; ++j) acc[i][j] = 0.f;
      // features in order: whole float4s, then a float2, then a float
      for (int f4 = 0; f4 < d4; ++f4) {
        float4 a[QPT];
#pragma unroll
        for (int i = 0; i < QPT; ++i)
          a[i] = *reinterpret_cast<const float4*>(q_s + (tr + TR * i) * sf +
                                                  4 * f4);
#pragma unroll
        for (int j = 0; j < TPT; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(
              tt + (tc + TC * j) * sf + 4 * f4);
#pragma unroll
          for (int i = 0; i < QPT; ++i) {
            if (EUCLID) {
              acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
              acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
              acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
              acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
            } else {
              // the TPU kernel's order: features 0..D-1 summed from 0.0
              acc[i][j] = acc[i][j] + fabsf(a[i].x - b.x);
              acc[i][j] = acc[i][j] + fabsf(a[i].y - b.y);
              acc[i][j] = acc[i][j] + fabsf(a[i].z - b.z);
              acc[i][j] = acc[i][j] + fabsf(a[i].w - b.w);
            }
          }
        }
      }
      if (d & 2) {
        float2 a[QPT];
#pragma unroll
        for (int i = 0; i < QPT; ++i)
          a[i] = *reinterpret_cast<const float2*>(q_s + (tr + TR * i) * sf +
                                                  4 * d4);
#pragma unroll
        for (int j = 0; j < TPT; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(
              tt + (tc + TC * j) * sf + 4 * d4);
#pragma unroll
          for (int i = 0; i < QPT; ++i) {
            if (EUCLID) {
              acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
              acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
            } else {
              acc[i][j] = acc[i][j] + fabsf(a[i].x - b.x);
              acc[i][j] = acc[i][j] + fabsf(a[i].y - b.y);
            }
          }
        }
      }
      if (d & 1) {
        float a[QPT];
#pragma unroll
        for (int i = 0; i < QPT; ++i) a[i] = q_s[(tr + TR * i) * sf + d - 1];
#pragma unroll
        for (int j = 0; j < TPT; ++j) {
          const float b = tt[(tc + TC * j) * sf + d - 1];
#pragma unroll
          for (int i = 0; i < QPT; ++i)
            acc[i][j] = EUCLID ? fmaf(a[i], b, acc[i][j])
                               : acc[i][j] + fabsf(a[i] - b);
        }
      }
      const int base = sbase + tb;
      if (base + TT <= row_end)
        select_tile<false, EUCLID, MODE>(best, acc, qn, lim, tns + tb,
                                         labs + tb, tc, base, row_end,
                                         pack_mask);
      else
        select_tile<true, EUCLID, MODE>(best, acc, qn, lim, tns + tb,
                                        labs + tb, tc, base, row_end,
                                        pack_mask);
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        int w = best[i].worst();
        w = min(w, __shfl_xor_sync(0xffffffffu, w, 1));
        lim[i] = min(w, __shfl_xor_sync(0xffffffffu, w, 2));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    merge_lanes(best[i]);
    const int qi = q0 + tr + TR * i;
    if (tc == 0 && qi < nq) {
      const size_t o = ((size_t)blockIdx.y * nq + qi) * K;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        part_key[o + s] = best[i].key[s];
        part_idx[o + s] = best[i].idx[s];
      }
    }
  }
}

template <int K, int METRIC, int MODE>
cudaError_t launch_partial(const float* q, const float* t, const float* qn,
                           const float* tn, const int* labels, int nq, int d,
                           int n_valid, int splits, int rows_per_split,
                           int pack_mask, int empty_key, int* part_key,
                           int* part_idx, cudaStream_t stream) {
  auto* fn = &partial_topk_kernel<K, METRIC, MODE>;
  StagePlan plan = stage_plan<K>(d);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return err;
  if (rows_per_split % plan.rows) return cudaErrorInvalidValue;
  void* args[] = {(void*)&q,          (void*)&t,          (void*)&qn,
                  (void*)&tn,         (void*)&labels,     (void*)&nq,
                  (void*)&d,          (void*)&n_valid,    (void*)&rows_per_split,
                  (void*)&plan.rows,  (void*)&plan.stages, (void*)&pack_mask,
                  (void*)&empty_key,  (void*)&part_key,   (void*)&part_idx};
  const dim3 grid((nq + block_queries<K>() - 1) / block_queries<K>(), splits);
  return cudaLaunchKernel(fn, grid, dim3(THREADS), args, plan.smem, stream);
}

// euclid picks the metric; qn and tn are the pre-pass's norms (euclidean
// only), q and t its bfloat16 copies for compute_dtype="bfloat16".
template <int K, int MODE>
cudaError_t launch_partial_metric(bool euclid, const float* q, const float* t,
                                  const float* qn, const float* tn,
                                  const int* labels, int nq, int d,
                                  int n_valid, int splits, int rows_per_split,
                                  int pack_mask, int empty_key, int* part_key,
                                  int* part_idx, cudaStream_t stream) {
  if (euclid)
    return launch_partial<K, L2, MODE>(q, t, qn, tn, labels, nq, d, n_valid,
                                       splits, rows_per_split, pack_mask,
                                       empty_key, part_key, part_idx, stream);
  return launch_partial<K, L1, MODE>(q, t, qn, tn, labels, nq, d, n_valid,
                                     splits, rows_per_split, pack_mask,
                                     empty_key, part_key, part_idx, stream);
}

// What one partial instance takes at D features: info[0] blocks that fit
// on an SM (its registers and shared memory), info[1] registers a thread,
// info[2] local-memory bytes a thread (spills; 0 when all is registers),
// info[3..5] its stage plan: rows a stage, stages, shared-memory bytes.
template <int K, int METRIC, int MODE>
cudaError_t partial_info(int d, int* info) {
  auto* fn = &partial_topk_kernel<K, METRIC, MODE>;
  const StagePlan plan = stage_plan<K>(d);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], fn, THREADS,
                                                      plan.smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = plan.rows;
  info[4] = plan.stages;
  info[5] = (int)plan.smem;
  return err;
}

template <int K, int MODE>
cudaError_t partial_info_metric(bool euclid, int d, int* info) {
  return euclid ? partial_info<K, L2, MODE>(d, info)
                : partial_info<K, L1, MODE>(d, info);
}

// The carry width K a k takes: the smallest of 8, 16, 32, 64 that holds it
// (0 when k is outside 1..64). Keeping K >= k slots is exact: the first k
// of the K smallest are the k smallest.
inline int carry_width(int k) {
  if (k < 1) return 0;
  if (k <= 8) return 8;
  if (k <= 16) return 16;
  if (k <= 32) return 32;
  if (k <= 64) return 64;
  return 0;
}

}  // namespace knn
