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
// d is non-negative, so its bit pattern orders like the float. Ties in key
// go to the lower train column, as the TPU kernels' first-argmin does. The
// carry holds the column beside each key, so PACKED needs no column bits
// in the key and no tile cap: it selects on (bits(d) & ~0xFFF, column).
//
// METRIC L2_BF16 is euclidean with the operands of the cross term q.t
// rounded to bfloat16, nearest even, as the TPU kernels'
// compute_dtype="bfloat16" does; products and sums stay fp32, and the
// norms |q|^2 and |t|^2 come from the unrounded values, so each is taken
// before its operand is rounded in shared memory. It is a template
// argument, not a runtime flag, so the fp32 instances compile as if bf16
// did not exist.
//
// Layout: one thread per query, BQ queries per block; blockIdx.y splits the
// train axis so that a few thousand queries still fill 132 SMs. Each split
// writes its sorted K-carry to a scratch buffer, and a second small kernel
// merges the splits in column order (ties stay with the lower column).
//
// What bounds it: the work is compute, nq*nt*D fp32 FMAs (euclidean) or
// sub+abs+add (manhattan), plus nq*nt selection compares; the bytes read
// are a few MB. The design keeps the train tile in shared memory, read as
// float4 broadcasts (one shared load feeds 4 FMAs), with TT accumulators
// per thread for instruction-level parallelism; the carry lives in
// registers and a candidate costs one compare unless it enters. Plain fp32
// FMA, never TF32 (the TPU reference measured ~4e-3 relative error without
// full-precision products).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace knn {

constexpr int BQ = 128;                 // queries per block, one per thread
constexpr int TT = 32;                  // train rows per shared-memory tile
constexpr int SENTINEL = 0x7F700000;    // empty packed slot (pallas_knn._SENTINEL)
constexpr int INF_BITS = 0x7F800000;    // empty exact slot: +inf

enum Mode { EXACT = 0, LANES = 1, LABELS = 2, PACKED = 3 };
enum Metric { L1 = 0, L2 = 1, L2_BF16 = 2 };

__device__ __forceinline__ float4 round_bf16(float4 v) {
  return make_float4(__bfloat162float(__float2bfloat16_rn(v.x)),
                     __bfloat162float(__float2bfloat16_rn(v.y)),
                     __bfloat162float(__float2bfloat16_rn(v.z)),
                     __bfloat162float(__float2bfloat16_rn(v.w)));
}

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

// Bytes of dynamic shared memory the partial kernel takes for D features.
inline size_t partial_smem_bytes(int d) {
  const int d4 = (d + 3) / 4;
  return sizeof(float4) * (size_t)d4 * (BQ + TT) + 2 * sizeof(int) * TT;
}

// Per split (blockIdx.y) and query: the K smallest keys over train rows
// [split*rows_per_split, min((split+1)*rows_per_split, n_valid)).
// Outputs part_key/part_idx [splits][nq][K].
template <int K, int METRIC, int MODE>
__global__ void __launch_bounds__(BQ)
partial_topk_kernel(const float* __restrict__ q, const float* __restrict__ t,
                    const int* __restrict__ labels, int nq, int d,
                    int n_valid, int rows_per_split, int pack_mask,
                    int empty_key, int* __restrict__ part_key,
                    int* __restrict__ part_idx) {
  constexpr bool EUCLID = METRIC != L1;
  constexpr bool BF16 = METRIC == L2_BF16;
  extern __shared__ float4 smem[];
  const int d4 = (d + 3) / 4;
  float4* q_s = smem;                                      // [d4][BQ]
  float4* t_s = q_s + (size_t)d4 * BQ;                     // [TT][d4]
  float* tn_s = reinterpret_cast<float*>(t_s + (size_t)TT * d4);  // [TT]
  int* lab_s = reinterpret_cast<int*>(tn_s + TT);          // [TT]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + tid;
  const int split = blockIdx.y;
  const int row0 = split * rows_per_split;
  const int row_end = min(row0 + rows_per_split, n_valid);

  // stage this block's queries, features zero-padded to a multiple of 4
  // (a zero feature adds exactly 0 to both the L1 sum and the dot form)
  float* qf = reinterpret_cast<float*>(q_s);
  for (int e = tid; e < d4 * 4 * BQ; e += BQ) {
    const int c = e & 3;
    const int r = (e >> 2) % BQ;
    const int f = ((e >> 2) / BQ) * 4 + c;
    const int row = q0 + r;
    qf[e] = (f < d && row < nq) ? q[(size_t)row * d + f] : 0.f;
  }
  __syncthreads();
  // a thread reads only its own query's column of q_s from here on, so it
  // may round that column in place once its norm is taken
  float qn = 0.f;
  if (EUCLID) {
    for (int f4 = 0; f4 < d4; ++f4) {
      const float4 a = q_s[f4 * BQ + tid];
      qn = fmaf(a.x, a.x, qn);
      qn = fmaf(a.y, a.y, qn);
      qn = fmaf(a.z, a.z, qn);
      qn = fmaf(a.w, a.w, qn);
      if (BF16) q_s[f4 * BQ + tid] = round_bf16(a);
    }
  }

  Carry<K> best;
  best.init(empty_key);
  float* tf = reinterpret_cast<float*>(t_s);
  const int tile_floats = TT * d4 * 4;
  for (int base = row0; base < row_end; base += TT) {
    __syncthreads();                   // the previous tile is consumed
    for (int e = tid; e < tile_floats; e += BQ) {
      const int j = e / (d4 * 4);
      const int f = e - j * (d4 * 4);
      const int row = base + j;
      tf[e] = (f < d && row < row_end) ? t[(size_t)row * d + f] : 0.f;
    }
    if (MODE == LABELS && tid < TT)
      lab_s[tid] = (base + tid < row_end) ? labels[base + tid] : 0;
    __syncthreads();
    if (EUCLID) {
      if (tid < TT) {
        float s = 0.f;
        for (int f4 = 0; f4 < d4; ++f4) {
          const float4 b = t_s[tid * d4 + f4];
          s = fmaf(b.x, b.x, s);
          s = fmaf(b.y, b.y, s);
          s = fmaf(b.z, b.z, s);
          s = fmaf(b.w, b.w, s);
          if (BF16) t_s[tid * d4 + f4] = round_bf16(b);   // after its norm
        }
        tn_s[tid] = s;
      }
      __syncthreads();
    }

    float acc[TT];
#pragma unroll
    for (int j = 0; j < TT; ++j) acc[j] = 0.f;
    for (int f4 = 0; f4 < d4; ++f4) {
      const float4 a = q_s[f4 * BQ + tid];
#pragma unroll
      for (int j = 0; j < TT; ++j) {
        const float4 b = t_s[j * d4 + f4];       // broadcast to the warp
        if (EUCLID) {
          acc[j] = fmaf(a.x, b.x, acc[j]);
          acc[j] = fmaf(a.y, b.y, acc[j]);
          acc[j] = fmaf(a.z, b.z, acc[j]);
          acc[j] = fmaf(a.w, b.w, acc[j]);
        } else {
          // the TPU kernel's order: features 0..D-1 summed from 0.0
          acc[j] = acc[j] + fabsf(a.x - b.x);
          acc[j] = acc[j] + fabsf(a.y - b.y);
          acc[j] = acc[j] + fabsf(a.z - b.z);
          acc[j] = acc[j] + fabsf(a.w - b.w);
        }
      }
    }
    if (qi < nq) {
#pragma unroll
      for (int j = 0; j < TT; ++j) {
        const int col = base + j;
        if (col < row_end) {
          float v = acc[j];
          if (EUCLID) {
            v = (qn + tn_s[j]) - 2.f * v;
            v = v > 0.f ? v : 0.f;             // clamp, and -0 becomes +0
          }
          int key = __float_as_int(v);
          if (MODE == LANES) key = (key & ~pack_mask) | (col >> 7);
          if (MODE == LABELS) key = (key & ~pack_mask) | lab_s[j];
          if (MODE == PACKED) key &= ~pack_mask;
          if (key < best.worst()) best.insert(key, col);
        }
      }
    }
  }
  if (qi < nq) {
    const size_t o = ((size_t)split * nq + qi) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      part_key[o + s] = best.key[s];
      part_idx[o + s] = best.idx[s];
    }
  }
}

// Merge the splits' sorted carries of one query into one sorted K-carry.
// Splits are visited in column order and each list is sorted, so strict
// comparisons keep the lower column first among equal keys.
template <int K>
__device__ __forceinline__ void merge_splits(const int* __restrict__ part_key,
                                             const int* __restrict__ part_idx,
                                             int nq, int splits, int qi,
                                             int empty_key, Carry<K>& best) {
  best.init(empty_key);
  for (int s = 0; s < splits; ++s) {
    const size_t o = ((size_t)s * nq + qi) * K;
    for (int j = 0; j < K; ++j) {
      const int key = part_key[o + j];
      if (!(key < best.worst())) break;  // the rest of this list is larger
      best.insert(key, part_idx[o + j]);
    }
  }
}

template <int K, int METRIC, int MODE>
cudaError_t launch_partial(const float* q, const float* t, const int* labels,
                           int nq, int d, int n_valid, int splits,
                           int rows_per_split, int pack_mask, int empty_key,
                           int* part_key, int* part_idx, cudaStream_t stream) {
  auto* fn = &partial_topk_kernel<K, METRIC, MODE>;
  const size_t smem = partial_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&q,        (void*)&t,          (void*)&labels,
                  (void*)&nq,       (void*)&d,          (void*)&n_valid,
                  (void*)&rows_per_split, (void*)&pack_mask,
                  (void*)&empty_key, (void*)&part_key, (void*)&part_idx};
  const dim3 grid((nq + BQ - 1) / BQ, splits);
  return cudaLaunchKernel(fn, grid, dim3(BQ), args, smem, stream);
}

// bf16 applies to euclidean only: manhattan ignores the compute dtype.
template <int K, int MODE>
cudaError_t launch_partial_metric(bool euclid, int bf16, const float* q,
                                  const float* t, const int* labels, int nq,
                                  int d, int n_valid, int splits,
                                  int rows_per_split, int pack_mask,
                                  int empty_key, int* part_key,
                                  int* part_idx, cudaStream_t stream) {
  if (euclid && bf16)
    return launch_partial<K, L2_BF16, MODE>(q, t, labels, nq, d, n_valid,
                                            splits, rows_per_split, pack_mask,
                                            empty_key, part_key, part_idx,
                                            stream);
  if (euclid)
    return launch_partial<K, L2, MODE>(q, t, labels, nq, d, n_valid, splits,
                                       rows_per_split, pack_mask, empty_key,
                                       part_key, part_idx, stream);
  return launch_partial<K, L1, MODE>(q, t, labels, nq, d, n_valid, splits,
                                     rows_per_split, pack_mask, empty_key,
                                     part_key, part_idx, stream);
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
