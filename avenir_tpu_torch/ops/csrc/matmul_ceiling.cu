// bf16 tensor-core matmul ceiling on Hopper (sm_90a):
//   out[i] = sum_j sum_d bf16(q[i,d]) * bf16(t[j,d])
// the product q.t^T with fp32 accumulation, reduced over the train axis into
// one row sum per query.
//
// Replaces the TPU kernel `kern` of bench.py:797 (bench_knn_matmul_ceiling,
// pallas_call at bench.py:812): a bf16 dot_general of a [1024, D] query
// block against a [4096, D] train block with fp32 accumulation, whose row
// sums the TPU carries in its output block across the sequential train-block
// grid axis. Hopper blocks run in no order, so nothing is carried between
// them: each block here owns 128 queries and one 4096-row slice of the
// train axis (the TPU's block), keeps its accumulator fragments in
// registers across the slice's 32 tiles of 128 train rows, reduces them to
// one partial per (query, slice) with warp shuffles and shared memory, and
// a second kernel sums the slices in slice order. No atomics: two runs are
// bit-equal.
//
// Inner loop: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, 8 warps
// as 4 (32 query rows) x 2 (64 train rows) over a 128 x 128 output tile.
// Operands are rounded to bf16 (round to nearest even, as XLA's astype)
// as they are staged into shared memory, rows padded by 8 halves so that
// fragment loads and ldmatrix hit 32 distinct banks. A warp's 32 query rows
// never change within the slice, so their A fragments (all D features) are
// loaded into registers once; D is a template argument (16 * KS, KS <= 8)
// so that they stay registers. t is [nt, D] row-major, so t^T is exactly
// the "col" operand: ldmatrix.x4 of four 8 x 8 blocks of train rows gives
// the B fragments of two 8-column tiles. The next train tile's fp32 rows
// are loaded in two halves while the current tile is multiplied, and
// rounded into the other of two shared-memory stages: one barrier a tile.
//
// What bounds it on this card: operations. At the bench's shape (8192 x
// 131072 x 128) it is 2.75e11 operations, 0.278 ms at the 989 TFLOP/s bf16
// dense peak, against 0.020 ms for the 68 MB of fp32 input at 3.35 TB/s.
// What this design leaves on the table: mma.sync cannot reach the wgmma
// rate; 255 registers a thread allow one block of 8 warps per SM, which
// all wait at each tile's barrier; every block re-reads and re-rounds its
// train slice from L2, 64 times over in all. wgmma fed by TMA through a
// ring of shared-memory stages, with a producer warp, is the way to the
// peak.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16mma::ldmatrix_x4;
using bf16mma::mma_bf16;
using bf16mma::store_bf16x4;

constexpr int BM = 128;           // queries per block
constexpr int BN = 128;           // train rows per tile
constexpr int THREADS = 256;      // 8 warps: 4 (32 query rows) x 2 (64 train rows)
constexpr int PAD = 8;            // bf16 halves of padding per shared row
constexpr int MAX_KS = 8;         // D = 16 * KS up to 128

// float4 number v of a thread's share of a rows x D tile: (row, column)
template <int D>
__device__ __forceinline__ int2 vec_pos(int v) {
  const int i = threadIdx.x + v * THREADS;
  return make_int2(i / (D / 4), (i % (D / 4)) * 4);
}

// rows x D fp32 (row-major, contiguous) -> bf16 rows of stride D + PAD
template <int D>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      __nv_bfloat16* __restrict__ dst,
                                      int rows) {
  for (int v = 0; v < rows * D / 4 / THREADS; ++v) {
    const int2 p = vec_pos<D>(v);
    store_bf16x4(dst + p.x * (D + PAD) + p.y,
                 __ldg(reinterpret_cast<const float4*>(src + p.x * D + p.y)));
  }
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// partial[split, i] = sum over the split's train rows j of q̂_i . t̂_j,
// D = 16 * KS features
template <int KS>
__global__ void __launch_bounds__(THREADS, 1)
ceiling_partial_kernel(const float* __restrict__ q, const float* __restrict__ t,
                       int nq, int n_tiles, int tiles_per_split,
                       float* __restrict__ partial) {
  constexpr int D = 16 * KS;
  constexpr int LD = D + PAD;
  constexpr int HALF = KS;        // a thread stages 2 * KS float4 per tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* t_s = q_s + BM * LD;             // two stages of BN rows
  const int q0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int tile0 = split * tiles_per_split;
  const int tile1 = min(tile0 + tiles_per_split, n_tiles);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, tg = lane & 3;

  stage<D>(q + (size_t)q0 * D, q_s, BM);
  if (tile0 < tile1) stage<D>(t + (size_t)tile0 * BN * D, t_s, BN);
  __syncthreads();

  // the warp's 32 query rows stay in registers for the whole slice
  uint32_t a[KS][2][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const __nv_bfloat16* p =
          q_s + (wm * 32 + mt * 16 + g) * LD + ks * 16 + tg * 2;
      a[ks][mt][0] = lds32(p);
      a[ks][mt][1] = lds32(p + 8 * LD);
      a[ks][mt][2] = lds32(p + 8);
      a[ks][mt][3] = lds32(p + 8 * LD + 8);
    }
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // this lane's ldmatrix row: n-tile (mat >> 1), k half (mat & 1)
  const int mat = lane >> 3;
  const int b_off = (wn * 64 + (mat >> 1) * 8 + (lane & 7)) * LD + (mat & 1) * 8;
  for (int tile = tile0; tile < tile1; ++tile) {
    const int stage_i = (tile - tile0) & 1;
    const __nv_bfloat16* tb = t_s + stage_i * BN * LD + b_off;
    // the next tile: global loads in two halves, in flight while this one
    // is multiplied, then rounded into the other stage, which every warp
    // finished reading before the previous iteration's barrier
    __nv_bfloat16* tn = t_s + (stage_i ^ 1) * BN * LD;
    const float* src = t + (size_t)(tile + 1) * BN * D;
    const bool more = tile + 1 < tile1;
    float4 pf[HALF];
    if (more) {
#pragma unroll
      for (int v = 0; v < HALF; ++v) {
        const int2 p = vec_pos<D>(v);
        pf[v] = __ldg(reinterpret_cast<const float4*>(src + p.x * D + p.y));
      }
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, tb + np * 16 * LD + ks * 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[ks][mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[ks][mt], b[2], b[3]);
        }
      }
      if (more && ks == (KS - 1) / 2) {
#pragma unroll
        for (int v = 0; v < HALF; ++v) {
          const int2 p = vec_pos<D>(v);
          store_bf16x4(tn + p.x * LD + p.y, pf[v]);
          const int2 p2 = vec_pos<D>(v + HALF);
          pf[v] = __ldg(reinterpret_cast<const float4*>(src + p2.x * D + p2.y));
        }
      }
    }
    if (more) {
#pragma unroll
      for (int v = 0; v < HALF; ++v) {
        const int2 p = vec_pos<D>(v + HALF);
        store_bf16x4(tn + p.x * LD + p.y, pf[v]);
      }
    }
    __syncthreads();
  }

  // row sums: a thread holds rows g and g + 8 of each 16-row tile, two
  // columns of each 8-column tile; the quad's 4 threads hold the rest
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [2 column halves][BM]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float lo = 0.f, hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      lo += acc[mt][nt][0] + acc[mt][nt][1];
      hi += acc[mt][nt][2] + acc[mt][nt][3];
    }
    lo += __shfl_xor_sync(0xffffffffu, lo, 1);
    lo += __shfl_xor_sync(0xffffffffu, lo, 2);
    hi += __shfl_xor_sync(0xffffffffu, hi, 1);
    hi += __shfl_xor_sync(0xffffffffu, hi, 2);
    if (tg == 0) {
      const int row = wm * 32 + mt * 16 + g;
      red[wn * BM + row] = lo;
      red[wn * BM + row + 8] = hi;
    }
  }
  __syncthreads();
  if (threadIdx.x < BM)
    partial[(size_t)split * nq + q0 + threadIdx.x] =
        red[threadIdx.x] + red[BM + threadIdx.x];
}

// out[i] = sum of partial[s, i] over splits s = 0, 1, ... in that order
__global__ void ceiling_reduce_kernel(const float* __restrict__ partial,
                                      int nq, int splits,
                                      float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  float s = partial[i];
  for (int sp = 1; sp < splits; ++sp) s += partial[(size_t)sp * nq + i];
  out[i] = s;
}

template <int KS>
cudaError_t launch_partial(const float* q, const float* t, int nq, int n_tiles,
                           int tiles_per_split, int splits, float* partial,
                           cudaStream_t s) {
  const size_t smem = (size_t)(BM + 2 * BN) * (16 * KS + PAD) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      ceiling_partial_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ceiling_partial_kernel<KS><<<dim3(nq / BM, splits), THREADS, smem, s>>>(
      q, t, nq, n_tiles, tiles_per_split, partial);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [nq, d] and t [nt, d] fp32 row-major on the device, 16-byte aligned,
// with nq and nt multiples of 128 and d a multiple of 16 up to 128;
// rows_per_split a multiple of 128. partial holds splits * nq floats,
// splits = ceil(nt / rows_per_split); out holds nq floats. Returns
// cudaGetLastError().
int matmul_ceiling_launch(const float* q, const float* t, int nq, int nt,
                          int d, int rows_per_split, float* partial,
                          float* out, void* stream) {
  if (nq <= 0 || nt <= 0 || nq % BM || nt % BN || d <= 0 || d % 16 ||
      d > 16 * MAX_KS || rows_per_split <= 0 || rows_per_split % BN)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = nt / BN;
  const int tiles_per_split = rows_per_split / BN;
  const int splits = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  cudaError_t err;
  switch (d / 16) {
#define CEILING_CASE(KS)                                                   \
  case KS:                                                                 \
    err = launch_partial<KS>(q, t, nq, n_tiles, tiles_per_split, splits,   \
                             partial, s);                                  \
    break;
    CEILING_CASE(1) CEILING_CASE(2) CEILING_CASE(3) CEILING_CASE(4)
    CEILING_CASE(5) CEILING_CASE(6) CEILING_CASE(7) CEILING_CASE(8)
#undef CEILING_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  ceiling_reduce_kernel<<<(nq + 255) / 256, 256, 0, s>>>(partial, nq, splits,
                                                          out);
  return (int)cudaGetLastError();
}

}  // extern "C"
