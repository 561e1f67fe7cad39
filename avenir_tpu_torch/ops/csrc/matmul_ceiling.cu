// bf16 tensor-core matmul ceiling on Hopper (sm_90a), wgmma fed by TMA:
//   out[i] = sum_j sum_d bf16(q[i,d]) * bf16(t[j,d])
// the product q.t^T with fp32 accumulation, reduced over the train axis into
// one row sum per query.
//
// Replaces the TPU kernel `kern` of bench.py:797 (bench_knn_matmul_ceiling,
// pallas_call at bench.py:812): a bf16 dot_general of a [1024, D] query
// block against a [4096, D] train block with fp32 accumulation, whose row
// sums the TPU carries in its output block across the sequential train-block
// grid axis.
//
// What bounds it on this card: operations. At the bench's shape (8192 x
// 131072 x 128) it is 2.75e11 operations, 0.278 ms at the 989 TFLOP/s bf16
// dense peak, against 0.020 ms for the 68 MB of fp32 input at 3.35 TB/s.
// What the design does about that:
// - A cast pass (ceiling_cast_kernel) rounds q and t to bf16 once (nearest
//   even, as XLA's astype) into scratch rows zero-padded to 64 or 128
//   features, so one 128-byte swizzle serves every D and the zeros add
//   nothing. TMA copies bytes and wgmma reads bf16, so the rounding leaves
//   the product loop; the pass moves about 100 MB, ~0.03 ms.
// - The product runs on wgmma.mma_async m64n128k16 with fp32 accumulators
//   in registers. A block owns 256 queries (its resident tile, loaded once
//   per query tile) and streams 128-row train tiles through a ring of
//   STAGES shared-memory stages. One producer thread (its warpgroup down
//   to 40 registers by setmaxnreg) issues the TMA loads; full and empty
//   mbarriers guard each stage. Two consumer warpgroups (up to 232
//   registers) each multiply 128 of the queries as two 64-row tiles
//   against every stage, keeping one wgmma group in flight while the next
//   stage is waited for. With 256 queries a tile, t is read from L2 32
//   times (about 1 GB), where a 128-query tile reads it 64 times.
// - The accumulators carry across every train tile of a block's range, so
//   the row reduction (a thread's columns, then shuffles in each quad) runs
//   once per segment, not once per tile.
// - Schedule: one persistent block an SM; block b walks the contiguous
//   range [b * pairs / blocks, (b + 1) * pairs / blocks) of (query tile,
//   train tile) pairs, query-tile major, so every SM gets the same share to
//   one pair. A range meets one or two query tiles (segments); each
//   segment writes one partial per query, and ceiling_reduce_kernel adds a
//   query's partials in block order, which is train order. No atomics: two
//   runs are bit-equal. The plan is `ops/matmul_ceiling.py` `plan`; the C
//   entry refuses a launch whose max_segs differs from its own count.
// - Rows past nq in the last query tile are zeros from TMA's bounds and are
//   never written.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace {

namespace wg = wgmma_bf16;

constexpr int CONSUMERS = 2;          // consumer warpgroups
constexpr int BM = 128 * CONSUMERS;   // queries per block tile
constexpr int BN = 128;               // train rows per stage
constexpr int STAGES = 4;
constexpr int THREADS = 128 * (CONSUMERS + 1);   // + the producer warpgroup
constexpr int ROW_BYTES = 128;        // a swizzled chunk row: 64 bf16 features
constexpr int MAX_D = 128;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// shared memory of the instance for KC chunks of 64 features (KC = 1 for
// D <= 64, 2 up to 128): the query tile, the stages, the barriers
template <int KC>
struct Smem {
  static constexpr int Q_BYTES = KC * BM * ROW_BYTES;
  static constexpr int STAGE_BYTES = KC * BN * ROW_BYTES;
  static constexpr int BAR_OFFSET = Q_BYTES + STAGES * STAGE_BYTES;
  // + full[STAGES], empty[STAGES], q_full, q_empty; + 1024 to align
  static constexpr int BYTES = BAR_OFFSET + (2 * STAGES + 2) * 8 + 1024;
};

// block b of `blocks` owns the (query tile, train tile) pairs
// [b * pairs / blocks, (b + 1) * pairs / blocks), query-tile major
__device__ __host__ __forceinline__ long long range_start(long long b,
                                                          long long pairs,
                                                          long long blocks) {
  return b * pairs / blocks;
}

// the query tiles of this block's range: qt from qt0 while qt * t_tiles
// < p1, train tiles [seg_lo, seg_hi) of each
struct Range {
  long long p0, p1;
  int t_tiles;
  __device__ int first() const { return (int)(p0 / t_tiles); }
  __device__ bool has(int qt) const { return (long long)qt * t_tiles < p1; }
  __device__ int lo(int qt) const {
    return (int)(max(p0, (long long)qt * t_tiles) - (long long)qt * t_tiles);
  }
  __device__ int hi(int qt) const {
    return (int)(min(p1, (long long)(qt + 1) * t_tiles) -
                 (long long)qt * t_tiles);
  }
};

template <int KC>
__global__ void __launch_bounds__(THREADS, 1)
ceiling_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tt, int nq,
                     int t_tiles, long long pairs, int max_segs,
                     float* __restrict__ partial) {
  using S = Smem<KC>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;
  unsigned char* t_s = smem + S::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFFSET);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;
  uint64_t* q_empty = q_full + 1;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 4 * CONSUMERS);   // a consumer warp each
    }
    wg::mbar_init(q_full, 1);
    wg::mbar_init(q_empty, 4 * CONSUMERS);
    wg::mbar_fence_init();
  }
  __syncthreads();
  const Range r{range_start(blockIdx.x, pairs, gridDim.x),
                range_start(blockIdx.x + 1, pairs, gridDim.x), t_tiles};

  if (tid < 128) {
    // ---- producer warpgroup: one thread keeps the ring full
    wg::regs_dec<PRODUCER_REGS>();
    if (tid == 0) {
      wg::prefetch_tmap(&tq);
      wg::prefetch_tmap(&tt);
      uint32_t it = 0, k = 0;
      for (int qt = r.first(); r.has(qt); ++qt, ++k) {
        wg::mbar_wait(q_empty, (k & 1) ^ 1);
        wg::mbar_expect_tx(q_full, S::Q_BYTES);
        for (int kc = 0; kc < KC; ++kc)
          wg::tma_load(q_s + kc * BM * ROW_BYTES, &tq, q_full, kc * 64,
                       qt * BM);
        for (int j = r.lo(qt); j < r.hi(qt); ++j, ++it) {
          const int s = it % STAGES;
          wg::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          wg::mbar_expect_tx(&full[s], S::STAGE_BYTES);
          for (int kc = 0; kc < KC; ++kc)
            wg::tma_load(t_s + s * S::STAGE_BYTES + kc * BN * ROW_BYTES, &tt,
                         &full[s], kc * 64, j * BN);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: c owns query rows [128c, 128c + 128) of
    // the tile, as two 64-row wgmma tiles against each stage's 128 rows
    wg::regs_inc<CONSUMER_REGS>();
    const int c = tid / 128 - 1;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    float acc[2][64];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[m][i] = 0.f;
    const uint32_t a_addr = wg::smem_addr(q_s) + c * 128 * ROW_BYTES;
    uint32_t it = 0, k = 0;
    for (int qt = r.first(); r.has(qt); ++qt, ++k) {
      wg::mbar_wait(q_full, k & 1);
      const int n = r.hi(qt) - r.lo(qt);
      for (int i = 0; i < n; ++i, ++it) {
        const int s = it % STAGES;
        wg::mbar_wait(&full[s], (it / STAGES) & 1);
        const uint32_t b_addr = wg::smem_addr(t_s + s * S::STAGE_BYTES);
        wg::fence_regs(acc[0]);
        wg::fence_regs(acc[1]);
        wg::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4 * KC; ++ks) {
          const uint64_t b =
              wg::desc_sw128(b_addr + (ks >> 2) * BN * ROW_BYTES + (ks & 3) * 32);
#pragma unroll
          for (int m = 0; m < 2; ++m)
            wg::wgmma_m64n128k16(
                acc[m],
                wg::desc_sw128(a_addr + (ks >> 2) * BM * ROW_BYTES +
                               m * 64 * ROW_BYTES + (ks & 3) * 32),
                b, i > 0 || ks > 0);
        }
        wg::wgmma_commit();
        // the previous stage's products are done: release it
        wg::wgmma_wait<1>();
        wg::fence_regs(acc[0]);
        wg::fence_regs(acc[1]);
        if (i > 0 && lane == 0) wg::mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wg::wgmma_wait<0>();
      wg::fence_regs(acc[0]);
      wg::fence_regs(acc[1]);
      if (lane == 0) {
        wg::mbar_arrive(&empty[(it - 1) % STAGES]);
        wg::mbar_arrive(q_empty);
      }
      // row sums: a thread holds rows g and g + 8 of its warp's 16 rows
      // of each 64-row tile, two columns of each 8-column group; the
      // quad's 4 threads hold the rest of the 128 columns
      const int g = lane >> 2;
      float* dst =
          partial + ((size_t)blockIdx.x * max_segs + (qt - r.first())) * BM;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float lo = 0.f, hi = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          lo += acc[m][4 * j] + acc[m][4 * j + 1];
          hi += acc[m][4 * j + 2] + acc[m][4 * j + 3];
        }
        lo += __shfl_xor_sync(0xffffffffu, lo, 1);
        lo += __shfl_xor_sync(0xffffffffu, lo, 2);
        hi += __shfl_xor_sync(0xffffffffu, hi, 1);
        hi += __shfl_xor_sync(0xffffffffu, hi, 2);
        const int row = c * 128 + m * 64 + warp * 16 + g;
        if ((lane & 3) == 0) {
          if (qt * BM + row < nq) dst[row] = lo;
          if (qt * BM + row + 8 < nq) dst[row + 8] = hi;
        }
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo, the lower
  return *reinterpret_cast<uint32_t*>(&v);            // address
}

// rows of q and t to bf16 (round to nearest even) at a width of dp
// features, zeros past d: 8 features a thread
__global__ void ceiling_cast_kernel(const float* __restrict__ q,
                                    const float* __restrict__ t, int nq, int nt,
                                    int d, int dp, __nv_bfloat16* __restrict__ qb,
                                    __nv_bfloat16* __restrict__ tb) {
  const int per_row = dp / 8;
  const long long total = (long long)(nq + nt) * per_row;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x; v < total;
       v += (long long)gridDim.x * blockDim.x) {
    const long long row = v / per_row;
    const int col = (int)(v % per_row) * 8;
    const float* src = row < nq ? q + row * d : t + (row - nq) * d;
    __nv_bfloat16* dst = row < nq ? qb + row * dp : tb + (row - nq) * dp;
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (col < d) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(src + col));
      const float4 b = __ldg(reinterpret_cast<const float4*>(src + col + 4));
      packed = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                          pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
    }
    *reinterpret_cast<uint4*>(dst + col) = packed;
  }
}

// out[i] = sum, in train order, of the partials of the blocks whose pair
// ranges meet query tile i / BM
__global__ void ceiling_reduce_kernel(const float* __restrict__ partial, int nq,
                                      int t_tiles, long long pairs, int blocks,
                                      int max_segs, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const int qt = i / BM;
  const long long lo = (long long)qt * t_tiles, hi = lo + t_tiles;
  // the block holding pair lo: range_start(b) <= lo < range_start(b + 1)
  int b = (int)(lo * blocks / pairs);
  while (b > 0 && range_start(b, pairs, blocks) > lo) --b;
  while (range_start(b + 1, pairs, blocks) <= lo) ++b;
  float s = 0.f;
  for (; b < blocks && range_start(b, pairs, blocks) < hi; ++b) {
    const int seg = qt - (int)(range_start(b, pairs, blocks) / t_tiles);
    s += partial[((size_t)b * max_segs + seg) * BM + i % BM];
  }
  out[i] = s;
}

// the most query tiles one block's pair range meets
int max_segments(long long pairs, int blocks, int t_tiles) {
  int most = 0;
  for (int b = 0; b < blocks; ++b) {
    const long long p0 = range_start(b, pairs, blocks);
    const long long p1 = range_start(b + 1, pairs, blocks);
    const int segs = (int)((p1 - 1) / t_tiles - p0 / t_tiles + 1);
    if (segs > most) most = segs;
  }
  return most;
}

template <int KC>
cudaError_t launch_main(const CUtensorMap& tq, const CUtensorMap& tt, int nq,
                        int t_tiles, long long pairs, int blocks, int max_segs,
                        float* partial, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      ceiling_wgmma_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<KC>::BYTES);
  if (err != cudaSuccess) return err;
  ceiling_wgmma_kernel<KC><<<blocks, THREADS, Smem<KC>::BYTES, s>>>(
      tq, tt, nq, t_tiles, pairs, max_segs, partial);
  return cudaGetLastError();
}

template <int KC>
int info(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, ceiling_wgmma_kernel<KC>);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ceiling_wgmma_kernel<KC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<KC>::BYTES);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ceiling_wgmma_kernel<KC>, THREADS, Smem<KC>::BYTES);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = Smem<KC>::BYTES;
  out[3] = THREADS;
  out[4] = per_sm;
  out[5] = BM;
  out[6] = BN;
  out[7] = STAGES;
  return 0;
}

}  // namespace

extern "C" {

// q [nq, d] and t [nt, d] fp32 row-major on the device, 16-byte aligned;
// nq and nt multiples of 128, d a multiple of 16 up to 128. qb [nq, dp]
// and tb [nt, dp] bf16 scratch, dp = d rounded up to 64; `blocks` blocks
// split the (query tile, train tile) pairs, `max_segs` the most query
// tiles one block meets (the wrapper's plan; refused if it differs);
// partial holds blocks * max_segs * BM floats, out nq. Returns
// cudaGetLastError() after the last launch.
int matmul_ceiling_launch(const float* q, const float* t, int nq, int nt,
                          int d, void* qb, void* tb, int blocks, int max_segs,
                          float* partial, float* out, void* stream) {
  if (nq <= 0 || nt <= 0 || nq % 128 || nt % BN || d <= 0 || d % 16 ||
      d > MAX_D || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const int dp = (d + 63) / 64 * 64;
  const int t_tiles = nt / BN;
  const long long pairs = (long long)((nq + BM - 1) / BM) * t_tiles;
  if (blocks > pairs || max_segs != max_segments(pairs, blocks, t_tiles))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  ceiling_cast_kernel<<<1024, 256, 0, s>>>(
      q, t, nq, nt, d, dp, (__nv_bfloat16*)qb, (__nv_bfloat16*)tb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tt;
  if (!wg::encode_bf16_rows(&tq, qb, nq, dp, BM) ||
      !wg::encode_bf16_rows(&tt, tb, nt, dp, BN))
    return (int)cudaErrorInvalidValue;
  err = dp == 64 ? launch_main<1>(tq, tt, nq, t_tiles, pairs, blocks, max_segs,
                                  partial, s)
                 : launch_main<2>(tq, tt, nq, t_tiles, pairs, blocks, max_segs,
                                  partial, s);
  if (err != cudaSuccess) return (int)err;
  ceiling_reduce_kernel<<<(nq + 255) / 256, 256, 0, s>>>(
      partial, nq, t_tiles, pairs, blocks, max_segs, out);
  return (int)cudaGetLastError();
}

// the main kernel's instance for d features: registers, local bytes,
// dynamic shared bytes, threads, blocks per SM, query rows a block, train
// rows a stage, stages (out[0..7])
int matmul_ceiling_info(int d, int* out) {
  if (d <= 0 || d % 16 || d > MAX_D) return (int)cudaErrorInvalidValue;
  return d <= 64 ? info<1>(out) : info<2>(out);
}

}  // extern "C"
