// Tensor-core form of the KNN partial top-k kernel for Hopper (sm_90a):
// euclidean distances with compute_dtype="bfloat16".
//
// It computes what partial_topk_kernel (knn_tile.cuh) computes for the
// four modes EXACT, LANES, LABELS and PACKED: per split and query the K
// smallest (key, column) pairs, in the same layout part_key/part_idx
// [splits][nq][K], with the same empty key and tie rule (the lower column
// wins), so the merge kernels, the wrapper's decoding and the vote take
// its lists unchanged. Only the cross term changes: v = sum_f bf16(q_f) *
// bf16(t_f) comes from mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// with fp32 accumulation, as the TPU kernels' bf16 dot_general on the MXU
// (avenir_tpu/ops/pallas_knn.py:54-70 _tile_distance, :44 _dot_precision).
// The key is then max((|q|^2 + |t|^2) - 2v, 0) from the pre-pass's fp32
// norms, masked as in partial_topk_kernel.
//
// Tolerance: a bf16 product is exact in fp32, so against the plain bf16
// version (fp32 products of the rounded operands, summed in another
// order) only the order of the fp32 accumulation differs. The keys are
// not bit-equal to it, nor to the CUDA-core form; they are held to the
// float32 kernel's tolerance plus the cancellation floor of the dot form
// (tools/knn_tolerance.py bf16_agrees) and kernel_check's bf16 bar (rtol
// 2e-2 against a float64 oracle, recall >= 0.999).
//
// What bounds it: at D=128 the product is 2 D operations a pair at the
// tensor cores' rate (0.278 ms at 8192 x 131072 on an H100); the key, the
// selection compare and the two shared-memory words a pair take CUDA-core
// instruction slots, so the epilogue and the selection set the pace. The
// design:
// - Operands. A block takes block_queries<K>() queries (128/64/32) and
//   walks its split's train rows in 32-row tiles. The pre-pass's rounded
//   copies (bf16 values stored as fp32) arrive through the cp.async ring
//   of partial_topk_kernel (load_stage); each landed stage is packed to
//   bf16 in shared memory, exactly, as its queries are once. Rows are
//   padded by 8 halves so that ldmatrix reads hit distinct banks; D runs
//   in k-steps of 16 with zeros past D, which add nothing. A fragments
//   are loaded from shared memory each k-step, so any D the wrapper
//   takes (up to MAX_D) runs in one instance.
// - Products. Four warps share the block's query x 32-row tile: 4 x 1
//   (32 or 16 query rows each) at 128 and 64 queries, 2 x 2 at 32; a
//   warp runs its m16 tiles one after another, and the kernel is built
//   for one block an SM at least (__launch_bounds__(THREADS, 1)): fewer
//   live registers, and ptxas spills none (with the default bound it
//   capped some instances' registers and spilled). At D=6 three blocks
//   fit an SM, at D=128 two.
// - Keys. The epilogue writes the warp's accumulator fragments (v) into a
//   shared tile of 32 columns a query, one of two that alternate, so one
//   barrier a tile separates writing from reading. partial_topk_kernel's
//   selection (select_tile: 4 lanes a query, a bound shared by them, a
//   bit-mask insert in column order) reads v from there, forms the key
//   and keeps the carries; the lanes merge by shuffles at the split's end.
#pragma once

#include "knn_tile.cuh"
#include "mma_bf16.cuh"

namespace knn {

constexpr int MMA_PAD = 8;              // bf16 halves of padding a shared row
constexpr int V_STRIDE = TT + 4;        // floats between rows of a v tile
// fp32 bytes of train rows a stage holds: half of STAGE_BYTES, so that at
// small D (192 rows a stage at D=6) three blocks fit an SM's shared memory
constexpr int MMA_STAGE_BYTES = 8192;
// clock64() sections of the diagnostic instance, in this order: stage
// wait, bf16 pack, mma, key epilogue, selection and insert, lane merge
constexpr int SECTIONS = 6;

// D rounded up to the mma's k-step of 16
__host__ __device__ inline int depth16(int d) { return (d + 15) / 16 * 16; }

// The tensor-core form's shared memory at D features: two v tiles, the
// block's queries and one stage's train rows as bf16 at depth16(d) + 8
// halves, and a ring of fp32 stages laid out as partial_topk_kernel's
// (whole 32-row tiles filling MMA_STAGE_BYTES; two stages where they fit,
// else one).
template <int K>
inline StagePlan mma_stage_plan(int d) {
  const size_t lda = sizeof(__nv_bfloat16) * (depth16(d) + MMA_PAD);
  const size_t row = sizeof(float4) * row_stride4(d) + 2 * sizeof(int);
  const int tiles = (int)(MMA_STAGE_BYTES / (row * TT));
  const int rows = (tiles > 1 ? tiles : 1) * TT;
  const size_t fixed = (2 * sizeof(float) * V_STRIDE + lda) *
                       block_queries<K>() + rows * lda;
  const int stages = fixed + 2 * rows * row <= SMEM_LIMIT ? 2 : 1;
  return {rows, stages, fixed + stages * rows * row};
}

// Rows [0, rows) of a staged fp32 stage (stride sf floats) packed to bf16
// rows of stride lda halves, zeros from d to depth16(d). The values are
// bf16 already, so the packing is exact.
__device__ __forceinline__ void pack_rows(__nv_bfloat16* dst, int lda,
                                          const float* src, int sf, int d,
                                          int rows) {
  const int n = depth16(d) / 4;            // 4-feature chunks a row
  const int dj = THREADS / n, dc = THREADS - dj * n;
  int j = threadIdx.x / n, c = threadIdx.x - j * n;
  while (j < rows) {
    const int f = 4 * c;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (f < d) {
      x = *reinterpret_cast<const float4*>(src + j * sf + f);
      if (f + 1 >= d) x.y = 0.f;
      if (f + 2 >= d) x.z = 0.f;
      if (f + 3 >= d) x.w = 0.f;
    }
    bf16mma::store_bf16x4(dst + j * lda + f, x);
    j += dj;
    c += dc;
    if (c >= n) {
      c -= n;
      ++j;
    }
  }
}

// acc = one m16 tile of q_s . t_s^T against the warp's NT n8 tiles over
// dp features: qa is the tile's first query row, tb the warp's first
// train row, both bf16 at a stride of lda halves.
template <int NT>
__device__ __forceinline__ void cross_tile(float (&acc)[NT][4],
                                           const __nv_bfloat16* qa,
                                           const __nv_bfloat16* tb, int lda,
                                           int dp, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  // A: lanes 0-15 give rows 0-15 at k 0-7, lanes 16-31 at k 8-15
  const __nv_bfloat16* pa = qa + (lane & 15) * lda + (lane >> 4) * 8;
  // B: lanes 8m..8m+7 give train rows of n-tile m >> 1 at k half m & 1
  const int mat = lane >> 3;
  const __nv_bfloat16* pb = tb + ((mat >> 1) * 8 + (lane & 7)) * lda +
                            (mat & 1) * 8;
  for (int k0 = 0; k0 < dp; k0 += 16) {
    uint32_t a[4];
    bf16mma::ldmatrix_x4(a, pa + k0);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      bf16mma::ldmatrix_x4(b, pb + np * 16 * lda + k0);
      bf16mma::mma_bf16(acc[2 * np], a, b[0], b[1]);
      bf16mma::mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Per split (blockIdx.y) and query: the K smallest keys over train rows
// [split*rows_per_split, min((split+1)*rows_per_split, n_valid)), as
// partial_topk_kernel<K, L2, MODE> on q and t, the pre-pass's rounded
// copies. With PROFILE, lane 0 of each warp adds the warp's clock64()
// cycles in each of the SECTIONS to sections[] (a diagnostic instance).
template <int K, int MODE, bool PROFILE>
__global__ void __launch_bounds__(THREADS, 1)
partial_topk_mma_kernel(const float* __restrict__ q,
                        const float* __restrict__ t,
                        const float* __restrict__ qn_g,
                        const float* __restrict__ tn_g,
                        const int* __restrict__ labels, int nq, int d,
                        int n_valid, int rows_per_split, int stage_rows,
                        int stages, int pack_mask, int empty_key,
                        int* __restrict__ part_key, int* __restrict__ part_idx,
                        unsigned long long* __restrict__ sections) {
  constexpr int QPT = qpt<K>();
  constexpr int BQK = block_queries<K>();
  constexpr int WARPS_M = BQK >= 64 ? 4 : 2;   // warps along the queries
  constexpr int WARPS_N = 4 / WARPS_M;         // ... along a tile's rows
  constexpr int MT = BQK / WARPS_M / 16;       // m16 tiles a warp
  constexpr int NT = TT / WARPS_N / 8;         // n8 tiles a warp
  static_assert(WARPS_M * WARPS_N * 32 == THREADS && MT >= 1 && NT % 2 == 0,
                "warp tiling");
  extern __shared__ float4 smem[];
  const int dp = depth16(d);
  const int lda = dp + MMA_PAD;            // halves between bf16 rows
  const int sf = 4 * row_stride4(d);       // floats between staged rows
  float* v_s = reinterpret_cast<float*>(smem);            // [2][BQK][V_STRIDE]
  __nv_bfloat16* q_s =
      reinterpret_cast<__nv_bfloat16*>(v_s + 2 * BQK * V_STRIDE);  // [BQK][lda]
  __nv_bfloat16* tb_s = q_s + (size_t)BQK * lda;          // [stage_rows][lda]
  float* t_s = reinterpret_cast<float*>(tb_s + (size_t)stage_rows * lda);
  float* tn_s = t_s + (size_t)stages * stage_rows * sf;   // [stages][rows]
  int* lab_s = reinterpret_cast<int*>(tn_s + stages * stage_rows);

  const int tid = threadIdx.x;
  const int tc = tid % TC;
  const int tr = tid / TC;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = blockIdx.x * BQK;
  const int row0 = blockIdx.y * rows_per_split;
  const int row_end = min(row0 + rows_per_split, n_valid);
  const int n_stages = (row_end - row0 + stage_rows - 1) / stage_rows;

  long long clk[SECTIONS] = {};
  long long c0 = PROFILE ? clock64() : 0;
  auto tick = [&](int s) {
    if constexpr (PROFILE) {
      const long long c1 = clock64();
      clk[s] += c1 - c0;
      c0 = c1;
    }
  };

  if (stages == 2 && n_stages > 0) {       // the first stage's copy flies
    load_stage<true, MODE>(t_s, tn_s, lab_s, t, tn_g, labels, d, sf, row0,
                           min(stage_rows, row_end - row0));
    cp_async_commit();
  }
  // this block's queries as bf16, zeros past d and past nq
  const int hq = dp / 2;
  for (int e = tid; e < BQK * hq; e += THREADS) {
    const int r = e / hq;
    const int f = 2 * (e - r * hq);
    const bool in = q0 + r < nq;
    const float* src = q + (size_t)(in ? q0 + r : 0) * d;
    const float x0 = in && f < d ? src[f] : 0.f;
    const float x1 = in && f + 1 < d ? src[f + 1] : 0.f;
    *reinterpret_cast<uint32_t*>(q_s + r * lda + f) = bf16mma::pack_bf16(x0, x1);
  }
  float qn[QPT];
  int lim[QPT];
  Carry<K> best[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int qi = q0 + tr + TR * i;
    qn[i] = qi < nq ? qn_g[qi] : 0.f;
    lim[i] = empty_key;
    best[i].init(empty_key);
  }
  tick(1);

  const __nv_bfloat16* qa = q_s + wm * MT * 16 * lda;
  int buf = 0;
  for (int it = 0; it < n_stages; ++it) {
    const int sbase = row0 + it * stage_rows;
    const int srows = min(stage_rows, row_end - sbase);
    const int slot = stages == 2 ? (it & 1) : 0;
    if (stages == 1) {                     // the stage is free once all read it
      __syncthreads();
      load_stage<true, MODE>(t_s, tn_s, lab_s, t, tn_g, labels, d, sf, sbase,
                             srows);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();    // the copies landed; every warp left the last stage
    if (stages == 2 && it + 1 < n_stages) {
      // the other slot was packed in the last stage, which all have left
      const int nb = sbase + stage_rows;
      const int o = (it + 1) & 1;
      load_stage<true, MODE>(t_s + (size_t)o * stage_rows * sf,
                             tn_s + o * stage_rows, lab_s + o * stage_rows, t,
                             tn_g, labels, d, sf, nb,
                             min(stage_rows, row_end - nb));
      cp_async_commit();
    }
    tick(0);
    pack_rows(tb_s, lda, t_s + (size_t)slot * stage_rows * sf, sf, d, srows);
    __syncthreads();                       // the packed rows are visible
    tick(1);
    const float* tns = tn_s + slot * stage_rows;
    const int* labs = lab_s + slot * stage_rows;
    for (int tb = 0; tb < srows; tb += TT) {
      // each m16 tile's fragments into this tile's v buffer, one after
      // another (fewer live registers): the other buffer was read before
      // the last tile's barrier, which every thread has passed
      float* vt = v_s + buf * BQK * V_STRIDE;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float acc[NT][4];
        cross_tile<NT>(acc, qa + mt * 16 * lda,
                       tb_s + (tb + wn * NT * 8) * lda, lda, dp, lane);
        tick(2);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float* p = vt + (wm * MT * 16 + mt * 16 + g) * V_STRIDE +
                     wn * NT * 8 + nt * 8 + 2 * tg;
          *reinterpret_cast<float2*>(p) = make_float2(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<float2*>(p + 8 * V_STRIDE) =
              make_float2(acc[nt][2], acc[nt][3]);
        }
        tick(3);
      }
      __syncthreads();                     // the tile's v is visible
      tick(3);
      float v[QPT][TPT];
#pragma unroll
      for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int j = 0; j < TPT; ++j)
          v[i][j] = vt[(tr + TR * i) * V_STRIDE + tc + TC * j];
      const int base = sbase + tb;
      if (base + TT <= row_end)
        select_tile<false, true, MODE>(best, v, qn, lim, tns + tb, labs + tb,
                                       tc, base, row_end, pack_mask);
      else
        select_tile<true, true, MODE>(best, v, qn, lim, tns + tb, labs + tb,
                                      tc, base, row_end, pack_mask);
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        int w = best[i].worst();
        w = min(w, __shfl_xor_sync(0xffffffffu, w, 1));
        lim[i] = min(w, __shfl_xor_sync(0xffffffffu, w, 2));
      }
      buf ^= 1;
      tick(4);
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
  if constexpr (PROFILE) {
    tick(5);
    if (lane == 0)
      for (int s = 0; s < SECTIONS; ++s)
        atomicAdd(sections + s, (unsigned long long)clk[s]);
  }
}

template <int K, int MODE, bool PROFILE = false>
cudaError_t launch_partial_mma(const float* q, const float* t, const float* qn,
                               const float* tn, const int* labels, int nq,
                               int d, int n_valid, int splits,
                               int rows_per_split, int pack_mask,
                               int empty_key, int* part_key, int* part_idx,
                               unsigned long long* sections,
                               cudaStream_t stream) {
  auto* fn = &partial_topk_mma_kernel<K, MODE, PROFILE>;
  StagePlan plan = mma_stage_plan<K>(d);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return err;
  if (rows_per_split % plan.rows) return cudaErrorInvalidValue;
  void* args[] = {(void*)&q,          (void*)&t,          (void*)&qn,
                  (void*)&tn,         (void*)&labels,     (void*)&nq,
                  (void*)&d,          (void*)&n_valid,    (void*)&rows_per_split,
                  (void*)&plan.rows,  (void*)&plan.stages, (void*)&pack_mask,
                  (void*)&empty_key,  (void*)&part_key,   (void*)&part_idx,
                  (void*)&sections};
  const dim3 grid((nq + block_queries<K>() - 1) / block_queries<K>(), splits);
  return cudaLaunchKernel(fn, grid, dim3(THREADS), args, plan.smem, stream);
}

// info[6] of the tensor-core instance for (K, MODE) at D features, as
// partial_info: blocks per SM, registers, local bytes, and its plan.
template <int K, int MODE>
cudaError_t partial_mma_info(int d, int* info) {
  auto* fn = &partial_topk_mma_kernel<K, MODE, false>;
  const StagePlan plan = mma_stage_plan<K>(d);
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

}  // namespace knn
