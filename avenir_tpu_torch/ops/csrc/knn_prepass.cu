// Pre-pass of the euclidean KNN kernels on Hopper (sm_90a): row norms and
// bfloat16 operand rows, once per call, before the partial kernel.
//
// Part of the port of avenir_tpu/ops/pallas_knn.py's euclidean kernels
// (_knn_kernel, _knn_kernel_lanes, _knn_kernel_lanes_vote,
// _knn_kernel_packed), whose dot form |q|^2 + |t|^2 - 2 q.t takes the
// norms of the fp32 values and, with compute_dtype="bfloat16", the cross
// term of operands rounded to bfloat16 (pallas_knn.py:54-70). The TPU
// kernels compute both inside each tile; here one launch over the rows of
// q and then of t does it for the whole call:
//   norm[r]      = fmaf chain over features 0..D-1 of x[r, f]^2, from 0.0
//                  (the order the partial kernel used to take it in), of
//                  the fp32 values, never the rounded ones
//   rounded[r, f] = x[r, f] rounded to bfloat16 (nearest even) for f < D,
//                  0 for D <= f < depth16(D): rows of depth16(D) bf16
//                  values (a pitch of 32-byte multiples, as TMA's tensor
//                  maps take it), written only when bf16 = 1.
// The partial kernels then read operands and norms and spend no barrier,
// no idle thread and no rounding on them per tile: the CUDA-core form
// (knn_tile.cuh) the fp32 values, the tensor-core form (knn_tile_mma.cuh)
// the bf16 rows, which its TMA copies as they lie.
//
// What bounds it: bytes, (nq + nt) * D * 4 read and, with bf16, (nq + nt)
// * depth16(D) * 2 written. A block takes ROWS rows of one operand and
// walks their features in chunks of up to CHUNK: its threads read a chunk
// of the rows in address order (coalesced), write the bf16 values from
// the same loads, and stage the values in shared memory at an odd row
// stride (then the rows' zero padding); then
// one thread a row continues that row's fmaf chain over the chunk from
// shared memory without bank conflicts, so the chain keeps feature order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 32;
constexpr int CHUNK = 128;

__global__ void __launch_bounds__(THREADS)
prepass_kernel(const float* __restrict__ q, int nq,
               const float* __restrict__ t, int nt, int d, int dp, int bf16,
               float* __restrict__ qn, float* __restrict__ tn,
               __nv_bfloat16* __restrict__ q_r,
               __nv_bfloat16* __restrict__ t_r) {
  __shared__ float tile[ROWS * (CHUNK + 1)];
  const int q_blocks = (nq + ROWS - 1) / ROWS;
  const bool is_q = (int)blockIdx.x < q_blocks;
  const int row0 = (is_q ? blockIdx.x : blockIdx.x - q_blocks) * ROWS;
  const int n = min(ROWS, (is_q ? nq : nt) - row0);
  const float* x = (is_q ? q : t) + (size_t)row0 * d;
  __nv_bfloat16* xr = (is_q ? q_r : t_r) + (size_t)row0 * dp;
  float s = 0.f;
  for (int f0 = 0; f0 < d; f0 += CHUNK) {
    const int fc = min(CHUNK, d - f0);
    const int stride = fc | 1;
    for (int i = threadIdx.x; i < n * fc; i += THREADS) {
      const int r = i / fc, f = i - r * fc;
      const float v = x[(size_t)r * d + f0 + f];
      tile[r * stride + f] = v;
      if (bf16) xr[(size_t)r * dp + f0 + f] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    if ((int)threadIdx.x < n) {
      const float* row = tile + threadIdx.x * stride;
      for (int f = 0; f < fc; ++f) s = fmaf(row[f], row[f], s);
    }
    __syncthreads();
  }
  if ((int)threadIdx.x < n) (is_q ? qn : tn)[row0 + threadIdx.x] = s;
  const int pad = dp - d;                  // the zeros past d
  if (bf16)
    for (int i = threadIdx.x; i < n * pad; i += THREADS) {
      const int r = i / pad;
      xr[(size_t)r * dp + d + i - r * pad] = __float2bfloat16_rn(0.f);
    }
}

}  // namespace

extern "C" {

// q [nq, d], t [nt, d] fp32 row-major on the device. Writes qn [nq] and
// tn [nt], and with bf16 = 1 the bf16 rows q_r [nq, dp] and t_r [nt, dp],
// dp = d rounded up to 16 (else they may be null). Returns
// cudaGetLastError().
int knn_prepass_launch(const float* q, int nq, const float* t, int nt, int d,
                       int bf16, float* qn, float* tn, void* q_r, void* t_r,
                       void* stream) {
  const int blocks = (nq + ROWS - 1) / ROWS + (nt + ROWS - 1) / ROWS;
  if (blocks == 0) return 0;
  int dp = (d + 15) / 16 * 16;
  void* args[] = {(void*)&q,  (void*)&nq,   (void*)&t,  (void*)&nt,
                  (void*)&d,  (void*)&dp,   (void*)&bf16, (void*)&qn,
                  (void*)&tn, (void*)&q_r,  (void*)&t_r};
  cudaError_t err = cudaLaunchKernel(&prepass_kernel, dim3(blocks),
                                     dim3(THREADS), args, 0,
                                     (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// 1: this pre-pass writes its bf16 operands as bf16 rows of depth16(d)
// values (an earlier one wrote fp32 copies of d values and lacks the
// entry); tools/knn_ab.py reads it to size an earlier build's buffers.
int knn_prepass_rows16() { return 1; }

}  // extern "C"
