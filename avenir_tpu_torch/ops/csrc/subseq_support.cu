// Subsequence support count of GSP on Hopper (sm_90a).
//
// The port of the XLA scan `_subseq_support_kernel` and its donated fold
// `_subseq_fold_kernel` (avenir_tpu/models/sequence.py:84-122): for rows
// int32 [n, t] (pad -1) and candidates int32 [c, kmax] of length k_vec[c]
// (pad -2), add to acc[c] the rows that hold candidate c as an
// order-preserving, not necessarily contiguous, subsequence. The reference
// walks the t time steps with a pointer ptr[n, c], the next candidate
// position to match:
//   expect = cands[c, min(ptr, kmax - 1)]
//   hit    = tok == expect  and  ptr < k_vec[c]  and  tok >= 0
// and row n supports c when ptr reaches k_vec[c] > 0. A pointer only ever
// steps by one, so "reaches k" is decided the moment it gets there, and
// a negative code (candidate pad, a token the source never saw) can never
// be matched, so a walk that meets one is over.
//
// The reference keeps the [n, c] pointers as a scan carry; here each lives
// in a register. A block of THREADS threads takes THREADS candidates, one
// a thread, with their codes staged in shared memory transposed (a hit
// reads the next code without a bank conflict), and walks a tile of rows
// staged in shared memory: every thread reads the same token at once (a
// broadcast), compares it with its own expected code and, on a hit, loads
// the next. A walk ends at the row's last token (1 + the index of its last
// non-negative token, found once a row), at k, or at a negative code. Each
// thread ends with one integer atomicAdd of its count: integer sums are
// exact in any order, so the counts equal the plain version's bit for bit.
//
// What bounds it: operations. A call makes one compare a (row token,
// candidate) pair up to the row's last token, at most; its bytes are the
// rows, the candidates and the counts, each read or written once.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// rows a tile at most, and the int32 tokens a staged tile holds (32 KB)
constexpr int ROWS = 256;
constexpr int STAGE_TOKENS = 8192;

__device__ __forceinline__ int row_length(const int* row, int t) {
  int len = t;
  while (len > 0 && row[len - 1] < 0) --len;
  return len;
}

// STAGED: the tile's rows are copied to shared memory (t <= STAGE_TOKENS);
// otherwise each walk reads its row from global memory.
template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
subseq_support_kernel(const int* __restrict__ rows, int n, int t,
                      const int* __restrict__ cands, int c, int kmax,
                      const int* __restrict__ k_vec, int tile_rows,
                      int tiles_per_block, int* __restrict__ acc) {
  extern __shared__ int smem[];
  int* s_cand = smem;                          // [kmax][THREADS]
  int* s_len = s_cand + kmax * THREADS;        // [tile_rows]
  int* s_rows = s_len + tile_rows;             // [tile_rows][t], STAGED
  const int c0 = blockIdx.y * THREADS;
  const int cand = c0 + threadIdx.x;
  for (int i = threadIdx.x; i < kmax * THREADS; i += THREADS) {
    const int j = i / THREADS, cc = c0 + i % THREADS;
    int v = -2;
    if (cc < c) {
      v = cands[(size_t)cc * kmax + j];
      if (v < 0) v = -2;
    }
    s_cand[i] = v;
  }
  const int k = cand < c ? k_vec[cand] : 0;
  __syncthreads();
  const int first = s_cand[threadIdx.x];
  const bool live = k > 0 && first >= 0;
  int count = 0;
  const int tile0 = blockIdx.x * tiles_per_block;
  for (int tile = tile0; tile < tile0 + tiles_per_block; ++tile) {
    const int row0 = tile * tile_rows;
    if (row0 >= n) break;
    const int nr = min(tile_rows, n - row0);
    const int* g = rows + (size_t)row0 * t;
    if (STAGED) {
      const int tokens = nr * t;
      for (int i = threadIdx.x; i < tokens; i += THREADS) s_rows[i] = g[i];
      __syncthreads();
      if ((int)threadIdx.x < nr)
        s_len[threadIdx.x] = row_length(s_rows + threadIdx.x * t, t);
    } else if ((int)threadIdx.x < nr) {
      s_len[threadIdx.x] = row_length(g + (size_t)threadIdx.x * t, t);
    }
    __syncthreads();
    if (live) {
      for (int r = 0; r < nr; ++r) {
        const int len = s_len[r];
        const int* tok = STAGED ? s_rows + r * t : g + (size_t)r * t;
        int p = 0, e = first;
        for (int i = 0; i < len; ++i) {
          if (tok[i] == e) {
            if (++p == k) break;
            e = s_cand[min(p, kmax - 1) * THREADS + threadIdx.x];
            if (e < 0) break;
          }
        }
        count += p == k;
      }
    }
    __syncthreads();
  }
  if (count > 0) atomicAdd(acc + cand, count);
}

}  // namespace

extern "C" {

// rows int32 [n, t], cands int32 [c, kmax], k_vec int32 [c], acc int32 [c],
// all row-major on the device; adds each candidate's count into acc on
// `stream`. Returns a cudaError_t: cudaErrorInvalidValue for a shape the
// kernel cannot stage (kmax codes a candidate beyond shared memory).
int subseq_support_launch(const int* rows, int n, int t, const int* cands,
                          int c, int kmax, const int* k_vec, int* acc,
                          void* stream) {
  if (n <= 0 || c <= 0 || t <= 0) return 0;
  if (kmax <= 0) return (int)cudaErrorInvalidValue;
  const bool staged = t <= STAGE_TOKENS;
  const int tile_rows = staged ? max(1, min(ROWS, STAGE_TOKENS / t)) : ROWS;
  const size_t smem = sizeof(int) * ((size_t)kmax * THREADS + tile_rows
                                     + (staged ? (size_t)tile_rows * t : 0));
  int dev = 0, sms = 1, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  const void* fn = staged ? (const void*)&subseq_support_kernel<true>
                          : (const void*)&subseq_support_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // about 16 blocks an SM in all: a block walks several tiles when the
  // rows would give more, so its candidates are staged and counted once
  const int grid_y = (c + THREADS - 1) / THREADS;
  const int tiles = (n + tile_rows - 1) / tile_rows;
  const int want_x = max(1, (sms * 16 + grid_y - 1) / grid_y);
  const int tiles_per_block = (tiles + want_x - 1) / want_x;
  const int grid_x = (tiles + tiles_per_block - 1) / tiles_per_block;
  void* args[] = {(void*)&rows,      (void*)&n,     (void*)&t,
                  (void*)&cands,     (void*)&c,     (void*)&kmax,
                  (void*)&k_vec,     (void*)&tile_rows,
                  (void*)&tiles_per_block, (void*)&acc};
  err = cudaLaunchKernel(fn, dim3(grid_x, grid_y), dim3(THREADS), args, smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Registers and local (spill) bytes a thread of the staged kernel, for
// the smoke run's spill check: out[0] registers, out[1] local bytes.
int subseq_support_info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, subseq_support_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
