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
// and row n supports c when ptr reaches k_vec[c] > 0. The pointer takes
// the leftmost match each time, so the row supports c exactly when each
// step j < k finds code min(j, kmax - 1) at a position after step j - 1's.
// A negative code can never be matched, and k > t can never be reached.
// Each block's thread holds one candidate; each thread ends with one
// integer atomicAdd of its count, so the counts equal the plain version's
// bit for bit in any order.
//
// Two routes, chosen by the launcher from the shape before the launch:
//
// The mask route (t <= 64, and the tables fit; subseq_support_mask_kernel).
// For each staged row, a table in shared memory indexed by token code holds
// the bitmask of the positions where that code stands (uint32 for t <= 32,
// uint64 for t <= 64). A warp builds a row's table once: lane i takes
// position i (and i + 32), __match_any_sync merges the lanes of one token,
// and the lowest of them stores the mask. Every candidate of the block
// reuses it. A candidate is then k lookups, with no branch and no break:
//   m = table[code_0];  m = table[code_j] & ~(m ^ (m - 1))  for j = 1..k-1
// (~(m ^ (m - 1)) keeps the positions after m's lowest, and 0 once m is
// 0), and the row counts when the last m is not 0. The tables of GROUP
// rows are built at once, in two buffers: while the block tests one group,
// its warps clear the group before and build the next, so the block syncs
// once a group. Entries lie [code][row]; lane l reads row (l + s) % 32 at
// step s, so the 32 lanes of a warp read 32 banks whatever their codes.
// Up to 4 steps the codes' offsets sit in registers and the steps unroll;
// longer candidates read them from shared memory. The code range n_codes
// (1 + the largest code, from the host) sizes the tables; a row token at
// or above it, or -1, is left out; a used code at or above it traps.
//
// The walk route (t > 64, or tables too large; subseq_support_kernel):
// each thread walks a tile of rows staged in shared memory, every thread
// reading the same token at once (a broadcast), comparing it with its
// expected code and, on a hit, loading the next from shared memory
// (codes transposed, no bank conflict). A walk ends at the row's last
// token (1 + the index of its last non-negative token, found once a row),
// at k, or at a negative code.
//
// What bounds it: operations. The mask route makes k lookups a (row, live
// candidate) pair (`ops/sequence_kernels.lookup_steps`); the walk route one
// compare a (row token, candidate) pair up to the row's last token, at
// most (`walk_steps`). The bytes are the rows, the candidates and the
// counts, each read or written once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// walk route: rows a tile at most, and the int32 tokens a staged tile
// holds (32 KB)
constexpr int ROWS = 256;
constexpr int STAGE_TOKENS = 8192;
// mask route: rows a table group (one a lane), the rows a warp builds, the
// steps whose codes sit in registers, the shared bytes a block at most (two
// blocks an SM)
constexpr int GROUP = 32;
constexpr int GROUP_ROWS = GROUP / WARPS;
constexpr int REG_STEPS = 4;
constexpr int MASK_SMEM = 113 * 1024;

enum Route { WALK = 0, MASK32 = 1, MASK64 = 2 };

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

// ------------------------------------------------------------ mask route
// The tokens of a group's rows that this warp builds: row slot
// warp + q * WARPS, positions lane and lane + 32 (-1 past the row or n).
template <typename M>
__device__ __forceinline__ void load_group(int (&tk)[GROUP_ROWS][2],
                                           const int* __restrict__ rows,
                                           int n, int t, long long group,
                                           int warp, int lane) {
#pragma unroll
  for (int q = 0; q < GROUP_ROWS; ++q) {
    const long long r = group * GROUP + warp + q * WARPS;
    tk[q][0] = tk[q][1] = -1;
    if (r < n) {
      const int* row = rows + r * t;
      if (lane < t) tk[q][0] = row[lane];
      if (sizeof(M) == 8 && lane + 32 < t) tk[q][1] = row[lane + 32];
    }
  }
}

// The position masks of those rows into tb ([n_codes][GROUP], all 0 there)
template <typename M>
__device__ __forceinline__ void set_group(M* tb, const int (&tk)[GROUP_ROWS][2],
                                          int n_codes, int warp, int lane) {
  const unsigned lower = (1u << lane) - 1;
#pragma unroll
  for (int q = 0; q < GROUP_ROWS; ++q) {
    const int slot = warp + q * WARPS;
    const int a = tk[q][0];
    const bool va = (unsigned)a < (unsigned)n_codes;
    const unsigned pa = __match_any_sync(FULL, va ? a : -1);
    if (va && (pa & lower) == 0) tb[(size_t)a * GROUP + slot] = (M)pa;
    if constexpr (sizeof(M) == 8) {
      const int b = tk[q][1];
      const bool vb = (unsigned)b < (unsigned)n_codes;
      const unsigned pb = __match_any_sync(FULL, vb ? b : -1);
      __syncwarp();
      if (vb && (pb & lower) == 0) tb[(size_t)b * GROUP + slot] |= (M)pb << 32;
    }
  }
}

template <typename M>
__device__ __forceinline__ void clear_group(M* tb,
                                            const int (&tk)[GROUP_ROWS][2],
                                            int n_codes, int warp) {
#pragma unroll
  for (int q = 0; q < GROUP_ROWS; ++q) {
    const int slot = warp + q * WARPS;
#pragma unroll
    for (int h = 0; h < (sizeof(M) == 8 ? 2 : 1); ++h)
      if ((unsigned)tk[q][h] < (unsigned)n_codes)
        tb[(size_t)tk[q][h] * GROUP + slot] = 0;
  }
}

// The rows of a group holding this thread's candidate of K steps, whose
// codes' byte offsets are off[0..K-1]
template <typename M, int K>
__device__ __forceinline__ int test_group(const M* tb,
                                          const int (&off)[REG_STEPS],
                                          int lane) {
  const char* base = reinterpret_cast<const char*>(tb);
  int count = 0;
#pragma unroll 8
  for (int s = 0; s < GROUP; ++s) {
    const char* row = base + ((lane + s) & (GROUP - 1)) * sizeof(M);
    M m = *reinterpret_cast<const M*>(row + off[0]);
#pragma unroll
    for (int j = 1; j < K; ++j)
      m = *reinterpret_cast<const M*>(row + off[j]) & ~(m ^ (m - 1));
    count += m != 0;
  }
  return count;
}

// The same for any k: the offsets of step j in s_off[min(j, kmax - 1)]
template <typename M>
__device__ int test_group_any(const M* tb, const int* s_off, int k, int kmax,
                              int lane) {
  const char* base = reinterpret_cast<const char*>(tb);
  int count = 0;
  for (int s = 0; s < GROUP; ++s) {
    const char* row = base + ((lane + s) & (GROUP - 1)) * sizeof(M);
    M m = *reinterpret_cast<const M*>(row + s_off[0]);
    for (int j = 1; j < k; ++j)
      m = *reinterpret_cast<const M*>(row + s_off[min(j, kmax - 1) * THREADS]) &
          ~(m ^ (m - 1));
    count += m != 0;
  }
  return count;
}

template <typename M>
__global__ void __launch_bounds__(THREADS)
subseq_support_mask_kernel(const int* __restrict__ rows, int n, int t,
                   const int* __restrict__ cands, int c, int kmax,
                   const int* __restrict__ k_vec, int n_codes,
                   int groups_per_block, int* __restrict__ acc) {
  extern __shared__ __align__(16) unsigned char mask_smem[];
  M* tables = reinterpret_cast<M*>(mask_smem);   // [2][n_codes][GROUP]
  int* s_off = reinterpret_cast<int*>(tables + 2 * (size_t)n_codes * GROUP);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cand = blockIdx.y * THREADS + tid;
  const size_t entries = (size_t)n_codes * GROUP;

  // the candidate's steps (0 if it can never count: a length of 0 or
  // less, past t, or a negative code among its steps) and its codes'
  // byte offsets into a table
  int k = cand < c ? k_vec[cand] : 0;
  if (k < 0 || k > t) k = 0;
  bool above = false;
  for (int j = 0; j < kmax; ++j) {
    const int code = k > 0 ? cands[(size_t)cand * kmax + j] : 0;
    if (j < k && code < 0) k = 0;
    above |= j < k && code >= n_codes;
    s_off[j * THREADS + tid] =
        (unsigned)code < (unsigned)n_codes ? code * GROUP * (int)sizeof(M) : 0;
  }
  if (k > 0 && above) __trap();   // n_codes below a code: a caller's fault
  int off[REG_STEPS];
#pragma unroll
  for (int j = 0; j < REG_STEPS; ++j)
    off[j] = s_off[min(j, kmax - 1) * THREADS + tid];
  for (size_t i = tid; i < 2 * entries; i += THREADS) tables[i] = 0;

  const long long groups = ((long long)n + GROUP - 1) / GROUP;
  const long long g0 = (long long)blockIdx.x * groups_per_block;
  const int ng = (int)min((long long)groups_per_block, groups - g0);
  int next[GROUP_ROWS][2], last[GROUP_ROWS][2];
  load_group<M>(next, rows, n, t, g0, warp, lane);
  __syncthreads();
  set_group(tables, next, n_codes, warp, lane);
  __syncthreads();
  int count = 0;
  for (int i = 0; i < ng; ++i) {
    const M* cur = tables + (i & 1) * entries;
    M* other = tables + ((i + 1) & 1) * entries;
    const bool more = i + 1 < ng;
    // the loads of the next group (and of the last, to clear) are in
    // flight while this group is tested
    if (more) {
      load_group<M>(next, rows, n, t, g0 + i + 1, warp, lane);
      if (i > 0) load_group<M>(last, rows, n, t, g0 + i - 1, warp, lane);
    }
    switch (k) {
      case 0: break;
      case 1: count += test_group<M, 1>(cur, off, lane); break;
      case 2: count += test_group<M, 2>(cur, off, lane); break;
      case 3: count += test_group<M, 3>(cur, off, lane); break;
      case 4: count += test_group<M, 4>(cur, off, lane); break;
      default: count += test_group_any<M>(cur, s_off + tid, k, kmax, lane);
    }
    if (more) {
      if (i > 0) clear_group(other, last, n_codes, warp);
      __syncwarp();
      set_group(other, next, n_codes, warp, lane);
    }
    __syncthreads();
  }
  if (count > 0) atomicAdd(acc + cand, count);
}

// The route of a call, and the mask route's shared bytes
int route_of(int t, int kmax, int n_codes, size_t* smem) {
  if (t > 64 || n_codes < 0) return WALK;
  const size_t entry = t <= 32 ? 4 : 8;
  *smem = 2 * (size_t)n_codes * GROUP * entry + (size_t)kmax * THREADS * 4;
  if (*smem > (size_t)MASK_SMEM) return WALK;
  return t <= 32 ? MASK32 : MASK64;
}

int grid_shape(int units, int c, int* per_block, dim3* grid) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // about 16 blocks an SM in all: a block takes several units (tiles or
  // groups of rows) when the rows would give more, so its candidates are
  // read and counted once
  const int grid_y = (c + THREADS - 1) / THREADS;
  const int want_x = max(1, (sms * 16 + grid_y - 1) / grid_y);
  *per_block = (units + want_x - 1) / want_x;
  *grid = dim3((units + *per_block - 1) / *per_block, grid_y);
  return 0;
}

int launch_mask(const int* rows, int n, int t, const int* cands, int c,
                int kmax, const int* k_vec, int n_codes, int* acc, int route,
                size_t smem, cudaStream_t stream) {
  const void* fn =
      route == MASK32 ? (const void*)&subseq_support_mask_kernel<uint32_t>
                      : (const void*)&subseq_support_mask_kernel<uint64_t>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_block;
  dim3 grid;
  grid_shape((n + GROUP - 1) / GROUP, c, &per_block, &grid);
  void* args[] = {(void*)&rows,  (void*)&n,       (void*)&t,
                  (void*)&cands, (void*)&c,       (void*)&kmax,
                  (void*)&k_vec, (void*)&n_codes, (void*)&per_block,
                  (void*)&acc};
  err = cudaLaunchKernel(fn, grid, dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_walk(const int* rows, int n, int t, const int* cands, int c,
                int kmax, const int* k_vec, int* acc, cudaStream_t stream) {
  const bool staged = t <= STAGE_TOKENS;
  const int tile_rows = staged ? max(1, min(ROWS, STAGE_TOKENS / t)) : ROWS;
  const size_t smem = sizeof(int) * ((size_t)kmax * THREADS + tile_rows
                                     + (staged ? (size_t)tile_rows * t : 0));
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  const void* fn = staged ? (const void*)&subseq_support_kernel<true>
                          : (const void*)&subseq_support_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int tiles_per_block;
  dim3 grid;
  grid_shape((n + tile_rows - 1) / tile_rows, c, &tiles_per_block, &grid);
  void* args[] = {(void*)&rows,      (void*)&n,     (void*)&t,
                  (void*)&cands,     (void*)&c,     (void*)&kmax,
                  (void*)&k_vec,     (void*)&tile_rows,
                  (void*)&tiles_per_block, (void*)&acc};
  err = cudaLaunchKernel(fn, grid, dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows int32 [n, t], cands int32 [c, kmax], k_vec int32 [c], acc int32 [c],
// all row-major on the device; n_codes is 1 + the largest code in cands
// (or more). Adds each candidate's count into acc on `stream`, on the
// route subseq_support_route gives. Returns a cudaError_t:
// cudaErrorInvalidValue for a shape the kernel cannot stage (kmax codes a
// candidate beyond shared memory) or a negative n_codes.
int subseq_support_launch(const int* rows, int n, int t, const int* cands,
                          int c, int kmax, const int* k_vec, int n_codes,
                          int* acc, void* stream) {
  if (n_codes < 0) return (int)cudaErrorInvalidValue;
  if (n <= 0 || c <= 0 || t <= 0) return 0;
  if (kmax <= 0) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  const int route = route_of(t, kmax, n_codes, &smem);
  if (route == WALK)
    return launch_walk(rows, n, t, cands, c, kmax, k_vec, acc,
                       (cudaStream_t)stream);
  return launch_mask(rows, n, t, cands, c, kmax, k_vec, n_codes, acc, route,
                     smem, (cudaStream_t)stream);
}

// The route a launch at (t, kmax, n_codes) takes: 0 the walk, 1 the mask
// route with uint32 masks, 2 with uint64 masks.
int subseq_support_route(int t, int kmax, int n_codes) {
  size_t smem = 0;
  return route_of(t, kmax, n_codes, &smem);
}

// Registers and local (spill) bytes a thread of one kernel, for the smoke
// run's spill check: which 0 the staged walk, 1 the walk from global
// memory, 2 the uint32 mask kernel, 3 the uint64 one; out[0] registers,
// out[1] local bytes.
int subseq_support_info(int which, int* out) {
  const void* fns[] = {(const void*)&subseq_support_kernel<true>,
                       (const void*)&subseq_support_kernel<false>,
                       (const void*)&subseq_support_mask_kernel<uint32_t>,
                       (const void*)&subseq_support_mask_kernel<uint64_t>};
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
