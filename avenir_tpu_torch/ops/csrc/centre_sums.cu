// The centre sums of k-means' Lloyd step, in row order, on Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the port of `jax.ops.segment_sum(x,
// assign, num_segments=k)` in the XLA program `_kmeans_step`
// (avenir_tpu/models/cluster.py:43). XLA's CPU build lowers that
// scatter-add to a serial loop over the rows, so sums[c, j] is a chain of
// float32 adds, from +0, of x[i, j] over the rows i with assign[i] == c,
// in row order. Float addition does not associate: no parallel split of
// a chain gives its bits, and float atomics add in an order that changes
// from run to run. So each (cluster, column) chain is one thread here,
// and the k x d chains run side by side; the centres, and the labels of
// every later step, are then the reference's bit for bit.
//
// A block takes up to CHAINS chains, ordered column-major (chain q is
// column q / k, cluster q % k), so it reads only its own columns of x.
// Its warps that hold no chain stage tiles of those columns and of the
// int32 labels into shared memory with cp.async, in two buffers: while
// the chain threads add tile t, the copies of tile t + 1 are in flight.
// A chain thread reads each row's label (every thread the same word, a
// broadcast) and its column's value, and adds the value when the label is
// its cluster, else +0 (the same bits, and no branch). It loads rows in
// sets of UNROLL into two register sets, the next set's loads issued
// before this set's adds, so the chain never waits on shared memory.
//
// What bounds it: the chain, not the bytes or the adds. x and the labels
// read once take about 10 us at 1,000,000 x 6 on an H100, and the adds
// needed are n x d; but every chain walks all n rows, and the one warp
// that holds the chains issues five instructions a row (two loads, a
// compare, a select, the add): about 14 cycles a row on an H100, some
// 7 ms a call at 1,000,000 rows (`tools/centre_sums_probe.py` times the
// parts). A per-cluster compacted walk would cut a chain to its own
// cluster's rows.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// chains a block at most: every thread may hold one
constexpr int CHAINS = THREADS;
// shared bytes of the two staging buffers, and the rows a tile at most
constexpr int STAGE_BYTES = 128 * 1024;
constexpr int MAX_TILE = 4096;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

constexpr int UNROLL = 16;

__device__ __forceinline__ void load_set(const int* lab, const float* xs,
                                         int width, int r, int* l, float* v) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    l[u] = lab[r + u];
    v[u] = xs[(r + u) * width];
  }
}

// A row of another cluster adds +0, which leaves acc as it is: acc starts
// at +0 and a float sum is -0 only when both terms are, so acc is never -0.
__device__ __forceinline__ void add_set(const int* l, const float* v,
                                        int cluster, float& acc) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) acc += l[u] == cluster ? v[u] : 0.0f;
}

__global__ void __launch_bounds__(THREADS)
centre_sums_kernel(const float* __restrict__ x, int n, int d,
                   const int* __restrict__ assign, int k, int tile_rows,
                   int width, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_lab = reinterpret_cast<int*>(smem);  // [2][tile_rows]
  float* s_x = reinterpret_cast<float*>(s_lab + 2 * tile_rows);
  // s_x: [2][tile_rows][width], this block's columns jlo.. of each row
  const int q0 = blockIdx.x * CHAINS;
  const int nq = min(CHAINS, k * d - q0);
  const int jlo = q0 / k;
  const int w = (q0 + nq - 1) / k - jlo + 1;
  const int tiles = (n + tile_rows - 1) / tile_rows;
  // the warps past the chains' stage the tiles (all warps, when the
  // chains fill the block), so the chains' warps only add
  const int lo = (nq + 31) / 32 * 32 < THREADS ? (nq + 31) / 32 * 32 : 0;

  auto stage = [&](int tile) {
    const int buf = tile & 1;
    const int row0 = tile * tile_rows;
    const int nr = min(tile_rows, n - row0);
    int* lab = s_lab + buf * tile_rows;
    float* xs = s_x + (size_t)buf * tile_rows * width;
    if ((int)threadIdx.x >= lo) {
      for (int i = threadIdx.x - lo; i < nr; i += THREADS - lo)
        cp_async4(lab + i, assign + row0 + i);
      for (int i = threadIdx.x - lo; i < nr * w; i += THREADS - lo) {
        const int r = i / w;
        cp_async4(xs + r * width + (i - r * w),
                  x + (size_t)(row0 + r) * d + jlo + (i - r * w));
      }
    }
    cp_async_commit();
  };

  const bool chain = (int)threadIdx.x < nq;
  const int q = q0 + threadIdx.x;
  const int cluster = chain ? q % k : -1;
  const int col = chain ? q / k - jlo : 0;
  float acc = 0.0f;
  if (tiles > 0) stage(0);
  for (int t = 0; t < tiles; ++t) {
    // tile t has landed for every thread, and every chain is done with
    // tile t - 1, whose buffer tile t + 1 now takes
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < tiles) stage(t + 1);
    if (chain) {
      const int nr = min(tile_rows, n - t * tile_rows);
      const int* lab = s_lab + (t & 1) * tile_rows;
      const float* xs = s_x + (size_t)(t & 1) * tile_rows * width + col;
      // UNROLL rows a set, two register sets: the loads of the next set go
      // out before the adds of this one, so the chain waits on no load
      int la[UNROLL], lb[UNROLL];
      float va[UNROLL], vb[UNROLL];
      int r = 0;
      const int full = nr / (2 * UNROLL) * (2 * UNROLL);
      if (full) load_set(lab, xs, width, 0, la, va);
      for (; r < full; r += 2 * UNROLL) {
        load_set(lab, xs, width, r + UNROLL, lb, vb);
        add_set(la, va, cluster, acc);
        if (r + 2 * UNROLL < full)
          load_set(lab, xs, width, r + 2 * UNROLL, la, va);
        add_set(lb, vb, cluster, acc);
      }
      for (; r < nr; ++r) acc += lab[r] == cluster ? xs[r * width] : 0.0f;
    }
  }
  if (chain) out[(size_t)(q % k) * d + q / k] = acc;
}

}  // namespace

extern "C" {

// x float32 [n, d] and assign int32 [n], row-major on the device; writes
// out float32 [k, d], the row-ordered sums of each cluster's rows (a label
// outside [0, k) adds nowhere), on `stream`. Returns a cudaError_t:
// cudaErrorInvalidValue for a shape the kernel cannot stage.
int centre_sums_launch(const float* x, int n, int d, const int* assign,
                       int k, float* out, void* stream) {
  if (k <= 0 || d <= 0) return 0;
  if (n < 0) return (int)cudaErrorInvalidValue;
  // the most columns a block stages: CHAINS consecutive chains, column-major
  const int width = min(d, (CHAINS + k - 1) / k + 1);
  const int row_bytes = 2 * (4 + 4 * width);
  const int tile_rows = min(MAX_TILE, STAGE_BYTES / row_bytes);
  if (tile_rows < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tile_rows * row_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      centre_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (k * d + CHAINS - 1) / CHAINS;
  centre_sums_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, n, d, assign, k, tile_rows, width, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
