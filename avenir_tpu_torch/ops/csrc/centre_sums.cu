// The centre sums of k-means' Lloyd step, in row order, on Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the port of `jax.ops.segment_sum(x,
// assign, num_segments=k)` in the XLA program `_kmeans_step`
// (avenir_tpu/models/cluster.py:43). XLA's CPU build lowers that
// scatter-add to a serial loop over the rows, so sums[c, j] is a chain of
// float32 adds, from +0, of x[i, j] over the rows i with assign[i] == c,
// in row order (a call of a single row is XLA's copy of it, a -0 kept).
// Float addition does not associate: no parallel split of a chain gives
// its bits, and float atomics add in an order that changes from run to
// run. So each (cluster, column) chain is one lane here, and the centres,
// and the labels of every later step, are the reference's bit for bit.
//
// What bounds it: the chains. x and the labels read once take about
// 0.008 ms at 1,000,000 x 6 on an H100, but a bit-exact sum is a serial
// chain of dependent adds, so no form can take less than the largest
// cluster's rows times the latency of one dependent FADD (4.44 cycles,
// 2.24 ns on an NVIDIA H100 80GB HBM3 at 700 W; `tools/centre_sums_probe.py`
// measures it). The design keeps everything else off that chain, in two
// launches on the caller's stream, with no read-back between them:
//
// 1. centre_sums_partition_kernel spreads over the card. A warp takes a
//    tile of up to TILE_MAX rows (and TILE_FLOATS floats of x): it stages
//    the tile's labels in shared memory with 16-byte cp.async, ranks each
//    row within its cluster (__match_any_sync groups a round's equal
//    labels, __popc of the lower lanes gives the rank), scans the tile's
//    per-cluster counts into offsets, and writes the tile's rows grouped by
//    cluster, in row order inside each cluster, with 16-byte stores
//    gathered from x through the read-only cache. A label outside [0, k)
//    is dropped. The columns go to planes of 32 columns ([n, 32] each, the
//    last [n, d % 32]), so a chain reads only its own columns. Per (tile,
//    cluster) it writes the start and count of the run into a table. The
//    tiles run in any order: a tile's runs sit in the tile's own rows of
//    each plane, so no tile needs another's counts.
// 2. centre_sums_chains_kernel: a block per (cluster, plane), each on an
//    SM of its own. A producer warp walks the table's column for its
//    cluster and keeps the cluster's runs, each contiguous, in flight into
//    a ring of STAGES shared-memory stages with bulk copies
//    (cp.async.bulk, completed on an mbarrier); a run longer than a stage
//    is cut at a row. The adder warp gives lane j column j of the plane:
//    one shared load and one __fadd_rn a row, from +0, in sets of UNROLL
//    rows whose loads go out between the adds of the set before. No
//    compare, no select, and no row of another cluster. Long runs are
//    what keep it near the floor: a stage costs a few hundred cycles
//    around its rows (the first loads, the -0 padding of the last set,
//    the barriers), so tiles of 4096 rows took 4.84 cycles a row at
//    1,000,000 x 6, k=3 (uniform labels) where tiles of 2048 took 5.14
//    (the same card).
//
// The C entries also run each launch alone (the probe's parts) and a
// single dependent-FADD chain (the add's latency, which sets the floor).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <utility>

#include "wgmma_bf16.cuh"

namespace {

namespace wg = wgmma_bf16;

constexpr unsigned FULL = 0xffffffffu;
// partition: rows a warp's tile at most, and floats of x a tile at most (a
// warp gathers its tile alone, so wide rows take shorter tiles); shared
// bytes a warp aims at, and a block's at most (the opt-in limit of
// sm_90); warps a block at most
constexpr int TILE_MAX = 4096;
constexpr int TILE_FLOATS = 64 * 1024;
constexpr int WARP_BUDGET = 48 * 1024 + 64;
constexpr int SMEM_MAX = 227 * 1024;
constexpr int PART_WARPS = 4;
// chains: ring stages, each STAGE_BYTES; rows a set of the adder's loads
constexpr int STAGES = 4;
constexpr int STAGE_BYTES = 48 * 1024;
constexpr int STAGE_FLOATS = STAGE_BYTES / 4;
constexpr int RING_OFFSET = 256;   // the barriers and run records first
constexpr int UNROLL = 32;

struct Plan {
  int tile;          // rows a tile, a multiple of 4
  int warps;         // partition warps a block (a tile each)
  int warp_bytes;    // a partition warp's shared bytes
  int tiles;
  int planes;        // ceil(d / 32)
  long long plane_floats;   // all planes, each 16-byte aligned
  long long table_offset;   // bytes into the workspace
  long long bytes;          // the workspace
};

long long align_up(long long v, long long a) { return (v + a - 1) / a * a; }

// false for a shape the partition cannot stage (k too large for one
// warp's shared memory)
bool make_plan(int n, int d, int k, Plan* p) {
  if (n < 0 || d <= 0 || k <= 0) return false;
  const long long row_bytes = 12;   // label, rank, source row
  const long long cnt_bytes = align_up(4LL * k, 16);
  long long budget = WARP_BUDGET;
  if (cnt_bytes + 4 * row_bytes > budget) budget = SMEM_MAX;
  long long tile = (budget - cnt_bytes) / row_bytes;
  tile = std::min<long long>(tile, std::min(TILE_MAX, TILE_FLOATS / d));
  tile &= ~3LL;
  if (tile < 4) return false;
  p->tile = (int)tile;
  p->warp_bytes = (int)(cnt_bytes + tile * row_bytes);
  p->warps = SMEM_MAX / p->warp_bytes;
  if (p->warps > PART_WARPS) p->warps = PART_WARPS;
  p->tiles = (int)((n + tile - 1) / tile);
  p->planes = (d + 31) / 32;
  const int last = d - 32 * (p->planes - 1);
  p->plane_floats =
      32LL * n * (p->planes - 1) + align_up((long long)n * last, 4);
  p->table_offset = align_up(4 * p->plane_floats, 256);
  p->bytes = p->table_offset + 8LL * p->tiles * k;
  if (p->bytes == 0) p->bytes = 16;
  return true;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   wg::smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   wg::smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// `count` floats (or ints) from global src to shared dst by the warp:
// 16-byte copies, then the last count % 4 one at a time. Both 16-byte
// aligned.
__device__ __forceinline__ void stage_words(void* dst, const void* src,
                                            int count, int lane) {
  const int quads = count >> 2;
  for (int i = lane; i < quads; i += 32)
    cp_async16(static_cast<int4*>(dst) + i, static_cast<const int4*>(src) + i);
  for (int i = 4 * quads + lane; i < count; i += 32)
    cp_async4(static_cast<int*>(dst) + i, static_cast<const int*>(src) + i);
}

__global__ void __launch_bounds__(32 * PART_WARPS)
centre_sums_partition_kernel(const float* __restrict__ x, int n, int d,
                 const int* __restrict__ assign, int k, int tile, int tiles,
                 int warp_bytes, float* __restrict__ planes,
                 int2* __restrict__ table) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * (blockDim.x >> 5) + warp;
  if (t >= tiles) return;
  unsigned char* base = smem + (size_t)warp * warp_bytes;
  int* cnt = reinterpret_cast<int*>(base);   // [k]: counts, then offsets
  int* lab = reinterpret_cast<int*>(base + (4 * k + 15) / 16 * 16);
  int* rank = lab + tile;
  int* src = rank + tile;   // the tile row at each grouped position
  const int row0 = t * tile, nr = min(tile, n - row0);

  stage_words(lab, assign + row0, nr, lane);
  cp_async_commit();
  for (int c = lane; c < k; c += 32) cnt[c] = 0;
  cp_async_wait_all();
  __syncwarp();

  // each valid row's rank among the tile's rows of its cluster
  const unsigned lower = (1u << lane) - 1;
  for (int i0 = 0; i0 < nr; i0 += 32) {
    const int i = i0 + lane;
    const int l = i < nr ? lab[i] : -1;
    const bool valid = (unsigned)l < (unsigned)k;
    const unsigned peers = __match_any_sync(FULL, valid ? l : -1);
    const int before = valid ? cnt[l] : 0;
    __syncwarp();
    if (valid && (peers & lower) == 0) cnt[l] = before + __popc(peers);
    __syncwarp();
    if (i < nr) rank[i] = valid ? before + __popc(peers & lower) : -1;
  }
  // counts to offsets; the table's (start, count) of each cluster's run
  int run = 0;
  for (int c0 = 0; c0 < k; c0 += 32) {
    const int c = c0 + lane;
    const int v = c < k ? cnt[c] : 0;
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += y;
    }
    if (c < k) {
      cnt[c] = run + inc - v;
      table[(size_t)t * k + c] = make_int2(run + inc - v, v);
    }
    run += __shfl_sync(FULL, inc, 31);
  }
  __syncwarp();
  for (int i = lane; i < nr; i += 32) {
    const int r = rank[i];
    if (r >= 0) src[cnt[lab[i]] + r] = i;
  }
  __syncwarp();

  // the grouped rows into each plane, 16 bytes a store, gathered from the
  // tile's rows of x (read once from memory, then from the caches)
  const float* xt = x + (size_t)row0 * d;
  for (int g = 0; g * 32 < d; ++g) {
    const int w = min(32, d - 32 * g);
    const float* xg = xt + 32 * g;
    float* out = planes + 32LL * n * g + (long long)row0 * w;
    const int total = run * w, quads = total >> 2;
    for (int q = lane; q < quads; q += 32) {
      int p = 4 * q / w, j = 4 * q - p * w;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = __ldg(xg + src[p] * d + j);
        if (++j == w) j = 0, ++p;
      }
      reinterpret_cast<float4*>(out)[q] = make_float4(v[0], v[1], v[2], v[3]);
    }
    for (int f = 4 * quads + lane; f < total; f += 32) {
      const int p = f / w;
      out[f] = __ldg(xg + src[p] * d + f - p * w);
    }
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(wg::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(wg::smem_addr(bar))
      : "memory");
}

// acc plus the UNROLL values of cur, in order, while the loads of the set
// at q (its first `live` rows; -0 past them, which leaves any sum as it
// is) go out into next
template <int W, bool GUARD>
__device__ __forceinline__ float add_load(const float* cur, float* next,
                                          const float* q, int live,
                                          float acc) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    acc = __fadd_rn(acc, cur[u]);
    next[u] = !GUARD || u < live ? q[u * W] : -0.0f;
  }
  return acc;
}

// The adds of a run of `rows` rows at p (a row W floats), in order, from
// acc, in sets of UNROLL rows, the last padded with -0. W is a template
// argument, so every load of a set is one shared load at a constant
// offset, and the loads of the next set go out between the adds of this
// one: in a loop alone the chain issues an add about every 4.6 cycles
// against the add's 4.4 (sets of 16 rows took 5.3).
template <int W>
__device__ __forceinline__ float add_run(const float* p, int rows,
                                         float acc) {
  float va[UNROLL], vb[UNROLL];
  const int full = rows / UNROLL, left = rows % UNROLL;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
    va[u] = full || u < left ? p[u * W] : -0.0f;
  const float* q = p + UNROLL * W;
  // va holds set s, whole while s < full
  int s = 0;
  for (; s + 2 < full; s += 2, q += 2 * UNROLL * W) {
    acc = add_load<W, false>(va, vb, q, 0, acc);
    acc = add_load<W, false>(vb, va, q + UNROLL * W, 0, acc);
  }
  // the last whole sets and the partial one: set s + 1 is whole if
  // s + 1 < full, partial if s + 1 == full, none past that
  if (s + 1 < full) {
    acc = add_load<W, false>(va, vb, q, 0, acc);
    acc = add_load<W, true>(vb, va, q + UNROLL * W,
                            s + 2 < full ? UNROLL : s + 2 == full ? left : 0,
                            acc);
    s += 2;
  }
  if (s < full || left) {
    acc = add_load<W, true>(va, vb, p + (s + 1) * UNROLL * W,
                            s + 1 < full ? UNROLL : s + 1 == full ? left : 0,
                            acc);
    if (s + 1 < full || (s + 1 == full && left)) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc = __fadd_rn(acc, vb[u]);
    }
  }
  return acc;
}

// The adder's loop over the ring for a plane W columns wide: lane j the
// chain of column j (lanes past W add a copy of the last column, never
// written). XLA's chain starts at +0, but a call of one row is its copy of
// that row: -0 + x is x, a -0 too.
template <int W>
__device__ __forceinline__ void adder(const float* ring, uint64_t* full,
                                     uint64_t* empty, const int2* meta, int n,
                                     float* out, int lane) {
  const int col = min(lane, W - 1);
  float acc = n == 1 ? -0.0f : 0.0f;
  bool any = false;
  for (int i = 0;; ++i) {
    const int s = i & (STAGES - 1);
    wg::mbar_wait(&full[s], (i / STAGES) & 1);
    const int2 m = meta[s];
    if (m.x < 0) break;
    acc = add_run<W>(ring + (size_t)s * STAGE_FLOATS + m.y + col, m.x, acc);
    any = true;
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[s]);
  }
  if (lane < W) out[lane] = any ? acc : 0.0f;
}

template <int... Ws>
__device__ __forceinline__ void adder_of(int w, const float* ring,
                                         uint64_t* full, uint64_t* empty,
                                         const int2* meta, int n, float* out,
                                         int lane,
                                         std::integer_sequence<int, Ws...>) {
  ((w == Ws + 1 ? adder<Ws + 1>(ring, full, empty, meta, n, out, lane)
                : void()), ...);
}

__global__ void __launch_bounds__(64)
centre_sums_chains_kernel(const float* __restrict__ planes, int n, int d, int k,
              int tile, int tiles, const int2* __restrict__ table,
              float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  unsigned char* smem = ring_smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  int2* meta = reinterpret_cast<int2*>(empty + STAGES);   // (rows, skip)
  float* ring = reinterpret_cast<float*>(smem + RING_OFFSET);
  const int c = blockIdx.x % k, g = blockIdx.x / k;
  const int w = min(32, d - 32 * g), lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 1);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 32) {
    // producer: the cluster's runs, tile by tile, cut to whole rows that
    // fit a stage; each copy the 16-byte-aligned span around its rows
    const float* plane = planes + 32LL * n * g;
    // a stage holds the 16-byte-aligned span of a chunk
    const int chunk = (STAGE_FLOATS - 8) / w;
    int i = 0;
    for (int t0 = 0; t0 < tiles; t0 += 32) {
      const int2 e = t0 + lane < tiles ? table[(size_t)(t0 + lane) * k + c]
                                       : make_int2(0, 0);
      const int nt = min(32, tiles - t0);
      for (int j = 0; j < nt; ++j) {
        const int start = __shfl_sync(FULL, e.x, j);
        const int count = __shfl_sync(FULL, e.y, j);
        const long long f0 = ((long long)(t0 + j) * tile + start) * w;
        for (int r = 0; r < count; r += chunk, ++i) {
          const int rows = min(chunk, count - r);
          const long long a = f0 + (long long)r * w;
          const long long a0 = a & ~3LL;
          const long long b0 = (a + (long long)rows * w + 3) & ~3LL;
          const int s = i & (STAGES - 1);
          wg::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
          if (lane == 0) {
            meta[s] = make_int2(rows, (int)(a - a0));
            const uint32_t bytes = (uint32_t)(b0 - a0) * 4;
            wg::mbar_expect_tx(&full[s], bytes);
            bulk_load(ring + (size_t)s * STAGE_FLOATS, plane + a0, bytes,
                      &full[s]);
          }
        }
      }
    }
    const int s = i & (STAGES - 1);
    wg::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
    if (lane == 0) {
      meta[s] = make_int2(-1, 0);   // the end
      wg::mbar_arrive(&full[s]);
    }
    return;
  }

  adder_of(w, ring, full, empty, meta, n, out + (size_t)c * d + 32 * g, lane,
           std::make_integer_sequence<int, 32>());
}

// one thread, `adds` dependent adds: the latency of a chained FADD
__global__ void centre_sums_fadd_chain_kernel(int adds, float v, float* out,
                                  long long* cycles) {
  float acc = 0.0f;
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < adds; ++i) acc = __fadd_rn(acc, v);
  const long long t1 = clock64();
  *out = acc;
  *cycles = t1 - t0;
}

int launch_partition(const float* x, int n, int d, const int* assign, int k,
                     const Plan& p, unsigned char* ws, cudaStream_t stream) {
  if (p.tiles == 0) return 0;
  const int smem = p.warps * p.warp_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      centre_sums_partition_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.tiles + p.warps - 1) / p.warps;
  centre_sums_partition_kernel<<<blocks, 32 * p.warps, smem, stream>>>(
      x, n, d, assign, k, p.tile, p.tiles, p.warp_bytes,
      reinterpret_cast<float*>(ws),
      reinterpret_cast<int2*>(ws + p.table_offset));
  return (int)cudaGetLastError();
}

int launch_chains(int n, int d, int k, const Plan& p, const unsigned char* ws,
                  float* out, cudaStream_t stream) {
  const int smem = RING_OFFSET + STAGES * STAGE_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      centre_sums_chains_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  centre_sums_chains_kernel<<<k * p.planes, 64, smem, stream>>>(
      reinterpret_cast<const float*>(ws), n, d, k, p.tile, p.tiles,
      reinterpret_cast<const int2*>(ws + p.table_offset), out);
  return (int)cudaGetLastError();
}

// the plan of a call whose workspace is checked; false if it is short
bool checked_plan(int n, int d, int k, const void* ws, long long ws_bytes,
                  Plan* p) {
  return make_plan(n, d, k, p) && ws_bytes >= p->bytes &&
         (reinterpret_cast<uintptr_t>(ws) & 255) == 0;
}

}  // namespace

extern "C" {

// The workspace bytes a call at (n, d, k) needs (the planes and the
// table) into *bytes. Returns cudaErrorInvalidValue for a shape the
// partition cannot stage.
int centre_sums_workspace(int n, int d, int k, long long* bytes) {
  Plan p;
  if (!make_plan(n, d, k, &p)) return (int)cudaErrorInvalidValue;
  *bytes = p.bytes;
  return 0;
}

// x float32 [n, d] and assign int32 [n], row-major on the device, both
// 16-byte aligned; ws a 256-byte-aligned workspace of
// centre_sums_workspace's bytes. Writes out float32 [k, d], the
// row-ordered sums of each cluster's rows (a label outside [0, k) adds
// nowhere), in two launches on `stream`. Returns a cudaError_t:
// cudaErrorInvalidValue for a shape the kernel cannot stage or a short or
// misaligned workspace.
int centre_sums_launch(const float* x, int n, int d, const int* assign, int k,
                       float* out, void* ws, long long ws_bytes,
                       void* stream) {
  if (k <= 0 || d <= 0) return 0;
  Plan p;
  if (!checked_plan(n, d, k, ws, ws_bytes, &p))
    return (int)cudaErrorInvalidValue;
  const int err = launch_partition(x, n, d, assign, k, p,
                                   static_cast<unsigned char*>(ws),
                                   (cudaStream_t)stream);
  if (err) return err;
  return launch_chains(n, d, k, p, static_cast<unsigned char*>(ws), out,
                       (cudaStream_t)stream);
}

// The first launch alone: the partition into ws.
int centre_sums_partition_launch(const float* x, int n, int d,
                                 const int* assign, int k, void* ws,
                                 long long ws_bytes, void* stream) {
  Plan p;
  if (!checked_plan(n, d, k, ws, ws_bytes, &p))
    return (int)cudaErrorInvalidValue;
  return launch_partition(x, n, d, assign, k, p,
                          static_cast<unsigned char*>(ws),
                          (cudaStream_t)stream);
}

// The second launch alone, on a workspace the partition has written.
int centre_sums_chains_launch(int n, int d, int k, const void* ws,
                              long long ws_bytes, float* out, void* stream) {
  Plan p;
  if (!checked_plan(n, d, k, ws, ws_bytes, &p))
    return (int)cudaErrorInvalidValue;
  return launch_chains(n, d, k, p, static_cast<const unsigned char*>(ws), out,
                       (cudaStream_t)stream);
}

// One thread adding v to +0 `adds` times, each add waiting on the last:
// out[0] the sum, cycles[0] the clock64() cycles of the loop.
int centre_sums_fadd_chain_launch(int adds, float v, float* out,
                                  long long* cycles, void* stream) {
  centre_sums_fadd_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      adds, v, out, cycles);
  return (int)cudaGetLastError();
}

}  // extern "C"
