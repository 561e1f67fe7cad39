// Tensor-core form of the KNN partial top-k kernel for Hopper (sm_90a):
// euclidean distances with compute_dtype="bfloat16".
//
// It computes what partial_topk_kernel (knn_tile.cuh) computes for the
// four modes EXACT, LANES, LABELS and PACKED: per list and query the K
// smallest (key, column) pairs, in the same layout part_key/part_idx
// [splits][nq][K], with the same empty key and tie rule (the lower column
// wins), so the merge kernels, the wrapper's decoding and the vote take
// its lists unchanged. Only the cross term changes: v = sum_f bf16(q_f) *
// bf16(t_f) comes from wgmma.mma_async m64nNk16 (bf16 operands, fp32
// accumulators in registers), as the TPU kernels' bf16 dot_general on the
// MXU (avenir_tpu/ops/pallas_knn.py:54-70 _tile_distance, :44
// _dot_precision). The key is then max((|q|^2 + |t|^2) - 2v, 0) from the
// pre-pass's fp32 norms, masked as in partial_topk_kernel.
//
// Tolerance: a bf16 product is exact in fp32, so against the plain bf16
// version (fp32 products of the rounded operands, summed in another
// order) only the order of the fp32 accumulation differs. The keys are
// not bit-equal to it, nor to the CUDA-core form; they are held to the
// float32 kernel's tolerance plus the cancellation floor of the dot form
// (tools/knn_tolerance.py bf16_agrees) and kernel_check's bf16 bar (rtol
// 2e-2 against a float64 oracle, recall >= 0.999).
//
// What bounds it: at D=128 the product, 2 D operations a pair at the
// tensor cores' rate (0.278 ms at 8192 x 131072 on an H100); at D=6 the
// compare a pair at the CUDA cores' fp32 rate. The form it replaces
// (mma.sync) spent its time, by its clock64() sections, in the selection
// (61% at D=6) and at D=128 in the stage wait, the fp32 to bf16 pack and
// the ldmatrix-fed products (20-23% each) beside the selection (33%). This
// one has no pack, no ldmatrix and no shared v tile, and leaves the CUDA
// cores an add, a multiply-add and a min a pair:
// - Operands. The pre-pass writes bf16 rows zero-padded to depth16(D)
//   features (knn_prepass.cu), so TMA copies them as they lie. The layout
//   is K-major in chunks of 16 features (32 bytes a row) under the 32-byte
//   swizzle: one chunk is one wgmma k-step, so D=6 multiplies 16 features,
//   not the 64 a 128-byte swizzle's chunk would pad it to (4x the tensor
//   work and the bytes), and one layout serves every D up to MAX_D.
// - Schedule. One persistent block an SM walks a contiguous range of
//   (query tile, train tile) pairs (MmaSchedule), so a carry scans a long
//   run of train rows and, once full, sees few keys under its bound: at
//   8192 x 131072 a query's carries start empty 3 times, where a split of
//   the train axis a block (in whole waves) starts them 41 times.
// - Producer. The last warpgroup drops to 40 registers (setmaxnreg); one
//   thread loads each segment's 128 queries, then keeps a ring of stages
//   full: a stage holds BN train rows as depth16(D) / 16 TMA boxes, and
//   their norms (and labels) by 1-D TMA copies, all on one mbarrier. Rows
//   past n_valid arrive as zeros (TMA's out-of-bounds fill) and are
//   masked. The ring has as many stages as shared memory holds, up to
//   MMA_MAX_STAGES: at BN = 128, 8 at D=6, 5 at D=128, 1 at MAX_D, where
//   the query tile (94 KB) and one stage still fit, so the depth is never
//   walked in pieces.
// - Product. Two consumer warpgroups (232 registers each by setmaxnreg:
//   ptxas allocates to that bound past the instruction, where the launch
//   bound of 384 threads alone would cap it at 168 and spill) each own 64
//   queries and run a k-step's wgmma per chunk against each stage, fp32
//   accumulators in registers; the two interleave, one's epilogue beside
//   the other's product.
// - Keys in registers. The wgmma layout gives each thread two rows (g and
//   g + 8 of its warp's 16) and, of each 8-column group, two columns; a
//   row's quad of threads holds all BN of its columns. A pair's distance
//   comes from the accumulator, the row's norm and the column's norm (read
//   from the stage); one min over 8 pairs' bits and one compare against
//   the row's bound rule them out, and only then are their keys built
//   (partial_topk_kernel's masks: n_valid, pad rows; the mode's packing).
// - Selection. A thread keeps a carry for each of its rows. The threads
//   sharing a row keep one bound for it after each tile, by shuffles: the
//   least of their worst keys or, if lower, the most of their (K /
//   threads)-th keys. Keys that pass go in by column, lowest first, so the
//   lower column wins a tie; at a segment's end the row's carries merge by
//   shuffles on (key, column). Above K = 8 a thread keeps one row: the
//   quad's halves swap the other row's accumulators by shuffles first, so
//   two threads share a row; BN is 128 up to K = 16 and 64 above, so the
//   accumulators (BN / 2), the carries (2K a row) and the epilogue's
//   values stay within the 232 registers.
// Tried on an H100 and left out (PERF.md §6): a second accumulator set,
// so a warpgroup's next product runs beside its own epilogue, and BN = 256
// at K = 8 were slower; three consumer warpgroups were 1.07x faster at
// K = 8 but leave 160 registers, which K = 64's carries do not fit. The
// diagnostic instance (PROFILE) adds each consumer warp's clock64()
// cycles in SECTIONS.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "knn_tile.cuh"
#include "wgmma_bf16.cuh"

namespace knn {

namespace wg = wgmma_bf16;

constexpr int MMA_CONSUMERS = 2;                    // consumer warpgroups
constexpr int MMA_BQ = 64 * MMA_CONSUMERS;          // queries a block
// the consumer warpgroups, then the producer warpgroup
constexpr int MMA_THREADS = 128 * (MMA_CONSUMERS + 1);
constexpr int MMA_PRODUCER_REGS = 40, MMA_CONSUMER_REGS = 232;
constexpr int MMA_CHUNK = 16;      // features of a swizzled chunk (32 bytes)
constexpr int MMA_AUX = 1024;      // a stage's norms and labels (bytes)
constexpr int MMA_LABELS_AT = 512; // labels' offset in a stage's aux bytes
constexpr int MMA_MAX_STAGES = 8;
// clock64() sections of the diagnostic instance, in this order: stage
// wait, query load, wgmma, key epilogue, selection and insert, lane merge
constexpr int SECTIONS = 6;

// D rounded up to the wgmma's k-step of 16
__host__ __device__ inline int depth16(int d) { return (d + 15) / 16 * 16; }

// Train rows a stage (the wgmma's N) and rows a thread keeps carries
// for: the choices that keep a consumer thread's accumulators (N/2), its
// carries (2K a row) and the epilogue's values within its 232 registers.
template <int K>
__host__ __device__ constexpr int mma_bn() {
  return K >= 32 ? 64 : 128;
}
template <int K>
__host__ __device__ constexpr int mma_rows() {
  return K <= 8 ? 2 : 1;
}

// The form's shared memory at D features: 1024 bytes to align the base,
// the block's queries as bf16 at depth16(d), then `stages` stages (BN rows
// and MMA_AUX bytes each) and 2 * stages + 2 mbarriers; the most stages,
// up to MMA_MAX_STAGES, that fit SMEM_LIMIT (0 if none does).
template <int K>
inline size_t mma_smem(int d, int stages) {
  const size_t row = 2 * (size_t)depth16(d);
  return 1024 + row * MMA_BQ + stages * (row * mma_bn<K>() + MMA_AUX) +
         (2 * stages + 2) * 8;
}
template <int K>
inline StagePlan mma_stage_plan(int d) {
  int stages = MMA_MAX_STAGES;
  while (stages > 0 && mma_smem<K>(d, stages) > SMEM_LIMIT) --stages;
  return {mma_bn<K>(), stages, mma_smem<K>(d, stages)};
}


// The persistent schedule. The (query tile, train tile) pairs, query-tile
// major, are cut into `blocks` contiguous ranges, one a block (one block
// an SM): block b takes [b * pairs / blocks, (b + 1) * pairs / blocks), so
// every SM gets the same share to one pair and no wave is left part full.
// A range meets one or a few query tiles (its segments), and a segment
// scans a long run of train tiles, so a carry, once full, sees few keys
// under its bound. A segment's lists go to slot b - first_block(qt) of
// part_key/part_idx: a query tile's slots run in column order, as the
// merge takes them, and the block that reaches a query tile's last train
// tile fills the slots past its own with empty lists. The merge's splits
// are `segments`, the most blocks that meet one query tile.
struct MmaSchedule {
  int tiles;        // train tiles of BN rows (at least 1)
  int q_tiles;      // query tiles of MMA_BQ rows
  long long pairs;  // q_tiles * tiles
  int blocks;       // min(blocks asked, pairs)
  __host__ __device__ long long at(long long b) const {
    return b * pairs / blocks;
  }
  // the block whose range holds pair p
  __host__ __device__ int block_of(long long p) const {
    int b = (int)(p * blocks / pairs);
    while (b > 0 && at(b) > p) --b;
    while (at(b + 1) <= p) ++b;
    return b;
  }
  __host__ __device__ int first_block(int qt) const {
    return block_of((long long)qt * tiles);
  }
  __host__ __device__ int last_block(int qt) const {
    return block_of((long long)(qt + 1) * tiles - 1);
  }
};

template <int K>
__host__ __device__ inline MmaSchedule mma_schedule(int nq, int n_valid,
                                                    int blocks) {
  MmaSchedule s;
  s.tiles = n_valid > 0 ? (n_valid + mma_bn<K>() - 1) / mma_bn<K>() : 1;
  s.q_tiles = (nq + MMA_BQ - 1) / MMA_BQ;
  s.pairs = (long long)s.q_tiles * s.tiles;
  s.blocks = (int)(blocks < s.pairs ? blocks : s.pairs);
  return s;
}

inline int mma_segments(const MmaSchedule& s) {
  int most = 0;
  for (int qt = 0; qt < s.q_tiles; ++qt) {
    const int n = s.last_block(qt) - s.first_block(qt) + 1;
    most = n > most ? n : most;
  }
  return most;
}

template <bool ON>
struct Clock {
  long long clk[SECTIONS] = {};
  long long c0 = 0;
  __device__ __forceinline__ void start() { c0 = clock64(); }
  __device__ __forceinline__ void tick(int s) {
    const long long c1 = clock64();
    clk[s] += c1 - c0;
    c0 = c1;
  }
};
template <>
struct Clock<false> {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void tick(int) {}
};

// a ? x : y as a register select: the compiler may otherwise turn a
// lane-dependent choice between two accumulators into an indexed load and
// move the accumulators to local memory
__device__ __forceinline__ float sel(bool a, float x, float y) {
  float r;
  asm("{\n .reg .pred p;\n setp.ne.b32 p, %1, 0;\n"
      " selp.f32 %0, %2, %3, p;\n}\n"
      : "=f"(r)
      : "r"((int)a), "f"(x), "f"(y));
  return r;
}

// The key of a pair from the bits of its distance x = (qn + tn) - 2v, as
// partial_topk_kernel builds it: x clamped at +0 (jnp.maximum(x, 0): an
// int max maps every negative float and -0 to +0, and keeps the card's
// NaN, which is positive; EXACT makes a NaN NAN_KEY), then the mode's
// packing; lane_bits is the tile's column / 128 (a tile of BN columns lies
// in one 128-column chunk).
template <int MODE>
__device__ __forceinline__ int mma_key(int bits, int lab, int lane_bits,
                                       int pack_mask) {
  int key = max(bits, 0);
  if (MODE == EXACT && key > INF_BITS) key = NAN_KEY;
  if (MODE == LANES) key = (key & ~pack_mask) | lane_bits;
  if (MODE == LABELS) key = (key & ~pack_mask) | lab;
  if (MODE == PACKED) key &= ~pack_mask;
  return key;
}

// Whether any of a row's 8 distances (their bits) may give a key at or
// below the row's bound thr: every key is at least its clamped bits less
// the packed ones, so one min of the bits and one compare rule the 8 out;
// in EXACT a NaN (bits above INF_BITS) gives NAN_KEY and always may.
template <int MODE>
__device__ __forceinline__ bool may_enter(const int (&bits)[8], int thr,
                                          int pack_mask) {
  const int a = min(min(bits[0], bits[1]), min(bits[2], bits[3]));
  const int b = min(min(bits[4], bits[5]), min(bits[6], bits[7]));
  bool may = (max(min(a, b), 0) & ~pack_mask) <= thr;
  if (MODE == EXACT) {
    const int c = max(max(bits[0], bits[1]), max(bits[2], bits[3]));
    const int e = max(max(bits[4], bits[5]), max(bits[6], bits[7]));
    may = may || max(c, e) > INF_BITS;
  }
  return may;
}

// The bound below which a row's key may still enter its carry: lim, the
// least worst key of the threads sharing the row, and below the carry's
// own worst.
template <int K>
__device__ __forceinline__ int bound(const Carry<K>& best, int lim) {
  return min(lim, best.worst() - 1);
}

// The bound the threads sharing a row (RPT == 2: lanes ^ 1 and ^ 2, else
// lane ^ 1) keep for it, an upper bound on the K-th smallest key of their
// carries' union: the least of their worst keys or, if lower, the most of
// their (K / lanes)-th smallest keys (between them the lanes hold K keys
// at or below it).
template <int K>
__device__ __forceinline__ int row_bound(const Carry<K>& best) {
  constexpr int LANES = mma_rows<K>() == 2 ? 4 : 2;
  int w = best.worst(), b = best.key[K / LANES - 1];
#pragma unroll
  for (int m = 1; m < LANES; m <<= 1) {
    w = min(w, __shfl_xor_sync(0xffffffffu, w, m));
    b = max(b, __shfl_xor_sync(0xffffffffu, b, m));
  }
  return min(w, b);
}

// (k, i) into the carry, below its worst: each slot takes its new entry
// from itself, the new pair or the slot before it at once (depth 3 where
// Carry::insert's network is K - 1 steps deep); equal keys keep their
// order, the new pair after them. Up to K = 16, where the 2K new values
// fit beside the epilogue's registers.
template <int K>
__device__ __forceinline__ void insert_wide(Carry<K>& c, int k, int i) {
  if constexpr (K > 16) {
    c.insert(k, i);
  } else {
    int nk[K], ni[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const bool shift = s > 0 && k < c.key[s - 1];
      const bool here = k < c.key[s];
      nk[s] = shift ? c.key[s - 1] : here ? k : c.key[s];
      ni[s] = shift ? c.idx[s - 1] : here ? i : c.idx[s];
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
      c.key[s] = nk[s];
      c.idx[s] = ni[s];
    }
  }
}

// A row's 8 pairs (bits[u] of column base + off(u)) into its carry: their
// keys, with CHECK's mask of the columns at and past n_valid; those at or
// below the bound thr go in, lowest column first, each below the carry's
// worst at its turn (a pair's key picked from the 8 by a mux tree on the
// bits of its place).
template <bool CHECK, int MODE, int K, typename Off>
__device__ __forceinline__ void insert_row(Carry<K>& best, const int (&bits)[8],
                                           const int (&lab)[8], int thr,
                                           int base, int n_valid,
                                           int pack_mask, Off off) {
  const int lane_bits = base >> 7;
  int key[8];
  unsigned hit = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    key[u] = mma_key<MODE>(bits[u], lab[u], lane_bits, pack_mask);
    if ((!CHECK || base + off(u) < n_valid) && key[u] <= thr) hit |= 1u << u;
  }
  while (hit) {
    const int u = __ffs(hit) - 1;
    hit &= hit - 1;
    const bool b0 = u & 1, b1 = u & 2, b2 = u & 4;
    const int a0 = b0 ? key[1] : key[0], a1 = b0 ? key[3] : key[2];
    const int a2 = b0 ? key[5] : key[4], a3 = b0 ? key[7] : key[6];
    const int c0 = b1 ? a1 : a0, c1 = b1 ? a3 : a2;
    const int k = b2 ? c1 : c0;
    if (k < best.worst()) insert_wide(best, k, base + off(u));
  }
}

// One tile's epilogue at two rows a thread (K = 8): rows g and g + 8 of
// the warp's 16, each over columns 8j + 2tg and + 1 of the tile. A pair
// costs an add, a multiply-add and a min until its 8-column group may
// enter the carry; then the group's keys are built and the passing ones
// go in.
template <bool CHECK, int MODE, int K, int NACC, bool PROFILE>
__device__ __forceinline__ void epilogue_two(
    Carry<K> (&best)[2], const float (&acc)[NACC], const float (&qn)[2],
    const int (&lim)[2], const float* tns, const int* labs, int tg,
    int base, int n_valid, int pack_mask, Clock<PROFILE>& clk) {
  constexpr int J = NACC / 4;              // 8-column groups
#pragma unroll
  for (int j0 = 0; j0 < J; j0 += 4) {      // 8 columns a row: 4 groups
    float tn[8];
    int lab[8] = {};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int at = 8 * (j0 + jj) + 2 * tg;
      const float2 x = *reinterpret_cast<const float2*>(tns + at);
      tn[2 * jj] = x.x;
      tn[2 * jj + 1] = x.y;
      if (MODE == LABELS) {
        const int2 l = *reinterpret_cast<const int2*>(labs + at);
        lab[2 * jj] = l.x;
        lab[2 * jj + 1] = l.y;
      }
    }
    auto off = [&](int u) { return 8 * (j0 + (u >> 1)) + 2 * tg + (u & 1); };
    int bits[2][8], thr[2];
    bool may[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        bits[r][u] = __float_as_int(
            (qn[r] + tn[u]) - 2.f * acc[4 * (j0 + (u >> 1)) + 2 * r + (u & 1)]);
      thr[r] = bound(best[r], lim[r]);
      may[r] = may_enter<MODE>(bits[r], thr[r], pack_mask);
    }
    // one branch for both rows' 16 pairs
    const bool any = may[0] || may[1];
    if (PROFILE ? __any_sync(0xffffffffu, any) : any) {
      clk.tick(3);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (may[r])
          insert_row<CHECK, MODE>(best[r], bits[r], lab, thr[r], base,
                                  n_valid, pack_mask, off);
      clk.tick(4);
    }
  }
}

// One tile's epilogue at one row a thread (K >= 16): threads tg < 2 take
// row g, tg >= 2 row g + 8; the partner lane ^ 2 holds the row's other
// two columns of each 8-column group and swaps them in by shuffles, so a
// thread has columns 8j + 2(tg & 1) + {0, 1, 4, 5}.
template <bool CHECK, int MODE, int K, int NACC, bool PROFILE>
__device__ __forceinline__ void epilogue_one(
    Carry<K>& best, const float (&acc)[NACC], float qn, int lim,
    const float* tns, const int* labs, int tg, int base, int n_valid,
    int pack_mask, Clock<PROFILE>& clk) {
  constexpr int J = NACC / 4;
  const bool lo = tg < 2;
  const int t2 = 2 * (tg & 1);
#pragma unroll
  for (int j0 = 0; j0 < J; j0 += 2) {      // 8 columns: 2 groups of 4
    float v[8], tn[8];
    int lab[8] = {};
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = j0 + jj;
      const float s0 = sel(lo, acc[4 * j + 2], acc[4 * j]);
      const float s1 = sel(lo, acc[4 * j + 3], acc[4 * j + 1]);
      const float r0 = __shfl_xor_sync(0xffffffffu, s0, 2);
      const float r1 = __shfl_xor_sync(0xffffffffu, s1, 2);
      v[4 * jj] = sel(lo, acc[4 * j], r0);
      v[4 * jj + 1] = sel(lo, acc[4 * j + 1], r1);
      v[4 * jj + 2] = sel(lo, r0, acc[4 * j + 2]);
      v[4 * jj + 3] = sel(lo, r1, acc[4 * j + 3]);
      const float2 a = *reinterpret_cast<const float2*>(tns + 8 * j + t2);
      const float2 b = *reinterpret_cast<const float2*>(tns + 8 * j + t2 + 4);
      tn[4 * jj] = a.x;
      tn[4 * jj + 1] = a.y;
      tn[4 * jj + 2] = b.x;
      tn[4 * jj + 3] = b.y;
      if (MODE == LABELS) {
        const int2 la = *reinterpret_cast<const int2*>(labs + 8 * j + t2);
        const int2 lb = *reinterpret_cast<const int2*>(labs + 8 * j + t2 + 4);
        lab[4 * jj] = la.x;
        lab[4 * jj + 1] = la.y;
        lab[4 * jj + 2] = lb.x;
        lab[4 * jj + 3] = lb.y;
      }
    }
    auto off = [&](int u) {
      return 8 * (j0 + (u >> 2)) + t2 + (u & 1) + 4 * ((u >> 1) & 1);
    };
    int bits[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      bits[u] = __float_as_int((qn + tn[u]) - 2.f * v[u]);
    const int thr = bound(best, lim);
    const bool may = may_enter<MODE>(bits, thr, pack_mask);
    if (PROFILE ? __any_sync(0xffffffffu, may) : may) {
      clk.tick(3);
      if (may)
        insert_row<CHECK, MODE>(best, bits, lab, thr, base, n_valid,
                                pack_mask, off);
      clk.tick(4);
    }
  }
}

// The LANES threads that share a row (lanes ^ 1 and, with 4, ^ 2) hold
// carries over disjoint columns; afterwards each holds the K smallest
// (key, column) pairs of their union, ascending (merge_lanes' butterfly).
template <int K, int LANES>
__device__ __forceinline__ void merge_row(Carry<K>& c) {
#pragma unroll
  for (int m = 1; m < LANES; m <<= 1) {
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

// d += a . b^T of one k-step at the stage's width N (128 or 64)
template <int N>
__device__ __forceinline__ void mma_k16(float (&d)[N / 2], uint64_t a,
                                        uint64_t b, int accumulate) {
  if constexpr (N == 128)
    wg::wgmma_m64n128k16(d, a, b, accumulate);
  else
    wg::wgmma_m64n64k16(d, a, b, accumulate);
}

// Per query tile and block of the persistent schedule (gridDim.x blocks):
// the K smallest keys of each query over the block's train tiles of that
// query tile, as partial_topk_kernel<K, L2, MODE> computes them over a
// split, on the pre-pass's bf16 rows (maps tq and tt, depth dp), its norms
// (qn_g, map ttn) and, for LABELS, the labels (map tlab); lists at slot
// b - first_block(qt) of `segments`.
template <int K, int MODE, bool PROFILE>
__global__ void __launch_bounds__(MMA_THREADS, 1)
partial_topk_mma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tt,
                        const __grid_constant__ CUtensorMap ttn,
                        const __grid_constant__ CUtensorMap tlab,
                        const float* __restrict__ qn_g, int nq, int dp,
                        int n_valid, int stages, int segments, int pack_mask,
                        int empty_key, int* __restrict__ part_key,
                        int* __restrict__ part_idx,
                        unsigned long long* __restrict__ sections) {
  constexpr int BN = mma_bn<K>();
  constexpr int RPT = mma_rows<K>();
  constexpr int NACC = BN / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int chunks = dp / MMA_CHUNK;
  const uint32_t q_bytes = MMA_BQ * dp * 2;
  const uint32_t t_bytes = BN * dp * 2;     // a stage's bf16 rows
  const uint32_t stage_bytes = t_bytes + MMA_AUX;
  unsigned char* q_s = smem;
  unsigned char* t_s = smem + q_bytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(t_s + (size_t)stages * stage_bytes);
  uint64_t* empty = full + stages;
  uint64_t* q_full = empty + stages;
  uint64_t* q_empty = q_full + 1;
  const int tid = threadIdx.x;
  const MmaSchedule sch = mma_schedule<K>(nq, n_valid, gridDim.x);
  const long long p0 = sch.at(blockIdx.x), p1 = sch.at(blockIdx.x + 1);
  const int qt0 = (int)(p0 / sch.tiles), qt1 = (int)((p1 - 1) / sch.tiles);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 4 * MMA_CONSUMERS);   // a consumer warp each
    }
    wg::mbar_init(q_full, 1);
    wg::mbar_init(q_empty, 4 * MMA_CONSUMERS);
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128 * MMA_CONSUMERS) {
    // ---- the producer warpgroup: one thread keeps the ring full
    wg::regs_dec<MMA_PRODUCER_REGS>();
    if (tid == 128 * MMA_CONSUMERS) {
      wg::prefetch_tmap(&tq);
      wg::prefetch_tmap(&tt);
      wg::prefetch_tmap(&ttn);
      if (MODE == LABELS) wg::prefetch_tmap(&tlab);
      const uint32_t tx = t_bytes + BN * 4 * (MODE == LABELS ? 2 : 1);
      uint32_t it = 0, k = 0;
      for (int qt = qt0; qt <= qt1; ++qt, ++k) {
        const long long t0 = (long long)qt * sch.tiles;
        const int lo = (int)(max(p0, t0) - t0);
        const int hi = (int)(min(p1, t0 + sch.tiles) - t0);
        wg::mbar_wait(q_empty, (k & 1) ^ 1);
        wg::mbar_expect_tx(q_full, q_bytes);
        for (int c = 0; c < chunks; ++c)
          wg::tma_load(q_s + (size_t)c * MMA_BQ * 32, &tq, q_full,
                       c * MMA_CHUNK, qt * MMA_BQ);
        for (int j = lo; j < hi; ++j, ++it) {
          const int s = it % stages;
          unsigned char* st = t_s + (size_t)s * stage_bytes;
          wg::mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
          wg::mbar_expect_tx(&full[s], tx);
          for (int c = 0; c < chunks; ++c)
            wg::tma_load(st + (size_t)c * BN * 32, &tt, &full[s],
                         c * MMA_CHUNK, j * BN);
          wg::tma_load_1d(st + t_bytes, &ttn, &full[s], j * BN);
          if (MODE == LABELS)
            wg::tma_load_1d(st + t_bytes + MMA_LABELS_AT, &tlab, &full[s],
                            j * BN);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: c owns query rows [64c, 64c + 64) of a tile
    wg::regs_inc<MMA_CONSUMER_REGS>();
    Clock<PROFILE> clk;
    clk.start();
    const int c = tid >> 7;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, tg = lane & 3;
    const uint32_t a0 = wg::smem_addr(q_s) + c * 64 * 32;
    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    uint32_t it = 0, k = 0;
    for (int qt = qt0; qt <= qt1; ++qt, ++k) {
      const long long t0 = (long long)qt * sch.tiles;
      const int lo = (int)(max(p0, t0) - t0);
      const int hi = (int)(min(p1, t0 + sch.tiles) - t0);
      int qi[RPT], lim[RPT];
      float qn[RPT];
      Carry<K> best[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        qi[r] = qt * MMA_BQ + c * 64 + warp * 16 + g +
                8 * (RPT == 2 ? r : tg >> 1);
        qn[r] = qi[r] < nq ? qn_g[qi[r]] : 0.f;
        lim[r] = empty_key;
        best[r].init(empty_key);
      }
      wg::mbar_wait(q_full, k & 1);
      clk.tick(1);
      for (int j = lo; j < hi; ++j, ++it) {
        const int s = it % stages;
        const unsigned char* st = t_s + (size_t)s * stage_bytes;
        wg::mbar_wait(&full[s], (it / stages) & 1);
        clk.tick(0);
        const uint32_t b0 = wg::smem_addr(st);
        wg::fence_regs(acc);
        wg::wgmma_fence();
        for (int kc = 0; kc < chunks; ++kc)
          mma_k16<BN>(acc, wg::desc_sw32(a0 + kc * MMA_BQ * 32),
                      wg::desc_sw32(b0 + kc * BN * 32), kc > 0);
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
        wg::fence_regs(acc);
        clk.tick(2);
        const float* tns = reinterpret_cast<const float*>(st + t_bytes);
        const int* labs =
            reinterpret_cast<const int*>(st + t_bytes + MMA_LABELS_AT);
        const int base = j * BN;
        if constexpr (RPT == 2) {
          if (base + BN <= n_valid)
            epilogue_two<false, MODE>(best, acc, qn, lim, tns, labs, tg, base,
                                      n_valid, pack_mask, clk);
          else
            epilogue_two<true, MODE>(best, acc, qn, lim, tns, labs, tg, base,
                                     n_valid, pack_mask, clk);
        } else {
          if (base + BN <= n_valid)
            epilogue_one<false, MODE>(best[0], acc, qn[0], lim[0], tns, labs,
                                      tg, base, n_valid, pack_mask, clk);
          else
            epilogue_one<true, MODE>(best[0], acc, qn[0], lim[0], tns, labs,
                                     tg, base, n_valid, pack_mask, clk);
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r) lim[r] = row_bound(best[r]);
        __syncwarp();                      // the warp has read the stage
        if (lane == 0) wg::mbar_arrive(&empty[s]);
        clk.tick(3);
      }
      __syncwarp();                        // every wgmma on the tile is done
      if (lane == 0) wg::mbar_arrive(q_empty);
      const int slot = blockIdx.x - sch.first_block(qt);
      const bool last = hi == sch.tiles;   // the tile's slots past it: empty
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        merge_row<K, RPT == 2 ? 4 : 2>(best[r]);
        const bool writer = RPT == 2 ? tg == 0 : (tg & 1) == 0;
        if (writer && qi[r] < nq) {
          size_t o = ((size_t)slot * nq + qi[r]) * K;
#pragma unroll
          for (int e = 0; e < K; ++e) {
            part_key[o + e] = best[r].key[e];
            part_idx[o + e] = best[r].idx[e];
          }
          for (int sl = slot + 1; last && sl < segments; ++sl) {
            o = ((size_t)sl * nq + qi[r]) * K;
            for (int e = 0; e < K; ++e) {
              part_key[o + e] = empty_key;
              part_idx[o + e] = -1;
            }
          }
        }
      }
      clk.tick(5);
    }
    if constexpr (PROFILE) {
      if (lane == 0)
        for (int s = 0; s < SECTIONS; ++s)
          atomicAdd(sections + s, (unsigned long long)clk.clk[s]);
    }
  }
}

// The launch of the form on the pre-pass's operands: q [nq, depth16(d)]
// and t [n_valid, depth16(d)] bf16 rows, norms qn [nq] and tn [n_valid]
// fp32 and, for LABELS, labels [>= n_valid] int32, all 16-byte aligned;
// `blocks` blocks of the persistent schedule (one an SM) and `segments`,
// the lists a query takes (mma_segments: refused if it differs). Encodes
// the four tensor maps (cudaErrorNotSupported if libcuda lacks
// cuTensorMapEncodeTiled, cudaErrorInvalidValue if an encode or the plan
// refuses), then launches; nothing falls back.
template <int K, int MODE, bool PROFILE = false>
cudaError_t launch_partial_mma(const void* q, const void* t, const float* qn,
                               const float* tn, const int* labels, int nq,
                               int d, int n_valid, int segments, int blocks,
                               int pack_mask, int empty_key, int* part_key,
                               int* part_idx, unsigned long long* sections,
                               cudaStream_t stream) {
  auto* fn = &partial_topk_mma_kernel<K, MODE, PROFILE>;
  const StagePlan plan = mma_stage_plan<K>(d);
  if (plan.stages < 1 || nq < 1 || n_valid < 0 || blocks < 1)
    return cudaErrorInvalidValue;
  const MmaSchedule sch = mma_schedule<K>(nq, n_valid, blocks);
  if (segments != mma_segments(sch)) return cudaErrorInvalidValue;
  if (!wg::encode_tiled_fn()) return cudaErrorNotSupported;
  int dp = depth16(d);
  // with no valid train row the one tile's columns are all masked: the
  // maps need only exist
  const bool rows = n_valid > 0;
  CUtensorMap tq, tt, ttn, tlab;
  if (!wg::encode_bf16_chunks16(&tq, q, nq, dp, MMA_BQ) ||
      !wg::encode_bf16_chunks16(&tt, rows ? t : q, rows ? n_valid : 1, dp,
                                plan.rows) ||
      !wg::encode_words(&ttn, rows ? (const void*)tn : (const void*)qn,
                        rows ? n_valid : 1, plan.rows,
                        CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return cudaErrorInvalidValue;
  tlab = ttn;
  if (MODE == LABELS && rows &&
      !wg::encode_words(&tlab, labels, n_valid, plan.rows,
                        CU_TENSOR_MAP_DATA_TYPE_INT32))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return err;
  int stages = plan.stages;
  void* args[] = {(void*)&tq,       (void*)&tt,       (void*)&ttn,
                  (void*)&tlab,     (void*)&qn,       (void*)&nq,
                  (void*)&dp,       (void*)&n_valid,  (void*)&stages,
                  (void*)&segments, (void*)&pack_mask, (void*)&empty_key,
                  (void*)&part_key, (void*)&part_idx, (void*)&sections};
  return cudaLaunchKernel(fn, dim3(sch.blocks), dim3(MMA_THREADS), args,
                          plan.smem, stream);
}

// info[6] of the tensor-core instance for (K, MODE) at D features, as
// partial_info: blocks per SM, registers, local bytes, and its plan.
template <int K, int MODE>
cudaError_t partial_mma_info(int d, int* info) {
  auto* fn = &partial_topk_mma_kernel<K, MODE, false>;
  const StagePlan plan = mma_stage_plan<K>(d);
  if (plan.stages < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], fn,
                                                      MMA_THREADS, plan.smem);
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

// out[2] = (blocks, segments) of the persistent schedule at carry width K
template <int K>
int mma_plan(int nq, int n_valid, int blocks, int* out) {
  if (nq < 1 || n_valid < 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  const MmaSchedule sch = mma_schedule<K>(nq, n_valid, blocks);
  out[0] = sch.blocks;
  out[1] = mma_segments(sch);
  return 0;
}

}  // namespace knn
