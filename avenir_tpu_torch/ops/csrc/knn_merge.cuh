// Split merge of the KNN top-k kernels on Hopper (sm_90a): a group of
// lanes per query.
//
// Ports the tile merge _merge_into_best (avenir_tpu/ops/pallas_knn.py:78)
// and the lane extraction _extract_lane_topk (:309); knn_topk.cu writes
// its answer, knn_classify.cu puts the vote epilogue _vote_epilogue
// (:501) on it. The partial kernel (knn_tile.cuh, knn_tile_mma.cuh)
// leaves, for each split of the train axis and each query, a list of K
// (key, column) pairs sorted by (key, column): [splits][nq][K] ints in
// part_key and part_idx, the splits in column order, a key >= the mode's
// empty key only as an empty slot (empty, -1) at a list's end. A query's
// answer is the first k entries of its lists merged by (key, split,
// position in the list), which is the order (key, column): the stable
// sort of merge_splits_plain (ops/knn_kernels.py).
//
// What bounds it: the latency of its loads and of the rounds' shuffles.
// A query's lists are a few hundred bytes and a launch reads a few MB, so
// neither bytes nor operations do; one thread a query walking its lists
// in turn waited on one load after another. The design:
// - A group of G lanes a query, G the fewest of 8, 16, 32 that cover
//   min(splits, 32) (merge_group), 256 threads a block: at nq=8192, 256
//   blocks at G=8 and 1024 at G=32, each more than the card's 132 SMs.
// - Lane l owns splits l, l+G, l+2G, ... It loads the first 4 keys of
//   each list it owns, one 16-byte load a list, all issued before the
//   first compare, so a query's loads are in flight together. (Windows of
//   8 keys take two loads a list and more registers.)
// - k rounds of a group arg-min: each lane offers the least head of its
//   lists; the group's least key is one redux.sync at G=32, else a
//   shuffle butterfly; a ballot of the lanes that offer it picks the
//   lowest split; that lane steps the list, and reloads its next 4 keys
//   when it has used the 4 it holds. Keys compare as signed int32, as
//   the partial kernel's carry compares them.
// - A head whose key is >= empty is exhausted; once every head is, the
//   remaining slots are (empty, -1), as an empty carry slot is.
// - Only the k winners' indices are read, one load a slot after the
//   rounds, all in flight together; the vote reads none. (Loading every
//   list's indices with its keys doubled the bytes read.)
// - A lane holds one list at G=8 and G=16 (splits <= G), MERGE_OWN at
//   G=32. More splits (more than 64) are merged in batches of 32 *
//   MERGE_OWN lists, the k entries of the batches before taking part as
//   one more list that wins ties: it holds lower splits.
// - The answer's slot j*G + l ends in lane l, so the group writes a row
//   of the answer with neighbouring lanes on neighbouring addresses.
// No atomics and no shared memory: a launch is deterministic.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace knn {

constexpr int MERGE_THREADS = 256;   // threads of a merge block
constexpr int MERGE_OWN = 2;         // lists a lane holds at once at G=32
constexpr int WIN = 4;               // keys a lane holds of a list

// Lanes of a query's group: the fewest of 8, 16, 32 that cover
// min(splits, 32).
__host__ __device__ inline int merge_group(int splits) {
  return splits <= 8 ? 8 : splits <= 16 ? 16 : 32;
}

inline dim3 merge_grid(int nq, int splits) {
  const int per_block = MERGE_THREADS / merge_group(splits);
  return dim3((nq + per_block - 1) / per_block);
}

// The list buffers are read 16 bytes at a time.
inline bool merge_misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

constexpr unsigned WARP = 0xffffffffu;

// A thread's place in the group of G lanes that merges query qi. The
// groups of a warp run every round together, so every shuffle, vote and
// reduction below names the whole warp: one whose mask differs between
// the lanes of a warp runs once for each mask.
template <int G>
struct Group {
  int lane;
  unsigned mask;   // the group's lanes in the warp
  int qi;
  bool live;       // qi < nq: a group past the last query only keeps pace
  __device__ explicit Group(int nq)
      : lane(threadIdx.x & (G - 1)),
        mask((G == 32 ? WARP : (1u << (G & 31)) - 1u)
             << ((threadIdx.x & 31) & ~(G - 1))),
        qi(blockIdx.x * (MERGE_THREADS / G) + threadIdx.x / G),
        live(qi < nq) {}
};

// The 4 ints at p (16-byte aligned) in one 16-byte load
__device__ __forceinline__ void load_window(const int* __restrict__ p,
                                            int (&w)[WIN]) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  w[0] = a.x;
  w[1] = a.y;
  w[2] = a.z;
  w[3] = a.w;
}

// The least of v over a group of G lanes, in every lane of it.
template <int G>
__device__ __forceinline__ int group_min(int v) {
  if (G == 32) return __reduce_min_sync(WARP, v);
#pragma unroll
  for (int o = G / 2; o > 0; o /= 2) v = min(v, __shfl_xor_sync(WARP, v, o));
  return v;
}

// The sum of v over a group of G lanes, in every lane of it.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o /= 2) v += __shfl_xor_sync(WARP, v, o);
  return v;
}

// Slots of the answer a lane holds: slot j*G + lane in its j-th.
template <int K, int G>
__host__ __device__ constexpr int slots() {
  return (K + G - 1) / G;
}

// Merge query grp.qi's lists. On return the lane holds slot j*G + lane
// of the answer in key[j] and idx[j], for the slots below k; every other
// slot it holds is (empty, -1). Without IDX no index is read and idx
// holds -1. Every lane of the warp calls it with the same arguments but
// grp.
template <int K, int G, bool IDX>
__device__ __forceinline__ void merge_lists(const int* __restrict__ part_key,
                                            const int* __restrict__ part_idx,
                                            int nq, int splits, int k,
                                            int empty, const Group<G>& grp,
                                            int (&key)[slots<K, G>()],
                                            int (&idx)[slots<K, G>()]) {
  constexpr int SLOTS = slots<K, G>();
  constexpr int OWN = G == 32 ? MERGE_OWN : 1;
  const int lane = grp.lane;
  int at[SLOTS];   // where a slot's entry lies: split * K + position
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    key[j] = empty;
    at[j] = -1;
  }
  int wk[OWN][WIN], pos[OWN];
  for (int b0 = 0; b0 < splits; b0 += G * OWN) {
#pragma unroll
    for (int m = 0; m < OWN; ++m) {
      const int s = b0 + lane + G * m;
      pos[m] = 0;
      if (grp.live && s < splits) {
        load_window(part_key + ((size_t)s * nq + grp.qi) * K, wk[m]);
      } else {
#pragma unroll
        for (int e = 0; e < WIN; ++e) wk[m][e] = INT_MAX;
      }
    }
    // the answer of the batches before (G = 32 only): its entry p sits
    // in lane p % 32, slot p / 32
    int ck[SLOTS], ca[SLOTS];
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      ck[j] = key[j];
      ca[j] = at[j];
    }
    int p = b0 ? 0 : k;
    for (int r = 0; r < k; ++r) {
      // this lane's offer: the least head of its lists, the lower split
      // on a tie
      int om = 0, bk = wk[0][0], bp = pos[0];
#pragma unroll
      for (int m = 1; m < OWN; ++m) {
        const bool lt = wk[m][0] < bk;
        om = lt ? m : om;
        bk = lt ? wk[m][0] : bk;
        bp = lt ? pos[m] : bp;
      }
      const int mk = group_min<G>(bk);
      // the lowest split offering the least key: the lists m = 0 of the
      // group's lanes in lane order, then the lists m = 1, ...
      unsigned tied = 0;
      int wm = 0;
#pragma unroll
      for (int m = 0; m < OWN; ++m) {
        const unsigned b = __ballot_sync(WARP, bk == mk && om == m) &
                           grp.mask;
        wm = tied ? wm : m;
        tied = tied ? tied : b;
      }
      const int owner = (__ffs(tied) - 1) & (G - 1);
      const int wpos = __shfl_sync(WARP, bp, owner, G);
      int hk = INT_MAX, ha = -1;
      if (G == 32 && p < k) {
        int vk = ck[0], va = ca[0];
#pragma unroll
        for (int j = 1; j < SLOTS; ++j) {
          vk = p >= 32 * j ? ck[j] : vk;
          va = p >= 32 * j ? ca[j] : va;
        }
        hk = __shfl_sync(WARP, vk, p & 31);
        ha = __shfl_sync(WARP, va, p & 31);
      }
      // the earlier batches' entry wins ties; a key >= empty is none
      const bool carry = hk <= mk;
      const int least = carry ? hk : mk;
      const bool hit = least < empty;
      const int wkey = hit ? least : empty;
      const int wat = !hit ? -1 : carry ? ha : (b0 + owner + G * wm) * K + wpos;
      p += hit && carry;
      const bool step = hit && !carry && lane == owner;
#pragma unroll
      for (int m = 0; m < OWN; ++m) {
        const bool adv = step && m == wm;
#pragma unroll
        for (int e = 0; e + 1 < WIN; ++e)
          wk[m][e] = adv ? wk[m][e + 1] : wk[m][e];
        wk[m][WIN - 1] = adv ? INT_MAX : wk[m][WIN - 1];
        pos[m] += adv;
        if (adv && pos[m] % WIN == 0 && pos[m] < K)
          load_window(part_key + ((size_t)(b0 + lane + G * m) * nq + grp.qi) *
                                     K + pos[m], wk[m]);
      }
      // round r fills slot r: lane r % G holds it, as its slot r / G
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        const bool mine = lane == r % G && j == r / G;
        key[j] = mine ? wkey : key[j];
        at[j] = mine ? wat : at[j];
      }
    }
  }
  // the winners' indices, one load a slot, all in flight together
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    idx[j] = -1;
    if (IDX && at[j] >= 0)
      idx[j] = __ldg(part_idx + ((size_t)(at[j] / K) * nq + grp.qi) * K +
                     at[j] % K);
  }
}

// No work on the merge's grid: what a launch of that grid costs the
// device, the floor under a merge's time.
__global__ void __launch_bounds__(MERGE_THREADS) merge_floor_kernel() {}

// info[3] of a merge instance: blocks per SM, registers a thread and
// local-memory bytes a thread (spills; 0 when all is registers).
template <typename Kernel>
cudaError_t merge_info(Kernel* fn, int* info) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[0], fn, MERGE_THREADS, 0);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  return err;
}

}  // namespace knn
