// Exact, lane-packed and packed k-nearest-neighbour top-k on Hopper (sm_90a).
//
// Replaces three TPU kernels of avenir_tpu/ops/pallas_knn.py:
//   _knn_kernel        (knn_topk_pallas, packed=False): exact top-k,
//                      ascending by (distance, train index)
//   _knn_kernel_lanes  (knn_topk_lanes) + _extract_lane_topk: top-k of the
//                      int32 key bits(d^2) & ~mask | column/128, with
//                      mask = 2^pack_bits - 1, so distances come back
//                      quantized exactly as on the TPU and the index exact.
//   _knn_kernel_packed (knn_topk_pallas, packed=True) + _merge_into_best:
//                      top-k by (bits(d^2) & ~0xFFF, train index), the
//                      order the TPU kernel's in-tile column bits and its
//                      first-argmin tile merge give; distances come back
//                      truncated to 12 fewer mantissa bits.
// The 128-lane carries, the lo/hi pair fold, the per-tile insertion
// network, the column bits inside a <=4096-row tile and the revisited
// output block are TPU vector-register and VMEM devices and are not
// carried over: here a thread owns a few queries' sorted register carries
// of (key, column) pairs over its share of the columns (knn_tile.cuh).
//
// What bounds it on this card: instruction issue on the CUDA cores (nq*nt*D
// FMAs or L1 terms and a few selection instructions a pair); the inputs
// are a few MB. The design, in knn_tile.cuh: register blocking over
// queries and train rows, a bound shared by a query's lanes, cp.async
// stages of train rows, and a train-axis split over gridDim.y in whole
// waves, merged by a second kernel. Euclidean compute_dtype="bfloat16"
// has entries of its own (knn_topk_mma_launch, knn_topk_mma_info): the
// tensor-core form of the partial kernel (knn_tile_mma.cuh, wgmma bf16
// products fed by TMA, fp32 accumulation), then the same merge.
//
// The wrapper (avenir_tpu_torch/ops/knn_kernels.py) allocates every buffer,
// decodes keys to distances, and finishes sqrt(d/n_attrs) or d/n_attrs.
#include "knn_merge.cuh"
#include "knn_tile_mma.cuh"

namespace {

// The split merge (knn_merge.cuh) by groups of G lanes, then the answer
// [nq, k] written by each group, neighbouring lanes on neighbouring slots.
template <int K, int G>
__device__ __forceinline__ void merge_topk(const int* __restrict__ part_key,
                                           const int* __restrict__ part_idx,
                                           int nq, int splits, int k,
                                           int empty_key,
                                           int* __restrict__ out_key,
                                           int* __restrict__ out_idx) {
  const knn::Group<G> grp(nq);
  if (__all_sync(knn::WARP, !grp.live)) return;
  constexpr int SLOTS = knn::slots<K, G>();
  int key[SLOTS], idx[SLOTS];
  knn::merge_lists<K, G, true>(part_key, part_idx, nq, splits, k, empty_key,
                               grp, key, idx);
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int r = j * G + grp.lane;
    if (grp.live && r < k) {
      out_key[(size_t)grp.qi * k + r] = key[j];
      out_idx[(size_t)grp.qi * k + r] = idx[j];
    }
  }
}

// g (knn::merge_group of splits) picks the group size.
template <int K>
__global__ void __launch_bounds__(knn::MERGE_THREADS)
merge_topk_kernel(const int* __restrict__ part_key,
                  const int* __restrict__ part_idx, int nq, int splits, int k,
                  int empty_key, int g, int* __restrict__ out_key,
                  int* __restrict__ out_idx) {
  switch (g) {
    case 8:
      merge_topk<K, 8>(part_key, part_idx, nq, splits, k, empty_key, out_key,
                       out_idx);
      break;
    case 16:
      merge_topk<K, 16>(part_key, part_idx, nq, splits, k, empty_key,
                        out_key, out_idx);
      break;
    default:
      merge_topk<K, 32>(part_key, part_idx, nq, splits, k, empty_key,
                        out_key, out_idx);
  }
}

// The empty slot of a mode's key: +inf for exact and packed keys, the
// sentinel for lane keys.
inline int empty_key(int mode) {
  return mode == knn::LANES ? knn::SENTINEL : knn::INF_BITS;
}

// The group size is picked here from splits (knn::merge_group).
template <int K>
cudaError_t launch_merge(const int* part_key, const int* part_idx, int nq,
                         int splits, int k, int empty, int* out_key,
                         int* out_idx, cudaStream_t stream) {
  if (knn::merge_misaligned(part_key) || knn::merge_misaligned(part_idx))
    return cudaErrorInvalidValue;
  int g = knn::merge_group(splits);
  void* args[] = {(void*)&part_key, (void*)&part_idx, (void*)&nq,
                  (void*)&splits,   (void*)&k,        (void*)&empty,
                  (void*)&g,        (void*)&out_key,  (void*)&out_idx};
  return cudaLaunchKernel(&merge_topk_kernel<K>, knn::merge_grid(nq, splits),
                          dim3(knn::MERGE_THREADS), args, 0, stream);
}

template <int K>
cudaError_t run(bool euclid, int mode, const float* q, const float* t,
                const float* qn, const float* tn, int nq, int d, int n_valid,
                int k, int pack_mask, int splits, int rows_per_split,
                int* part_key, int* part_idx, int* out_key, int* out_idx,
                cudaStream_t stream) {
  int empty = knn::INF_BITS;
  cudaError_t err;
  switch (mode) {
    case knn::EXACT:
      err = knn::launch_partial_metric<K, knn::EXACT>(
          euclid, q, t, qn, tn, nullptr, nq, d, n_valid, splits,
          rows_per_split, 0, empty, part_key, part_idx, stream);
      break;
    case knn::LANES:
      empty = knn::SENTINEL;
      err = knn::launch_partial_metric<K, knn::LANES>(
          euclid, q, t, qn, tn, nullptr, nq, d, n_valid, splits,
          rows_per_split, pack_mask, empty, part_key, part_idx, stream);
      break;
    case knn::PACKED:
      err = knn::launch_partial_metric<K, knn::PACKED>(
          euclid, q, t, qn, tn, nullptr, nq, d, n_valid, splits,
          rows_per_split, pack_mask, empty, part_key, part_idx, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_merge<K>(part_key, part_idx, nq, splits, k, empty, out_key,
                         out_idx, stream);
}

// The tensor-core form (knn_tile_mma.cuh) of run's partial kernel, for
// euclidean compute_dtype="bfloat16", then the same merge.
// splits is the schedule's segments, blocks its blocks (knn::mma_plan).
template <int K>
cudaError_t run_mma(int mode, const void* q, const void* t, const float* qn,
                    const float* tn, int nq, int d, int n_valid, int k,
                    int pack_mask, int splits, int blocks, int* part_key,
                    int* part_idx, int* out_key, int* out_idx,
                    cudaStream_t stream) {
  const int empty = empty_key(mode);
  cudaError_t err;
  switch (mode) {
#define MMA_MODE(M)                                                        \
  case M:                                                                  \
    err = knn::launch_partial_mma<K, M>(q, t, qn, tn, nullptr, nq, d,      \
                                        n_valid, splits, blocks,           \
                                        M == knn::EXACT ? 0 : pack_mask,   \
                                        empty, part_key, part_idx,         \
                                        nullptr, stream);                  \
    break;
    MMA_MODE(knn::EXACT) MMA_MODE(knn::LANES) MMA_MODE(knn::PACKED)
#undef MMA_MODE
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_merge<K>(part_key, part_idx, nq, splits, k, empty, out_key,
                         out_idx, stream);
}

}  // namespace

extern "C" {

// q [nq, d] and t [nt, d] fp32 row-major on the device; rows >= n_valid of t
// are padding and never read. Euclidean takes the norms qn [nq] and tn
// [n_valid] of knn_prepass.cu (null for manhattan), and for
// compute_dtype="bfloat16" the tensor-core entry below. mode (knn::Mode)
// 0 exact: out_key = bits of the raw distance (squared for euclidean);
// 1 lanes, 3 packed: out_key = the packed key, with pack_bits low bits
// masked. out_idx is the train row, -1 for an empty slot.
// part_key/part_idx hold splits * nq * carry_width(k) ints each. Returns
// cudaGetLastError().
int knn_topk_launch(const float* q, const float* t, const float* qn,
                    const float* tn, int nq, int d, int n_valid, int k,
                    int euclid, int mode, int pack_bits, int splits,
                    int rows_per_split, int* part_key, int* part_idx,
                    int* out_key, int* out_idx, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int pack_mask = mode == knn::EXACT ? 0 : (1 << pack_bits) - 1;
  cudaError_t err;
  switch (knn::carry_width(k)) {
    case 8:
      err = run<8>(euclid, mode, q, t, qn, tn, nq, d, n_valid, k, pack_mask,
                   splits, rows_per_split, part_key, part_idx, out_key,
                   out_idx, s);
      break;
    case 16:
      err = run<16>(euclid, mode, q, t, qn, tn, nq, d, n_valid, k, pack_mask,
                    splits, rows_per_split, part_key, part_idx, out_key,
                    out_idx, s);
      break;
    case 32:
      err = run<32>(euclid, mode, q, t, qn, tn, nq, d, n_valid, k, pack_mask,
                    splits, rows_per_split, part_key, part_idx, out_key,
                    out_idx, s);
      break;
    case 64:
      err = run<64>(euclid, mode, q, t, qn, tn, nq, d, n_valid, k, pack_mask,
                    splits, rows_per_split, part_key, part_idx, out_key,
                    out_idx, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info[6] of the partial instance for (k, euclid, mode) at d
// features: blocks per SM, registers, local bytes, and its stage plan
// (knn::partial_info).
int knn_topk_partial_info(int k, int euclid, int mode, int d, int* info) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (knn::carry_width(k) * 4 + mode) {
#define KNN_INFO(KW, M)                                                   \
  case KW * 4 + M:                                                        \
    err = knn::partial_info_metric<KW, M>(euclid, d, info);              \
    break;
    KNN_INFO(8, knn::EXACT) KNN_INFO(8, knn::LANES) KNN_INFO(8, knn::PACKED)
    KNN_INFO(16, knn::EXACT) KNN_INFO(16, knn::LANES) KNN_INFO(16, knn::PACKED)
    KNN_INFO(32, knn::EXACT) KNN_INFO(32, knn::LANES) KNN_INFO(32, knn::PACKED)
    KNN_INFO(64, knn::EXACT) KNN_INFO(64, knn::LANES) KNN_INFO(64, knn::PACKED)
#undef KNN_INFO
  }
  return (int)err;
}

// As knn_topk_launch, through the tensor-core form of the partial kernel
// (knn_tile_mma.cuh) for euclidean compute_dtype="bfloat16": q and t are
// the pre-pass's bf16 rows ([nq, depth16(d)] and [n_valid, depth16(d)]),
// qn and tn its norms; in place of rows_per_split the persistent
// schedule's blocks, and splits its segments (knn_topk_mma_plan; a launch
// whose splits differ is refused). euclid must be 1.
int knn_topk_mma_launch(const void* q, const void* t, const float* qn,
                        const float* tn, int nq, int d, int n_valid, int k,
                        int euclid, int mode, int pack_bits, int splits,
                        int blocks, int* part_key, int* part_idx,
                        int* out_key, int* out_idx, void* stream) {
  if (!euclid) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int pack_mask = (1 << pack_bits) - 1;
  cudaError_t err;
  switch (knn::carry_width(k)) {
#define MMA_RUN(KW)                                                        \
  case KW:                                                                 \
    err = run_mma<KW>(mode, q, t, qn, tn, nq, d, n_valid, k, pack_mask,    \
                      splits, blocks, part_key, part_idx, out_key,         \
                      out_idx, s);                                         \
    break;
    MMA_RUN(8) MMA_RUN(16) MMA_RUN(32) MMA_RUN(64)
#undef MMA_RUN
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info[6] of the tensor-core instance for (k, mode) at d features, as
// knn_topk_partial_info; euclid must be 1.
int knn_topk_mma_info(int k, int euclid, int mode, int d, int* info) {
  cudaError_t err = cudaErrorInvalidValue;
  if (!euclid) return (int)err;
  switch (knn::carry_width(k) * 4 + mode) {
#define MMA_INFO(KW, M)                                                    \
  case KW * 4 + M:                                                         \
    err = knn::partial_mma_info<KW, M>(d, info);                           \
    break;
    MMA_INFO(8, knn::EXACT) MMA_INFO(8, knn::LANES) MMA_INFO(8, knn::PACKED)
    MMA_INFO(16, knn::EXACT) MMA_INFO(16, knn::LANES) MMA_INFO(16, knn::PACKED)
    MMA_INFO(32, knn::EXACT) MMA_INFO(32, knn::LANES) MMA_INFO(32, knn::PACKED)
    MMA_INFO(64, knn::EXACT) MMA_INFO(64, knn::LANES) MMA_INFO(64, knn::PACKED)
#undef MMA_INFO
  }
  return (int)err;
}

// The merge kernel alone on lists a partial launch left in part_key /
// part_idx (splits * nq * carry_width(k) ints each), for timing it apart:
// out_key/out_idx [nq, k] as knn_topk_launch writes them.
int knn_topk_merge_launch(const int* part_key, const int* part_idx, int nq,
                          int splits, int k, int mode, int* out_key,
                          int* out_idx, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int empty = empty_key(mode);
  cudaError_t err;
  switch (knn::carry_width(k)) {
#define MERGE(KW)                                                          \
  case KW:                                                                 \
    err = launch_merge<KW>(part_key, part_idx, nq, splits, k, empty,       \
                           out_key, out_idx, s);                           \
    break;
    MERGE(8) MERGE(16) MERGE(32) MERGE(64)
#undef MERGE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info[3] of the merge instance for k: blocks per SM, registers and
// local bytes (knn::merge_info).
int knn_topk_merge_info(int k, int* info) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (knn::carry_width(k)) {
#define MERGE_INFO(KW)                                                     \
  case KW:                                                                 \
    err = knn::merge_info(&merge_topk_kernel<KW>, info);                   \
    break;
    MERGE_INFO(8) MERGE_INFO(16) MERGE_INFO(32) MERGE_INFO(64)
#undef MERGE_INFO
  }
  return (int)err;
}

// out[4]: the layout both merge kernels launch for nq queries' splits
// lists (knn_merge.cuh): lanes a query's group, blocks, threads a block
// and lists a lane holds at once.
int knn_merge_layout(int nq, int splits, int* out) {
  const int g = knn::merge_group(splits);
  out[0] = g;
  out[1] = (int)knn::merge_grid(nq, splits).x;
  out[2] = knn::MERGE_THREADS;
  out[3] = g == 32 ? knn::MERGE_OWN : 1;
  return 0;
}

// An empty kernel on the grid a merge of nq queries' splits lists takes:
// the launch floor under the merges' device times.
int knn_merge_floor_launch(int nq, int splits, void* stream) {
  cudaError_t err = cudaLaunchKernel(&knn::merge_floor_kernel,
                                     knn::merge_grid(nq, splits),
                                     dim3(knn::MERGE_THREADS), nullptr, 0,
                                     (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The diagnostic instance: the tensor-core partial kernel at K=8 in mode
// `mode` (knn::Mode; labels [n_valid] for LABELS, else null), with
// clock64() sections (knn::SECTIONS). Launches the partial kernel alone on
// knn_topk_mma_launch's arguments; adds each warp's cycles a section to
// sections[knn::SECTIONS] (zeroed by the caller).
int knn_topk_mma_profile(const void* q, const void* t, const float* qn,
                         const float* tn, const int* labels, int nq, int d,
                         int n_valid, int mode, int pack_bits, int splits,
                         int blocks, int* part_key, int* part_idx,
                         unsigned long long* sections, void* stream) {
  const int mask = mode == knn::EXACT ? 0 : (1 << pack_bits) - 1;
  const int empty = mode == knn::LABELS ? knn::SENTINEL : empty_key(mode);
  cudaError_t err;
  switch (mode) {
#define MMA_PROFILE(M)                                                     \
  case M:                                                                  \
    err = knn::launch_partial_mma<8, M, true>(                             \
        q, t, qn, tn, labels, nq, d, n_valid, splits, blocks, mask, empty, \
        part_key, part_idx, sections, (cudaStream_t)stream);               \
    break;
    MMA_PROFILE(knn::EXACT) MMA_PROFILE(knn::LANES) MMA_PROFILE(knn::PACKED)
    MMA_PROFILE(knn::LABELS)
#undef MMA_PROFILE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// out[2] = (blocks, segments) of the tensor-core form's persistent
// schedule for k, nq queries and n_valid train rows on `blocks` blocks
// (knn::mma_plan): the blocks it launches and the splits its lists take.
int knn_topk_mma_plan(int k, int nq, int n_valid, int blocks, int* out) {
  switch (knn::carry_width(k)) {
    case 8: return knn::mma_plan<8>(nq, n_valid, blocks, out);
    case 16: return knn::mma_plan<16>(nq, n_valid, blocks, out);
    case 32: return knn::mma_plan<32>(nq, n_valid, blocks, out);
    case 64: return knn::mma_plan<64>(nq, n_valid, blocks, out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
