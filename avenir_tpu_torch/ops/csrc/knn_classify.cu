// Fused k-nearest-neighbour class vote on Hopper (sm_90a).
//
// Replaces _knn_kernel_lanes_vote (knn_classify_lanes) of
// avenir_tpu/ops/pallas_knn.py: per query, the k smallest keys
// bits(d^2) & ~mask | label, mask = 2^label_bits - 1, taken as a multiset
// (equal keys carry the same distance and label, so the same vote), then
// the vote epilogue: each key decodes to its quantized distance, is scored
// by the reference kernel function on floor(dist * 100)
// (Neighborhood.java:150-218) and summed into its class. Only [nq, C]
// scores leave the device; no neighbour index is ever written.
//
// What bounds it on this card: the same fp32 distance compute as the top-k
// kernels (knn_tile.cuh); the vote is k steps per query. The design shares
// the partial kernel of knn_topk.cu (shared-memory train tile, register
// carry, train-axis split) and fuses the split merge with the vote.
// Euclidean compute_dtype="bfloat16" runs the partial kernel's tensor-core
// form (knn_tile_mma.cuh) through knn_classify_mma_launch.
#include "knn_merge.cuh"
#include "knn_tile_mma.cuh"

namespace {

enum KernelFn { NONE = 0, LINEAR_MULT = 1, LINEAR_ADD = 2, GAUSSIAN = 3 };

// max(a, b) that is NaN when a is, as jnp.maximum and torch.clamp are;
// fmaxf would return b
__device__ __forceinline__ float max_keep_nan(float a, float b) {
  return a >= b || a != a ? a : b;
}

// pallas_knn._kernel_score on the final attribute-averaged distance
__device__ __forceinline__ float kernel_score(float dist, int fn,
                                              float param) {
  const float d = floorf(dist * 100.f);
  switch (fn) {
    case LINEAR_MULT:
      return d == 0.f ? 200.f : floorf(100.f / max_keep_nan(d, 1.f));
    case LINEAR_ADD:
      return max_keep_nan(100.f - d, 0.f);
    case GAUSSIAN: {
      const float u = d / param;
      return floorf(100.f * expf(-0.5f * u * u));
    }
    default:
      return 1.f;
  }
}

// The split merge (knn_merge.cuh) by groups of G lanes, without
// indices, then the vote: each lane scores the slots it holds, as the
// carry's slots were scored, and the group sums each class over its lanes
// and writes its row once.
template <int K, int G>
__device__ __forceinline__ void merge_vote(const int* __restrict__ part_key,
                                           int nq, int splits, int k,
                                           int label_mask, int n_classes,
                                           float inv_attrs, int euclid,
                                           int kernel_fn, float kernel_param,
                                           float* __restrict__ scores) {
  const knn::Group<G> grp(nq);
  if (__all_sync(knn::WARP, !grp.live)) return;
  constexpr int SLOTS = knn::slots<K, G>();
  int key[SLOTS], idx[SLOTS];
  knn::merge_lists<K, G, false>(part_key, nullptr, nq, splits, k,
                                knn::SENTINEL, grp, key, idx);
  float points[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    // slots past k and past the lists' ends hold the sentinel: no vote
    points[j] = 0.f;
    if (key[j] < knn::SENTINEL) {
      const float d2 = __int_as_float(key[j] & ~label_mask);
      // times the fp32 reciprocal of the attribute count, as XLA compiles
      // the reference's division by that constant
      const float dist = euclid ? sqrtf(max_keep_nan(d2, 0.f) * inv_attrs)
                                : d2 * inv_attrs;
      points[j] = kernel_score(dist, kernel_fn, kernel_param);
    }
  }
  // Every score is a whole number of at most 200 (kernel_score floors it
  // or gives 1 or 200; an empty slot scores 0) or NaN (gaussian at
  // kernel_param 0 on a zero distance, a NaN distance), and k <= 64: a
  // class's float sum is exact in any order below 2^24 and NaN wherever
  // one of its scores is, so it equals the carry's sum in slot order and
  // _vote's.
  float* row = scores + (size_t)grp.qi * n_classes;
  for (int c = 0; c < n_classes; ++c) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j)
      sum += key[j] < knn::SENTINEL && (key[j] & label_mask) == c ? points[j]
                                                                   : 0.f;
    sum = knn::group_sum<G>(sum);
    if (grp.live && grp.lane == c % G) row[c] = sum;
  }
}

// g (knn::merge_group of splits) picks the group size.
template <int K>
__global__ void __launch_bounds__(knn::MERGE_THREADS)
merge_vote_kernel(const int* __restrict__ part_key, int nq, int splits, int k,
                  int g, int label_mask, int n_classes, float inv_attrs,
                  int euclid, int kernel_fn, float kernel_param,
                  float* __restrict__ scores) {
  switch (g) {
    case 8:
      merge_vote<K, 8>(part_key, nq, splits, k, label_mask, n_classes,
                       inv_attrs, euclid, kernel_fn, kernel_param, scores);
      break;
    case 16:
      merge_vote<K, 16>(part_key, nq, splits, k, label_mask, n_classes,
                        inv_attrs, euclid, kernel_fn, kernel_param, scores);
      break;
    default:
      merge_vote<K, 32>(part_key, nq, splits, k, label_mask, n_classes,
                        inv_attrs, euclid, kernel_fn, kernel_param, scores);
  }
}

// The group size is picked here from splits (knn::merge_group); the vote
// reads no index, so part_idx is not passed on.
template <int K>
cudaError_t launch_vote(const int* part_key, const int* part_idx, int nq,
                        int splits, int k, int label_mask, int n_classes,
                        float inv_attrs, bool euclid, int kernel_fn,
                        float kernel_param, float* scores,
                        cudaStream_t stream) {
  (void)part_idx;
  if (knn::merge_misaligned(part_key)) return cudaErrorInvalidValue;
  int g = knn::merge_group(splits), eu = euclid ? 1 : 0;
  void* args[] = {(void*)&part_key,  (void*)&nq,        (void*)&splits,
                  (void*)&k,         (void*)&g,         (void*)&label_mask,
                  (void*)&n_classes, (void*)&inv_attrs, (void*)&eu,
                  (void*)&kernel_fn, (void*)&kernel_param, (void*)&scores};
  return cudaLaunchKernel(&merge_vote_kernel<K>, knn::merge_grid(nq, splits),
                          dim3(knn::MERGE_THREADS), args, 0, stream);
}

template <int K>
cudaError_t run(bool euclid, const float* q, const float* t, const float* qn,
                const float* tn, const int* labels, int nq, int d,
                int n_valid, int k, int label_mask, int n_classes,
                float inv_attrs, int kernel_fn, float kernel_param,
                int splits, int rows_per_split, int* part_key, int* part_idx,
                float* scores, cudaStream_t stream) {
  cudaError_t err = knn::launch_partial_metric<K, knn::LABELS>(
      euclid, q, t, qn, tn, labels, nq, d, n_valid, splits, rows_per_split,
      label_mask, knn::SENTINEL, part_key, part_idx, stream);
  if (err != cudaSuccess) return err;
  return launch_vote<K>(part_key, part_idx, nq, splits, k, label_mask,
                        n_classes, inv_attrs, euclid, kernel_fn, kernel_param,
                        scores, stream);
}

// The tensor-core form (knn_tile_mma.cuh) of run's partial kernel, for
// euclidean compute_dtype="bfloat16", then the same merge and vote.
// splits is the schedule's segments, blocks its blocks (knn::mma_plan).
template <int K>
cudaError_t run_mma(const void* q, const void* t, const float* qn,
                    const float* tn, const int* labels, int nq, int d,
                    int n_valid, int k, int label_mask, int n_classes,
                    float inv_attrs, int kernel_fn, float kernel_param,
                    int splits, int blocks, int* part_key, int* part_idx,
                    float* scores, cudaStream_t stream) {
  cudaError_t err = knn::launch_partial_mma<K, knn::LABELS>(
      q, t, qn, tn, labels, nq, d, n_valid, splits, blocks,
      label_mask, knn::SENTINEL, part_key, part_idx, nullptr, stream);
  if (err != cudaSuccess) return err;
  return launch_vote<K>(part_key, part_idx, nq, splits, k, label_mask,
                        n_classes, inv_attrs, true, kernel_fn, kernel_param,
                        scores, stream);
}

}  // namespace

extern "C" {

// q [nq, d], t [nt, d] fp32 and labels [nt] int32 on the device; rows >=
// n_valid of t are padding. Euclidean takes the norms qn [nq] and tn
// [n_valid] of knn_prepass.cu (null for manhattan); euclidean
// compute_dtype="bfloat16" takes knn_classify_mma_launch. scores [nq,
// n_classes] fp32 is overwritten. kernel_fn: 0 none, 1
// linearMultiplicative, 2 linearAdditive, 3 gaussian. part_key/part_idx
// hold splits * nq * carry_width(k) ints each. Returns cudaGetLastError().
int knn_classify_launch(const float* q, const float* t, const float* qn,
                        const float* tn, const int* labels, int nq, int d,
                        int n_valid, int k, int euclid, int label_bits,
                        int n_classes, float inv_attrs, int kernel_fn,
                        float kernel_param,
                        int splits, int rows_per_split, int* part_key,
                        int* part_idx, float* scores, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int mask = (1 << label_bits) - 1;
  cudaError_t err;
  switch (knn::carry_width(k)) {
    case 8:
      err = run<8>(euclid, q, t, qn, tn, labels, nq, d, n_valid, k, mask,
                   n_classes, inv_attrs, kernel_fn, kernel_param, splits,
                   rows_per_split, part_key, part_idx, scores, s);
      break;
    case 16:
      err = run<16>(euclid, q, t, qn, tn, labels, nq, d, n_valid, k, mask,
                    n_classes, inv_attrs, kernel_fn, kernel_param, splits,
                    rows_per_split, part_key, part_idx, scores, s);
      break;
    case 32:
      err = run<32>(euclid, q, t, qn, tn, labels, nq, d, n_valid, k, mask,
                    n_classes, inv_attrs, kernel_fn, kernel_param, splits,
                    rows_per_split, part_key, part_idx, scores, s);
      break;
    case 64:
      err = run<64>(euclid, q, t, qn, tn, labels, nq, d, n_valid, k, mask,
                    n_classes, inv_attrs, kernel_fn, kernel_param, splits,
                    rows_per_split, part_key, part_idx, scores, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info[6] of the partial instance for (k, euclid) at d features:
// blocks per SM, registers, local bytes, and its stage plan
// (knn::partial_info).
int knn_classify_partial_info(int k, int euclid, int d, int* info) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (knn::carry_width(k)) {
    case 8:
      err = knn::partial_info_metric<8, knn::LABELS>(euclid, d, info);
      break;
    case 16:
      err = knn::partial_info_metric<16, knn::LABELS>(euclid, d, info);
      break;
    case 32:
      err = knn::partial_info_metric<32, knn::LABELS>(euclid, d, info);
      break;
    case 64:
      err = knn::partial_info_metric<64, knn::LABELS>(euclid, d, info);
      break;
  }
  return (int)err;
}

// As knn_classify_launch, through the tensor-core form of the partial
// kernel (knn_tile_mma.cuh) for euclidean compute_dtype="bfloat16": q and
// t are the pre-pass's bf16 rows ([nq, depth16(d)] and [n_valid,
// depth16(d)]), qn and tn its norms, labels 16-byte aligned; in place of
// rows_per_split the persistent schedule's blocks, and splits its
// segments (knn_classify_mma_plan). euclid must be 1.
int knn_classify_mma_launch(const void* q, const void* t, const float* qn,
                            const float* tn, const int* labels, int nq, int d,
                            int n_valid, int k, int euclid, int label_bits,
                            int n_classes, float inv_attrs, int kernel_fn,
                            float kernel_param, int splits, int blocks,
                            int* part_key, int* part_idx, float* scores,
                            void* stream) {
  if (!euclid) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int mask = (1 << label_bits) - 1;
  cudaError_t err;
  switch (knn::carry_width(k)) {
#define MMA_RUN(KW)                                                        \
  case KW:                                                                 \
    err = run_mma<KW>(q, t, qn, tn, labels, nq, d, n_valid, k, mask,       \
                      n_classes, inv_attrs, kernel_fn, kernel_param,       \
                      splits, blocks, part_key, part_idx, scores, s);      \
    break;
    MMA_RUN(8) MMA_RUN(16) MMA_RUN(32) MMA_RUN(64)
#undef MMA_RUN
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info[6] of the tensor-core LABELS instance for k at d features, as
// knn_classify_partial_info; euclid must be 1.
int knn_classify_mma_info(int k, int euclid, int d, int* info) {
  cudaError_t err = cudaErrorInvalidValue;
  if (!euclid) return (int)err;
  switch (knn::carry_width(k)) {
    case 8:
      err = knn::partial_mma_info<8, knn::LABELS>(d, info);
      break;
    case 16:
      err = knn::partial_mma_info<16, knn::LABELS>(d, info);
      break;
    case 32:
      err = knn::partial_mma_info<32, knn::LABELS>(d, info);
      break;
    case 64:
      err = knn::partial_mma_info<64, knn::LABELS>(d, info);
      break;
  }
  return (int)err;
}

// The merge-and-vote kernel alone on lists a partial launch left in
// part_key / part_idx, for timing it apart: scores as
// knn_classify_launch writes them.
int knn_classify_merge_launch(const int* part_key, const int* part_idx,
                              int nq, int splits, int k, int euclid,
                              int label_bits, int n_classes, float inv_attrs,
                              int kernel_fn, float kernel_param,
                              float* scores, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int mask = (1 << label_bits) - 1;
  cudaError_t err;
  switch (knn::carry_width(k)) {
#define VOTE(KW)                                                           \
  case KW:                                                                 \
    err = launch_vote<KW>(part_key, part_idx, nq, splits, k, mask,         \
                          n_classes, inv_attrs, euclid, kernel_fn,         \
                          kernel_param, scores, s);                        \
    break;
    VOTE(8) VOTE(16) VOTE(32) VOTE(64)
#undef VOTE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info[3] of the merge-and-vote instance for k: blocks per SM, registers
// and local bytes (knn::merge_info).
int knn_classify_merge_info(int k, int* info) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (knn::carry_width(k)) {
#define MERGE_INFO(KW)                                                     \
  case KW:                                                                 \
    err = knn::merge_info(&merge_vote_kernel<KW>, info);                   \
    break;
    MERGE_INFO(8) MERGE_INFO(16) MERGE_INFO(32) MERGE_INFO(64)
#undef MERGE_INFO
  }
  return (int)err;
}

// out[2] = (blocks, segments) of the tensor-core form's persistent
// schedule, as knn_topk_mma_plan.
int knn_classify_mma_plan(int k, int nq, int n_valid, int blocks, int* out) {
  switch (knn::carry_width(k)) {
    case 8: return knn::mma_plan<8>(nq, n_valid, blocks, out);
    case 16: return knn::mma_plan<16>(nq, n_valid, blocks, out);
    case 32: return knn::mma_plan<32>(nq, n_valid, blocks, out);
    case 64: return knn::mma_plan<64>(nq, n_valid, blocks, out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
