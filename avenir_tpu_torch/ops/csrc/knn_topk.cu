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
// waves, merged by a second kernel.
//
// The wrapper (avenir_tpu_torch/ops/knn_kernels.py) allocates every buffer,
// decodes keys to distances, and finishes sqrt(d/n_attrs) or d/n_attrs.
#include "knn_tile.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(knn::THREADS)
merge_topk_kernel(const int* __restrict__ part_key,
                  const int* __restrict__ part_idx, int nq, int splits, int k,
                  int empty_key, int* __restrict__ out_key,
                  int* __restrict__ out_idx) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  knn::Carry<K> best;
  knn::merge_splits<K>(part_key, part_idx, nq, splits, qi, empty_key, best);
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < k) {
      out_key[(size_t)qi * k + s] = best.key[s];
      out_idx[(size_t)qi * k + s] = best.idx[s];
    }
  }
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
  void* args[] = {(void*)&part_key, (void*)&part_idx, (void*)&nq,
                  (void*)&splits,   (void*)&k,        (void*)&empty,
                  (void*)&out_key,  (void*)&out_idx};
  return cudaLaunchKernel(&merge_topk_kernel<K>,
                          dim3((nq + knn::THREADS - 1) / knn::THREADS),
                          dim3(knn::THREADS),
                          args, 0, stream);
}

}  // namespace

extern "C" {

// q [nq, d] and t [nt, d] fp32 row-major on the device; rows >= n_valid of t
// are padding and never read. Euclidean takes the norms qn [nq] and tn
// [n_valid] of knn_prepass.cu (null for manhattan), and for
// compute_dtype="bfloat16" its rounded copies as q and t. mode (knn::Mode)
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

}  // extern "C"
