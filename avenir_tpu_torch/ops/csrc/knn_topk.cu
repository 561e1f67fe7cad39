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
// carried over: here a thread owns a query and a sorted register carry of
// (key, column) pairs (knn_tile.cuh).
//
// What bounds it on this card: fp32 compute (nq*nt*D FMAs or L1 terms and
// nq*nt compares) against the CUDA-core fp32 peak; the inputs are a few MB.
// The design answers with a shared-memory train tile read as float4
// broadcasts, 32 independent accumulators per thread, and a train-axis
// split over gridDim.y merged by a second kernel (see knn_tile.cuh).
//
// The wrapper (avenir_tpu_torch/ops/knn_kernels.py) allocates every buffer,
// decodes keys to distances, and finishes sqrt(d/n_attrs) or d/n_attrs.
#include "knn_tile.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(knn::BQ)
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
cudaError_t run(bool euclid, int mode, int bf16, const float* q,
                const float* t, int nq, int d, int n_valid, int k,
                int pack_mask, int splits, int rows_per_split, int* part_key,
                int* part_idx, int* out_key, int* out_idx,
                cudaStream_t stream) {
  int empty = knn::INF_BITS;
  cudaError_t err;
  switch (mode) {
    case knn::EXACT:
      err = knn::launch_partial_metric<K, knn::EXACT>(
          euclid, bf16, q, t, nullptr, nq, d, n_valid, splits,
          rows_per_split, 0, empty, part_key, part_idx, stream);
      break;
    case knn::LANES:
      empty = knn::SENTINEL;
      err = knn::launch_partial_metric<K, knn::LANES>(
          euclid, bf16, q, t, nullptr, nq, d, n_valid, splits,
          rows_per_split, pack_mask, empty, part_key, part_idx, stream);
      break;
    case knn::PACKED:
      err = knn::launch_partial_metric<K, knn::PACKED>(
          euclid, bf16, q, t, nullptr, nq, d, n_valid, splits,
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
                          dim3((nq + knn::BQ - 1) / knn::BQ), dim3(knn::BQ),
                          args, 0, stream);
}

}  // namespace

extern "C" {

// q [nq, d] and t [nt, d] fp32 row-major on the device; rows >= n_valid of t
// are padding and never read. mode (knn::Mode) 0 exact: out_key = bits of
// the raw distance (squared for euclidean); 1 lanes, 3 packed: out_key =
// the packed key, with pack_bits low bits masked. bf16=1 rounds the
// euclidean cross term's operands to bfloat16. out_idx is the train row,
// -1 for an empty slot. part_key/part_idx hold splits * nq *
// carry_width(k) ints each. Returns cudaGetLastError().
int knn_topk_launch(const float* q, const float* t, int nq, int d,
                    int n_valid, int k, int euclid, int mode, int pack_bits,
                    int bf16, int splits, int rows_per_split, int* part_key,
                    int* part_idx, int* out_key, int* out_idx, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int pack_mask = mode == knn::EXACT ? 0 : (1 << pack_bits) - 1;
  cudaError_t err;
  switch (knn::carry_width(k)) {
    case 8:
      err = run<8>(euclid, mode, bf16, q, t, nq, d, n_valid, k, pack_mask,
                   splits, rows_per_split, part_key, part_idx, out_key,
                   out_idx, s);
      break;
    case 16:
      err = run<16>(euclid, mode, bf16, q, t, nq, d, n_valid, k, pack_mask,
                    splits, rows_per_split, part_key, part_idx, out_key,
                    out_idx, s);
      break;
    case 32:
      err = run<32>(euclid, mode, bf16, q, t, nq, d, n_valid, k, pack_mask,
                    splits, rows_per_split, part_key, part_idx, out_key,
                    out_idx, s);
      break;
    case 64:
      err = run<64>(euclid, mode, bf16, q, t, nq, d, n_valid, k, pack_mask,
                    splits, rows_per_split, part_key, part_idx, out_key,
                    out_idx, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
