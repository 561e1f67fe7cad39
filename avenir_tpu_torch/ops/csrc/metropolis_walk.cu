// The Metropolis walk over a histogram target: one thread walks the chain.
//
// Replaces no Pallas kernel: it is the port of the XLA scan of
// `MetropolisSampler.sample` (avenir_tpu/utils/sampling.py:184, the
// `lax.scan` of `one_step` at :172). The sampler (utils/sampling.py
// `draw_steps`) draws every step's proposal draw and uniforms first, on the
// card, from the port's threefry (ops/prng.py); this kernel, launched by
// ops/sampling_kernels.py `metropolis_walk`, walks the chain over them and
// writes each step's x and the accept count. A step's draw z is the normal
// in mixture mode; in plain mode XLA folds pstd into the normal's sqrt(2),
// so z is erf_inv(u) and pstd the float32 product pstd * sqrt(2).
//
// What bounds it: a step is a dependent chain of scalar operations (the
// proposal's multiply-add, the clamp, the bin index, the gather, the ratio,
// the compare and the selects), each waiting on the last through x and fx.
// The walk is sequential, so its least time is the steps times that chain's
// latency; the loads of the draws and the stores of the chain lie off it.
// The design keeps the chain in one thread's registers and unrolls the loop
// so that the draws' loads go out ahead of the chain. The chain latency is
// timed on the card by `metropolis_chain_latency_launch` (clock64()).
//
// Every float operation is written out as its IEEE round-to-nearest
// intrinsic, so that nvcc contracts nothing the plain version
// (`metropolis_walk_plain`) does not:
// - the proposal x + std * z is one fused multiply-add (fmaf), as XLA's
//   CPU build contracts it;
// - the bin index is JAX's float floor division (`_float_divmod`): fmod,
//   (a - mod) / bw, the sign fix, then round half away from zero; then the
//   int32 convert and the clip to [0, nb - 1].

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float sgn(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : v);
}

__device__ __forceinline__ int bin_index(float x, float xmin, float bw,
                                         int nb) {
  const float a = __fsub_rn(x, xmin);
  float mod = fmodf(a, bw);
  float div = __fdiv_rn(__fsub_rn(a, mod), bw);
  if (mod != 0.0f && sgn(bw) != sgn(mod)) {
    mod = __fadd_rn(mod, bw);
    div = __fsub_rn(div, 1.0f);
  }
  const int i = __float2int_rz(roundf(div));
  return min(max(i, 0), nb - 1);
}

struct Walk {
  const float* bins;
  int nb;
  float xmin, xmax, bw, pstd, gstd, thr;
};

// one step from (x, fx): returns whether it took the proposal
__device__ __forceinline__ bool step(const Walk& w, float scale, float zi,
                                     float u, float& x, float& fx) {
  const float nxt = fminf(fmaxf(fmaf(scale, zi, x), w.xmin), w.xmax);
  const float fn = __ldg(w.bins + bin_index(nxt, w.xmin, w.bw, w.nb));
  const bool take = u < __fdiv_rn(fn, fmaxf(fx, 1e-30f));
  x = take ? nxt : x;
  fx = take ? fn : fx;
  return take;
}

__global__ void metropolis_walk_kernel(Walk w, const float* __restrict__ z,
                                       const float* __restrict__ uniforms,
                                       const float* __restrict__ mix,
                                       long long steps, float x0,
                                       float* __restrict__ chain,
                                       long long* __restrict__ acc_out) {
  float x = x0;
  float fx = fmaxf(__ldg(w.bins + bin_index(x0, w.xmin, w.bw, w.nb)), 1e-30f);
  long long acc = 0;
#pragma unroll 8
  for (long long i = 0; i < steps; ++i) {
    const float scale = mix == nullptr
        ? w.pstd : (__ldg(mix + i) < w.thr ? w.pstd : w.gstd);
    acc += step(w, scale, __ldg(z + i), __ldg(uniforms + i), x, fx);
    chain[i] = x;
  }
  *acc_out = acc;
}

// the chain's latency: the same step on draws held in registers (eight
// z and uniforms loaded before the clock starts), so that no load
// lies on it; x is written out so that nothing is dropped
__global__ void metropolis_chain_kernel(Walk w, const float* z8,
                                        const float* uniforms8,
                                        long long steps, float x0, float* out,
                                        long long* cycles) {
  float nr[8], un[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    nr[j] = z8[j];
    un[j] = uniforms8[j];
  }
  float x = x0;
  float fx = fmaxf(__ldg(w.bins + bin_index(x0, w.xmin, w.bw, w.nb)), 1e-30f);
  long long acc = 0;
  const long long t0 = clock64();
  for (long long i = 0; i < steps; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += step(w, w.pstd, nr[j], un[j], x, fx);
  }
  const long long t1 = clock64();
  out[0] = x;
  out[1] = (float)acc;
  *cycles = t1 - t0;
}

Walk make_walk(const float* bins, int nb, float xmin, float xmax, float bw,
               float pstd, float gstd, float thr) {
  Walk w;
  w.bins = bins;
  w.nb = nb;
  w.xmin = xmin;
  w.xmax = xmax;
  w.bw = bw;
  w.pstd = pstd;
  w.gstd = gstd;
  w.thr = thr;
  return w;
}

}  // namespace

extern "C" {

// chain[i] = x after step i of `steps`; *acc = the proposals taken. mix is
// null for the plain proposal, else the mixture's uniforms (std = pstd
// where mix[i] < thr, else gstd). Returns cudaGetLastError().
int metropolis_walk_launch(const float* z, const float* uniforms,
                           const float* mix, long long steps,
                           const float* bins, int nb, float xmin, float xmax,
                           float bw, float pstd, float gstd, float thr,
                           float x0, float* chain, long long* acc,
                           void* stream) {
  if (nb < 1 || steps < 0) return (int)cudaErrorInvalidValue;
  metropolis_walk_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      make_walk(bins, nb, xmin, xmax, bw, pstd, gstd, thr), z, uniforms,
      mix, steps, x0, chain, acc);
  return (int)cudaGetLastError();
}

// `steps` (a multiple of 8) plain-proposal steps on the eight draws of
// z8 / uniforms8 in turn; out[0] = the last x, out[1] = the taken
// count, *cycles = clock64() cycles of the loop
int metropolis_chain_latency_launch(const float* z8,
                                    const float* uniforms8, long long steps,
                                    const float* bins, int nb, float xmin,
                                    float xmax, float bw, float pstd,
                                    float x0, float* out, long long* cycles,
                                    void* stream) {
  if (nb < 1 || steps < 0 || steps % 8 != 0) return (int)cudaErrorInvalidValue;
  metropolis_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      make_walk(bins, nb, xmin, xmax, bw, pstd, pstd, 0.0f), z8,
      uniforms8, steps, x0, out, cycles);
  return (int)cudaGetLastError();
}

}  // extern "C"
