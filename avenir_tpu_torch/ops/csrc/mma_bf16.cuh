// bf16 tensor-core fragment helpers for Hopper (sm_90a), used by the
// tensor-core form of the KNN partial kernel (knn_tile_mma.cuh): packing
// fp32 pairs to bf16, ldmatrix of four 8 x 8 blocks, and mma.sync m16n8k16
// with fp32 accumulation. The wgmma and TMA helpers are in wgmma_bf16.cuh.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bf16mma {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  // .x (the low half, the lower column of a fragment) = lo
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float4 x) {
  uint2 packed;
  packed.x = pack_bf16(x.x, x.y);
  packed.y = pack_bf16(x.z, x.w);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// four 8x8 bf16 matrices, one row address per lane (lanes 8m..8m+7: matrix m)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a . b of one 16 x 8 x 16 tile: a row-major (4 registers of bf16
// pairs), b column-major (2), c fp32 (lane l holds rows l/4 and l/4 + 8,
// columns 2(l%4) and 2(l%4) + 1)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace bf16mma
