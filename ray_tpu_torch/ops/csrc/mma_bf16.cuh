// bf16 tensor-core helpers of the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): packing two values into one 32-bit fragment register, and
// one m16n8k16 mma.sync with f32 accumulation.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 = (row g, cols 2t, 2t+1), a1 = (row g+8, same),
//                         a2 = (row g, cols 2t+8, 2t+9), a3 = (row g+8, same);
//   B (16x8, column-major): b0 = (rows 2t, 2t+1; col g), b1 = (rows 2t+8, 2t+9);
//   C/D (16x8): d0, d1 = (row g, cols 2t, 2t+1), d2, d3 = (row g+8, same).
// So the f32 accumulators of two neighbouring n-tiles, packed in pairs, are
// exactly the A fragment of the next 16-deep product.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack_bf16_raw(__nv_bfloat16 lo,
                                                  __nv_bfloat16 hi) {
  __nv_bfloat162 p;
  p.x = lo;
  p.y = hi;
  return *reinterpret_cast<uint32_t*>(&p);
}

// d += a * b for one 16x8x16 tile: a row-major 16x16, b column-major 16x8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
