// Device helpers shared by the packed attention kernels (forward and
// backward): bf16 fragment loads, the m16n8k16 tensor-core product, and the
// pixel norm of one D-wide row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vivid {

constexpr int kBlockQ = 64;   // query rows per tile, 16 per warp
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kMaxSegments = 3;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row-major) * b (16x8, column-major); bf16 in, fp32 out.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp loads one D-wide row (lane holds D/32 elements) and returns the
// pixel-norm denominator eps + ||x|| / sqrt(D). A null row reads as zeros.
template <int D>
__device__ __forceinline__ float load_row(const __nv_bfloat16* row, int lane,
                                          float eps, float (&x)[D / 32]) {
  constexpr int kPer = D / 32;
  if (row == nullptr) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) x[e] = 0.f;
  } else {
    if constexpr (kPer == 2) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(row + 2 * lane);
      x[0] = __bfloat162float(v.x);
      x[1] = __bfloat162float(v.y);
    } else {
      x[0] = __bfloat162float(row[lane]);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < kPer; ++e) ss += x[e] * x[e];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  return eps + (1.0f / sqrtf(static_cast<float>(D))) * sqrtf(ss);
}

}  // namespace vivid
