// Device helpers shared by the kernels: bf16 packing, shared-memory
// addresses, ldmatrix, and the register A fragments of rows read from device
// memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vivid {

constexpr int kMaxSegments = 3;   // key segments of a packed launch: self and two sources

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8. Lane t receives elements [t / 4][2 (t % 4) .. + 1] of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A-operand fragments of the warp's 16 rows starting at `row0` of a matrix
// in device memory (rows `row_stride` elements apart), as they are: this
// thread's rows r0 and r0 + 8. Rows at or past `len` read as zeros.
template <int D>
__device__ __forceinline__ void load_q_fragments(const __nv_bfloat16* base, long long row_stride,
                                                 int row0, int len, int r0, int c0,
                                                 uint32_t (&f)[D / 16][4]) {
  float x[D / 16][4][2];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + r0 + (i & 1) * 8;
      const int col = kk * 16 + c0 + (i >> 1) * 8;
      float lo = 0.f, hi = 0.f;
      if (row < len) {
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(base + row * row_stride + col);
        lo = __bfloat162float(v.x);
        hi = __bfloat162float(v.y);
      }
      x[kk][i][0] = lo;
      x[kk][i][1] = hi;
    }
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[kk][i] = pack_bf16(x[kk][i][0], x[kk][i][1]);
  }
}

}  // namespace vivid
