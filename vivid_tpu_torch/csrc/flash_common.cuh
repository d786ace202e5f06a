// Device helpers shared by the attention kernels: bf16 packing, the
// m16n8k16 tensor-core product, the pixel norm of one D-wide row, and the
// cp.async + ldmatrix feeding of shared-memory tiles, with the strided tile
// copy, the in-place pixel norm of a tile and the normalised query fragments
// of the kernels that do both.

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros (rows past the end).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Four 8x8 bf16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8. Lane t receives elements [t / 4][2 (t % 4) .. + 1] of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed: lane t receives [2 (t % 4) .. + 1][t / 4].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Rows [r_first, r_first + kRows) of a matrix whose rows of D values lie
// `row_stride` elements apart, into a padded tile, by cp.async (the caller
// commits); rows at or past `len` are zero-filled.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void copy_rows(__nv_bfloat16 (*tile)[D + 8], const __nv_bfloat16* base,
                                          long long row_stride, int r_first, int len) {
  constexpr int kRowChunks = D / 8;   // 16-byte chunks in one row
  for (int c = threadIdx.x; c < kRows * kRowChunks; c += kThreads) {
    const int r = c / kRowChunks;
    const int col = (c % kRowChunks) * 8;
    const bool ok = r_first + r < len;
    cp_async16(&tile[r][col], base + (ok ? r_first + r : len - 1) * row_stride + col,
               ok ? 16 : 0);
  }
}

// Pixel norm of every row of a tile in place: x / (eps + ||x|| / sqrt(D)) in
// fp32, rounded to bf16. One warp a row; a zero row stays zero.
template <int D, int kRows, int kWarpsIn>
__device__ __forceinline__ void normalize_tile(__nv_bfloat16 (*tile)[D + 8], float eps) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarpsIn) {
    float x[D / 32];
    const float den = load_row<D>(&tile[r][0], lane, eps, x);
    if constexpr (D == 64) {
      *reinterpret_cast<__nv_bfloat162*>(&tile[r][2 * lane]) =
          __floats2bfloat162_rn(x[0] / den, x[1] / den);
    } else {
      tile[r][lane] = __float2bfloat16(x[0] / den);
    }
  }
}

// A-operand fragments of the warp's 16 query rows starting at `row0`, read
// from device memory (rows `row_stride` elements apart): this thread's rows
// r0 and r0 + 8. With kNorm each row is pixel-normalised first; the quad that
// shares a row holds all D of its values, so the sum of squares meets in two
// shuffles. The value is multiplied by `scale` (after the norm, scale / den
// in one factor) and rounded once; kRoundNorm rounds the normalised value to
// bf16 before that, as a caller that normalised ahead would have. Rows at or
// past `len` read as zeros.
template <int D, bool kNorm, bool kRoundNorm>
__device__ __forceinline__ void load_q_fragments(const __nv_bfloat16* base, long long row_stride,
                                                 int row0, int len, int r0, int c0, float eps,
                                                 float scale, uint32_t (&f)[D / 16][4]) {
  float x[D / 16][4][2];
  float ss[2] = {0.f, 0.f};
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
      ss[i & 1] += lo * lo + hi * hi;
    }
  }
  float mul[2] = {scale, scale};
  float den[2] = {1.f, 1.f};
  if constexpr (kNorm) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], 1);
      ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], 2);
      den[i] = eps + (1.0f / sqrtf(static_cast<float>(D))) * sqrtf(ss[i]);
      mul[i] = scale / den[i];
    }
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float lo = x[kk][i][0], hi = x[kk][i][1];
      if constexpr (kNorm && kRoundNorm) {
        lo = __bfloat162float(__float2bfloat16(lo / den[i & 1])) * scale;
        hi = __bfloat162float(__float2bfloat16(hi / den[i & 1])) * scale;
      } else {
        lo *= mul[i & 1];
        hi *= mul[i & 1];
      }
      f[kk][i] = pack_bf16(lo, hi);
    }
  }
}

}  // namespace vivid
