// 3x3 convolution at 64 channels with the magnitude-preserving SiLU fused
// into its input (sm_90a).
//
// Replaces the TPU kernel of tools/fused_conv_lab.py (make_pallas_conv_h,
// _conv_kernel_h): y = conv3x3_same(silu(x) / 0.596) on NHWC bf16 with no
// bias and fp32 accumulation, or the convolution alone. The SiLU is computed
// in fp32 and rounded to bf16 on its way into the product, as that kernel
// rounds it. The TPU kernel's height packing and its embedded [3, 3, 2C, 2C]
// weight fill the 128 lanes of that machine's matrix unit at twice the
// products; neither is part of the function, and neither is here.
//
// Design for this card: an implicit GEMM on mma.sync m16n8k16. A block of 8
// warps owns a tile of 8 x 16 output pixels by all 64 output channels: warp r
// takes the 16 pixels of tile row r (M = 16) against N = 64, K = 9 taps x 64
// input channels. The block loads the haloed 10 x 18 x 64 input tile once,
// through registers (the SiLU happens there), zero outside the image, and the
// nine [64 out, 64 in] weight taps (73.7 KB) once for all the tiles it walks:
// blocks are persistent, two to an SM (108.9 KB of dynamic shared memory
// each), and stride over the tiles. A pixel's 64 channels are 128 contiguous
// bytes, so both operands are fed by ldmatrix from rows padded by 16 bytes
// (no bank conflicts): the A fragment of tap (ky, kx) is the input tile
// shifted by (ky, kx), which costs nothing but an address.
//
// What bounds it: bytes, narrowly. At B = 8, 256 x 256: 38.65 GFLOP over the
// bf16 peak is 0.0391 ms, and 134.3 MB in and out over the memory rate is
// 0.0401 ms. This version is far from both: the input tile is loaded
// synchronously (the two blocks of an SM are its only overlap), the output
// goes out in 4-byte pieces, and mma.sync cannot reach the wgmma rate.

#include "flash_common.cuh"

namespace {

using namespace vivid;

constexpr int kC = 64;            // channels in and out
constexpr int kTileH = 8;         // output rows per tile, one per warp
constexpr int kTileW = 16;        // output pixels per tile row: the M of one warp
constexpr int kConvWarps = kTileH;
constexpr int kConvThreads = kConvWarps * 32;
constexpr int kPadC = kC + 8;     // +16 bytes a row: ldmatrix rows hit distinct banks
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kWeightElems = 9 * kC * kPadC;
constexpr int kInputElems = kHaloH * kHaloW * kPadC;
constexpr int kConvSmemBytes = (kWeightElems + kInputElems) * 2;

__device__ __forceinline__ float mp_silu(float x) {
  return x / (1.0f + __expf(-x)) / 0.596f;
}

template <bool kFuseSilu>
__global__ void __launch_bounds__(kConvThreads)
conv3x3_silu_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ y, int B, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto ws = reinterpret_cast<__nv_bfloat16(*)[kC][kPadC]>(smem);             // [9][out][in]
  auto xs = reinterpret_cast<__nv_bfloat16(*)[kHaloW][kPadC]>(
      smem + kWeightElems * 2);                                              // [10][18][in]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // The weights, once: w is [3][3][out][in], 16-byte chunks by cp.async.
  for (int c = threadIdx.x; c < 9 * kC * (kC / 8); c += kConvThreads) {
    const int row = c / (kC / 8);           // tap * 64 + out
    const int col = (c % (kC / 8)) * 8;
    cp_async16(&ws[row / kC][row % kC][col], w + row * kC + col, 16);
  }
  cp_async_commit();

  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const long long n_tiles = static_cast<long long>(B) * tiles_y * tiles_x;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = static_cast<int>(tile / (tiles_y * tiles_x));
    const int ty = static_cast<int>(tile / tiles_x % tiles_y);
    const int tx = static_cast<int>(tile % tiles_x);
    const int y0 = ty * kTileH;
    const int x0 = tx * kTileW;
    const __nv_bfloat16* xb = x + static_cast<long long>(b) * H * W * kC;

    __syncthreads();   // every warp is done with the previous input tile
    for (int c = threadIdx.x; c < kHaloH * kHaloW * (kC / 8); c += kConvThreads) {
      const int pix = c / (kC / 8);
      const int col = (c % (kC / 8)) * 8;
      const int iy = y0 + pix / kHaloW - 1;
      const int ix = x0 + pix % kHaloW - 1;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
        val = *reinterpret_cast<const uint4*>(
            xb + (static_cast<long long>(iy) * W + ix) * kC + col);
        if constexpr (kFuseSilu) {
          uint32_t* u = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162 v2 = *reinterpret_cast<__nv_bfloat162*>(&u[i]);
            u[i] = pack_bf16(mp_silu(__bfloat162float(v2.x)), mp_silu(__bfloat162float(v2.y)));
          }
        }
      }
      *reinterpret_cast<uint4*>(&xs[pix / kHaloW][pix % kHaloW][col]) = val;
    }
    cp_async_wait<0>();   // the weights (a no-op after the first tile)
    __syncthreads();

    float acc[kC / 8][4];
#pragma unroll
    for (int j = 0; j < kC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3;
      const int kx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < kC / 16; kk += 2) {
        // A: pixels (lane % 16) of this warp's row shifted by the tap, input
        // channels kk*16 .. kk*16 + 31 in two k16 steps.
        uint32_t a0[4], a1[4];
        const __nv_bfloat16* arow = &xs[warp + ky][lane % 16 + kx][kk * 16 + (lane / 16) * 8];
        ldmatrix_x4(a0, arow);
        ldmatrix_x4(a1, arow + 16);
#pragma unroll
        for (int j = 0; j < kC / 8; ++j) {
          uint32_t bf[4];   // output channels j*8 .., input channels kk*16 .. kk*16 + 31
          ldmatrix_x4(bf, &ws[tap][j * 8 + lane % 8][kk * 16 + (lane / 8) * 8]);
          mma_16816(acc[j], a0, bf[0], bf[1]);
          mma_16816(acc[j], a1, bf[2], bf[3]);
        }
      }
    }

    // This thread holds pixels lane / 4 and lane / 4 + 8 of the warp's row,
    // output channels j*8 + c0, + 1.
    const int oy = y0 + warp;
    const int c0 = (lane % 4) * 2;
    if (oy < H) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ox = x0 + lane / 4 + i * 8;
        if (ox >= W) continue;
        __nv_bfloat16* orow =
            y + ((static_cast<long long>(b) * H + oy) * W + ox) * kC;
#pragma unroll
        for (int j = 0; j < kC / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + c0) =
              __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();   // a block with no tile still owns its weight copies
}

}  // namespace

// C entry for ctypes. x, y [B, H, W, 64] bf16 (NHWC, contiguous); w
// [3, 3, 64 out, 64 in] bf16, contiguous. `blocks` is the grid: the caller
// gives two per SM. Returns the first CUDA error (0 on success); the caller
// checks it.
extern "C" int vivid_conv3x3_silu_fwd(
    const void* x, const void* w, void* y, int B, int H, int W, int fuse_silu, int blocks,
    void* stream) {
  if (B < 1 || H < 1 || W < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  const long long n_tiles = static_cast<long long>(B) * ((H + kTileH - 1) / kTileH) *
                            ((W + kTileW - 1) / kTileW);
  const int grid = static_cast<int>(n_tiles < blocks ? n_tiles : blocks);
  cudaError_t err;
  if (fuse_silu) {
    err = cudaFuncSetAttribute(conv3x3_silu_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kConvSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv3x3_silu_kernel<true><<<grid, kConvThreads, kConvSmemBytes, st>>>(xp, wp, yp, B, H, W);
  } else {
    err = cudaFuncSetAttribute(conv3x3_silu_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kConvSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv3x3_silu_kernel<false><<<grid, kConvThreads, kConvSmemBytes, st>>>(xp, wp, yp, B, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
