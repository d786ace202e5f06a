// 3x3 convolution at 64 channels with the magnitude-preserving SiLU fused
// into its input (sm_90a: wgmma, TMA, mbarriers).
//
// Replaces the TPU kernel of tools/fused_conv_lab.py (make_pallas_conv_h,
// _conv_kernel_h): y = conv3x3_same(silu(x) / 0.596) on NHWC bf16 with no
// bias and fp32 accumulation, or the convolution alone. The SiLU is computed
// in fp32 and rounded to bf16 once, before the product, as that kernel rounds
// it (the reciprocal of 1 + exp(-x) is the special-function unit's, within
// two fp32 ulps of a division). The TPU kernel's height packing and its
// embedded [3, 3, 2C, 2C] weight fill the 128 lanes of that machine's matrix
// unit at twice the products; neither is part of the function, and neither
// is here.
//
// Design for this card: an implicit GEMM on wgmma. One persistent block per
// SM walks output tiles of 8 rows x 16 pixels x 64 output channels, in
// row-major order within an image, so that the blocks at work at one time
// sit on neighbouring tiles and meet in L2 on their halo rows. A block is
// four warpgroups:
//   producers  (the last two) give registers away. One thread keeps a ring
//              of kConvStages input stages full: each is the haloed 10 x 18 x
//              64 tile, one TMA box of a 4-d tensor map over [B, H, W, 64]
//              at (0, x0 - 1, y0 - 1, b). TMA fills what lies outside the
//              image with zeros: that is the SAME padding, and it stays
//              exact under the SiLU since silu(0) = 0; the batch is a
//              dimension of the map, so a halo never reaches into the next
//              image. With the SiLU the other 224 producer threads apply it
//              in place to each stage that lands, one fp32 pass an element,
//              while the consumers multiply the stages before: the
//              exponentials run under the products.
//   consumers  (the first two) first write the weights, OIHW in device
//              memory, into shared memory as nine [64 out][64 in] taps (73.7
//              KB) with the 128-byte swizzle, while the first stages land:
//              the B operand of every product, read K-major by descriptor,
//              laid out here so that a call needs no permuted copy. Then they
//              take the tiles in turn, each a whole tile:
//              M = 128 output pixels as two m64 halves, warp w holding tile
//              rows 2 w and 2 w + 1. A fragments come from registers, loaded
//              by ldmatrix from the swizzled stage: the A fragment of tap
//              (ky, kx) for tile row r is halo row r + ky shifted by kx, so a
//              shift costs only an address (applied to the pixel row before
//              the swizzle's XOR), and halo row 2 w + j serves row 2 w with
//              ky = j and row 2 w + 1 with ky = j - 1: 12 loads (of 4 k16
//              steps) feed the 18 row-taps of a warp, each into 4 wgmma
//              m64n64k16. The next load runs while the products of the one
//              before do. Then the consumer hands the stage back, rounds its
//              tile to bf16 into a swizzled staging tile and one thread
//              stores it by TMA, which clips the ragged edges; the store
//              overlaps the next tile's products, and the other consumer's
//              products overlap this one's epilogue.
// Every output element has one owner and nothing is atomic, so two runs give
// the same bits. Proxies: shared memory that threads write and the async
// proxy then reads or writes (the weight taps wgmma reads, a stage after the
// SiLU pass that TMA refills, the staging tile TMA stores) is fenced by each
// writing thread (fence.proxy.async) before the barrier that hands it over.
//
// What bounds it: at B = 8, 256 x 256, bytes and operations alike: 134.3 MB
// in and out over the memory rate is 0.0401 ms, 38.65 GFLOP over the bf16
// peak 0.0391 ms. On the SM, shared memory: every wgmma reads its 2 KB of
// weights from it (the operations / 64 in bytes), the A fragments another
// 2/3 of that, the TMA loads, the SiLU pass and the staging tile the rest:
// ~350 KB a tile against ~2,300 clocks of products, at 128 bytes a clock.

#include "flash_fwd.cuh"

namespace {

using namespace vivid;

constexpr int kC = 64;               // channels in and out
constexpr int kPixBytes = kC * 2;    // one pixel's channels: one 128-byte swizzle row
constexpr int kTileH = 8;            // output rows per tile
constexpr int kTileW = 16;           // output pixels per tile row
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kStageBytes = kHaloH * kHaloW * kPixBytes;           // 23,040: one TMA box
constexpr int kStageStride = (kStageBytes + 1023) / 1024 * 1024;   // swizzle atoms start aligned
constexpr int kTapBytes = kC * kPixBytes;                          // [64 out][64 in]
constexpr int kWeightBytes = 9 * kTapBytes;                        // 73,728
constexpr int kConvStages = 4;
constexpr int kConvConsumers = 2;
constexpr int kProducerThreads = 2 * 128;
constexpr int kSiluThreads = kProducerThreads - 32;   // all but the TMA thread's warp
constexpr int kConvThreads = kConvConsumers * 128 + kProducerThreads;
constexpr int kOutBytes = kTileH * kTileW * kPixBytes;              // a consumer's staging tile
// 65536 / 512 = 128 registers a thread at launch; then the warpgroups trade
// them: 256 * 56 + 256 * 200 = 65536. A producer keeps enough for the SiLU
// pass.
constexpr int kConvProducerRegs = 56;
constexpr int kConvConsumerRegs = 200;
constexpr int kConvEmptyArrivals = 4;   // one lane of every warp of the tile's consumer
constexpr int kConvSmemBytes = kAlignSlack + kWeightBytes + kConvStages * kStageStride
    + kConvConsumers * kOutBytes + 3 * kConvStages * 8;
constexpr float kInvMpSilu = 1.0f / 0.596f;

static_assert(kStageBytes % 16 == 0 && kOutBytes % 1024 == 0, "TMA boxes in whole atoms");

__device__ __forceinline__ float mp_silu(float x) {
  return __fdividef(x, 1.0f + __expf(-x)) * kInvMpSilu;
}

// One box of a 4-d tensor map (coordinates innermost first) into shared
// memory; its bytes complete on `bar`. Coordinates outside read as 0.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box from shared memory into a 4-d tensor map; what lies outside the
// tensor is not written. Completes in the issuing thread's bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until this thread's bulk stores have read their shared memory (kRead) or
// are complete.
template <bool kRead>
__device__ __forceinline__ void bulk_wait_all() {
  if constexpr (kRead) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// This thread's generic-proxy accesses of shared memory before any later
// async-proxy access (TMA, wgmma operands) of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// The block's n-th tile: image b, first row y0, first pixel x0.
struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_of(int n, int tiles_y, int tiles_x) {
  const unsigned t = blockIdx.x + static_cast<unsigned>(n) * gridDim.x;
  const unsigned ty = t / tiles_x;
  return Tile{static_cast<int>(ty / tiles_y), static_cast<int>(ty % tiles_y) * kTileH,
              static_cast<int>(t - ty * tiles_x) * kTileW};
}

// The weights, OIHW [64 out][64 in][3][3], into the nine swizzled taps: unit
// (o, c) is out channel o, in channels 8 c .. 8 c + 7, 72 contiguous values
// (144 bytes, 16-byte aligned) read in nine 16-byte loads; each tap's eight
// of them are one 16-byte chunk of row o (chunk c lies at c ^ (o % 8)).
__device__ __forceinline__ void load_weights(uint8_t* wts, const __nv_bfloat16* w, int t) {
  for (int u = t; u < kC * kC / 8; u += kConvConsumers * 128) {
    const int o = u / 8;
    uint32_t v[36];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(w + u * 72) + k);
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
    uint8_t* row = wts + o * kPixBytes + (((u % 8) ^ (o & 7)) << 4);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      uint32_t p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {   // in channels 2 i and 2 i + 1: values 18 i + tap, + 9
        const int e0 = 18 * i + tap, e1 = e0 + 9;
        p[i] = ((v[e0 / 2] >> (16 * (e0 % 2))) & 0xffffu) | ((v[e1 / 2] >> (16 * (e1 % 2))) << 16);
      }
      *reinterpret_cast<uint4*>(row + tap * kTapBytes) = make_uint4(p[0], p[1], p[2], p[3]);
    }
  }
}

// silu(x) / 0.596 over a whole stage in place; elementwise, so the swizzle
// does not matter. A thread loads kSiluChunks 16-byte chunks, then computes
// their 8 kSiluChunks values, then stores them: the exponentials of one chunk
// are independent of the next one's, and written so, ptxas keeps them in
// flight together (left to it, a loop of one chunk a step ran a third slower).
constexpr int kSiluChunks = 4;

__device__ __forceinline__ void silu_stage(uint8_t* stage, int t) {
  constexpr int kChunks = kStageBytes / 16;
  for (int c0 = t; c0 < kChunks; c0 += kSiluChunks * kSiluThreads) {
    uint4 v[kSiluChunks];
#pragma unroll
    for (int k = 0; k < kSiluChunks; ++k) {
      const int c = c0 + k * kSiluThreads;
      if (c < kChunks) v[k] = *reinterpret_cast<const uint4*>(stage + c * 16);
    }
#pragma unroll
    for (int k = 0; k < kSiluChunks; ++k) {
      uint32_t* u = reinterpret_cast<uint32_t*>(&v[k]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 x2 = *reinterpret_cast<__nv_bfloat162*>(&u[i]);
        u[i] = pack_bf16(mp_silu(__bfloat162float(x2.x)), mp_silu(__bfloat162float(x2.y)));
      }
    }
#pragma unroll
    for (int k = 0; k < kSiluChunks; ++k) {
      const int c = c0 + k * kSiluThreads;
      if (c < kChunks) *reinterpret_cast<uint4*>(stage + c * 16) = v[k];
    }
  }
}

// The four k16 A fragments at halo pixel row `pix` of a stage: this warp's
// 16 pixels (lane % 16), input channels 16 kk + 8 (lane / 16) on. The
// stage's rows are 128-byte swizzled: chunk j of row p lies at j ^ (p % 8).
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const uint8_t* stage, int pix,
                                       int half) {
  const uint8_t* row = stage + pix * kPixBytes;
  const int sw = pix & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(a[kk], row + (((2 * kk + half) ^ sw) << 4));
}

template <bool kFuseSilu>
__global__ void __launch_bounds__(kConvThreads, 1)
conv3x3_silu_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap y_map,
                    const __nv_bfloat16* __restrict__ w, int B, int H, int W) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* wts = aligned_smem(smem_raw);
  uint8_t* stages = wts + kWeightBytes;
  uint8_t* outs = stages + kConvStages * kStageStride;
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + kConvConsumers * kOutBytes);
  uint64_t* ready = full + kConvStages;   // with the SiLU: the stage after its pass
  uint64_t* empty = ready + kConvStages;

  const int wg = threadIdx.x / 128;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const long long n_tiles = static_cast<long long>(B) * tiles_y * tiles_x;
  const int my_tiles = static_cast<int>((n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kConvStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kSiluThreads);
      mbar_init(&empty[s], kConvEmptyArrivals);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg >= kConvConsumers) {
    reg_dealloc<kConvProducerRegs>();
    const int t = threadIdx.x - kConvConsumers * 128;
    auto load = [&](int n) {
      const int s = n % kConvStages;
      const Tile tl = tile_of(n, tiles_y, tiles_x);
      mbar_expect_tx(&full[s], kStageBytes);
      tma_load_4d(stages + s * kStageStride, &x_map, &full[s], 0, tl.x0 - 1, tl.y0 - 1, tl.b);
    };
    if (t == 0) {
      for (int n = 0; n < kConvStages && n < my_tiles; ++n) load(n);
    }
    if (kFuseSilu && t >= 32) {
      for (int n = 0; n < my_tiles; ++n) {
        const int s = n % kConvStages;
        mbar_wait(&full[s], (n / kConvStages) & 1);
        silu_stage(stages + s * kStageStride, t - 32);
        fence_proxy_async();   // before TMA refills the stage
        mbar_arrive(&ready[s]);
      }
    } else if (t == 0) {
      // Tile n - kConvStages has handed its stage back: tile n may land there.
      for (int n = kConvStages; n < my_tiles; ++n) {
        mbar_wait(&empty[n % kConvStages], (n / kConvStages - 1) & 1);
        load(n);
      }
    }
  } else {
    reg_alloc<kConvConsumerRegs>();
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int pix0 = 2 * warp * kHaloW + lane % 16;   // halo row 2 warp, pixel lane % 16
    const int half = lane / 16;
    uint8_t* out_tile = outs + wg * kOutBytes;
    uint64_t* landed = kFuseSilu ? ready : full;
    const uint64_t wdesc = smem_desc<kPixBytes>(wts);
    load_weights(wts, w, threadIdx.x);
    fence_proxy_async();   // wgmma reads the taps through the async proxy
    named_sync(1 + kConvConsumers, kConvConsumers * 128);
    float acc[2][kC / 2];   // tile rows 2 warp + r, r = 0, 1
    for (int n = wg; n < my_tiles; n += kConvConsumers) {
      const int s = n % kConvStages;
      const uint8_t* stage = stages + s * kStageStride;
      mbar_wait(&landed[s], (n / kConvStages) & 1);

      // Slot q = 4 kx + j: halo row 2 warp + j shifted by kx, the A fragment
      // of tap (ky, kx) for tile row 2 warp + r wherever r + ky = j.
      uint32_t a[2][4][4];   // [slot parity][k16 step]
      load_a(a[0], stage, pix0, half);
      fence_regs(acc[0]);
      fence_regs(acc[1]);
#pragma unroll
      for (int q = 0; q < 12; ++q) {
        const int kx = q / 4;
        const int j = q % 4;
        wgmma_fence();
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int ky = j - r;
          if (ky < 0 || ky > 2) continue;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            Wgmma<kC, true>::template run<0>(
                acc[r], a[q & 1][kk], wdesc + ((ky * 3 + kx) * kTapBytes >> 4) + kk * kDescStepK,
                kx > 0 || ky > 0 || kk > 0);
          }
        }
        wgmma_commit();
        if (q + 1 < 12) {
          wgmma_wait<1>();   // the slot before, whose fragments the next slot's replace
          load_a(a[(q + 1) & 1], stage, pix0 + (q + 1) % 4 * kHaloW + (q + 1) / 4, half);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with the stage

      // Outputs: this thread holds pixels lane / 4 and + 8 of rows 2 warp + r,
      // channels 8 j + 2 (lane % 4), + 1. The staging tile is [8 rows][16
      // pixels][64] with the 128-byte swizzle (pixel row p's chunk j at
      // j ^ (p % 8); p % 8 = lane / 4), so a warp's stores meet no bank twice.
      const Tile tl = tile_of(n, tiles_y, tiles_x);
      if (threadIdx.x % 128 == 0) bulk_wait_all<true>();   // the last store has read it
      named_sync(1 + wg, 128);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint8_t* orow = out_tile + ((2 * warp + r) * kTileW + lane / 4 + 8 * i) * kPixBytes
              + (lane % 4) * 4;
#pragma unroll
          for (int j = 0; j < kC / 8; ++j) {
            *reinterpret_cast<uint32_t*>(orow + ((j ^ (lane / 4)) << 4)) =
                pack_bf16(acc[r][4 * j + 2 * i], acc[r][4 * j + 2 * i + 1]);
          }
        }
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if (threadIdx.x % 128 == 0) {
        tma_store_4d(&y_map, out_tile, 0, tl.x0, tl.y0, tl.b);
        bulk_commit();
      }
    }
    if (threadIdx.x % 128 == 0) bulk_wait_all<false>();
  }
}

// Map of an NHWC bf16 tensor [B, H, W, 64] for boxes of box_h rows x box_w
// pixels x 64 channels of one image, with the 128-byte swizzle (a pixel's
// channels are one swizzle row). The base must be 16-byte aligned.
int nhwc_map(CUtensorMap* map, const void* base, int B, int H, int W, int box_w, int box_h) {
  if (encoder() == nullptr) return kEncodeError;
  const cuuint64_t dims[4] = {kC, static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {kPixBytes, static_cast<cuuint64_t>(kPixBytes) * W,
                                 static_cast<cuuint64_t>(kPixBytes) * W * H};
  const cuuint32_t box[4] = {kC, static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(box_h),
                             1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult rc = encoder()(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(rc);
}

using ConvKernel = void (*)(CUtensorMap, CUtensorMap, const __nv_bfloat16*, int, int, int);

ConvKernel conv_kernel(int fuse_silu) {
  return fuse_silu ? conv3x3_silu_kernel<true> : conv3x3_silu_kernel<false>;
}

}  // namespace

// C entry for ctypes. x, y [B, H, W, 64] bf16 (NHWC, contiguous); w
// [64 out, 64 in, 3, 3] bf16 (OIHW, contiguous); all three 16-byte aligned.
// `blocks` bounds the grid: the caller gives one per SM. Returns the first
// CUDA error (0 on success; a tensor-map encoding error above 10000); the
// caller checks it.
extern "C" int vivid_conv3x3_silu_fwd(
    const void* x, const void* w, void* y, int B, int H, int W, int fuse_silu, int blocks,
    void* stream) {
  if (B < 1 || H < 1 || W < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map, y_map;
  int rc = nhwc_map(&x_map, x, B, H, W, kHaloW, kHaloH);
  if (rc == 0) rc = nhwc_map(&y_map, y, B, H, W, kTileW, kTileH);
  if (rc != 0) return rc;
  const long long n_tiles = static_cast<long long>(B) * ((H + kTileH - 1) / kTileH) *
                            ((W + kTileW - 1) / kTileW);
  const int grid = static_cast<int>(n_tiles < blocks ? n_tiles : blocks);
  const ConvKernel kernel = conv_kernel(fuse_silu);
  rc = allow_smem(kernel, kConvSmemBytes);
  if (rc != 0) return rc;
  kernel<<<grid, kConvThreads, kConvSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x_map, y_map, static_cast<const __nv_bfloat16*>(w), B, H, W);
  return static_cast<int>(cudaGetLastError());
}

// info[0..2]: registers a thread at launch, bytes of local memory a thread
// (spills) and dynamic shared memory of the kernel with (fuse_silu) or
// without the SiLU, as the runtime reports them; info[3..8]: tile rows, tile
// pixels, stages, a consumer's and a producer's registers after the trade,
// threads.
extern "C" int vivid_conv3x3_silu_info(int fuse_silu, int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, conv_kernel(fuse_silu));
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = kConvSmemBytes;
  info[3] = kTileH;
  info[4] = kTileW;
  info[5] = kConvStages;
  info[6] = kConvConsumerRegs;
  info[7] = kConvProducerRegs;
  info[8] = kConvThreads;
  return 0;
}
