// Big-S attention without a running max, for the 256px super-resolution
// model (sm_90a).
//
// Replaces the TPU kernel flash_nomax (_kernel_nomax, _kernel_nomax_biased)
// in vivid_tpu/kernels/flash.py. Inputs are q [B, H, Sq, D] and k, v
// [B, H, Sk, D] in bf16 whose q and k rows the caller has pixel-normalised
// (row norm <= sqrt(D)), so every scaled logit q.k / sqrt(D) lies below
// sqrt(D) and exp of it cannot overflow: e^5.66 at D = 32, e^8 at D = 64.
// Softmax is invariant to a constant shift, so no maximum is tracked and
// nothing is ever rescaled:
//
//   unbiased:  p = exp(q.k / sqrt(D))
//   biased:    p = exp(q.k / sqrt(D) + bias - shift),
//              shift = sqrt(D) + max(bias), computed by the caller and read
//              here from device memory (fp32 bias [B, H, Sq, Sk])
//   out = sum_k p v / sum_k p
//
// q is scaled by 1/sqrt(D) in fp32 and rounded to bf16 once, as the TPU
// kernel does; p is rounded to bf16 for the second product while its row sum
// stays in fp32. Unnormalised input overflows, as in the TPU kernel: the
// contract is the caller's and nothing here guards it.
//
// Design for this card: one block of 8 warps per (b, h, 128-row query tile),
// 16 rows a warp, q fragments held in registers for the whole walk. K and V
// tiles of 64 keys come through a two-stage cp.async ring in shared memory,
// so the next tile loads while this one is multiplied; fragments are read
// with ldmatrix (V transposed on the way, so no transposed copy is stored).
// With no maximum there is no cross-lane traffic in the loop at all: each
// thread adds up its own columns and the four partial row sums meet once,
// after the last tile. Any Sq and Sk: a key past the end gets p = 0, a query
// row past the end is not written.
//
// What bounds it: operations. At the path's shapes (Sq = 16384 or 4096; the
// denoiser's cross-attention has Sk = 2 Sq at D = 32, the encoder's
// self-attention Sk = Sq at D = 64) each k/v byte read from device memory is
// used by every query tile of its (b, h), and those tiles run side by side
// out of L2, so the 4 B H Sq Sk D operations over the tensor-core peak
// dominate the bytes by two orders of magnitude. At D = 32 one exp stands against only
// 128 tensor-core operations, so the special-function unit is the second
// limit. mma.sync cannot reach the wgmma rate; a wgmma + TMA version is
// later work.

#include "flash_common.cuh"

namespace {

using namespace vivid;

constexpr int kNmQ = 128;      // query rows per block, 16 per warp
constexpr int kNmK = 64;       // keys per shared-memory tile
constexpr int kNmWarps = 8;
constexpr int kNmStages = 2;

template <int D, bool kBiased>
__global__ void __launch_bounds__(kNmWarps * 32)
flash_nomax_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                   const float* __restrict__ shift_ptr, __nv_bfloat16* __restrict__ out,
                   int Sq, int Sk) {
  constexpr int kPad = D + 8;         // +16 bytes a row: ldmatrix rows hit distinct banks
  constexpr int kDk = D / 16;         // k16 steps over the head dim
  constexpr int kDn = D / 8;          // n8 tiles over the head dim
  constexpr int kKn = kNmK / 8;       // n8 tiles over a key tile
  constexpr int kRowChunks = D / 8;   // 16-byte chunks in one row
  constexpr int kChunks = kNmK * kRowChunks;
  // 1/sqrt(D) as the nearest fp32, the value the plain version multiplies by.
  constexpr float kScale = D == 32 ? 0.17677669529663687f : 0.125f;
  __shared__ __align__(16) __nv_bfloat16 ks[kNmStages][kNmK][kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kNmStages][kNmK][kPad];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kNmQ;
  const long long bh = static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  const __nv_bfloat16* qb = q + bh * Sq * D;
  const __nv_bfloat16* kb = k + bh * Sk * D;
  const __nv_bfloat16* vb = v + bh * Sk * D;
  const int n_tiles = (Sk + kNmK - 1) / kNmK;

  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kNmK;
    for (int c = threadIdx.x; c < kChunks; c += kNmWarps * 32) {
      const int r = c / kRowChunks;
      const int col = (c % kRowChunks) * 8;
      const bool ok = k0 + r < Sk;
      const long long off = static_cast<long long>(ok ? k0 + r : Sk - 1) * D + col;
      cp_async16(&ks[stage][r][col], kb + off, ok ? 16 : 0);
      cp_async16(&vs[stage][r][col], vb + off, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  // Fragment coordinates: this thread holds rows r0 and r0 + 8 of the warp's
  // 16 query rows, and columns c0, c0 + 1 of every n8 tile.
  const int r0 = warp * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;

  // q fragments straight from device memory: scale in fp32, round once.
  uint32_t qf[kDk][4];
#pragma unroll
  for (int kk = 0; kk < kDk; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r0 + (i & 1) * 8;
      const int col = kk * 16 + c0 + (i >> 1) * 8;
      if (row < Sq) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
            qb + static_cast<long long>(row) * D + col);
        qf[kk][i] = pack_bf16(__bfloat162float(x.x) * kScale, __bfloat162float(x.y) * kScale);
      } else {
        qf[kk][i] = 0u;
      }
    }
  }

  float o[kDn][4];
#pragma unroll
  for (int j = 0; j < kDn; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float l[2] = {0.f, 0.f};
  float shift = 0.f;
  const float* brow[2] = {nullptr, nullptr};
  if constexpr (kBiased) {
    shift = *shift_ptr;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r0 + i * 8;
      if (row < Sq) brow[i] = bias + (bh * Sq + row) * Sk;
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_tile(t + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // every thread's part of tile t has landed

    // Logits of the warp's 16 rows against this tile's 64 keys.
    float s[kKn][4];
#pragma unroll
    for (int j = 0; j < kKn; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDk; kk += 2) {
        uint32_t kf[4];   // keys j*8.., head-dim columns kk*16 .. kk*16 + 31
        ldmatrix_x4(kf, &ks[stage][j * 8 + lane % 8][kk * 16 + (lane / 8) * 8]);
        mma_16816(s[j], qf[kk], kf[0], kf[1]);
        mma_16816(s[j], qf[kk + 1], kf[2], kf[3]);
      }
    }

    // p = exp(s [+ bias - shift]); keys past the end count for nothing.
    const int k0 = t * kNmK;
    const bool edge = k0 + kNmK > Sk;
#pragma unroll
    for (int j = 0; j < kKn; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + c0 + (e & 1);
        float x = s[j][e];
        if constexpr (kBiased) {
          const float* br = brow[e >> 1];
          if (br != nullptr && col < Sk) x += __ldg(br + col);
          x -= shift;
        }
        float p = __expf(x);
        if (edge && col >= Sk) p = 0.f;
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }

    // o += p v, with p rounded to bf16 (the accumulator layout of two n8
    // logit tiles is the A-fragment layout of one k16 step).
#pragma unroll
    for (int kk = 0; kk < kNmK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < kDn; j += 2) {
        uint32_t vf[4];   // keys kk*16 .. + 15, head-dim columns j*8 .. + 15
        ldmatrix_x4_trans(vf, &vs[stage][kk * 16 + ((lane / 8) % 2) * 8 + lane % 8]
                                 [(j + lane / 16) * 8]);
        mma_16816(o[j], a, vf[0], vf[1]);
        mma_16816(o[j + 1], a, vf[2], vf[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

  // The quad's partial row sums meet here, once; then one division.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + i * 8;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = out + (bh * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < kDn; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + c0) =
          __floats2bfloat162_rn(o[j][2 * i] / l[i], o[j][2 * i + 1] / l[i]);
    }
  }
}

}  // namespace

// C entry for ctypes. All tensors are contiguous: q, out [B, H, Sq, d] bf16;
// k, v [B, H, Sk, d] bf16; bias [B, H, Sq, Sk] fp32 with shift one fp32 on
// the device, or both null. d is 32 or 64. Returns the launch's
// cudaGetLastError() (0 on success); the caller checks it.
extern "C" int vivid_flash_nomax_fwd(
    const void* q, const void* k, const void* v, const void* bias, const void* shift,
    void* out, int B, int H, int Sq, int Sk, int d, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || B > 65535 || H > 65535 ||
      (d != 32 && d != 64) || (bias == nullptr) != (shift == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((Sq + kNmQ - 1) / kNmQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* bp = static_cast<const float*>(bias);
  const auto* sp = static_cast<const float*>(shift);
  auto* op = static_cast<__nv_bfloat16*>(out);
  constexpr int kThreads = kNmWarps * 32;
  if (d == 64) {
    if (bias != nullptr) {
      flash_nomax_kernel<64, true><<<grid, kThreads, 0, st>>>(qp, kp, vp, bp, sp, op, Sq, Sk);
    } else {
      flash_nomax_kernel<64, false><<<grid, kThreads, 0, st>>>(qp, kp, vp, bp, sp, op, Sq, Sk);
    }
  } else {
    if (bias != nullptr) {
      flash_nomax_kernel<32, true><<<grid, kThreads, 0, st>>>(qp, kp, vp, bp, sp, op, Sq, Sk);
    } else {
      flash_nomax_kernel<32, false><<<grid, kThreads, 0, st>>>(qp, kp, vp, bp, sp, op, Sq, Sk);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
