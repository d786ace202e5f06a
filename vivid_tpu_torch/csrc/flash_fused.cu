// Blocked online-softmax attention on [B, H, S, D] with the pixel norm and
// the zero sink inside the kernel (sm_90a).
//
// Replaces the TPU kernel flash_fused (_kernel) in vivid_tpu/kernels/flash.py.
// Inputs are q [B, H, Sq, D] and k, v [B, H, Sk, D] in bf16 and an optional
// unscaled fp32 bias [B, H, Sq, Sk]:
//
//   with the norm (eps > 0 given): every q, k and v row is pixel-normalised,
//     x / (eps + ||x|| / sqrt(D)) in fp32, and rounded to bf16, as the TPU
//     kernel's _rms_norm does; without it the rows are taken as they are
//     (the caller has normalised them)
//   s = (q . k) / sqrt(D) + bias      the scale multiplies the fp32 logits,
//                                     as in the TPU kernel, not q
//   o = softmax(s) v                  online softmax with a running max, p
//                                     rounded to bf16 for the second product,
//                                     its row sum kept in fp32
//   zero_sink all-zero key columns (logit 0, value 0): after the last tile
//     the max is raised to max(m, 0) and zero_sink * exp(-m) joins the
//     denominator. A bias and a sink may come together.
//
// Design for this card: the big-S forward's (flash_bwd.cu flash_fwd_kernel):
// one block of 8 warps per (b, h, 128 query rows), 16 rows a warp, q
// fragments in registers, K and V tiles of 64 keys through a two-stage
// cp.async ring, ldmatrix fragments. The norm is added where the data
// already is: a q row's D values lie in one quad's registers, so its sum of
// squares meets in two shuffles; a K or V tile is normalised in place in
// shared memory once it has landed, one warp a row, which costs one more
// block-wide barrier a tile. Any Sq and Sk: rows past the end are zero-filled
// and not written, a key past the end gets logit -inf.
//
// What bounds it: operations at the lab's shapes (4 B H Sq Sk D over the
// tensor-core peak, the inputs being a few tens of MB), bytes at the 64px
// path's shapes with a bias (4 B H Sq Sk bytes of it). Every query tile
// normalises the same K and V rows again: Sq / 128 times the norm's work,
// which a pre-pass (one more pass over device memory) would save. mma.sync
// cannot reach the wgmma rate.

#include "flash_common.cuh"

namespace {

using namespace vivid;

constexpr int kFfQ = 128;      // query rows per block, 16 per warp
constexpr int kFfK = 64;       // keys per shared-memory tile
constexpr int kFfWarps = 8;
constexpr int kFfThreads = kFfWarps * 32;

template <int D, bool kBiased, bool kNorm>
__global__ void __launch_bounds__(kFfThreads)
flash_fused_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, int Sq, int Sk, float eps,
                   float zero_sink) {
  constexpr int kDk = D / 16;
  constexpr int kDn = D / 8;
  constexpr int kKn = kFfK / 8;
  // 1/sqrt(D) as the nearest fp32, the value the plain version multiplies by.
  constexpr float kScale = D == 32 ? 0.17677669529663687f : 0.125f;
  __shared__ __align__(16) __nv_bfloat16 ks[2][kFfK][D + 8];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kFfK][D + 8];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kFfQ;
  const long long bh = static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  const __nv_bfloat16* kb = k + bh * Sk * D;
  const __nv_bfloat16* vb = v + bh * Sk * D;
  const int n_tiles = (Sk + kFfK - 1) / kFfK;

  auto load_tile = [&](int tile, int stage) {
    copy_rows<D, kFfK, kFfThreads>(ks[stage], kb, D, tile * kFfK, Sk);
    copy_rows<D, kFfK, kFfThreads>(vs[stage], vb, D, tile * kFfK, Sk);
    cp_async_commit();
  };
  load_tile(0, 0);

  // This thread holds rows r0 and r0 + 8 of the warp's 16 query rows, and
  // columns c0, c0 + 1 of every n8 tile.
  const int r0 = warp * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
  uint32_t qf[kDk][4];
  load_q_fragments<D, kNorm, true>(q + bh * Sq * D, D, q0, Sq, r0, c0, eps, 1.0f, qf);

  float o[kDn][4];
#pragma unroll
  for (int j = 0; j < kDn; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};   // per-thread partial sums; a quad holds a row
  const float* brow[2] = {nullptr, nullptr};
  if constexpr (kBiased) {
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
    if constexpr (kNorm) {
      normalize_tile<D, kFfK, kFfWarps>(ks[stage], eps);
      normalize_tile<D, kFfK, kFfWarps>(vs[stage], eps);
      __syncthreads();
    }

    float s[kKn][4];
#pragma unroll
    for (int j = 0; j < kKn; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDk; kk += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &ks[stage][j * 8 + lane % 8][kk * 16 + (lane / 8) * 8]);
        mma_16816(s[j], qf[kk], kf[0], kf[1]);
        mma_16816(s[j], qf[kk + 1], kf[2], kf[3]);
      }
    }

    // Scale, bias, the ragged edge, and the tile's row maxima.
    const int k0 = t * kFfK;
    const bool edge = k0 + kFfK > Sk;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kKn; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + c0 + (e & 1);
        float x = s[j][e] * kScale;
        if constexpr (kBiased) {
          const float* br = brow[e >> 1];
          if (br != nullptr && col < Sk) x += __ldg(br + col);
        }
        if (edge && col >= Sk) x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = __expf(m[i] - mx[i]);   // 0 on the first tile (m = -inf)
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kDn; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < kKn; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }

    // o += p v, with p rounded to bf16 (the accumulator layout of two n8
    // logit tiles is the A-fragment layout of one k16 step).
#pragma unroll
    for (int kk = 0; kk < kFfK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < kDn; j += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &vs[stage][kk * 16 + ((lane / 8) % 2) * 8 + lane % 8]
                                 [(j + lane / 16) * 8]);
        mma_16816(o[j], a, vf[0], vf[1]);
        mma_16816(o[j + 1], a, vf[2], vf[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

  // The quad's partial sums meet; the sink; one division.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    float corr = 1.f;
    if (zero_sink > 0.f) {
      const float m0 = fmaxf(m[i], 0.f);
      corr = __expf(m[i] - m0);
      l[i] = l[i] * corr + zero_sink * __expf(-m0);
    }
    const int row = q0 + r0 + i * 8;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = out + (bh * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < kDn; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + c0) = __floats2bfloat162_rn(
          o[j][2 * i] * corr / l[i], o[j][2 * i + 1] * corr / l[i]);
    }
  }
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const float* bias, __nv_bfloat16* out, int B, int H, int Sq, int Sk, bool norm,
           float eps, float zero_sink, cudaStream_t st) {
  const dim3 grid((Sq + kFfQ - 1) / kFfQ, H, B);
  if (bias != nullptr) {
    if (norm) {
      flash_fused_kernel<D, true, true><<<grid, kFfThreads, 0, st>>>(
          q, k, v, bias, out, Sq, Sk, eps, zero_sink);
    } else {
      flash_fused_kernel<D, true, false><<<grid, kFfThreads, 0, st>>>(
          q, k, v, bias, out, Sq, Sk, eps, zero_sink);
    }
  } else {
    if (norm) {
      flash_fused_kernel<D, false, true><<<grid, kFfThreads, 0, st>>>(
          q, k, v, bias, out, Sq, Sk, eps, zero_sink);
    } else {
      flash_fused_kernel<D, false, false><<<grid, kFfThreads, 0, st>>>(
          q, k, v, bias, out, Sq, Sk, eps, zero_sink);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes. All tensors are contiguous: q, out [B, H, Sq, d] bf16;
// k, v [B, H, Sk, d] bf16; bias [B, H, Sq, Sk] fp32 or null. d is 32 or 64.
// norm != 0 normalises q, k and v rows with `eps`; zero_sink >= 0. Returns
// the launch's cudaGetLastError() (0 on success); the caller checks it.
extern "C" int vivid_flash_fused_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int B, int H, int Sq, int Sk, int d, int norm, float eps, float zero_sink, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || B > 65535 || H > 65535 ||
      (d != 32 && d != 64) || zero_sink < 0.f) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<__nv_bfloat16*>(out);
  return d == 64 ? launch<64>(qp, kp, vp, bp, op, B, H, Sq, Sk, norm != 0, eps, zero_sink, st)
                 : launch<32>(qp, kp, vp, bp, op, B, H, Sq, Sk, norm != 0, eps, zero_sink, st);
}
