// Lab variants of the big-S no-max attention (sm_90a).
//
// Replaces the TPU kernel nomax_attention (_kernel_nomax) of
// tools/nomax_attn_lab.py: attention on pixel-normalised q [B, H, Sq, D] and
// k, v [B, H, Sk, D] in bf16 with the constant softmax shift sqrt(D) and no
// running max, under three switches that the lab times against each other:
//
//   prescale   q / sqrt(D) in fp32 rounded to bf16 once, then
//              p = exp(q . k - sqrt(D)); without it p = exp(q . k / sqrt(D)
//              - sqrt(D)), the scale on the fp32 logits
//   fold_l     the denominator is summed by the tensor cores: V gains one
//              8-wide column group whose first column is ones, so the product
//              that forms P V also forms the row sums, from the p that was
//              rounded to bf16. Without it each thread adds up its unrounded
//              fp32 p. The extra column group is the same for every tile, so
//              it is a constant B fragment in registers and never stored.
//   chains     1, 2 or 4 independent accumulator sets, each over its part of
//              the 64-key tile (64, 32 or 16 keys), added up after the last
//              tile: products of one chain can overlap the exponentials of
//              another
//
// Row norms are at most sqrt(D), so every scaled logit lies below sqrt(D)
// and p <= 1: the contract is the caller's, as in flash_nomax.cu, whose
// feeding this file shares: one block of 8 warps per (b, h, 128 query rows),
// q fragments in registers, 64-key K and V tiles through a two-stage
// cp.async ring, ldmatrix fragments. Any Sq and Sk: a key past the end gets
// p = 0, a query row past the end is not written.
//
// What bounds it: operations (4 B H Sq Sk D over the tensor-core peak; the
// inputs are tens of MB and every query tile of a (b, h) reads K and V out of
// L2). At D = 32 one exp stands against 128 tensor-core operations, so the
// special-function unit is the second limit; fold_l adds one n8 product in
// D / 8 + 1 and removes an fp32 add a logit.

#include "flash_common.cuh"

namespace {

using namespace vivid;

constexpr int kLabQ = 128;      // query rows per block, 16 per warp
constexpr int kLabK = 64;       // keys per shared-memory tile
constexpr int kLabWarps = 8;
constexpr int kLabThreads = kLabWarps * 32;

template <int D, bool kFoldL, int kChains, bool kPrescale>
__global__ void __launch_bounds__(kLabThreads)
flash_nomax_lab_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       int Sq, int Sk) {
  constexpr int kDk = D / 16;
  constexpr int kDn = D / 8;
  constexpr int kPart = kLabK / kChains;   // keys of a tile that one chain takes
  constexpr int kPn = kPart / 8;           // n8 tiles over a chain's keys
  // 1/sqrt(D) and sqrt(D) as the nearest fp32, the values the plain version uses.
  constexpr float kScale = D == 32 ? 0.17677669529663687f : 0.125f;
  constexpr float kShift = D == 32 ? 5.656854249492381f : 8.0f;
  __shared__ __align__(16) __nv_bfloat16 ks[2][kLabK][D + 8];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kLabK][D + 8];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kLabQ;
  const long long bh = static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  const __nv_bfloat16* kb = k + bh * Sk * D;
  const __nv_bfloat16* vb = v + bh * Sk * D;
  const int n_tiles = (Sk + kLabK - 1) / kLabK;

  auto load_tile = [&](int tile, int stage) {
    copy_rows<D, kLabK, kLabThreads>(ks[stage], kb, D, tile * kLabK, Sk);
    copy_rows<D, kLabK, kLabThreads>(vs[stage], vb, D, tile * kLabK, Sk);
    cp_async_commit();
  };
  load_tile(0, 0);

  // This thread holds rows r0 and r0 + 8 of the warp's 16 query rows, and
  // columns c0, c0 + 1 of every n8 tile.
  const int r0 = warp * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
  uint32_t qf[kDk][4];
  load_q_fragments<D, false, false>(q + bh * Sq * D, D, q0, Sq, r0, c0, 0.f,
                                    kPrescale ? kScale : 1.0f, qf);
  // B fragment of V's extra column group: column 0 all ones (bf16 1.0 twice),
  // columns 1-7 zeros. A thread holds column lane / 4 of an n8 tile.
  const uint32_t ones = lane / 4 == 0 ? 0x3f803f80u : 0u;

  float o[kChains][kDn][4];
  float l[kChains][4];   // fold_l: the extra n8 tile's accumulator; else [0], [1] partial sums
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) l[c][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kDn; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][j][e] = 0.f;
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

    const int k0 = t * kLabK;
    const bool edge = k0 + kLabK > Sk;
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      // Logits of the warp's 16 rows against this chain's keys.
      float s[kPn][4];
#pragma unroll
      for (int j = 0; j < kPn; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kDk; kk += 2) {
          uint32_t kf[4];
          ldmatrix_x4(kf, &ks[stage][c * kPart + j * 8 + lane % 8][kk * 16 + (lane / 8) * 8]);
          mma_16816(s[j], qf[kk], kf[0], kf[1]);
          mma_16816(s[j], qf[kk + 1], kf[2], kf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kPn; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = kPrescale ? __expf(s[j][e] - kShift) : __expf(s[j][e] * kScale - kShift);
          if (edge && k0 + c * kPart + j * 8 + c0 + (e & 1) >= Sk) p = 0.f;
          s[j][e] = p;
          if constexpr (!kFoldL) l[c][e >> 1] += p;
        }
      }
      // o += p v, with p rounded to bf16; with fold_l one more n8 tile sums it.
#pragma unroll
      for (int kk = 0; kk < kPart / 16; ++kk) {
        const uint32_t a[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < kDn; j += 2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(
              vf, &vs[stage][c * kPart + kk * 16 + ((lane / 8) % 2) * 8 + lane % 8]
                     [(j + lane / 16) * 8]);
          mma_16816(o[c][j], a, vf[0], vf[1]);
          mma_16816(o[c][j + 1], a, vf[2], vf[3]);
        }
        if constexpr (kFoldL) mma_16816(l[c], a, ones, ones);
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

  // The chains meet; then the row sums: with fold_l column 0 of the extra
  // tile, which the quad's first lane holds (rows r0 and r0 + 8 in elements 0
  // and 2); else the quad's partial sums. One division.
#pragma unroll
  for (int c = 1; c < kChains; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) l[0][e] += l[c][e];
#pragma unroll
    for (int j = 0; j < kDn; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[0][j][e] += o[c][j][e];
  }
  float den[2];
  if constexpr (kFoldL) {
    den[0] = __shfl_sync(0xffffffffu, l[0][0], lane & ~3);
    den[1] = __shfl_sync(0xffffffffu, l[0][2], lane & ~3);
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      den[i] = l[0][i];
      den[i] += __shfl_xor_sync(0xffffffffu, den[i], 1);
      den[i] += __shfl_xor_sync(0xffffffffu, den[i], 2);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + i * 8;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = out + (bh * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < kDn; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + c0) =
          __floats2bfloat162_rn(o[0][j][2 * i] / den[i], o[0][j][2 * i + 1] / den[i]);
    }
  }
}

template <int D, bool kFoldL, int kChains>
void launch_prescale(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                     __nv_bfloat16* out, dim3 grid, int Sq, int Sk, bool prescale,
                     cudaStream_t st) {
  if (prescale) {
    flash_nomax_lab_kernel<D, kFoldL, kChains, true><<<grid, kLabThreads, 0, st>>>(
        q, k, v, out, Sq, Sk);
  } else {
    flash_nomax_lab_kernel<D, kFoldL, kChains, false><<<grid, kLabThreads, 0, st>>>(
        q, k, v, out, Sq, Sk);
  }
}

template <int D, bool kFoldL>
void launch_chains(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   __nv_bfloat16* out, dim3 grid, int Sq, int Sk, int chains, bool prescale,
                   cudaStream_t st) {
  if (chains == 1) {
    launch_prescale<D, kFoldL, 1>(q, k, v, out, grid, Sq, Sk, prescale, st);
  } else if (chains == 2) {
    launch_prescale<D, kFoldL, 2>(q, k, v, out, grid, Sq, Sk, prescale, st);
  } else {
    launch_prescale<D, kFoldL, 4>(q, k, v, out, grid, Sq, Sk, prescale, st);
  }
}

template <int D>
void launch_fold(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                 __nv_bfloat16* out, dim3 grid, int Sq, int Sk, bool fold_l, int chains,
                 bool prescale, cudaStream_t st) {
  if (fold_l) {
    launch_chains<D, true>(q, k, v, out, grid, Sq, Sk, chains, prescale, st);
  } else {
    launch_chains<D, false>(q, k, v, out, grid, Sq, Sk, chains, prescale, st);
  }
}

}  // namespace

// C entry for ctypes. All tensors are contiguous: q, out [B, H, Sq, d] bf16;
// k, v [B, H, Sk, d] bf16. d is 32 or 64; chains is 1, 2 or 4. Returns the
// launch's cudaGetLastError() (0 on success); the caller checks it.
extern "C" int vivid_flash_nomax_lab_fwd(
    const void* q, const void* k, const void* v, void* out,
    int B, int H, int Sq, int Sk, int d, int fold_l, int chains, int prescale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || B > 65535 || H > 65535 ||
      (d != 32 && d != 64) || (chains != 1 && chains != 2 && chains != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((Sq + kLabQ - 1) / kLabQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (d == 64) {
    launch_fold<64>(qp, kp, vp, op, grid, Sq, Sk, fold_l != 0, chains, prescale != 0, st);
  } else {
    launch_fold<32>(qp, kp, vp, op, grid, Sq, Sk, fold_l != 0, chains, prescale != 0, st);
  }
  return static_cast<int>(cudaGetLastError());
}
