// Big-S flash attention with a running max, forward and backward, for
// training the 256px super-resolution model (sm_90a).
//
// Replaces JAX's pallas.ops.tpu.flash_attention as _stock_flash calls it in
// vivid_tpu/kernels/attention.py: the forward that returns the output with
// its row statistics, and the backward kernels for dk/dv and for dq with the
// bias cotangent. In the JAX package this is the backward of the no-max
// forward (flash_nomax): jax.vjp(_stock_flash) runs this forward again for
// the statistics, then the two backward kernels. The port keeps that
// schedule (kernels/flash.py `_NomaxAttention`).
//
// Inputs are q [B, H, Sq, D] and k, v [B, H, Sk, D] in bf16, pixel-normalised
// by the caller, and an optional unscaled fp32 bias [B, H, Sq, Sk]:
//
//   s   = (q / sqrt(D)) . k (+ bias)       q / sqrt(D) rounded to bf16 once,
//                                          as the no-max kernel rounds it
//   fwd:  o = softmax(s) v,  lse = log sum exp(s)   (exact for any logits:
//         online softmax with a running max)
//   bwd:  P = exp(s - lse),  delta = rowsum(dO o o),
//         dv = P^T dO,  dS = P o (dO v^T - delta),
//         dq = dS k / sqrt(D),  dk = dS^T (q / sqrt(D)),  dbias = dS
//
// P and dS are rounded to bf16 for the second products, their fp32 values
// feed the sums and dbias. delta comes from the output this forward wrote
// (rounded to bf16), so forward and backward of this file are one
// consistent pair whatever kernel made the output the model used.
//
// Design. Blocks share nothing and a training step must repeat bitwise, so
// no sum crosses blocks by atomics; every output element has one owner:
//   flash_fwd_kernel      one block of 8 warps per (b, h, 128 query rows);
//                         q fragments in registers, K/V tiles of 64 keys
//                         through a two-stage cp.async ring, ldmatrix
//                         fragments (the no-max kernel's feeding), plus the
//                         running max and one rescale per tile.
//   bwd_delta_kernel      one warp per row: delta = sum(dO * o).
//   flash_bwd_dkv_kernel  one block of 4 warps per (b, h, 64 keys); k and v
//                         fragments in registers; Q and dO tiles of 64 rows
//                         stream through the ring with their lse and delta.
//                         It forms the transposed tiles S^T = k q^T and
//                         dP^T = v dO^T, so P^T and dS^T come out in the
//                         accumulator layout that is the A operand of the
//                         products into dv and dk: nothing is transposed
//                         through shared memory. Each thread scales the q
//                         chunks it copied, in place, before the block meets.
//   flash_bwd_dq_kernel   one block of 4 warps per (b, h, 64 query rows); q
//                         and dO fragments in registers, K/V tiles through
//                         the ring; writes dq and its rows of dbias.
// Any Sq and Sk: rows past the end are zero-filled and not written; a key
// past the end gets p = 0 (forward) or dS = 0 (backward).
//
// What bounds it: operations. The backward needs 10 B H Sq Sk D operations
// (five Sq x Sk x D products) against inputs and outputs of a few tens of
// MB, three orders of magnitude above the 295 operations a byte where the
// tensor cores become the limit; with a bias the fp32 bias and dbias
// (8 B H Sq Sk bytes) turn the bound to bytes. The two backward kernels each
// recompute S and dP: seven products where five are needed. mma.sync cannot
// reach the wgmma rate; wgmma + TMA and saving the no-max forward's row sums
// are later work.

#include "flash_common.cuh"

namespace {

using namespace vivid;

constexpr int kFwQ = 128;      // forward: query rows per block, 16 per warp
constexpr int kFwK = 64;       // forward: keys per shared-memory tile
constexpr int kFwWarps = 8;
constexpr int kBwQ = 64;       // backward: query rows per tile
constexpr int kBwK = 64;       // backward: keys per tile
constexpr int kBwWarps = 4;
constexpr int kBwThreads = kBwWarps * 32;
constexpr int kBwChunk = 32;   // tile columns handled at a time
constexpr int kBwCn = kBwChunk / 8;
constexpr int kStages = 2;
constexpr int kTileRows = 64;  // rows of every shared-memory tile
static_assert(kFwK == kTileRows && kBwQ == kTileRows && kBwK == kTileRows, "copy_tile");

// 1/sqrt(D) as the nearest fp32, the value the plain version multiplies by.
template <int D>
constexpr float kScaleOf = D == 32 ? 0.17677669529663687f : 0.125f;

// A-operand fragments of 16 rows starting at `row0` of a [rows, D] matrix in
// device memory: this thread's rows r0 and r0 + 8, scaled by `scale` in fp32
// and rounded once. Rows at or past `len` read as zeros.
template <int D>
__device__ __forceinline__ void load_a_global(const __nv_bfloat16* base, int row0, int len,
                                              int r0, int c0, float scale,
                                              uint32_t (&f)[D / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + r0 + (i & 1) * 8;
      const int col = kk * 16 + c0 + (i >> 1) * 8;
      if (row < len) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
            base + static_cast<long long>(row) * D + col);
        f[kk][i] = pack_bf16(__bfloat162float(x.x) * scale, __bfloat162float(x.y) * scale);
      } else {
        f[kk][i] = 0u;
      }
    }
  }
}

// Rows [r_first, r_first + kTileRows) of a [len, D] matrix into a padded tile;
// rows at or past `len` are zero-filled.
template <int D, int kThreads>
__device__ __forceinline__ void copy_tile(__nv_bfloat16 (*tile)[D + 8],
                                          const __nv_bfloat16* base, int r_first, int len) {
  constexpr int kRowChunks = D / 8;   // 16-byte chunks in one row
  for (int c = threadIdx.x; c < kTileRows * kRowChunks; c += kThreads) {
    const int r = c / kRowChunks;
    const int col = (c % kRowChunks) * 8;
    const bool ok = r_first + r < len;
    const long long off = static_cast<long long>(ok ? r_first + r : len - 1) * D + col;
    cp_async16(&tile[r][col], base + off, ok ? 16 : 0);
  }
}

// acc[j] (16 x 8 each, kBwCn of them) = a (16 x D) . tile[row0 + j*8 ..][:]^T.
template <int D>
__device__ __forceinline__ void chunk_product(float (&acc)[kBwCn][4],
                                              const uint32_t (&a)[D / 16][4],
                                              const __nv_bfloat16 (*tile)[D + 8], int row0,
                                              int lane) {
#pragma unroll
  for (int j = 0; j < kBwCn; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t b[4];   // rows row0 + j*8 .., columns kk*16 .. kk*16 + 31
      ldmatrix_x4(b, &tile[row0 + j * 8 + lane % 8][kk * 16 + (lane / 8) * 8]);
      mma_16816(acc[j], a[kk], b[0], b[1]);
      mma_16816(acc[j], a[kk + 1], b[2], b[3]);
    }
  }
}

// out (16 x D) += w (16 x kBwChunk, rounded to bf16) . tile[row0 ..][:]. The
// accumulator layout of two n8 tiles is the A-fragment layout of a k16 step.
template <int D>
__device__ __forceinline__ void chunk_accumulate(float (&out)[D / 8][4],
                                                 const float (&w)[kBwCn][4],
                                                 const __nv_bfloat16 (*tile)[D + 8], int row0,
                                                 int lane) {
#pragma unroll
  for (int kk = 0; kk < kBwChunk / 16; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(w[2 * kk][0], w[2 * kk][1]), pack_bf16(w[2 * kk][2], w[2 * kk][3]),
        pack_bf16(w[2 * kk + 1][0], w[2 * kk + 1][1]),
        pack_bf16(w[2 * kk + 1][2], w[2 * kk + 1][3])};
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      uint32_t b[4];   // rows row0 + kk*16 .. + 15, columns j*8 .. + 15
      ldmatrix_x4_trans(b, &tile[row0 + kk * 16 + ((lane / 8) % 2) * 8 + lane % 8]
                                [(j + lane / 16) * 8]);
      mma_16816(out[j], a, b[0], b[1]);
      mma_16816(out[j + 1], a, b[2], b[3]);
    }
  }
}

template <int D, bool kBiased>
__global__ void __launch_bounds__(kFwWarps * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Sq, int Sk) {
  constexpr int kPad = D + 8;         // +16 bytes a row: ldmatrix rows hit distinct banks
  constexpr int kDk = D / 16;
  constexpr int kDn = D / 8;
  constexpr int kKn = kFwK / 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kStages][kFwK][kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kStages][kFwK][kPad];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kFwQ;
  const long long bh = static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  const __nv_bfloat16* kb = k + bh * Sk * D;
  const __nv_bfloat16* vb = v + bh * Sk * D;
  const int n_tiles = (Sk + kFwK - 1) / kFwK;

  auto load_tile = [&](int tile, int stage) {
    copy_tile<D, kFwWarps * 32>(ks[stage], kb, tile * kFwK, Sk);
    copy_tile<D, kFwWarps * 32>(vs[stage], vb, tile * kFwK, Sk);
    cp_async_commit();
  };
  load_tile(0, 0);

  // This thread holds rows r0 and r0 + 8 of the warp's 16 query rows, and
  // columns c0, c0 + 1 of every n8 tile.
  const int r0 = warp * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
  uint32_t qf[kDk][4];
  load_a_global<D>(q + bh * Sq * D, q0, Sq, r0, c0, kScaleOf<D>, qf);

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

    // Bias, the ragged edge, and the tile's row maxima.
    const int k0 = t * kFwK;
    const bool edge = k0 + kFwK > Sk;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kKn; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + c0 + (e & 1);
        float x = s[j][e];
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

    // o += p v, with p rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < kFwK / 16; ++kk) {
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
    if (lane % 4 == 0) lse[bh * Sq + row] = m[i] + logf(l[i]);
  }
}

// delta[row] = sum_d dO[row, d] * o[row, d], one warp per row.
template <int D>
__global__ void __launch_bounds__(256)
bwd_delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ g,
                 float* __restrict__ delta, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float acc;
  if constexpr (D == 64) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(o + row * D + 2 * lane);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(g + row * D + 2 * lane);
    acc = __bfloat162float(a.x) * __bfloat162float(b.x)
        + __bfloat162float(a.y) * __bfloat162float(b.y);
  } else {
    acc = __bfloat162float(o[row * D + lane]) * __bfloat162float(g[row * D + lane]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// dk and dv of one (b, h, 64-key tile).
template <int D, bool kBiased>
__global__ void __launch_bounds__(kBwThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Sq, int Sk) {
  constexpr int kPad = D + 8;
  constexpr int kDk = D / 16;
  constexpr int kDn = D / 8;
  constexpr int kRowChunks = D / 8;
  static_assert(kBwThreads == 2 * kBwQ, "one thread per lse and per delta of a tile");
  __shared__ __align__(16) __nv_bfloat16 qs[kStages][kBwQ][kPad];
  __shared__ __align__(16) __nv_bfloat16 gs[kStages][kBwQ][kPad];
  __shared__ float lse_s[kStages][kBwQ];
  __shared__ float delta_s[kStages][kBwQ];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kBwK;
  const long long bh = static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  const __nv_bfloat16* qb = q + bh * Sq * D;
  const __nv_bfloat16* gb = g + bh * Sq * D;
  const float* lse_b = lse + bh * Sq;
  const float* delta_b = delta + bh * Sq;
  const int n_tiles = (Sq + kBwQ - 1) / kBwQ;

  auto load_tile = [&](int tile, int stage) {
    const int q0 = tile * kBwQ;
    copy_tile<D, kBwThreads>(qs[stage], qb, q0, Sq);
    copy_tile<D, kBwThreads>(gs[stage], gb, q0, Sq);
    // Statistics of rows past the end read as 0: with their zero q and dO
    // rows they add nothing to dk or dv.
    const int r = threadIdx.x % kBwQ;
    const bool ok = q0 + r < Sq;
    const int row = ok ? q0 + r : Sq - 1;
    if (threadIdx.x < kBwQ) {
      cp_async4(&lse_s[stage][r], lse_b + row, ok ? 4 : 0);
    } else {
      cp_async4(&delta_s[stage][r], delta_b + row, ok ? 4 : 0);
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  // This thread holds keys kr0 and kr0 + 8 of the warp's 16, and columns
  // c0, c0 + 1 of every n8 tile.
  const int kr0 = warp * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
  const int keys[2] = {k0 + kr0, k0 + kr0 + 8};
  uint32_t kf[kDk][4], vf[kDk][4];
  load_a_global<D>(k + bh * Sk * D, k0, Sk, kr0, c0, 1.f, kf);
  load_a_global<D>(v + bh * Sk * D, k0, Sk, kr0, c0, 1.f, vf);

  float dka[kDn][4], dva[kDn][4];
#pragma unroll
  for (int j = 0; j < kDn; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_tile(t + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // q / sqrt(D), rounded once: each thread scales the chunks it copied.
    for (int c = threadIdx.x; c < kBwQ * kRowChunks; c += kBwThreads) {
      uint4* p = reinterpret_cast<uint4*>(&qs[stage][c / kRowChunks][(c % kRowChunks) * 8]);
      uint4 w = *p;
      uint32_t* h = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&h[i]));
        h[i] = pack_bf16(f.x * kScaleOf<D>, f.y * kScaleOf<D>);
      }
      *p = w;
    }
    __syncthreads();   // every thread's part of tile t has landed, scaled

    const int q0 = t * kBwQ;
#pragma unroll 1
    for (int cc = 0; cc < kBwQ; cc += kBwChunk) {
      // Transposed tiles: rows are this warp's keys, columns the queries.
      float st[kBwCn][4], dpt[kBwCn][4];
      chunk_product<D>(st, kf, qs[stage], cc, lane);
      chunk_product<D>(dpt, vf, gs[stage], cc, lane);
#pragma unroll
      for (int j = 0; j < kBwCn; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = cc + j * 8 + c0 + (e & 1);
          float sv = st[j][e];
          if constexpr (kBiased) {
            const int key = keys[e >> 1];
            if (q0 + qc < Sq && key < Sk) {
              sv += __ldg(bias + (bh * Sq + q0 + qc) * Sk + key);
            }
          }
          const float pe = __expf(sv - lse_s[stage][qc]);
          st[j][e] = pe;                                        // P^T
          dpt[j][e] = pe * (dpt[j][e] - delta_s[stage][qc]);    // dS^T
        }
      }
      chunk_accumulate<D>(dva, st, gs[stage], cc, lane);
      chunk_accumulate<D>(dka, dpt, qs[stage], cc, lane);
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

  // q was scaled before the product, so dk already carries 1/sqrt(D).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= Sk) continue;
    const long long off = (bh * Sk + keys[i]) * D;
#pragma unroll
    for (int j = 0; j < kDn; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + j * 8 + c0) =
          __floats2bfloat162_rn(dka[j][2 * i], dka[j][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + j * 8 + c0) =
          __floats2bfloat162_rn(dva[j][2 * i], dva[j][2 * i + 1]);
    }
  }
}

// dq, and with a bias dbias = dS, of one (b, h, 64-row query tile).
template <int D, bool kBiased>
__global__ void __launch_bounds__(kBwThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                    float* __restrict__ dbias, int Sq, int Sk) {
  constexpr int kPad = D + 8;
  constexpr int kDk = D / 16;
  constexpr int kDn = D / 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kStages][kBwK][kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kStages][kBwK][kPad];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBwQ;
  const long long bh = static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  const __nv_bfloat16* kb = k + bh * Sk * D;
  const __nv_bfloat16* vb = v + bh * Sk * D;
  const int n_tiles = (Sk + kBwK - 1) / kBwK;

  auto load_tile = [&](int tile, int stage) {
    copy_tile<D, kBwThreads>(ks[stage], kb, tile * kBwK, Sk);
    copy_tile<D, kBwThreads>(vs[stage], vb, tile * kBwK, Sk);
    cp_async_commit();
  };
  load_tile(0, 0);

  const int r0 = warp * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
  const int rows[2] = {q0 + r0, q0 + r0 + 8};
  uint32_t qf[kDk][4], gf[kDk][4];
  load_a_global<D>(q + bh * Sq * D, q0, Sq, r0, c0, kScaleOf<D>, qf);
  load_a_global<D>(g + bh * Sq * D, q0, Sq, r0, c0, 1.f, gf);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse_r[i] = rows[i] < Sq ? lse[bh * Sq + rows[i]] : 0.f;
    delta_r[i] = rows[i] < Sq ? delta[bh * Sq + rows[i]] : 0.f;
  }

  float dqa[kDn][4];
#pragma unroll
  for (int j = 0; j < kDn; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_tile(t + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int k0 = t * kBwK;
#pragma unroll 1
    for (int cc = 0; cc < kBwK; cc += kBwChunk) {
      float s[kBwCn][4], dp[kBwCn][4];
      chunk_product<D>(s, qf, ks[stage], cc, lane);
      chunk_product<D>(dp, gf, vs[stage], cc, lane);
#pragma unroll
      for (int j = 0; j < kBwCn; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int col = k0 + cc + j * 8 + c0 + (e & 1);
          const bool live = rows[i] < Sq && col < Sk;
          float x = s[j][e];
          long long at = 0;
          if constexpr (kBiased) {
            at = (bh * Sq + rows[i]) * Sk + col;
            if (live) x += __ldg(bias + at);
          }
          float ds = __expf(x - lse_r[i]) * (dp[j][e] - delta_r[i]);
          if (col >= Sk) ds = 0.f;   // a key past the end: p is not 0 there
          s[j][e] = ds;
          if constexpr (kBiased) {
            if (live) dbias[at] = ds;
          }
        }
      }
      chunk_accumulate<D>(dqa, s, ks[stage], cc, lane);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= Sq) continue;
    __nv_bfloat16* row = dq + (bh * Sq + rows[i]) * D;
#pragma unroll
    for (int j = 0; j < kDn; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(row + j * 8 + c0) = __floats2bfloat162_rn(
          dqa[j][2 * i] * kScaleOf<D>, dqa[j][2 * i + 1] * kScaleOf<D>);
    }
  }
}

bool bad_shape(int B, int H, int Sq, int Sk, int d) {
  return B < 1 || H < 1 || Sq < 1 || Sk < 1 || B > 65535 || H > 65535 || (d != 32 && d != 64);
}

template <int D, bool kBiased>
int launch_bwd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
               const float* bias, const __nv_bfloat16* out, const float* lse,
               const __nv_bfloat16* g, float* delta, __nv_bfloat16* dq, __nv_bfloat16* dk,
               __nv_bfloat16* dv, float* dbias, int B, int H, int Sq, int Sk,
               cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * H * Sq;
  bwd_delta_kernel<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(out, g, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_k((Sk + kBwK - 1) / kBwK, H, B);
  flash_bwd_dkv_kernel<D, kBiased><<<grid_k, kBwThreads, 0, st>>>(
      q, k, v, bias, g, lse, delta, dk, dv, Sq, Sk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((Sq + kBwQ - 1) / kBwQ, H, B);
  flash_bwd_dq_kernel<D, kBiased><<<grid_q, kBwThreads, 0, st>>>(
      q, k, v, bias, g, lse, delta, dq, dbias, Sq, Sk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries for ctypes. All tensors are contiguous: q, out, g, dq
// [B, H, Sq, d] bf16; k, v, dk, dv [B, H, Sk, d] bf16; lse, delta [B, H, Sq]
// fp32; bias, dbias [B, H, Sq, Sk] fp32 or both null. d is 32 or 64. Each
// returns the first launch error (0 on success); the caller checks it.

// out and lse are written.
extern "C" int vivid_flash_attn_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out, void* lse,
    int B, int H, int Sq, int Sk, int d, void* stream) {
  if (bad_shape(B, H, Sq, Sk, d)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sq + kFwQ - 1) / kFwQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(lse);
  constexpr int kThreads = kFwWarps * 32;
  if (d == 64) {
    if (bias != nullptr) {
      flash_fwd_kernel<64, true><<<grid, kThreads, 0, st>>>(qp, kp, vp, bp, op, lp, Sq, Sk);
    } else {
      flash_fwd_kernel<64, false><<<grid, kThreads, 0, st>>>(qp, kp, vp, bp, op, lp, Sq, Sk);
    }
  } else {
    if (bias != nullptr) {
      flash_fwd_kernel<32, true><<<grid, kThreads, 0, st>>>(qp, kp, vp, bp, op, lp, Sq, Sk);
    } else {
      flash_fwd_kernel<32, false><<<grid, kThreads, 0, st>>>(qp, kp, vp, bp, op, lp, Sq, Sk);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// out and lse are this file's forward's; delta is scratch; dq, dk, dv and
// (with a bias) every element of dbias are written.
extern "C" int vivid_flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* bias, const void* out,
    const void* lse, const void* g, void* delta, void* dq, void* dk, void* dv, void* dbias,
    int B, int H, int Sq, int Sk, int d, void* stream) {
  if (bad_shape(B, H, Sq, Sk, d) || (bias == nullptr) != (dbias == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* bp = static_cast<const float*>(bias);
  const auto* op = static_cast<const __nv_bfloat16*>(out);
  const auto* lp = static_cast<const float*>(lse);
  const auto* gp = static_cast<const __nv_bfloat16*>(g);
  auto* dl = static_cast<float*>(delta);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  auto* dbp = static_cast<float*>(dbias);
  if (d == 64) {
    return bias != nullptr
        ? launch_bwd<64, true>(qp, kp, vp, bp, op, lp, gp, dl, dqp, dkp, dvp, dbp, B, H, Sq, Sk, st)
        : launch_bwd<64, false>(qp, kp, vp, bp, op, lp, gp, dl, dqp, dkp, dvp, dbp, B, H, Sq, Sk, st);
  }
  return bias != nullptr
      ? launch_bwd<32, true>(qp, kp, vp, bp, op, lp, gp, dl, dqp, dkp, dvp, dbp, B, H, Sq, Sk, st)
      : launch_bwd<32, false>(qp, kp, vp, bp, op, lp, gp, dl, dqp, dkp, dvp, dbp, B, H, Sq, Sk, st);
}
