// Backward of the packed-layout fused attention in flash_packed.cu (sm_90a).
//
// Replaces the TPU kernels in vivid_tpu/kernels/flash.py:
//   * flash_fused_packed_bwd       (_kernel_packed_bwd): qkv, g -> dqkv, with
//     the unconditional model's zero sink;
//   * flash_fused_packed_xattn_bwd (_kernel_packed_xattn_bwd): qkv, up to two
//     cross sources, optional per-source logit biases, g -> dqkv, dfeats per
//     source, dbias per biased source;
// both bodies of _kernel_packed_bwd_common. One source serves both, as the
// forward kernel does: a launch walks 1 to 3 key/value segments.
//
// What it computes. With q', k', v' the pixel-normalised rows
// x / (eps + ||x|| / sqrt(D)) rounded to bf16 exactly as the forward kernel
// rounds them, c = 1/sqrt(D), logits s = c q'.k' (+ bias) and P the softmax
// whose denominator also holds the sink's mass zero_sink * exp(-max(m, 0)):
//   dv' = P^T dO,  dP = dO v'^T,  dS = P o (dP - rowsum(P o dP)),
//   dq' = c dS k',  dk' = c dS^T q',  dbias = dS,
// then the norm's VJP dx = dy/(eps+r) - x <x,dy> / (D r (eps+r)^2) with
// r = ||x||/sqrt(D) (r = 0 guarded) on each of q, k and v, written as bf16
// straight into the packed layouts. The softmax is exact, with a running
// max. rowsum(P o dP) is recomputed from P and dP in fp32, as the TPU
// kernel does, not taken from dO.O (the rounded output would bias every
// column of a row the same way).
//
// Design. The TPU kernel is one grid step per batch row that carries dk/dv
// through a loop over query chunks; here blocks share nothing, and the
// trainer promises bitwise repeatable steps, so no sum crosses blocks by
// atomics. Two kernels, each recomputing the logits:
//   1. bwd_dq_kernel, one block per (b, h, 64-row query tile), walks every
//      key tile twice. The first walk is the pre-pass: online softmax
//      statistics and rowsum(P o dP); it writes the log-sum-exp and that row
//      sum as fp32 [B, H, S] scratch (all the port saves between the two
//      kernels; between forward and backward it saves only the inputs). The
//      second walk forms dS, writes the dbias tiles and accumulates dq.
//   2. bwd_dkv_kernel, one block per (b, h, segment, 64-key tile), walks
//      every query tile and owns dk and dv of its keys.
// Each applies the norm VJP in its epilogue, where one quad of threads holds
// the whole D-vector. That is nine 64x64xD products per tile pair (2 + 3 in
// the first kernel, 4 in the second) where a single pass with atomics would
// do five and one with the statistics saved by the forward seven.
//
// What bounds it on the card: at the training shape B = 8, S = 1024,
// Sk = 3072, H = 4, D = 64 the function needs 10 B H S Sk D = 64 GFLOP
// against ~63 MB moved, ~1000 FLOP per byte, well above the ~295 where the
// bf16 tensor cores become the limit: the bound is operations. This first
// version is far from it: mma.sync m16n8k16 from synchronously loaded,
// single-buffered shared-memory tiles, every block normalising the rows it
// loads again, and 9/5 of the necessary products. wgmma, TMA, saved
// statistics and normalising once are later work.

#include "flash_common.cuh"

namespace {

using namespace vivid;

constexpr int kChunk = 32;              // tile columns handled at a time
constexpr int kCn = kChunk / 8;         // n8 tiles in a chunk

struct Segment {
  const __nv_bfloat16* base;  // batch 0, row 0, channel 0
  __nv_bfloat16* dbase;       // gradient of base, same layout
  const float* bias;          // [B, H, S, len] fp32, or nullptr
  float* dbias;               // gradient of bias, or nullptr
  long long batch_stride;     // elements between batch rows
  int row_stride;             // elements between sequence rows
  int k_off;                  // channel of head 0's k; head h adds h*D
  int v_off;
  int len;
};

struct Params {
  const __nv_bfloat16* qkv;
  const __nv_bfloat16* g;     // [B, S, H*D]
  __nv_bfloat16* dqkv;
  float* lse;                 // [B, H, S] log of the softmax denominator
  float* delta;               // [B, H, S] rowsum(P o dP)
  Segment seg[kMaxSegments];
  int n_seg;
  int S;
  int H;
  float eps;
  float zero_sink;
};

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// VJP of the pixel norm for the two rows of an accumulator fragment, and the
// store. dy[j][2*i + e] is the cotangent of column j*8 + c0 + e of row i
// (i = 0, 1), already scaled; x_i / out_i point at that row's D raw inputs /
// D outputs (null: the row is past the ragged edge). A quad holds a row.
template <int D>
__device__ __forceinline__ void norm_vjp_store(
    const float (&dy)[D / 8][4], const __nv_bfloat16* x0, const __nv_bfloat16* x1,
    __nv_bfloat16* out0, __nv_bfloat16* out1, int c0, float eps) {
  constexpr int kDn = D / 8;
  const __nv_bfloat16* xs[2] = {x0, x1};
  __nv_bfloat16* outs[2] = {out0, out1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float x[kDn][2];
    float ss = 0.f, xdy = 0.f;
#pragma unroll
    for (int j = 0; j < kDn; ++j) {
      if (xs[i] != nullptr) {
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(xs[i] + j * 8 + c0);
        x[j][0] = __bfloat162float(v.x);
        x[j][1] = __bfloat162float(v.y);
      } else {
        x[j][0] = x[j][1] = 0.f;
      }
      ss += x[j][0] * x[j][0] + x[j][1] * x[j][1];
      xdy += x[j][0] * dy[j][2 * i] + x[j][1] * dy[j][2 * i + 1];
    }
    ss = quad_sum(ss);
    xdy = quad_sum(xdy);
    const float r = sqrtf(ss / static_cast<float>(D));
    const float den = eps + r;
    // r == 0 means x == 0, so the second term's numerator is 0 as well.
    const float coef = xdy / (static_cast<float>(D) * den * den * fmaxf(r, 1e-30f));
    if (outs[i] == nullptr) continue;
#pragma unroll
    for (int j = 0; j < kDn; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(outs[i] + j * 8 + c0) = __floats2bfloat162_rn(
          dy[j][2 * i] / den - x[j][0] * coef, dy[j][2 * i + 1] / den - x[j][1] * coef);
    }
  }
}

// Normalised rows [r0, r0 + 64) of one part (q, k or v) of a segment into a
// row-major tile and, when `t` is given, its transpose. Rows at or past
// `len` read as zeros. `scale` multiplies after the first rounding, as the
// forward kernel scales q.
template <int D, bool kScale>
__device__ __forceinline__ void load_norm_tile(
    const __nv_bfloat16* part, int row_stride, int r0, int len, float eps,
    float scale, __nv_bfloat16 (*tile)[D + 8], __nv_bfloat16 (*t)[kBlockK + 8],
    int warp, int lane) {
  constexpr int kPer = D / 32;
  for (int r = warp; r < kBlockK; r += kWarps) {
    const int j = r0 + r;
    float x[kPer];
    const float den = load_row<D>(
        j < len ? part + static_cast<long long>(j) * row_stride : nullptr, lane, eps, x);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      __nv_bfloat16 y = __float2bfloat16(x[e] / den);
      if constexpr (kScale) y = __float2bfloat16(__bfloat162float(y) * scale);
      tile[r][lane * kPer + e] = y;
      if (t != nullptr) t[lane * kPer + e][r] = y;
    }
  }
}

// A-operand fragments of a warp's 16 rows from a row-major tile.
template <int D>
__device__ __forceinline__ void load_a_frags(const __nv_bfloat16 (*tile)[D + 8],
                                             int r0, int c0, uint32_t (&f)[D / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    f[kk][0] = ld32(&tile[r0][kk * 16 + c0]);
    f[kk][1] = ld32(&tile[r0 + 8][kk * 16 + c0]);
    f[kk][2] = ld32(&tile[r0][kk * 16 + c0 + 8]);
    f[kk][3] = ld32(&tile[r0 + 8][kk * 16 + c0 + 8]);
  }
}

// acc[j] = a (16 x D) . tile[col0 + j*8 ...][:]^T for the chunk's n8 tiles.
template <int D>
__device__ __forceinline__ void chunk_product(
    float (&acc)[kCn][4], const uint32_t (&a)[D / 16][4],
    const __nv_bfloat16 (*tile)[D + 8], int col0, int lane, int c0) {
#pragma unroll
  for (int j = 0; j < kCn; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* br = &tile[col0 + j * 8 + lane / 4][kk * 16 + c0];
      mma_16816(acc[j], a[kk], ld32(br), ld32(br + 8));
    }
  }
}

// out (16 x D) += w (16 x kChunk, rounded to bf16) . m, where `t` holds m
// transposed (t[d][col0 + ...]). The accumulator layout of two n8 tiles is
// the A-fragment layout of one k16 step.
template <int D>
__device__ __forceinline__ void chunk_accumulate(
    float (&out)[D / 8][4], const float (&w)[kCn][4],
    const __nv_bfloat16 (*t)[kBlockK + 8], int col0, int lane, int c0) {
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(w[2 * kk][0], w[2 * kk][1]), pack_bf16(w[2 * kk][2], w[2 * kk][3]),
        pack_bf16(w[2 * kk + 1][0], w[2 * kk + 1][1]),
        pack_bf16(w[2 * kk + 1][2], w[2 * kk + 1][3])};
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat16* br = &t[j * 8 + lane / 4][col0 + kk * 16 + c0];
      mma_16816(out[j], a, ld32(br), ld32(br + 8));
    }
  }
}

// Kernel 1: statistics, dbias and dq of one (b, h, query tile).
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
bwd_dq_kernel(const Params p) {
  constexpr int kPad = D + 8;      // +16 bytes a row: fragment loads hit 32 banks
  constexpr int kPadT = kBlockK + 8;
  constexpr int kDk = D / 16;
  constexpr int kDn = D / 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK][kPad];   // also stages q
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK][kPad];
  __shared__ __align__(16) __nv_bfloat16 kt[D][kPadT];        // k tile, transposed

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = p.S;
  const int H = p.H;
  const int qkv_row = 3 * H * D;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const __nv_bfloat16* xb = p.qkv + static_cast<long long>(b) * S * qkv_row;

  // Fragment coordinates: this thread holds rows r0 and r0 + 8 of the warp's
  // 16 query rows, and columns c0, c0 + 1 of every n8 tile.
  const int r0 = warp * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
  const int rows[2] = {q0 + r0, q0 + r0 + 8};

  uint32_t qf[kDk][4];
  load_norm_tile<D, true>(xb + h * D, qkv_row, q0, S, p.eps, scale, ks, nullptr, warp, lane);
  __syncthreads();
  load_a_frags<D>(ks, r0, c0, qf);

  // dO fragments straight from g; rows past S are zero.
  uint32_t gf[kDk][4];
  {
    const __nv_bfloat16* gb = p.g + static_cast<long long>(b) * S * (H * D) + h * D;
#pragma unroll
    for (int kk = 0; kk < kDk; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e & 1];
        gf[kk][e] = row < S ? ld32(gb + static_cast<long long>(row) * (H * D)
                                   + kk * 16 + c0 + (e >> 1) * 8)
                            : 0u;
      }
  }

  float lse[2], delta[2];
  float dq[kDn][4];
#pragma unroll
  for (int j = 0; j < kDn; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  // Walk 0 gathers the statistics; walk 1 forms dS, dbias and dq.
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};      // per-thread partial sums; a quad holds a row
  float acc[2] = {0.f, 0.f};    // partial sums of p * dP
  for (int walk = 0; walk < 2; ++walk) {
    for (int si = 0; si < p.n_seg; ++si) {
      const Segment sg = p.seg[si];
      const __nv_bfloat16* seg_b = sg.base + b * sg.batch_stride + h * D;
      const long long bias_off = (static_cast<long long>(b) * H + h) * S * sg.len;
      const float* bias = sg.bias == nullptr ? nullptr : sg.bias + bias_off;
      float* dbias = sg.dbias == nullptr ? nullptr : sg.dbias + bias_off;

      for (int k0 = 0; k0 < sg.len; k0 += kBlockK) {
        __syncthreads();  // every warp is done with the previous tile
        load_norm_tile<D, false>(seg_b + sg.k_off, sg.row_stride, k0, sg.len, p.eps, 1.f,
                                 ks, walk ? kt : nullptr, warp, lane);
        load_norm_tile<D, false>(seg_b + sg.v_off, sg.row_stride, k0, sg.len, p.eps, 1.f,
                                 vs, nullptr, warp, lane);
        __syncthreads();

#pragma unroll 1
        for (int cc = 0; cc < kBlockK; cc += kChunk) {
          float s[kCn][4], dp[kCn][4];
          chunk_product<D>(s, qf, ks, cc, lane, c0);
          chunk_product<D>(dp, gf, vs, cc, lane, c0);
#pragma unroll
          for (int j = 0; j < kCn; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + cc + j * 8 + c0 + (e & 1);
              const int row = rows[e >> 1];
              if (col >= sg.len) {
                s[j][e] = -INFINITY;
              } else if (bias != nullptr && row < S) {
                s[j][e] += bias[static_cast<long long>(row) * sg.len + col];
              }
            }
          if (walk == 0) {
            float mx[2] = {m[0], m[1]};
#pragma unroll
            for (int j = 0; j < kCn; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
              mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
              const float alpha = expf(m[i] - mx[i]);
              m[i] = mx[i];
              l[i] *= alpha;
              acc[i] *= alpha;
            }
#pragma unroll
            for (int j = 0; j < kCn; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float pe = expf(s[j][e] - m[e >> 1]);
                l[e >> 1] += pe;
                acc[e >> 1] += pe * dp[j][e];
              }
          } else {
#pragma unroll
            for (int j = 0; j < kCn; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = e >> 1;
                s[j][e] = expf(s[j][e] - lse[i]) * (dp[j][e] - delta[i]);   // dS
                const int col = k0 + cc + j * 8 + c0 + (e & 1);
                if (dbias != nullptr && rows[i] < S && col < sg.len) {
                  dbias[static_cast<long long>(rows[i]) * sg.len + col] = s[j][e];
                }
              }
            chunk_accumulate<D>(dq, s, kt, cc, lane, c0);
          }
        }
      }
    }

    if (walk == 0) {
      // Close the statistics: the sink's mass joins the denominator after
      // the running max is raised to max(m, 0).
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float lt = quad_sum(l[i]);
        float at = quad_sum(acc[i]);
        float mt = m[i];
        if (p.zero_sink > 0.f) {
          mt = fmaxf(m[i], 0.f);
          const float corr = expf(m[i] - mt);
          lt = lt * corr + p.zero_sink * expf(-mt);
          at *= corr;
        }
        lse[i] = mt + logf(lt);
        delta[i] = at / lt;
        if (lane % 4 == 0 && rows[i] < S) {
          const long long at_row = (static_cast<long long>(b) * H + h) * S + rows[i];
          p.lse[at_row] = lse[i];
          p.delta[at_row] = delta[i];
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kDn; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] *= scale;
  const __nv_bfloat16* x_rows[2];
  __nv_bfloat16* o_rows[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long off = (static_cast<long long>(b) * S + rows[i]) * qkv_row + h * D;
    x_rows[i] = rows[i] < S ? p.qkv + off : nullptr;
    o_rows[i] = rows[i] < S ? p.dqkv + off : nullptr;
  }
  norm_vjp_store<D>(dq, x_rows[0], x_rows[1], o_rows[0], o_rows[1], c0, p.eps);
}

// Kernel 2: dk and dv of one (b, h, segment, key tile).
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
bwd_dkv_kernel(const Params p) {
  constexpr int kPad = D + 8;
  constexpr int kPadT = kBlockQ + 8;
  constexpr int kDk = D / 16;
  constexpr int kDn = D / 8;
  __shared__ __align__(16) __nv_bfloat16 qs[kBlockQ][kPad];   // also stages k, v
  __shared__ __align__(16) __nv_bfloat16 gs[kBlockQ][kPad];
  __shared__ __align__(16) __nv_bfloat16 qt[D][kPadT];
  __shared__ __align__(16) __nv_bfloat16 gt[D][kPadT];
  __shared__ float lse_s[kBlockQ];
  __shared__ float delta_s[kBlockQ];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = p.S;
  const int H = p.H;
  const int qkv_row = 3 * H * D;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  // blockIdx.x counts key tiles through the segments in order.
  int si = 0;
  int tile = blockIdx.x;
  while (tile >= (p.seg[si].len + kBlockK - 1) / kBlockK) {
    tile -= (p.seg[si].len + kBlockK - 1) / kBlockK;
    ++si;
  }
  const Segment sg = p.seg[si];
  const int k0 = tile * kBlockK;
  const long long seg_off = b * sg.batch_stride + h * D;
  const float* bias = sg.bias == nullptr
      ? nullptr
      : sg.bias + (static_cast<long long>(b) * H + h) * S * sg.len;

  // This thread holds keys kr0 and kr0 + 8 of the warp's 16, and columns
  // c0, c0 + 1 of every n8 tile.
  const int kr0 = warp * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
  const int keys[2] = {k0 + kr0, k0 + kr0 + 8};

  uint32_t kf[kDk][4], vf[kDk][4];
  load_norm_tile<D, false>(sg.base + seg_off + sg.k_off, sg.row_stride, k0, sg.len, p.eps,
                           1.f, qs, nullptr, warp, lane);
  load_norm_tile<D, false>(sg.base + seg_off + sg.v_off, sg.row_stride, k0, sg.len, p.eps,
                           1.f, gs, nullptr, warp, lane);
  __syncthreads();
  load_a_frags<D>(qs, kr0, c0, kf);
  load_a_frags<D>(gs, kr0, c0, vf);

  float dk[kDn][4], dv[kDn][4];
#pragma unroll
  for (int j = 0; j < kDn; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const __nv_bfloat16* xb = p.qkv + static_cast<long long>(b) * S * qkv_row + h * D;
  const __nv_bfloat16* gb = p.g + static_cast<long long>(b) * S * (H * D) + h * D;
  const long long stat_off = (static_cast<long long>(b) * H + h) * S;

  for (int q0 = 0; q0 < S; q0 += kBlockQ) {
    __syncthreads();  // every warp is done with the previous tile
    load_norm_tile<D, true>(xb, qkv_row, q0, S, p.eps, scale, qs, qt, warp, lane);
    // dO rows as they are (rows past S zero), and the rows' statistics.
    for (int r = warp; r < kBlockQ; r += kWarps) {
      const int row = q0 + r;
      constexpr int kPer = D / 32;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int d = lane * kPer + e;
        const __nv_bfloat16 y = row < S ? gb[static_cast<long long>(row) * (H * D) + d]
                                        : __float2bfloat16(0.f);
        gs[r][d] = y;
        gt[d][r] = y;
      }
    }
    if (threadIdx.x < kBlockQ) {
      const int row = q0 + threadIdx.x;
      // +inf makes P vanish for rows past the ragged edge.
      lse_s[threadIdx.x] = row < S ? p.lse[stat_off + row] : INFINITY;
      delta_s[threadIdx.x] = row < S ? p.delta[stat_off + row] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int cc = 0; cc < kBlockQ; cc += kChunk) {
      // Transposed tiles: rows are this warp's keys, columns the queries.
      float st[kCn][4], dpt[kCn][4];
      chunk_product<D>(st, kf, qs, cc, lane, c0);
      chunk_product<D>(dpt, vf, gs, cc, lane, c0);
#pragma unroll
      for (int j = 0; j < kCn; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = cc + j * 8 + c0 + (e & 1);
          const int key = keys[e >> 1];
          float sv = st[j][e];
          if (bias != nullptr && q0 + qc < S && key < sg.len) {
            sv += bias[static_cast<long long>(q0 + qc) * sg.len + key];
          }
          const float pe = expf(sv - lse_s[qc]);
          st[j][e] = pe;                                 // P^T
          dpt[j][e] = pe * (dpt[j][e] - delta_s[qc]);    // dS^T
        }
      chunk_accumulate<D>(dv, st, gt, cc, lane, c0);
      chunk_accumulate<D>(dk, dpt, qt, cc, lane, c0);
    }
  }

  // q was scaled by c before the product, so dk already carries it.
  const __nv_bfloat16* xk[2];
  const __nv_bfloat16* xv[2];
  __nv_bfloat16* ok[2];
  __nv_bfloat16* ov[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool live = keys[i] < sg.len;
    const long long off = seg_off + static_cast<long long>(keys[i]) * sg.row_stride;
    xk[i] = live ? sg.base + off + sg.k_off : nullptr;
    xv[i] = live ? sg.base + off + sg.v_off : nullptr;
    ok[i] = live ? sg.dbase + off + sg.k_off : nullptr;
    ov[i] = live ? sg.dbase + off + sg.v_off : nullptr;
  }
  norm_vjp_store<D>(dk, xk[0], xk[1], ok[0], ok[1], c0, p.eps);
  norm_vjp_store<D>(dv, xv[0], xv[1], ov[0], ov[1], c0, p.eps);
}

}  // namespace

// C entry for ctypes. All tensors are contiguous: qkv, dqkv [B, S, 3*H*d]
// bf16; g [B, S, H*d] bf16; lse, delta [B, H, S] fp32 scratch; feats_i,
// dfeats_i [B, sf_i, 2*H*d] bf16; bias_i, dbias_i [B, H, S, sf_i] fp32 or
// both null. n_src is 0, 1 or 2; d is 32 or 64. Every element of dqkv,
// dfeats_i and dbias_i is written. Returns the first launch error (0 on
// success); the caller checks it.
extern "C" int vivid_flash_packed_bwd(
    const void* qkv, const void* g, void* dqkv, void* lse, void* delta,
    int B, int S, int H, int d, int n_src,
    const void* feats0, void* dfeats0, int sf0, const void* bias0, void* dbias0,
    const void* feats1, void* dfeats1, int sf1, const void* bias1, void* dbias1,
    float eps, float zero_sink, void* stream) {
  if (B < 1 || S < 1 || H < 1 || n_src < 0 || n_src > 2 || (d != 32 && d != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.qkv = static_cast<const __nv_bfloat16*>(qkv);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.dqkv = static_cast<__nv_bfloat16*>(dqkv);
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.S = S;
  p.H = H;
  p.eps = eps;
  p.zero_sink = zero_sink;
  p.n_seg = 1 + n_src;
  const long long hd = static_cast<long long>(H) * d;
  p.seg[0] = Segment{p.qkv, p.dqkv, nullptr, nullptr, S * 3 * hd, static_cast<int>(3 * hd),
                     static_cast<int>(hd), static_cast<int>(2 * hd), S};
  const void* feats[2] = {feats0, feats1};
  void* dfeats[2] = {dfeats0, dfeats1};
  const void* biases[2] = {bias0, bias1};
  void* dbiases[2] = {dbias0, dbias1};
  const int sfs[2] = {sf0, sf1};
  int key_tiles = (S + kBlockK - 1) / kBlockK;
  for (int i = 0; i < n_src; ++i) {
    if (sfs[i] < 1 || (biases[i] == nullptr) != (dbiases[i] == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.seg[1 + i] = Segment{static_cast<const __nv_bfloat16*>(feats[i]),
                           static_cast<__nv_bfloat16*>(dfeats[i]),
                           static_cast<const float*>(biases[i]),
                           static_cast<float*>(dbiases[i]),
                           sfs[i] * 2 * hd, static_cast<int>(2 * hd), 0,
                           static_cast<int>(hd), sfs[i]};
    key_tiles += (sfs[i] + kBlockK - 1) / kBlockK;
  }
  const dim3 grid_q((S + kBlockQ - 1) / kBlockQ, H, B);
  const dim3 grid_k(key_tiles, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) {
    bwd_dq_kernel<64><<<grid_q, kWarps * 32, 0, st>>>(p);
  } else {
    bwd_dq_kernel<32><<<grid_q, kWarps * 32, 0, st>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d == 64) {
    bwd_dkv_kernel<64><<<grid_k, kWarps * 32, 0, st>>>(p);
  } else {
    bwd_dkv_kernel<32><<<grid_k, kWarps * 32, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
