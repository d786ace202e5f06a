// Backward of the packed-layout fused attention in flash_packed.cu (sm_90a:
// wgmma, TMA, mbarriers; the pieces both share are in flash_packed.cuh).
//
// Replaces the TPU kernels in vivid_tpu/kernels/flash.py:
//   * flash_fused_packed_bwd       (_kernel_packed_bwd): qkv, g -> dqkv, with
//     the unconditional model's zero sink;
//   * flash_fused_packed_xattn_bwd (_kernel_packed_xattn_bwd): qkv, up to two
//     cross sources, optional per-source logit biases, g -> dqkv, dfeats per
//     source, dbias per biased source;
// both bodies of _kernel_packed_bwd_common. One launch sequence serves both:
// the keys are 1 to 3 segments, the self segment and each source.
//
// What it computes. With q', k', v' the pixel-normalised rows
// x / (eps + ||x|| / sqrt(D)) rounded to bf16 as the forward kernel rounds
// them, c = 1/sqrt(D), logits s = (c q').k' (+ bias) with c q' rounded to
// bf16 once more, and P the softmax whose denominator also holds the sink's
// mass zero_sink * exp(-max(m, 0)):
//   dv' = P^T dO,  dP = dO v'^T,  dS = P o (dP - rowsum(P o dP)),
//   dq' = c dS k',  dk' = dS^T (c q'),  dbias = dS,
// then the norm's VJP dx = dy/(eps+r) - x <x,dy> / (D r (eps+r)^2) with
// r = ||x||/sqrt(D) (r = 0 guarded) on each of q, k and v, written as bf16
// straight into the packed layouts. P and dS are rounded to bf16 for the
// second products; every sum is fp32. The softmax is exact, with a running
// max. rowsum(P o dP) is recomputed from P and dP in fp32, as the TPU kernel
// does, not taken from dO.O (the rounded output would bias every column of a
// row the same way). Between forward and backward only the inputs are kept,
// so the backward recomputes the statistics, as the reference does.
//
// Design for this card, three launches:
//   packed_bwd_norm_kernel  a pre-pass (flash_packed.cuh's, the forward
//                           runs the same): every row of q, k and v normalised
//                           once into head-major scratch the caller gives,
//                           c q' [B, H, S, D] and k', v' [B, H, keys, D]
//                           with each segment padded with zero rows to whole
//                           64-row tiles, so that no key tile straddles two
//                           segments. D / 8 threads a row, 16 bytes each.
//   packed_bwd_dq_kernel    one block per (b, h, 64 query rows): a TMA
//                           producer warpgroup keeps a 4-stage ring of
//                           64-key stages (k', v') full, and a consumer
//                           warpgroup owns the 64 query rows with c q' and
//                           dO as register A fragments. Walk 0 over every
//                           key tile forms S and dP on wgmma and keeps the
//                           online max, the sum of p and of p dP in fp32,
//                           then closes them with the sink: lse * log2(e)
//                           and delta = rowsum(P o dP) go to fp32 scratch
//                           padded to whole tiles (+inf and 0 past S). Walk
//                           1 forms them again, dS, writes the fp32 dbias
//                           rows of biased sources (this kernel is dbias's
//                           only owner) and adds dS k' on wgmma with k' read
//                           MN-major. Epilogue: times c, the norm VJP of q,
//                           bf16 into dqkv's q columns.
//   packed_bwd_dkv_kernel   one block per (b, h, 64-key tile), the tile's
//                           k' and v' resident in shared memory as the A
//                           operands; stages of 64 query
//                           rows bring c q' and dO (a 3-d tensor map reads g
//                           [B, S, H*D] at column h*D) and the two statistics
//                           (bulk copies). S^T = k' (c q')^T and dP^T = v'
//                           dO^T on wgmma, P^T and dS^T rounded into
//                           register A fragments, dv += P^T dO and dk +=
//                           dS^T (c q'); per-source biases read transposed.
//                           Epilogue: the norm VJP, then dqkv's k/v columns
//                           for the self segment or dfeats_i for a source.
// Both are blocks of one consumer and one producer warpgroup, two blocks an
// SM: blocks of three consumers measured no faster at the path's shapes.
// Blocks share nothing and a training step must repeat bitwise, so no sum
// crosses blocks by atomics and every output element has one owner. A key past its segment's end gets p = 0 in the dq
// kernel and is not written by the dk/dv kernel; a query row past S reads as
// zeros (dO included) and gets P = 0 through its +inf statistic.
//
// What bounds it on the card: at B = 8, S = 1024, H = 4, D = 64 with two
// sources of 1024 the function needs 10 B H S Sk D = 64 GFLOP against ~63 MB
// moved: the bound is operations. With a bias the fp32 bias and dbias turn
// it to bytes. The schedule costs nine 64x64xD products per tile pair (two
// and three in the two walks of dq, four in dk/dv) where five are needed: a
// floor of 9/5 of the operations bound, the price of recomputing the
// statistics and of one owner an element.

#include "flash_packed.cuh"

namespace {

template <int D>
constexpr int kDqSmemBytes = kAlignSlack + kStages * 2 * kRows * 2 * D + 2 * kStages * 8;

// dk/dv: k' and v' of the block's tile, then stages of c q', dO, lse2[64]
// and delta[64] (512 bytes, kept 1024-aligned).
template <int D>
constexpr int kDkvStageBytes = 2 * kRows * 2 * D + 1024;

template <int D>
constexpr int kDkvSmemBytes = kAlignSlack + 2 * kRows * 2 * D
    + kStages * kDkvStageBytes<D> + (2 * kStages + 1) * 8;

// VJP of the pixel norm for the two rows of a wgmma accumulator, and the
// store. dy[4 j + 2 i + e] is the cotangent of column j*8 + c0 + e of row i
// (i = 0, 1), already scaled; x_i / out_i point at that row's D raw inputs /
// D outputs (null: the row does not exist). A quad holds a row.
template <int D>
__device__ __forceinline__ void norm_vjp_store(
    const float (&dy)[D / 2], const __nv_bfloat16* x0, const __nv_bfloat16* x1,
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
      xdy += x[j][0] * dy[4 * j + 2 * i] + x[j][1] * dy[4 * j + 2 * i + 1];
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
          dy[4 * j + 2 * i] / den - x[j][0] * coef,
          dy[4 * j + 2 * i + 1] / den - x[j][1] * coef);
    }
  }
}

// The pre-pass (flash_packed.cuh's norm_rows).
template <int D>
__global__ void __launch_bounds__(kNormThreads)
packed_bwd_norm_kernel(const __grid_constant__ Params p, __nv_bfloat16* __restrict__ qn,
                       __nv_bfloat16* __restrict__ kn, __nv_bfloat16* __restrict__ vn,
                       long long q_rows, long long kv_rows) {
  norm_rows<D>(p, qn, kn, vn, q_rows, kv_rows);
}

// Statistics, dbias and dq of one (b, h, 64 query rows).
template <int D, bool kBiased>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
packed_bwd_dq_kernel(const __grid_constant__ CUtensorMap kn_map,
                     const __grid_constant__ CUtensorMap vn_map,
                     const __grid_constant__ Params p) {
  constexpr int kRowBytes = 2 * D;
  constexpr int kBoxBytes = kRows * kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = aligned_smem(smem_raw);   // stage: k' box, v' box
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + kStages * 2 * kBoxBytes);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / 128;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * p.H + h;
  const int n_tiles = p.key_tiles;
  const int n_steps = 2 * n_tiles;   // both walks
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kEmptyArrivals);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 1) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 128) {
      for (int n = 0; n < n_steps; ++n) {
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(&empty[s], (n / kStages - 1) & 1);
        const int row = (n < n_tiles ? n : n - n_tiles) * kRows;
        mbar_expect_tx(&full[s], 2 * kBoxBytes);
        tma_load_3d(tiles + s * 2 * kBoxBytes, &kn_map, &full[s], 0, row, bh);
        tma_load_3d(tiles + s * 2 * kBoxBytes + kBoxBytes, &vn_map, &full[s], 0, row, bh);
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int S = p.S;
    const int q0 = blockIdx.x * kRows;
    // This thread holds rows r0 and r0 + 8 of the consumer's 64, and
    // columns c0, c0 + 1 of every n8 group.
    const int r0 = warp * 16 + lane / 4;
    const int c0 = (lane % 4) * 2;
    const int rows[2] = {q0 + r0, q0 + r0 + 8};
    const int hd = p.H * D;
    uint32_t qf[D / 16][4], gf[D / 16][4];
    load_q_fragments<D>(p.qn + static_cast<long long>(bh) * S * D, D, q0, S, r0, c0, qf);
    load_q_fragments<D>(p.g + static_cast<long long>(b) * S * hd + h * D, hd, q0, S, r0, c0, gf);

    float s[kRows / 2], dp[kRows / 2];
    // S = (c q') k'^T and dP = dO v'^T of step n, key tile t: the bias
    // added and the keys past the segment's end at -inf. -> the k' tile's
    // descriptor; the stage stays the consumer's until it arrives on `empty`.
    auto products = [&](int n, int t) {
      const Segment& sg = p.seg[segment_of(p, t)];
      const int k0 = (t - sg.tile0) * kRows;   // the tile's first key in its segment
      const int cols = sg.len - k0;            // keys of the tile that exist
      mbar_wait(&full[n % kStages], (n / kStages) & 1);
      const uint8_t* kt = tiles + (n % kStages) * 2 * kBoxBytes;
      const uint64_t kd = smem_desc<kRowBytes>(kt);
      const uint64_t vd = smem_desc<kRowBytes>(kt + kBoxBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<kRows, true>::template run<0>(s, qf[kk], kd + kk * kDescStepK, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<kRows, true>::template run<0>(dp, gf[kk], vd + kk * kDescStepK, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      // The A fragments are pinned too: with both walks in one loop and no
      // pin, the second walk's dP came out wrong at d 64.
      fence_regs(s);
      fence_regs(dp);
      fence_regs(qf);
      fence_regs(gf);
      if constexpr (kBiased) {
        if (sg.bias != nullptr) {
          const float* at[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            at[i] = rows[i] < S
                ? sg.bias + (static_cast<long long>(bh) * S + rows[i]) * sg.len + k0 + c0
                : nullptr;
          }
          add_bias<kRows>(s, at, cols - c0, sg.len % 2 == 0 && cols >= kRows, lane);
        }
      }
      if (cols < kRows) {   // the segment's ragged edge: those keys get p = 0
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j * 8 + c0 + (e & 1) >= cols) s[4 * j + e] = -INFINITY;
          }
        }
      }
      return kd;
    };

    // Walk 0: the running max, the sum of p and the sum of p dP.
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};     // per-thread partial sums; a quad holds a row
    float pdp[2] = {0.f, 0.f};
    for (int t = 0; t < n_tiles; ++t) {
      products(t, t);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
      }
      float m2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float alpha = fast_exp2((m[i] - mx[i]) * kLog2e);   // 0 on the first tile
        m[i] = mx[i];
        m2[i] = mx[i] * kLog2e;
        l[i] *= alpha;
        pdp[i] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = fast_exp2(fmaf(s[4 * j + e], kLog2e, -m2[e >> 1]));
          l[e >> 1] += pe;
          pdp[e >> 1] += pe * dp[4 * j + e];
        }
      }
      if (lane == 0) mbar_arrive(&empty[t % kStages]);
    }

    // Close the statistics: the sink's mass joins the denominator after the
    // running max is raised to max(m, 0).
    float lse2[2], delta[2];
    const long long stat_row = static_cast<long long>(bh) * p.s_pad;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float lt = quad_sum(l[i]);
      float at = quad_sum(pdp[i]);
      float mt = m[i];
      if (p.zero_sink > 0.f) {
        mt = fmaxf(m[i], 0.f);
        const float corr = fast_exp2((m[i] - mt) * kLog2e);
        lt = lt * corr + p.zero_sink * fast_exp2(-mt * kLog2e);
        at *= corr;
      }
      lse2[i] = fmaf(mt, kLog2e, log2f(lt));
      delta[i] = at / lt;
      if (lane % 4 == 0) {
        const bool live = rows[i] < S;
        p.lse2[stat_row + rows[i]] = live ? lse2[i] : INFINITY;
        p.delta[stat_row + rows[i]] = live ? delta[i] : 0.f;
      }
    }

    // Walk 1: dS = P o (dP - delta), the bias gradient, dq += dS k'.
    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      const int n = n_tiles + t;
      const uint64_t kd = products(n, t);
      const Segment& sg = p.seg[segment_of(p, t)];
      const int k0 = (t - sg.tile0) * kRows;
      const int cols = sg.len - k0;
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        const int col = j * 8 + c0;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float ds0 = fast_exp2(fmaf(s[4 * j + 2 * i], kLog2e, -lse2[i]))
              * (dp[4 * j + 2 * i] - delta[i]);
          const float ds1 = fast_exp2(fmaf(s[4 * j + 2 * i + 1], kLog2e, -lse2[i]))
              * (dp[4 * j + 2 * i + 1] - delta[i]);
          s[4 * j + 2 * i] = ds0;
          s[4 * j + 2 * i + 1] = ds1;
          if constexpr (kBiased) {
            if (sg.dbias != nullptr && rows[i] < S && col < cols) {
              float* at = sg.dbias + (static_cast<long long>(bh) * S + rows[i]) * sg.len
                  + k0 + col;
              if (sg.len % 2 == 0 && col + 1 < cols) {
                *reinterpret_cast<float2*>(at) = make_float2(ds0, ds1);
              } else {
                at[0] = ds0;
                if (col + 1 < cols) at[1] = ds1;
              }
            }
          }
        }
      }
      uint32_t da[kRows / 16][4];
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) acc_to_a(s, kk, da[kk]);
      fence_regs(dqa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        Wgmma<D, true>::template run<1>(dqa, da[kk], kd + kk * kDescStepMN<kRowBytes>, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      fence_regs(da);
      if (lane == 0) mbar_arrive(&empty[n % kStages]);
    }

#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] *= kScaleOf<D>;
    const __nv_bfloat16* x_rows[2];
    __nv_bfloat16* o_rows[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long off = (static_cast<long long>(b) * S + rows[i]) * (3 * hd) + h * D;
      x_rows[i] = rows[i] < S ? p.qkv + off : nullptr;
      o_rows[i] = rows[i] < S ? p.dqkv + off : nullptr;
    }
    norm_vjp_store<D>(dqa, x_rows[0], x_rows[1], o_rows[0], o_rows[1], c0, p.eps);
  }
}

// dk and dv of one (b, h, 64-key tile).
template <int D, bool kBiased>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
packed_bwd_dkv_kernel(const __grid_constant__ CUtensorMap kn_map,
                      const __grid_constant__ CUtensorMap vn_map,
                      const __grid_constant__ CUtensorMap qn_map,
                      const __grid_constant__ CUtensorMap g_map,
                      const __grid_constant__ Params p) {
  constexpr int kRowBytes = 2 * D;
  constexpr int kBoxBytes = kRows * kRowBytes;
  constexpr int kStageBytes = kDkvStageBytes<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* kv = aligned_smem(smem_raw);                // k' of the block's tile, then v'
  uint8_t* stages = kv + 2 * kBoxBytes;                // c q', dO, lse2[64], delta[64]
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;

  const int wg = threadIdx.x / 128;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * p.H + h;
  const int n_tiles = p.s_pad / kRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kEmptyArrivals);
    }
    mbar_init(kv_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 1) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 128) {
      mbar_expect_tx(kv_full, 2 * kBoxBytes);
      tma_load_3d(kv, &kn_map, kv_full, 0, blockIdx.x * kRows, bh);
      tma_load_3d(kv + kBoxBytes, &vn_map, kv_full, 0, blockIdx.x * kRows, bh);
      const float* lse2_b = p.lse2 + static_cast<long long>(bh) * p.s_pad;
      const float* delta_b = p.delta + static_cast<long long>(bh) * p.s_pad;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);
        uint8_t* st = stages + s * kStageBytes;
        mbar_expect_tx(&full[s], 2 * kBoxBytes + 2 * kRows * 4);
        tma_load_3d(st, &qn_map, &full[s], 0, t * kRows, bh);
        tma_load_3d(st + kBoxBytes, &g_map, &full[s], h * D, t * kRows, b);
        bulk_load(st + 2 * kBoxBytes, lse2_b + t * kRows, kRows * 4, &full[s]);
        bulk_load(st + 2 * kBoxBytes + kRows * 4, delta_b + t * kRows, kRows * 4, &full[s]);
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int tile = blockIdx.x;
    const Segment& sg = p.seg[segment_of(p, tile)];
    const int S = p.S;
    const int len = sg.len;
    // This thread holds keys kr0 and kr0 + 8 of the consumer's 64 (counted
    // in their segment), and query columns c0, c0 + 1 of every n8 group.
    const int kr0 = warp * 16 + lane / 4;
    const int c0 = (lane % 4) * 2;
    const int k0 = (tile - sg.tile0) * kRows;
    const int keys[2] = {k0 + kr0, k0 + kr0 + 8};
    const uint64_t ka = smem_desc<kRowBytes>(kv);
    const uint64_t va = smem_desc<kRowBytes>(kv + kBoxBytes);
    const float* bias = nullptr;
    if constexpr (kBiased) {
      if (sg.bias != nullptr) bias = sg.bias + static_cast<long long>(bh) * S * len;
    }

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int stage = t % kStages;
      mbar_wait(&full[stage], (t / kStages) & 1);
      const uint8_t* st = stages + stage * kStageBytes;
      const uint64_t qd = smem_desc<kRowBytes>(st);
      const uint64_t gd = smem_desc<kRowBytes>(st + kBoxBytes);
      const float* lse2_s = reinterpret_cast<const float*>(st + 2 * kBoxBytes);
      const float* delta_s = lse2_s + kRows;

      // Transposed tiles: rows are this consumer's keys, columns the queries.
      float sT[kRows / 2], dpT[kRows / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<kRows, false>::template run<0>(sT, ka + kk * kDescStepK, qd + kk * kDescStepK,
                                             kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<kRows, false>::template run<0>(dpT, va + kk * kDescStepK, gd + kk * kDescStepK,
                                             kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sT);
      fence_regs(dpT);

      if constexpr (kBiased) {
        if (bias != nullptr) {
          // The bias transposed: this thread's two keys of sixteen query rows.
          const int q0 = t * kRows;
          const float* bp = bias + static_cast<long long>(q0 + c0) * len;
          if (q0 + kRows <= S && keys[1] < len) {   // all there: loads sixteen at a time
#pragma unroll
            for (int j0 = 0; j0 < kRows / 8; j0 += 4) {
              float bv[4][4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  bv[j][e] = __ldg(bp + static_cast<long long>((j0 + j) * 8 + (e & 1)) * len
                                   + keys[e >> 1]);
                }
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) sT[4 * (j0 + j) + e] += bv[j][e];
              }
            }
          } else {
#pragma unroll
            for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int qc = j * 8 + (e & 1);   // past q0 + c0
                if (q0 + c0 + qc < S && keys[e >> 1] < len) {
                  sT[4 * j + e] += __ldg(bp + static_cast<long long>(qc) * len + keys[e >> 1]);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        const float2 ls = *reinterpret_cast<const float2*>(lse2_s + j * 8 + c0);
        const float2 de = *reinterpret_cast<const float2*>(delta_s + j * 8 + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = fast_exp2(fmaf(sT[4 * j + e], kLog2e, -((e & 1) ? ls.y : ls.x)));
          sT[4 * j + e] = pe;                                                  // P^T
          dpT[4 * j + e] = pe * (dpT[4 * j + e] - ((e & 1) ? de.y : de.x));    // dS^T
        }
      }

      uint32_t pa[kRows / 16][4], da[kRows / 16][4];
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        acc_to_a(sT, kk, pa[kk]);
        acc_to_a(dpT, kk, da[kk]);
      }
      fence_regs(dva);
      fence_regs(dka);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        Wgmma<D, true>::template run<1>(dva, pa[kk], gd + kk * kDescStepMN<kRowBytes>, 1);
      }
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        Wgmma<D, true>::template run<1>(dka, da[kk], qd + kk * kDescStepMN<kRowBytes>, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(da);
      if (lane == 0) mbar_arrive(&empty[stage]);
    }

    // c q' went into the products, so dk already carries c.
    const __nv_bfloat16* xk[2];
    const __nv_bfloat16* xv[2];
    __nv_bfloat16* ok[2];
    __nv_bfloat16* ov[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool live = keys[i] < len;
      const long long off = b * sg.batch_stride + static_cast<long long>(keys[i]) * sg.row_stride
          + h * D;
      xk[i] = live ? sg.base + off + sg.k_off : nullptr;
      xv[i] = live ? sg.base + off + sg.v_off : nullptr;
      ok[i] = live ? sg.dbase + off + sg.k_off : nullptr;
      ov[i] = live ? sg.dbase + off + sg.v_off : nullptr;
    }
    norm_vjp_store<D>(dka, xk[0], xk[1], ok[0], ok[1], c0, p.eps);
    norm_vjp_store<D>(dva, xv[0], xv[1], ov[0], ov[1], c0, p.eps);
  }
}

// Map of g [B, S, H*d] bf16 for boxes of 64 rows of one head's d columns:
// coordinates (h * d, row, b); rows past S read as zeros.
inline int g_map(CUtensorMap* map, const void* g, int B, int S, int H, int d) {
  if (encoder() == nullptr) return kEncodeError;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(H) * d, static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {2ull * H * d, 2ull * H * d * S};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(d), kRows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult rc = encoder()(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(g), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      d == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(rc);
}

template <int D, bool kBiased>
int launch_dq(const CUtensorMap& kn, const CUtensorMap& vn, const Params& p, int B,
              cudaStream_t st) {
  auto* kernel = packed_bwd_dq_kernel<D, kBiased>;
  const int rc = allow_smem(kernel, kDqSmemBytes<D>);
  if (rc != 0) return rc;
  const dim3 grid((p.S + kRows - 1) / kRows, p.H, B);
  kernel<<<grid, kThreads, kDqSmemBytes<D>, st>>>(kn, vn, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kBiased>
int launch_dkv(const CUtensorMap& kn, const CUtensorMap& vn, const CUtensorMap& qn,
               const CUtensorMap& g, const Params& p, int B, cudaStream_t st) {
  auto* kernel = packed_bwd_dkv_kernel<D, kBiased>;
  const int rc = allow_smem(kernel, kDkvSmemBytes<D>);
  if (rc != 0) return rc;
  const dim3 grid(p.key_tiles, p.H, B);
  kernel<<<grid, kThreads, kDkvSmemBytes<D>, st>>>(kn, vn, qn, g, p);
  return static_cast<int>(cudaGetLastError());
}

// The three launches. `rows` is the pre-pass's scratch: c q' [B*H, S, D],
// then k' and v' [B*H, key_tiles * 64, D] each.
template <int D, bool kBiased>
int launch(Params p, __nv_bfloat16* rows, int B, cudaStream_t st) {
  const int bh = B * p.H;
  const int keys = p.key_tiles * kRows;
  __nv_bfloat16* qn = rows;
  __nv_bfloat16* kn = qn + static_cast<long long>(bh) * p.S * D;
  __nv_bfloat16* vn = kn + static_cast<long long>(bh) * keys * D;
  p.qn = qn;
  CUtensorMap qn_map, kn_map, vn_map, g_tiles;
  int rc = rows_map(&qn_map, qn, bh, p.S, D);
  if (rc == 0) rc = rows_map(&kn_map, kn, bh, keys, D);
  if (rc == 0) rc = rows_map(&vn_map, vn, bh, keys, D);
  if (rc == 0) rc = g_map(&g_tiles, p.g, B, p.S, p.H, D);
  if (rc == 0) rc = launch_norm<D>(packed_bwd_norm_kernel<D>, p, qn, kn, vn, B, st);
  if (rc != 0) return rc;
  rc = launch_dq<D, kBiased>(kn_map, vn_map, p, B, st);
  if (rc != 0) return rc;
  return launch_dkv<D, kBiased>(kn_map, vn_map, qn_map, g_tiles, p, B, st);
}

template <int D, bool kBiased>
int describe_one(int kernel, int* info) {
  if (kernel == 0) return describe_packed(packed_bwd_dq_kernel<D, kBiased>, kDqSmemBytes<D>, info);
  return describe_packed(packed_bwd_dkv_kernel<D, kBiased>, kDkvSmemBytes<D>, info);
}

}  // namespace

// C entry for ctypes. All tensors are contiguous and 16-byte aligned: qkv,
// dqkv [B, S, 3*H*d] bf16; g [B, S, H*d] bf16; feats_i, dfeats_i
// [B, sf_i, 2*H*d] bf16; bias_i, dbias_i [B, H, S, sf_i] fp32 or both null.
// Scratch: lse, delta [B*H, S rounded up to 64] fp32; rows bf16 of
// B*H*(S + 2*keys)*d elements, keys the sum over the self segment (S) and
// the sources of each length rounded up to 64. n_src is 0, 1 or 2; d is 32
// or 64. Every element of dqkv, dfeats_i and
// dbias_i is written. Returns the first error (0 on success; 10000 and
// above: the tensor-map encoder was not found or refused); the caller checks
// it.
extern "C" int vivid_flash_packed_bwd(
    const void* qkv, const void* g, void* dqkv, void* lse, void* delta, void* rows,
    int B, int S, int H, int d, int n_src,
    const void* feats0, void* dfeats0, int sf0, const void* bias0, void* dbias0,
    const void* feats1, void* dfeats1, int sf1, const void* bias1, void* dbias1,
    float eps, float zero_sink, void* stream) {
  if (bad_shape(B, H, S, 1, d) || n_src < 0 || n_src > 2 || !(eps > 0.f) ||
      !(zero_sink >= 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.qkv = static_cast<const __nv_bfloat16*>(qkv);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.dqkv = static_cast<__nv_bfloat16*>(dqkv);
  p.qn = nullptr;
  p.lse2 = static_cast<float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.S = S;
  p.s_pad = (S + kRows - 1) / kRows * kRows;
  p.H = H;
  p.eps = eps;
  p.zero_sink = zero_sink;
  const void* feats[2] = {feats0, feats1};
  void* dfeats[2] = {dfeats0, dfeats1};
  const void* biases[2] = {bias0, bias1};
  void* dbiases[2] = {dbias0, dbias1};
  const int sfs[2] = {sf0, sf1};
  for (int i = 0; i < n_src; ++i) {
    if ((biases[i] == nullptr) != (dbiases[i] == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int biased = fill_segments(p, d, n_src, feats, dfeats, biases, dbiases, sfs);
  if (biased < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* r = static_cast<__nv_bfloat16*>(rows);
  if (d == 64) {
    return biased ? launch<64, true>(p, r, B, st) : launch<64, false>(p, r, B, st);
  }
  return biased ? launch<32, true>(p, r, B, st) : launch<32, false>(p, r, B, st);
}

// What was built: `kernel` 0 the dq kernel, 1 dk/dv, for a launch with
// (biased != 0) or without a bias. info[0..2]: registers a thread at launch,
// local-memory bytes a thread, dynamic shared memory; info[3..8]: rows of
// the outputs a block owns, rows (dk/dv) or keys a stage, stages, the
// registers of a consumer and of the producer thread after the warpgroups
// have traded them, threads a block.
extern "C" int vivid_flash_packed_bwd_info(int kernel, int d, int biased, int* info) {
  if ((d != 32 && d != 64) || kernel < 0 || kernel > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d == 64) {
    return biased ? describe_one<64, true>(kernel, info) : describe_one<64, false>(kernel, info);
  }
  return biased ? describe_one<32, true>(kernel, info) : describe_one<32, false>(kernel, info);
}
