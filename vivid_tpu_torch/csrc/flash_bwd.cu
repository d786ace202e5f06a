// Big-S flash attention with a running max, forward and backward, for
// training the 256px super-resolution model (sm_90a: wgmma, TMA, mbarriers).
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
// Exponentials are exp2 of one fused multiply-add, s * log2(e) - m * log2(e);
// the backward's pre-pass hands lse over as lse * log2(e).
//
// Where q / sqrt(D) is rounded. The forward rounds it as it loads its query
// fragments into registers, once per block. The backward's pre-pass
// (bwd_prep_kernel) writes the rounded copy to scratch once, and both
// backward kernels read that copy: the dk/dv kernel streams it through TMA,
// which cannot scale what it copies. It is the rounding of the plain
// versions (kernels/flash.py `flash_attention_ref`).
//
// Design. Every kernel is a block of four warpgroups. The last is the
// producer: it gives its registers away and one thread of it keeps a ring of
// shared-memory stages full by TMA (64-row boxes, swizzled by row width, rows
// past the end zero-filled), waiting on each stage's "empty" mbarrier and
// completing its "full" one. The first three are consumers on different 64-row
// tiles, so one's exponentials run under the others' products; they never
// issue a copy and meet no block-wide barrier. Products run on wgmma: the
// logits tile with K (or the streamed rows) read K-major through a
// descriptor, the second products with A from registers (the fp32
// accumulator of the first, rounded, is the A fragment of the next) and the
// same shared tile read MN-major through the transpose bit. Nothing is
// transposed through shared memory.
// Blocks share nothing and a training step must repeat bitwise, so no sum
// crosses blocks by atomics; every output element has one owner:
//   flash_fwd_kernel      one block per (b, h, 192 query rows), 64 per
//                         consumer; q fragments in registers; stages of 128
//                         keys (K and V), logits 64 x 128 a consumer. Its
//                         body is flash_fwd.cuh's, which K6 shares.
//   bwd_prep_kernel       one warp per row: delta = sum(dO * o),
//                         lse * log2(e), both into rows padded to 64 (zeros
//                         past the end), and the rounded q / sqrt(D).
//   flash_bwd_dkv_kernel  one block per (b, h, 192 keys), 64 per consumer; K
//                         and V stay in shared memory as the A operands;
//                         stages of 64 query rows (q / sqrt(D), dO, and their
//                         statistics by a bulk copy). It forms the transposed
//                         tiles S^T = k q^T and dP^T = v dO^T, so P^T and dS^T
//                         come out in the layout that is the A operand of the
//                         products into dv and dk.
//   flash_bwd_dq_kernel   one block per (b, h, 192 query rows), 64 per
//                         consumer; q / sqrt(D) and dO fragments in
//                         registers; stages of 64 keys (K and V); writes dq
//                         and its rows of dbias.
// Any Sq and Sk: rows past the end are zero-filled and not written; a key
// past the end gets p = 0 (forward) or dS = 0 (backward). A consumer whose 64
// rows all lie past the end only hands the stages back.
//
// What bounds it: at d = 64 operations and exponentials alike, at d = 32
// exponentials (the special-function unit makes 16 a clock and SM, and a
// logit costs one whatever D is). The backward needs 10 B H Sq Sk D operations
// (five Sq x Sk x D products) against inputs and outputs of a few tens of
// MB; with a bias the fp32 bias and dbias (8 B H Sq Sk bytes) turn the bound
// to bytes. The two backward kernels each recompute S and dP: seven products
// where five are needed, the price of one owner per element.

#include "flash_fwd.cuh"

namespace {

using namespace vivid;

constexpr int kBwStages = 4;     // backward: 64 rows (dk/dv) or 64 keys (dq) per stage

template <int D>
constexpr int kDqSmemBytes = kAlignSlack + kBwStages * 2 * kRows * 2 * D + 2 * kBwStages * 8;

// dk/dv: K and V of the block, then stages of q / sqrt(D), dO, lse * log2(e)
// and delta (the statistics' 512 bytes, kept 1024-aligned).
template <int D>
constexpr int kDkvStageBytes = 2 * kRows * 2 * D + 1024;

template <int D>
constexpr int kDkvSmemBytes = kAlignSlack + 2 * kBlockRows * 2 * D
    + kBwStages * kDkvStageBytes<D> + (2 * kBwStages + 1) * 8;

// Two neighbouring fp32 values of a row of dbias: one 8-byte store where
// `pair` says the address is even and both columns exist.
__device__ __forceinline__ void store_pair(float* p, float2 x, bool pair, bool ok0, bool ok1) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = x;
  } else {
    if (ok0) p[0] = x.x;
    if (ok1) p[1] = x.y;
  }
}

// The forward (flash_fwd.cuh: the body it shares with K6).
template <int D, bool kBiased>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __nv_bfloat16* __restrict__ q, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Sq, int Sk) {
  attn_fwd<D, kBiased, false, false>(&k_map, &v_map, q, bias, nullptr, out, lse, Sq, Sk);
}

// The backward's pre-pass, one warp per row of the padded statistics
// [B * H, sq_pad] (sq_pad a multiple of 64): stats[row] = lse * log2(e),
// stats[rows_pad + row] = delta = sum_d dO * o, zeros past Sq; and
// qs = q / sqrt(D) rounded to bf16.
template <int D>
__global__ void __launch_bounds__(256)
bwd_prep_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ g, const float* __restrict__ lse,
                __nv_bfloat16* __restrict__ qs, float* __restrict__ stats, int Sq, int sq_pad,
                long long rows_pad) {
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows_pad) return;
  const int lane = threadIdx.x % 32;
  const int r = static_cast<int>(row % sq_pad);
  if (r >= Sq) {
    if (lane == 0) stats[row] = stats[rows_pad + row] = 0.f;
    return;
  }
  const long long src = (row / sq_pad) * Sq + r;
  float acc;
  if constexpr (D == 64) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(o + src * D + 2 * lane);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(g + src * D + 2 * lane);
    acc = __bfloat162float(a.x) * __bfloat162float(b.x)
        + __bfloat162float(a.y) * __bfloat162float(b.y);
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(q + src * D + 2 * lane);
    *reinterpret_cast<__nv_bfloat162*>(qs + src * D + 2 * lane) = __floats2bfloat162_rn(
        __bfloat162float(x.x) * kScaleOf<D>, __bfloat162float(x.y) * kScaleOf<D>);
  } else {
    acc = __bfloat162float(o[src * D + lane]) * __bfloat162float(g[src * D + lane]);
    qs[src * D + lane] = __float2bfloat16(__bfloat162float(q[src * D + lane]) * kScaleOf<D>);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    stats[row] = lse[src] * kLog2e;
    stats[rows_pad + row] = acc;
  }
}

// dk and dv of one (b, h, 192-key block), 64 keys a consumer.
template <int D, bool kBiased>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap qs_map,
                     const __grid_constant__ CUtensorMap g_map,
                     const float* __restrict__ stats, const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     int Sq, int Sk, int sq_pad, long long rows_pad) {
  constexpr int kRowBytes = 2 * D;
  constexpr int kBoxBytes = kRows * kRowBytes;
  constexpr int kStageBytes = kDkvStageBytes<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* kv = aligned_smem(smem_raw);           // K of the block, then V
  uint8_t* stages = kv + 2 * kBlockRows * kRowBytes;   // qs, dO, lse2[64], delta[64]
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kBwStages * kStageBytes);
  uint64_t* empty = full + kBwStages;
  uint64_t* kv_full = empty + kBwStages;

  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  const int n_tiles = (Sq + kRows - 1) / kRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kEmptyArrivals);
    }
    mbar_init(kv_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(kv_full, 2 * kBlockRows * kRowBytes);
#pragma unroll
      for (int h = 0; h < kConsumers; ++h) {
        const int row = blockIdx.x * kBlockRows + h * kRows;
        tma_load_3d(kv + h * kBoxBytes, &k_map, kv_full, 0, row, bh);
        tma_load_3d(kv + (kConsumers + h) * kBoxBytes, &v_map, kv_full, 0, row, bh);
      }
      const float* lse2_b = stats + static_cast<long long>(bh) * sq_pad;
      const float* delta_b = lse2_b + rows_pad;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kBwStages;
        if (t >= kBwStages) mbar_wait(&empty[s], (t / kBwStages - 1) & 1);
        uint8_t* st = stages + s * kStageBytes;
        mbar_expect_tx(&full[s], 2 * kBoxBytes + 2 * kRows * 4);
        tma_load_3d(st, &qs_map, &full[s], 0, t * kRows, bh);
        tma_load_3d(st + kBoxBytes, &g_map, &full[s], 0, t * kRows, bh);
        bulk_load(st + 2 * kBoxBytes, lse2_b + t * kRows, kRows * 4, &full[s]);
        bulk_load(st + 2 * kBoxBytes + kRows * 4, delta_b + t * kRows, kRows * 4, &full[s]);
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int k0 = blockIdx.x * kBlockRows + wg * kRows;
    if (k0 >= Sk) {   // nothing to own: hand every stage back
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(&full[t % kBwStages], (t / kBwStages) & 1);
        if (lane == 0) mbar_arrive(&empty[t % kBwStages]);
      }
    } else {
      // This thread holds keys kr0 and kr0 + 8 of the consumer's 64, and query
      // columns c0, c0 + 1 of every n8 group of a stage.
      const int kr0 = warp * 16 + lane / 4;
      const int c0 = (lane % 4) * 2;
      const int keys[2] = {k0 + kr0, k0 + kr0 + 8};
      const long long qrow0 = static_cast<long long>(bh) * Sq;
      const uint64_t ka = smem_desc<kRowBytes>(kv + wg * kBoxBytes);
      const uint64_t va = smem_desc<kRowBytes>(kv + (kConsumers + wg) * kBoxBytes);

      float dka[D / 2], dva[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
      mbar_wait(kv_full, 0);

      for (int t = 0; t < n_tiles; ++t) {
        const int stage = t % kBwStages;
        mbar_wait(&full[stage], (t / kBwStages) & 1);
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
          // The bias transposed: this thread's two keys of sixteen query rows.
          const int q0 = t * kRows;
          const float* bp = bias + (qrow0 + q0 + c0) * Sk;
          if (q0 + kRows <= Sq && keys[1] < Sk) {   // all there: loads sixteen at a time
#pragma unroll
            for (int j0 = 0; j0 < kRows / 8; j0 += 4) {
              float b[4][4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  b[j][e] = __ldg(bp + static_cast<long long>((j0 + j) * 8 + (e & 1)) * Sk
                                  + keys[e >> 1]);
                }
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) sT[4 * (j0 + j) + e] += b[j][e];
              }
            }
          } else {
#pragma unroll
            for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int qc = j * 8 + (e & 1);   // past q0 + c0
                if (q0 + c0 + qc < Sq && keys[e >> 1] < Sk) {
                  sT[4 * j + e] += __ldg(bp + static_cast<long long>(qc) * Sk + keys[e >> 1]);
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
            const float sv = sT[4 * j + e];
            const float pe = fast_exp2(fmaf(sv, kLog2e, -((e & 1) ? ls.y : ls.x)));
            sT[4 * j + e] = pe;                                              // P^T
            dpT[4 * j + e] = pe * (dpT[4 * j + e] - ((e & 1) ? de.y : de.x));   // dS^T
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
        if (lane == 0) mbar_arrive(&empty[stage]);
      }

      // q was scaled before the product, so dk already carries 1/sqrt(D).
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (keys[i] >= Sk) continue;
        const long long off = (static_cast<long long>(bh) * Sk + keys[i]) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + j * 8 + c0) =
              __floats2bfloat162_rn(dka[4 * j + 2 * i], dka[4 * j + 2 * i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + j * 8 + c0) =
              __floats2bfloat162_rn(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
        }
      }
    }
  }
}

// dq, and with a bias dbias = dS, of one (b, h, 192-row query block), 64 rows
// a consumer.
template <int D, bool kBiased>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __nv_bfloat16* __restrict__ qs, const __nv_bfloat16* __restrict__ g,
                    const float* __restrict__ stats, const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ dq, float* __restrict__ dbias,
                    int Sq, int Sk, int sq_pad, long long rows_pad) {
  constexpr int kRowBytes = 2 * D;
  constexpr int kBoxBytes = kRows * kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = aligned_smem(smem_raw);   // stage: K box, V box
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + kBwStages * 2 * kBoxBytes);
  uint64_t* empty = full + kBwStages;

  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  const int n_tiles = (Sk + kRows - 1) / kRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kEmptyArrivals);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kBwStages;
        if (t >= kBwStages) mbar_wait(&empty[s], (t / kBwStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * kBoxBytes);
        tma_load_3d(tiles + s * 2 * kBoxBytes, &k_map, &full[s], 0, t * kRows, bh);
        tma_load_3d(tiles + s * 2 * kBoxBytes + kBoxBytes, &v_map, &full[s], 0, t * kRows, bh);
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int q0 = blockIdx.x * kBlockRows + wg * kRows;
    if (q0 >= Sq) {   // nothing to own: hand every stage back
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(&full[t % kBwStages], (t / kBwStages) & 1);
        if (lane == 0) mbar_arrive(&empty[t % kBwStages]);
      }
    } else {
      const int r0 = warp * 16 + lane / 4;
      const int c0 = (lane % 4) * 2;
      const int rows[2] = {q0 + r0, q0 + r0 + 8};
      const long long qrow0 = static_cast<long long>(bh) * Sq;
      uint32_t qf[D / 16][4], gf[D / 16][4];
      load_a_global<D>(qs + qrow0 * D, q0, Sq, r0, c0, 1.f, qf);
      load_a_global<D>(g + qrow0 * D, q0, Sq, r0, c0, 1.f, gf);
      // The padded statistics read as 0 past Sq.
      const float* lse2_b = stats + static_cast<long long>(bh) * sq_pad;
      const float lse2_r[2] = {lse2_b[rows[0]], lse2_b[rows[1]]};
      const float delta_r[2] = {lse2_b[rows_pad + rows[0]], lse2_b[rows_pad + rows[1]]};
      const bool pairs = Sk % 2 == 0;   // every pair of bias columns is 8-byte aligned
      const float* brow[2] = {nullptr, nullptr};
      if constexpr (kBiased) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (rows[i] < Sq) brow[i] = bias + (qrow0 + rows[i]) * Sk;
        }
      }

      float dqa[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

      for (int t = 0; t < n_tiles; ++t) {
        const int stage = t % kBwStages;
        mbar_wait(&full[stage], (t / kBwStages) & 1);
        const uint8_t* kt = tiles + stage * 2 * kBoxBytes;
        const uint64_t kd = smem_desc<kRowBytes>(kt);
        const uint64_t vd = smem_desc<kRowBytes>(kt + kBoxBytes);

        float s[kRows / 2], dp[kRows / 2];
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
        fence_regs(s);
        fence_regs(dp);

        const int k0 = t * kRows;
        const bool edge = k0 + kRows > Sk;
        if constexpr (kBiased) {
          const float* at[2] = {brow[0] == nullptr ? nullptr : brow[0] + k0 + c0,
                                brow[1] == nullptr ? nullptr : brow[1] + k0 + c0};
          add_bias<kRows>(s, at, Sk - k0 - c0, pairs && !edge, lane);
        }
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j) {
          const int col = k0 + j * 8 + c0;
          const bool ok0 = col < Sk, ok1 = col + 1 < Sk;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float x0 = s[4 * j + 2 * i], x1 = s[4 * j + 2 * i + 1];
            const bool live = rows[i] < Sq;
            const long long at = (qrow0 + rows[i]) * Sk + col;
            float ds0 = fast_exp2(fmaf(x0, kLog2e, -lse2_r[i])) * (dp[4 * j + 2 * i] - delta_r[i]);
            float ds1 = fast_exp2(fmaf(x1, kLog2e, -lse2_r[i]))
                * (dp[4 * j + 2 * i + 1] - delta_r[i]);
            if (edge) {   // a key past the end: p is not 0 there
              if (!ok0) ds0 = 0.f;
              if (!ok1) ds1 = 0.f;
            }
            s[4 * j + 2 * i] = ds0;
            s[4 * j + 2 * i + 1] = ds1;
            if constexpr (kBiased) {
              if (live) store_pair(dbias + at, make_float2(ds0, ds1), pairs && ok1, ok0, ok1);
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
        if (lane == 0) mbar_arrive(&empty[stage]);
      }

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (rows[i] >= Sq) continue;
        __nv_bfloat16* row = dq + (qrow0 + rows[i]) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(row + j * 8 + c0) = __floats2bfloat162_rn(
              dqa[4 * j + 2 * i] * kScaleOf<D>, dqa[4 * j + 2 * i + 1] * kScaleOf<D>);
        }
      }
    }
  }
}

template <int D, bool kBiased>
int launch_fwd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
               const float* bias, __nv_bfloat16* out, float* lse, int B, int H, int Sq, int Sk,
               cudaStream_t st) {
  CUtensorMap k_map, v_map;
  int rc = rows_map(&k_map, k, B * H, Sk, D);
  if (rc == 0) rc = rows_map(&v_map, v, B * H, Sk, D);
  if (rc == 0) rc = allow_smem(flash_fwd_kernel<D, kBiased>, kFwdSmemBytes<D>);
  if (rc != 0) return rc;
  flash_fwd_kernel<D, kBiased><<<dim3(blocks_of(Sq), H, B), kThreads, kFwdSmemBytes<D>, st>>>(
      k_map, v_map, q, bias, out, lse, Sq, Sk);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kBiased>
int launch_bwd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
               const float* bias, const __nv_bfloat16* out, const float* lse,
               const __nv_bfloat16* g, __nv_bfloat16* qs, float* stats, __nv_bfloat16* dq,
               __nv_bfloat16* dk, __nv_bfloat16* dv, float* dbias, int B, int H, int Sq, int Sk,
               cudaStream_t st) {
  CUtensorMap k_map, v_map, qs_map, g_map;
  int rc = rows_map(&k_map, k, B * H, Sk, D);
  if (rc == 0) rc = rows_map(&v_map, v, B * H, Sk, D);
  if (rc == 0) rc = rows_map(&qs_map, qs, B * H, Sq, D);
  if (rc == 0) rc = rows_map(&g_map, g, B * H, Sq, D);
  if (rc == 0) rc = allow_smem(flash_bwd_dkv_kernel<D, kBiased>, kDkvSmemBytes<D>);
  if (rc == 0) rc = allow_smem(flash_bwd_dq_kernel<D, kBiased>, kDqSmemBytes<D>);
  if (rc != 0) return rc;

  const int sq_pad = (Sq + kRows - 1) / kRows * kRows;
  const long long rows_pad = static_cast<long long>(B) * H * sq_pad;
  bwd_prep_kernel<D><<<static_cast<unsigned>((rows_pad + 7) / 8), 256, 0, st>>>(
      q, out, g, lse, qs, stats, Sq, sq_pad, rows_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<D, kBiased>
      <<<dim3(blocks_of(Sk), H, B), kThreads, kDkvSmemBytes<D>, st>>>(
          k_map, v_map, qs_map, g_map, stats, bias, dk, dv, Sq, Sk, sq_pad, rows_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D, kBiased>
      <<<dim3(blocks_of(Sq), H, B), kThreads, kDqSmemBytes<D>, st>>>(
          k_map, v_map, qs, g, stats, bias, dq, dbias, Sq, Sk, sq_pad, rows_pad);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kBiased>
int describe_all(int which, int* info) {
  if (which == 0) {
    return describe(flash_fwd_kernel<D, kBiased>, kFwdSmemBytes<D>, kFwK, kFwStages, info);
  }
  if (which == 1) {
    return describe(flash_bwd_dkv_kernel<D, kBiased>, kDkvSmemBytes<D>, kRows, kBwStages, info);
  }
  return describe(flash_bwd_dq_kernel<D, kBiased>, kDqSmemBytes<D>, kRows, kBwStages, info);
}

}  // namespace

// C entries for ctypes. All tensors are contiguous and 16-byte aligned: q,
// out, g, dq, qs [B, H, Sq, d] bf16; k, v, dk, dv [B, H, Sk, d] bf16; lse
// [B, H, Sq] fp32; bias, dbias [B, H, Sq, Sk] fp32 or both null. d is 32 or
// 64. Each returns the first error (0 on success; 10000 and above: the
// tensor-map encoder was not found or refused); the caller checks it.

// out and lse are written.
extern "C" int vivid_flash_attn_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out, void* lse,
    int B, int H, int Sq, int Sk, int d, void* stream) {
  if (bad_shape(B, H, Sq, Sk, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(lse);
  if (d == 64) {
    return bias != nullptr ? launch_fwd<64, true>(qp, kp, vp, bp, op, lp, B, H, Sq, Sk, st)
                           : launch_fwd<64, false>(qp, kp, vp, bp, op, lp, B, H, Sq, Sk, st);
  }
  return bias != nullptr ? launch_fwd<32, true>(qp, kp, vp, bp, op, lp, B, H, Sq, Sk, st)
                         : launch_fwd<32, false>(qp, kp, vp, bp, op, lp, B, H, Sq, Sk, st);
}

// out and lse are this file's forward's. Scratch: qs [B, H, Sq, d] bf16 and
// stats [2, B * H, Sq rounded up to 64] fp32. dq, dk, dv and (with a bias)
// every element of dbias are written.
extern "C" int vivid_flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* bias, const void* out,
    const void* lse, const void* g, void* qs, void* stats, void* dq, void* dk, void* dv,
    void* dbias, int B, int H, int Sq, int Sk, int d, void* stream) {
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
  auto* qsp = static_cast<__nv_bfloat16*>(qs);
  auto* sp = static_cast<float*>(stats);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  auto* dbp = static_cast<float*>(dbias);
  if (d == 64) {
    return bias != nullptr
        ? launch_bwd<64, true>(qp, kp, vp, bp, op, lp, gp, qsp, sp, dqp, dkp, dvp, dbp, B, H, Sq, Sk, st)
        : launch_bwd<64, false>(qp, kp, vp, bp, op, lp, gp, qsp, sp, dqp, dkp, dvp, dbp, B, H, Sq, Sk, st);
  }
  return bias != nullptr
      ? launch_bwd<32, true>(qp, kp, vp, bp, op, lp, gp, qsp, sp, dqp, dkp, dvp, dbp, B, H, Sq, Sk, st)
      : launch_bwd<32, false>(qp, kp, vp, bp, op, lp, gp, qsp, sp, dqp, dkp, dvp, dbp, B, H, Sq, Sk, st);
}

// What was built: `kernel` 0 the forward, 1 dk/dv, 2 dq. info[0..2]: registers
// a thread at launch, local-memory bytes a thread, dynamic shared memory;
// info[3..8]: rows of the outputs a block owns, rows (dk/dv) or keys a stage,
// stages, and the registers of a consumer and of the producer thread after
// the warpgroups have traded them, threads a block.
extern "C" int vivid_flash_attn_info(int kernel, int d, int biased, int* info) {
  if ((d != 32 && d != 64) || kernel < 0 || kernel > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d == 64) {
    return biased ? describe_all<64, true>(kernel, info) : describe_all<64, false>(kernel, info);
  }
  return biased ? describe_all<32, true>(kernel, info) : describe_all<32, false>(kernel, info);
}
