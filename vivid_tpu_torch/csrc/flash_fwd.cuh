// The forward of the big-S attention kernels on wgmma and TMA (sm_90a), one
// body for four kernels, chosen at compile time by kNoMax, kFused and
// kChains:
//   K8's forward  (flash_bwd.cu `flash_fwd_kernel`): softmax about a running
//                 row maximum, the output and lse = max + log(sum) written;
//   K6            (flash_nomax.cu `flash_nomax_kernel`): no maximum, p =
//                 exp(s) or exp(s + bias - shift), the output alone;
//   K5            (flash_fused.cu `flash_fused_kernel`, kFused): K8's softmax
//                 with q loaded as it is and the scale on the fp32 logits,
//                 the zero sink in the epilogue, the output alone;
//   K10           (flash_nomax_lab.cu `flash_nomax_lab_kernel`, kChains > 0):
//                 K6's no-max softmax with the constant shift sqrt(D) in the
//                 exponentials' fused multiply-add, and the no-max lab's
//                 switches: q unscaled and the scale in that multiply-add
//                 (!kPrescale), the row sums formed by the tensor cores
//                 (kFoldL), and kChains accumulator sets over parts of a stage.
// Beside it, the block layout and the pieces the four files' kernels and
// launches use: q fragments from device memory, the bias of a tile, the
// tensor-map encoder, the shared-memory opt-in and what a kernel was built
// with.
//
// A block is four warpgroups. The last is the producer: it gives its
// registers away and one thread of it keeps a ring of kFwStages stages of
// kFwK keys (K and V, TMA boxes of 64 rows swizzled by row width, rows past
// a (b, h)'s end zero-filled) full, waiting on each stage's "empty" mbarrier
// and completing its "full" one. The first three are consumers, each on its
// own 64-row query tile, so one's exponentials run under another's products;
// they never issue a copy and meet no block-wide barrier. A consumer holds
// q / sqrt(D) (scaled in fp32, rounded to bf16 once) as A fragments in
// registers, forms S = (q / sqrt(D)) K^T on wgmma with K read K-major, turns
// S into p in registers, and adds p V on wgmma with p (rounded to bf16) from
// registers and V read MN-major (the transpose bit). Nothing is transposed
// through shared memory. K5 holds q as it is and multiplies the fp32 logits
// by 1/sqrt(D) instead: without a bias inside the exponentials' fused
// multiply-add, with one in the fused multiply-add that adds the bias. Row
// sums are per-thread fp32 partials of the unrounded p; the four of a quad
// meet once, after the last tile. Every output element has one owner and
// nothing is atomic, so two runs give the same bits. A key past Sk gets
// p = 0, a row past Sq is not written, and a consumer whose 64 rows all lie
// past Sq only hands the stages back.
//
// Without a maximum, p of a tile depends on no other tile, and nothing
// accumulated is ever rescaled. So K6 may keep one product in flight while
// it takes exponentials (kOverlap): it issues the logits of tile t and the
// product p(t-1) V(t-1) together, waits for the logits alone, takes tile t's
// exponentials in place while p(t-1) V(t-1) runs on the tensor cores, and
// rounds them into the A fragments only once that product is done (its A
// fragments stay in their registers until then; writing a product's input
// registers while one runs makes ptxas serialise the products). It costs
// the registers of one more tile's A fragments.
//
// K10's switches, each a compile-time branch whose default is K6's:
//   kFoldL   the denominator is the fp32 sum of the rounded p, formed by the
//            tensor cores: one more m64n8 product a k16 step, the same P A
//            fragments against a tile of bf16 ones that the block writes
//            once into shared memory (wgmma reads B from there only), so
//            every column of its accumulator is the row's sum
//   kChains  2 or 4: the 128-key stage in parts of 64 or 32 keys, each with
//            its own o (and row sums); a part's P V is issued, and runs on
//            the tensor cores, while the next part's exponentials are taken;
//            the parts' sums meet after the last tile. With 1 the stage is
//            one part and the schedule is K6's (kOverlap at D = 32).

#pragma once

#include <dlfcn.h>

#include "flash_hopper.cuh"

namespace vivid {

constexpr int kRows = 64;        // rows of a TMA box and of a consumer's tile
constexpr int kFwK = 128;        // forward: keys per stage (64 was 15-20 % slower)
constexpr int kFwStages = 4;     // 2, 4 and 6 stages time alike: the producer is never late

constexpr int kConsumers = 3;    // consumer warpgroups in a block
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kBlockRows = kConsumers * kRows;   // rows of the outputs a block owns
// Registers a thread: 65536 / 512 = 128 at launch, then the warpgroups trade
// them: 128 * 24 + 384 * 160 = 64512. (Two consumers of 232 and a producer of
// 40 were slower at every path shape: three hide each other's waits better.)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 160;
constexpr int kEmptyArrivals = kConsumers * 4;   // one lane of every consumer warp

// 1/sqrt(D) as the nearest fp32, the value the plain versions multiply by.
template <int D>
constexpr float kScaleOf = D == 32 ? 0.17677669529663687f : 0.125f;

// sqrt(D) as the nearest fp32: K10's constant shift, above every scaled
// logit of pixel-normalised rows.
template <int D>
constexpr float kShiftOf = D == 32 ? 5.656854249492381f : 8.0f;

// Dynamic shared memory starts at no particular alignment: tiles start at the
// next multiple of 1024 bytes (kAlignSlack is asked for on top).
constexpr int kAlignSlack = 1024;

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_addr(raw);
  return raw + ((1024u - (a & 1023u)) & 1023u);
}

template <int D>
constexpr int kFwdSmemBytes = kAlignSlack + kFwStages * 2 * kFwK * 2 * D + 2 * kFwStages * 8;

// K10 with kFoldL: the tile of bf16 ones (8 rows of 128 bytes, 1024-byte
// aligned, past the barriers), and the shared memory it then needs.
constexpr int kOnesBytes = 1024;
template <int D>
constexpr int kOnesOffset = kFwStages * 2 * kFwK * 2 * D + 1024;
template <int D, bool kFoldL>
constexpr int kLabSmemBytes = kFoldL ? kAlignSlack + kOnesOffset<D> + kOnesBytes
                                     : kFwdSmemBytes<D>;

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

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// The A fragments of a product in flight stay where they are until its wait.
template <int kN>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
  }
}

// s + b, or with kScaleD a head dim (K5) s * kScaleOf<kScaleD> + b in one
// fused multiply-add: the scale on the fp32 logits before the bias joins.
template <int kScaleD>
__device__ __forceinline__ float plus_bias(float s, float b) {
  if constexpr (kScaleD == 0) {
    return s + b;
  } else {
    return fmaf(s, kScaleOf<kScaleD>, b);
  }
}

// s (this thread's part of a 64 x kCols tile of logits) += the bias. brow[i]
// is the thread's row i of the bias at the tile's first key plus c0, or null
// past Sq; `cols` keys of the tile exist. `whole` says every pair of columns
// exists and is 8-byte aligned: then the loads go out sixteen at a time with
// no branch between them, so their latencies overlap. The next tile's lines
// of these rows are asked into L2 meanwhile, one 128-byte line a thread of
// the quad that shares the row.
template <int kCols, int kScaleD = 0>
__device__ __forceinline__ void add_bias(float (&s)[kCols / 2], const float* const (&brow)[2],
                                         int cols, bool whole, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (brow[i] == nullptr) continue;
    const int line = (lane % 4) * 32 - (lane % 4) * 2;   // from c0 to the quad's line
    if ((lane % 4) * 32 < kCols && kCols + line < cols) prefetch_l2(brow[i] + kCols + line);
  }
  if (whole && brow[0] != nullptr && brow[1] != nullptr) {
#pragma unroll
    for (int j0 = 0; j0 < kCols / 8; j0 += 8) {
      float2 b[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          b[j][i] = __ldg(reinterpret_cast<const float2*>(brow[i] + (j0 + j) * 8));
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          s[4 * (j0 + j) + 2 * i] = plus_bias<kScaleD>(s[4 * (j0 + j) + 2 * i], b[j][i].x);
          s[4 * (j0 + j) + 2 * i + 1] =
              plus_bias<kScaleD>(s[4 * (j0 + j) + 2 * i + 1], b[j][i].y);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + (e & 1);   // past c0
        if (brow[e >> 1] != nullptr && col < cols) {
          s[4 * j + e] = plus_bias<kScaleD>(s[4 * j + e], __ldg(brow[e >> 1] + col));
        }
      }
    }
  }
}

// Bias (through add_bias, kScaleD as there) and the ragged edge of the tile
// of logits that starts at key k0: keys past Sk become -inf, so their p is 0.
template <bool kBiased, int kScaleD = 0>
__device__ __forceinline__ void bias_and_edge(float (&s)[kFwK / 2], const float* const (&brow)[2],
                                              int k0, int c0, int Sk, bool pairs, int lane) {
  const bool edge = k0 + kFwK > Sk;
  if constexpr (kBiased) {
    const float* at[2] = {brow[0] == nullptr ? nullptr : brow[0] + k0 + c0,
                          brow[1] == nullptr ? nullptr : brow[1] + k0 + c0};
    add_bias<kFwK, kScaleD>(s, at, Sk - k0 - c0, pairs && !edge, lane);
  }
  if (edge) {
#pragma unroll
    for (int j = 0; j < kFwK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + j * 8 + c0 + (e & 1) >= Sk) s[4 * j + e] = -INFINITY;
      }
    }
  }
}

// K6's p of one tile of logits, in place: exp2 of one multiply by log2(e) or,
// with a bias (already added), of one fused multiply-add with -shift * log2(e)
// folded in; the unrounded p added into the thread's partial row sums.
template <bool kBiased>
__device__ __forceinline__ void nomax_exps(float (&s)[kFwK / 2], float shift2, float (&l)[2]) {
#pragma unroll
  for (int j = 0; j < kFwK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[4 * j + e];
      const float p = fast_exp2(kBiased ? fmaf(x, kLog2e, -shift2) : x * kLog2e);
      s[4 * j + e] = p;
      l[e >> 1] += p;
    }
  }
}

// K10's p of the n8 groups [j0, j0 + n_groups) of a tile of logits, in place:
// exp2 of one fused multiply-add, log2(e) (times 1/sqrt(D) without
// kPrescale) and the shift sqrt(D) * log2(e) folded in; the unrounded p
// added into the thread's partial row sums unless the tensor cores sum the
// rounded p (kFoldL).
template <int D, bool kPrescale, bool kFoldL>
__device__ __forceinline__ void lab_exps(float (&s)[kFwK / 2], int j0, int n_groups,
                                         float (&l)[2]) {
  constexpr float kMul = (kPrescale ? 1.f : kScaleOf<D>) * kLog2e;
  constexpr float kShift2 = kShiftOf<D> * kLog2e;
#pragma unroll
  for (int j = j0; j < j0 + n_groups; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(fmaf(s[4 * j + e], kMul, -kShift2));
      s[4 * j + e] = p;
      if constexpr (!kFoldL) l[e >> 1] += p;
    }
  }
}

// The body of K8's forward (kNoMax false: out and lse written), of K6
// (kNoMax true: out alone; with a bias, shift = sqrt(D) + max(bias) read from
// device memory; kOverlap: exponentials under the product before, no-max
// only) and of K5 (kFused: K8's softmax on s = (q . k) / sqrt(D) + bias, out
// alone, `zero_sink` all-zero key columns joined after the last tile) and of
// K10 (kChains > 0: K6 unbiased with the constant shift and the lab's
// switches kFoldL and kPrescale; kOverlap with one chain only). Grid
// (ceil(Sq / kBlockRows), H, B), kThreads threads, kFwdSmemBytes<D> of
// dynamic shared memory (K10: kLabSmemBytes<D, kFoldL>); k_map and v_map as
// rows_map encodes them.
template <int D, bool kBiased, bool kNoMax, bool kOverlap, bool kFused = false,
          int kChains = 0, bool kFoldL = false, bool kPrescale = true>
__device__ __forceinline__ void attn_fwd(const CUtensorMap* k_map, const CUtensorMap* v_map,
                                         const __nv_bfloat16* __restrict__ q,
                                         const float* __restrict__ bias,
                                         const float* __restrict__ shift,
                                         __nv_bfloat16* __restrict__ out,
                                         float* __restrict__ lse, int Sq, int Sk,
                                         float zero_sink = 0.f) {
  static_assert(!(kFused && (kNoMax || kOverlap)), "K5 keeps a running maximum");
  constexpr bool kLab = kChains > 0;   // K10
  static_assert(!kLab || (kNoMax && !kBiased && !kFused && (kChains == 1 || !kOverlap)),
                "K10 is K6 unbiased; its chains have a schedule of their own");
  static_assert(kLab || (!kFoldL && kPrescale), "the lab's switches are K10's");
  static_assert(kChains == 0 || kChains == 1 || kChains == 2 || kChains == 4, "chains 1, 2, 4");
  // log2(e) per unit of the logits the maximum is taken of: K5 without a bias
  // keeps them unscaled and folds 1/sqrt(D) in here (the maximum of the
  // scaled logits is the scaled maximum: rounding is monotonic).
  constexpr float kExp2 = kFused && !kBiased ? kScaleOf<D> * kLog2e : kLog2e;
  constexpr int kRowBytes = 2 * D;
  constexpr int kTileBytes = kFwK * kRowBytes;   // one of K, V of a stage
  constexpr int kBoxBytes = kRows * kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + kFwStages * 2 * kTileBytes);
  uint64_t* empty = full + kFwStages;

  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  const int n_tiles = (Sk + kFwK - 1) / kFwK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kEmptyArrivals);
    }
    mbar_fence_init();
  }
  if constexpr (kFoldL) {   // the tile of ones, written once, read by wgmma
    uint32_t* ones = reinterpret_cast<uint32_t*>(tiles + kOnesOffset<D>);
    for (int i = threadIdx.x; i < kOnesBytes / 4; i += blockDim.x) ones[i] = 0x3f803f80u;
    fence_shared_to_async();
  }
  __syncthreads();

  if (wg == kConsumers) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kFwStages;
        if (t >= kFwStages) mbar_wait(&empty[s], (t / kFwStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        uint8_t* kt = tiles + s * 2 * kTileBytes;
#pragma unroll
        for (int h = 0; h < kFwK / kRows; ++h) {
          tma_load_3d(kt + h * kBoxBytes, k_map, &full[s], 0, t * kFwK + h * kRows, bh);
          tma_load_3d(kt + kTileBytes + h * kBoxBytes, v_map, &full[s], 0,
                      t * kFwK + h * kRows, bh);
        }
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int q0 = blockIdx.x * kBlockRows + wg * kRows;
    if (q0 >= Sq) {   // nothing to own: hand every stage back
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(&full[t % kFwStages], (t / kFwStages) & 1);
        if (lane == 0) mbar_arrive(&empty[t % kFwStages]);
      }
    } else {
      // This thread holds rows r0 and r0 + 8 of the consumer's 64 query rows,
      // and columns c0, c0 + 1 of every n8 group.
      const int r0 = warp * 16 + lane / 4;
      const int c0 = (lane % 4) * 2;
      const long long qrow0 = static_cast<long long>(bh) * Sq;
      uint32_t qf[D / 16][4];
      load_a_global<D>(q + qrow0 * D, q0, Sq, r0, c0,
                       kFused || (kLab && !kPrescale) ? 1.f : kScaleOf<D>, qf);
      // K10 with kFoldL: B of the row sums' products, the ones read K-major.
      const uint64_t ones_d = kFoldL ? smem_desc<128>(tiles + kOnesOffset<D>) : 0;

      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};   // per-thread partial sums; a quad holds a row
      const float* brow[2] = {nullptr, nullptr};
      const bool pairs = Sk % 2 == 0;   // every pair of bias columns is 8-byte aligned
      float shift2 = 0.f;               // K6: shift * log2(e)
      if constexpr (kBiased) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = q0 + r0 + i * 8;
          if (row < Sq) brow[i] = bias + (qrow0 + row) * Sk;
        }
        if constexpr (kNoMax) shift2 = *shift * kLog2e;
      }

      if constexpr (kNoMax && kOverlap) {
        // Tile 0's logits and p; then per tile t the logits of t and
        // p(t-1) V(t-1) go out together, and t's exponentials run under the
        // second product.
        float s[kFwK / 2];
        uint32_t pa[kFwK / 16][4];
        float ls[4] = {0.f, 0.f, 0.f, 0.f};   // K10 kFoldL: the tensor cores' row sums
        mbar_wait(&full[0], 0);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          Wgmma<kFwK, true>::template run<0>(s, qf[kk], smem_desc<kRowBytes>(tiles)
                                             + kk * kDescStepK, kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        bias_and_edge<kBiased>(s, brow, 0, c0, Sk, pairs, lane);
        if constexpr (kLab) {
          lab_exps<D, kPrescale, kFoldL>(s, 0, kFwK / 8, l);
        } else {
          nomax_exps<kBiased>(s, shift2, l);
        }
#pragma unroll
        for (int kk = 0; kk < kFwK / 16; ++kk) acc_to_a(s, kk, pa[kk]);

        for (int t = 1; t < n_tiles; ++t) {
          const int stage = t % kFwStages;
          const int prev = (t - 1) % kFwStages;
          mbar_wait(&full[stage], (t / kFwStages) & 1);
          const uint64_t kd = smem_desc<kRowBytes>(tiles + stage * 2 * kTileBytes);
          const uint64_t vd = smem_desc<kRowBytes>(tiles + prev * 2 * kTileBytes + kTileBytes);
          fence_regs(o);
          if constexpr (kFoldL) fence_regs(ls);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            Wgmma<kFwK, true>::template run<0>(s, qf[kk], kd + kk * kDescStepK, kk > 0);
          }
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < kFwK / 16; ++kk) {
            Wgmma<D, true>::template run<1>(o, pa[kk], vd + kk * kDescStepMN<kRowBytes>, 1);
          }
          if constexpr (kFoldL) {
#pragma unroll
            for (int kk = 0; kk < kFwK / 16; ++kk) {
              Wgmma<8, true>::template run<0>(ls, pa[kk], ones_d, 1);
            }
          }
          wgmma_commit();
          wgmma_wait<1>();   // the logits; p(t-1) V(t-1) may still run
          fence_regs(s);
          bias_and_edge<kBiased>(s, brow, t * kFwK, c0, Sk, pairs, lane);
          if constexpr (kLab) {
            lab_exps<D, kPrescale, kFoldL>(s, 0, kFwK / 8, l);
          } else {
            nomax_exps<kBiased>(s, shift2, l);
          }
          wgmma_wait<0>();
          fence_regs(o);
          if constexpr (kFoldL) fence_regs(ls);
          fence_regs(pa);
          if (lane == 0) mbar_arrive(&empty[prev]);   // this warp is done with the stage
#pragma unroll
          for (int kk = 0; kk < kFwK / 16; ++kk) acc_to_a(s, kk, pa[kk]);
        }
        const int last = (n_tiles - 1) % kFwStages;
        const uint64_t vd = smem_desc<kRowBytes>(tiles + last * 2 * kTileBytes + kTileBytes);
        fence_regs(o);
        if constexpr (kFoldL) fence_regs(ls);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kFwK / 16; ++kk) {
          Wgmma<D, true>::template run<1>(o, pa[kk], vd + kk * kDescStepMN<kRowBytes>, 1);
        }
        if constexpr (kFoldL) {
#pragma unroll
          for (int kk = 0; kk < kFwK / 16; ++kk) {
            Wgmma<8, true>::template run<0>(ls, pa[kk], ones_d, 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        if constexpr (kFoldL) {
          fence_regs(ls);
          l[0] = ls[0];   // every column is the row's sum: rows r0 and r0 + 8
          l[1] = ls[2];
        }
        if (lane == 0) mbar_arrive(&empty[last]);
      } else if constexpr (kChains > 1) {
        // K10's chains: the stage's logits at once; then part by part the
        // exponentials, and the part's P V (and with kFoldL its row sums)
        // issued into the part's own accumulators, running on the tensor
        // cores while the next part's exponentials are taken. The parts meet
        // after the last tile.
        constexpr int kPart = kFwK / kChains;   // keys of a part
        float oc[kChains][D / 2];
        float lc[kChains][2];
        float ls[kChains][4];
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) oc[c][i] = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) ls[c][i] = 0.f;
          lc[c][0] = lc[c][1] = 0.f;
        }
        for (int t = 0; t < n_tiles; ++t) {
          const int stage = t % kFwStages;
          mbar_wait(&full[stage], (t / kFwStages) & 1);
          const uint8_t* kt = tiles + stage * 2 * kTileBytes;
          const uint64_t kd = smem_desc<kRowBytes>(kt);
          const uint64_t vd = smem_desc<kRowBytes>(kt + kTileBytes);

          float s[kFwK / 2];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            Wgmma<kFwK, true>::template run<0>(s, qf[kk], kd + kk * kDescStepK, kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);
          bias_and_edge<false>(s, brow, t * kFwK, c0, Sk, pairs, lane);

          uint32_t pa[kFwK / 16][4];
#pragma unroll
          for (int c = 0; c < kChains; ++c) {
            lab_exps<D, kPrescale, kFoldL>(s, c * kPart / 8, kPart / 8, lc[c]);
#pragma unroll
            for (int kk = c * kPart / 16; kk < (c + 1) * kPart / 16; ++kk) acc_to_a(s, kk, pa[kk]);
            fence_regs(oc[c]);
            if constexpr (kFoldL) fence_regs(ls[c]);
            wgmma_fence();
#pragma unroll
            for (int kk = c * kPart / 16; kk < (c + 1) * kPart / 16; ++kk) {
              Wgmma<D, true>::template run<1>(oc[c], pa[kk], vd + kk * kDescStepMN<kRowBytes>, 1);
              if constexpr (kFoldL) Wgmma<8, true>::template run<0>(ls[c], pa[kk], ones_d, 1);
            }
            wgmma_commit();
          }
          wgmma_wait<0>();
#pragma unroll
          for (int c = 0; c < kChains; ++c) {
            fence_regs(oc[c]);
            if constexpr (kFoldL) fence_regs(ls[c]);
          }
          fence_regs(pa);
          if (lane == 0) mbar_arrive(&empty[stage]);   // this warp is done with the stage
        }
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] += oc[c][i];
#pragma unroll
          for (int i = 0; i < 2; ++i) l[i] += kFoldL ? ls[c][2 * i] : lc[c][i];
        }
      } else {
        float ls[4] = {0.f, 0.f, 0.f, 0.f};   // K10 kFoldL: the tensor cores' row sums
        for (int t = 0; t < n_tiles; ++t) {
          const int stage = t % kFwStages;
          mbar_wait(&full[stage], (t / kFwStages) & 1);
          const uint8_t* kt = tiles + stage * 2 * kTileBytes;
          const uint64_t kd = smem_desc<kRowBytes>(kt);
          const uint64_t vd = smem_desc<kRowBytes>(kt + kTileBytes);

          float s[kFwK / 2];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            Wgmma<kFwK, true>::template run<0>(s, qf[kk], kd + kk * kDescStepK, kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);

          // Bias (K5: after the scale), the ragged edge, and (K8, K5) the
          // tile's row maxima.
          bias_and_edge<kBiased, kFused ? D : 0>(s, brow, t * kFwK, c0, Sk, pairs, lane);
          if constexpr (kLab) {
            lab_exps<D, kPrescale, kFoldL>(s, 0, kFwK / 8, l);
          } else if constexpr (kNoMax) {
            nomax_exps<kBiased>(s, shift2, l);
          } else {
            float mx[2] = {m[0], m[1]};
#pragma unroll
            for (int j = 0; j < kFwK / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
            }
            float m2[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
              mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
              const float alpha = fast_exp2((m[i] - mx[i]) * kExp2);   // 0 on the first tile
              m[i] = mx[i];
              m2[i] = mx[i] * kExp2;
              l[i] *= alpha;
#pragma unroll
              for (int j = 0; j < D / 8; ++j) {
                o[4 * j + 2 * i] *= alpha;
                o[4 * j + 2 * i + 1] *= alpha;
              }
            }
#pragma unroll
            for (int j = 0; j < kFwK / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float p = fast_exp2(fmaf(s[4 * j + e], kExp2, -m2[e >> 1]));
                s[4 * j + e] = p;
                l[e >> 1] += p;
              }
            }
          }

          // o += p v, with p rounded to bf16.
          uint32_t pa[kFwK / 16][4];
#pragma unroll
          for (int kk = 0; kk < kFwK / 16; ++kk) acc_to_a(s, kk, pa[kk]);
          fence_regs(o);
          if constexpr (kFoldL) fence_regs(ls);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kFwK / 16; ++kk) {
            Wgmma<D, true>::template run<1>(o, pa[kk], vd + kk * kDescStepMN<kRowBytes>, 1);
          }
          if constexpr (kFoldL) {
#pragma unroll
            for (int kk = 0; kk < kFwK / 16; ++kk) {
              Wgmma<8, true>::template run<0>(ls, pa[kk], ones_d, 1);
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(o);
          if constexpr (kFoldL) {
            fence_regs(ls);
            fence_regs(pa);
          }
          if (lane == 0) mbar_arrive(&empty[stage]);   // this warp is done with the stage
        }
        if constexpr (kFoldL) {
          l[0] = ls[0];   // every column is the row's sum: rows r0 and r0 + 8
          l[1] = ls[2];
        }
      }

      if constexpr (!kFoldL) {   // with kFoldL every thread holds its rows' whole sums
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + r0 + i * 8;
        if (row >= Sq) continue;
        __nv_bfloat16* orow = out + (qrow0 + row) * D;
        if constexpr (kNoMax) {   // one division, as the plain version
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + c0) =
                __floats2bfloat162_rn(o[4 * j + 2 * i] / l[i], o[4 * j + 2 * i + 1] / l[i]);
          }
        } else if constexpr (kFused) {
          // The sink: the maximum raised to 0 rescales the sum and the
          // accumulator; one division, as the plain version.
          float corr = 1.f, den = l[i];
          if (zero_sink > 0.f) {
            const float mi = kBiased ? m[i] : m[i] * kScaleOf<D>;
            const float m0 = fmaxf(mi, 0.f);
            corr = expf(mi - m0);
            den = l[i] * corr + zero_sink * expf(-m0);
          }
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + c0) = __floats2bfloat162_rn(
                o[4 * j + 2 * i] * corr / den, o[4 * j + 2 * i + 1] * corr / den);
          }
        } else {
          const float inv = 1.f / l[i];
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + c0) =
                __floats2bfloat162_rn(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
          }
          if (lane % 4 == 0) lse[qrow0 + row] = m[i] + logf(l[i]);
        }
      }
    }
  }
}

// ---- host side -----------------------------------------------------------

inline bool bad_shape(int B, int H, int Sq, int Sk, int d) {
  return B < 1 || H < 1 || Sq < 1 || Sk < 1 || B > 65535 || H > 65535 || (d != 32 && d != 64);
}

// Errors of the tensor-map encoder come back above this offset.
constexpr int kEncodeError = 10000;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda at run time (the process that
// launches kernels has it loaded), so the library links without it.
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    void* p = lib == nullptr ? nullptr : dlsym(lib, "cuTensorMapEncodeTiled");
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Map of a contiguous [n_bh, len, d] bf16 tensor for boxes of 64 rows of one
// (b, h), swizzled by the row's width. The base must be 16-byte aligned.
inline int rows_map(CUtensorMap* map, const void* base, int n_bh, int len, int d) {
  if (encoder() == nullptr) return kEncodeError;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(n_bh)};
  const cuuint64_t strides[2] = {2ull * d, 2ull * d * len};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(d), kRows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult rc = encoder()(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      d == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(rc);
}

// More than 48 KB of dynamic shared memory has to be asked for, on the
// device the launch goes to: before every launch.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

inline int blocks_of(int len) { return (len + kBlockRows - 1) / kBlockRows; }

// info[0..2]: registers a thread at launch, bytes of local memory a thread
// (spills) and dynamic shared memory of one kernel, as the runtime reports
// them; info[3..8]: what the kernel was built with.
template <typename Kernel>
int describe(Kernel kernel, int smem_bytes, int stage_rows, int stages, int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = smem_bytes;
  info[3] = kBlockRows;
  info[4] = stage_rows;
  info[5] = stages;
  info[6] = kConsumerRegs;
  info[7] = kProducerRegs;
  info[8] = kThreads;
  return 0;
}

}  // namespace vivid
