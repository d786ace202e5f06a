// Packed-layout fused attention for the VIVID blocks: the forward (sm_90a:
// wgmma, TMA, mbarriers). Its backward is flash_packed_bwd.cu; the pieces
// both share are in flash_packed.cuh.
//
// Replaces the TPU kernels in vivid_tpu/kernels/flash.py:
//   * flash_fused_packed       (_kernel_packed): self-attention straight off
//     the part-major packed qkv [B, S, 3*H*D], with the unconditional model's
//     zero-feature sink;
//   * flash_fused_packed_xattn (_kernel_packed_xattn): the same self segment
//     plus up to two cross sources [B, Sf, 2*H*D] (k, v part-major) under one
//     joint softmax, with an optional unscaled per-source logit bias
//     [B, H, S, Sf] (the self segment carries none).
// One launch sequence serves both: the keys are 1 to 3 segments, the self
// segment and each source.
//
// What it computes, per (batch b, head h, query row): q, k, v rows
// pixel-normalised, x / (eps + ||x|| / sqrt(D)) in fp32 rounded to bf16, as
// the TPU kernel's _rms_norm does, q then times c = 1/sqrt(D) and rounded
// again; logits s = (c q').k' (+ bias) in fp32; a softmax about the running
// row maximum, exact with or without a bias (the TPU's shiftless exp(s) was
// a speed trick for its VPU); `zero_sink` all-zero key columns add
// zero_sink * exp(-m) to the denominator after the maximum m is raised to
// max(m, 0); o = P v' with P rounded to bf16, every sum in fp32, one
// division, the output rounded to bf16 once, at out[b, s, h*D + j], the
// (head, d) order the projection reads.
//
// Design for this card, two launches:
//   packed_fwd_norm_kernel  the pre-pass of flash_packed.cuh (K3/K4 run the
//                           same): every row of q, k and v normalised once
//                           into head-major scratch the caller gives, each
//                           key segment padded with zero rows to whole
//                           64-row tiles.
//   packed_fwd_kernel       one block per (b, h, 64 query rows), the layout
//                           of K3/K4's dq kernel: a TMA producer warpgroup
//                           keeps a 4-stage ring of 64-key stages (k', v')
//                           full over every tile of every segment in order,
//                           and a consumer warpgroup holds its rows of c q'
//                           as register A fragments. Per tile: S = (c q') k'^T
//                           on wgmma with k' read K-major, the tile's fp32
//                           bias rows added, p = 0 for the keys at or past
//                           the segment's end (the padding), the online
//                           softmax step in fp32 with ex2, then o += P v' on
//                           wgmma with P from registers and v' read MN-major
//                           (the transpose bit): nothing is transposed
//                           through shared memory. Epilogue: the sink, one
//                           division, bf16 straight from the accumulator.
// Two blocks an SM; each output element has one owner and nothing is atomic,
// so two runs give the same bits. A query row past S reads as zeros and is
// not written. The softmax step is one function (softmax_step): the no-max
// form of K7 (p = exp(s), nothing rescaled) would be its other branch.
//
// What bounds it on the card: at B = 8, S = 1024, H = 4, D = 64 with two
// sources of 1024 the function needs 4 B H S Sk D = 26 GFLOP against ~34 MB
// moved: the bound is operations (with a std-1 fp32 bias of each source it
// turns to bytes, the bias read once). The exponentials (one a logit) come
// close: 100 M of them against the SFU's ~3.9e12 a second.

#include "flash_packed.cuh"

namespace {

template <int D>
constexpr int kPackedSmemBytes = kAlignSlack + kStages * 2 * kRows * 2 * D + 2 * kStages * 8;

// The pre-pass (flash_packed.cuh's norm_rows).
template <int D>
__global__ void __launch_bounds__(kNormThreads)
packed_fwd_norm_kernel(const __grid_constant__ Params p, __nv_bfloat16* __restrict__ qn,
                       __nv_bfloat16* __restrict__ kn, __nv_bfloat16* __restrict__ vn,
                       long long q_rows, long long kv_rows) {
  norm_rows<D>(p, qn, kn, vn, q_rows, kv_rows);
}

// One tile's step of the online softmax, in place: s (this thread's part of
// 64 rows x 64 keys of logits, -inf where a key is masked) becomes p =
// exp(s - m) about the running maximum m of each of its two rows, raised by
// this tile; the partial row sums l and the accumulator o are rescaled to
// the new maximum first, then l takes the unrounded p.
template <int D>
__device__ __forceinline__ void softmax_step(float (&s)[kRows / 2], float (&m)[2], float (&l)[2],
                                             float (&o)[D / 2]) {
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
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 2 * i] *= alpha;
      o[4 * j + 2 * i + 1] *= alpha;
    }
  }
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = fast_exp2(fmaf(s[4 * j + e], kLog2e, -m2[e >> 1]));
      s[4 * j + e] = pe;
      l[e >> 1] += pe;
    }
  }
}

// The output of one (b, h, 64 query rows).
template <int D, bool kBiased>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
packed_fwd_kernel(const __grid_constant__ CUtensorMap kn_map,
                  const __grid_constant__ CUtensorMap vn_map,
                  const __grid_constant__ Params p, __nv_bfloat16* __restrict__ out) {
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
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * kBoxBytes);
        tma_load_3d(tiles + s * 2 * kBoxBytes, &kn_map, &full[s], 0, t * kRows, bh);
        tma_load_3d(tiles + s * 2 * kBoxBytes + kBoxBytes, &vn_map, &full[s], 0, t * kRows, bh);
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
    uint32_t qf[D / 16][4];   // c q' is rounded already: scale 1 repacks it as it is
    load_a_global<D>(p.qn + static_cast<long long>(bh) * S * D, q0, S, r0, c0, 1.f, qf);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};   // per-thread partial sums; a quad holds a row
    for (int t = 0; t < n_tiles; ++t) {
      const Segment& sg = p.seg[segment_of(p, t)];
      const int k0 = (t - sg.tile0) * kRows;   // the tile's first key in its segment
      const int cols = sg.len - k0;            // keys of the tile that exist
      const int stage = t % kStages;
      mbar_wait(&full[stage], (t / kStages) & 1);
      const uint8_t* kt = tiles + stage * 2 * kBoxBytes;
      const uint64_t kd = smem_desc<kRowBytes>(kt);
      const uint64_t vd = smem_desc<kRowBytes>(kt + kBoxBytes);

      float s[kRows / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<kRows, true>::template run<0>(s, qf[kk], kd + kk * kDescStepK, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(qf);
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
      if (cols < kRows) {   // the segment's ragged edge: its padding rows get p = 0
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j * 8 + c0 + (e & 1) >= cols) s[4 * j + e] = -INFINITY;
          }
        }
      }
      softmax_step<D>(s, m, l, o);

      // o += P v', P rounded to bf16.
      uint32_t pa[kRows / 16][4];
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) acc_to_a(s, kk, pa[kk]);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        Wgmma<D, true>::template run<1>(o, pa[kk], vd + kk * kDescStepMN<kRowBytes>, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(&empty[stage]);   // this warp is done with the stage
    }

    // The sink: the maximum raised to 0 rescales the sum and the
    // accumulator; one division, as the plain version.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float den = quad_sum(l[i]);
      float corr = 1.f;
      if (p.zero_sink > 0.f) {
        const float m0 = fmaxf(m[i], 0.f);
        corr = expf(m[i] - m0);
        den = den * corr + p.zero_sink * expf(-m0);
      }
      if (rows[i] >= S) continue;
      __nv_bfloat16* orow = out + (static_cast<long long>(b) * S + rows[i]) * (p.H * D) + h * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + c0) = __floats2bfloat162_rn(
            o[4 * j + 2 * i] * corr / den, o[4 * j + 2 * i + 1] * corr / den);
      }
    }
  }
}

// The two launches. `rows` is the pre-pass's scratch: c q' [B*H, S, D],
// then k' and v' [B*H, key_tiles * 64, D] each.
template <int D, bool kBiased>
int launch(Params p, __nv_bfloat16* rows, __nv_bfloat16* out, int B, cudaStream_t st) {
  const int bh = B * p.H;
  const int keys = p.key_tiles * kRows;
  __nv_bfloat16* qn = rows;
  __nv_bfloat16* kn = qn + static_cast<long long>(bh) * p.S * D;
  __nv_bfloat16* vn = kn + static_cast<long long>(bh) * keys * D;
  p.qn = qn;
  CUtensorMap kn_map, vn_map;
  int rc = rows_map(&kn_map, kn, bh, keys, D);
  if (rc == 0) rc = rows_map(&vn_map, vn, bh, keys, D);
  if (rc == 0) rc = launch_norm<D>(packed_fwd_norm_kernel<D>, p, qn, kn, vn, B, st);
  if (rc != 0) return rc;
  auto* kernel = packed_fwd_kernel<D, kBiased>;
  rc = allow_smem(kernel, kPackedSmemBytes<D>);
  if (rc != 0) return rc;
  const dim3 grid((p.S + kRows - 1) / kRows, p.H, B);
  kernel<<<grid, kThreads, kPackedSmemBytes<D>, st>>>(kn_map, vn_map, p, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes. All tensors are contiguous and 16-byte aligned: qkv
// [B, S, 3*H*d] bf16, out [B, S, H*d] bf16, feats_i [B, sf_i, 2*H*d] bf16,
// bias_i [B, H, S, sf_i] fp32 or null. Scratch: rows bf16 of
// B*H*(S + 2*keys)*d elements, keys the sum over the self segment (S) and
// the sources of each length rounded up to 64. n_src is 0, 1 or 2; d is 32
// or 64. Returns the first error (0 on success; 10000 and above: the
// tensor-map encoder was not found or refused); the caller checks it.
extern "C" int vivid_flash_packed_fwd(
    const void* qkv, void* out, void* rows, int B, int S, int H, int d, int n_src,
    const void* feats0, int sf0, const void* bias0,
    const void* feats1, int sf1, const void* bias1,
    float eps, float zero_sink, void* stream) {
  if (bad_shape(B, H, S, 1, d) || n_src < 0 || n_src > 2 || !(eps > 0.f) ||
      !(zero_sink >= 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = {};
  p.qkv = static_cast<const __nv_bfloat16*>(qkv);
  p.S = S;
  p.s_pad = (S + kRows - 1) / kRows * kRows;
  p.H = H;
  p.eps = eps;
  p.zero_sink = zero_sink;
  const void* feats[2] = {feats0, feats1};
  const void* biases[2] = {bias0, bias1};
  void* const none[2] = {nullptr, nullptr};
  const int sfs[2] = {sf0, sf1};
  const int biased = fill_segments(p, d, n_src, feats, none, biases, none, sfs);
  if (biased < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* r = static_cast<__nv_bfloat16*>(rows);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (d == 64) {
    return biased ? launch<64, true>(p, r, o, B, st) : launch<64, false>(p, r, o, B, st);
  }
  return biased ? launch<32, true>(p, r, o, B, st) : launch<32, false>(p, r, o, B, st);
}

// What was built: the forward kernel for head dim d (32 or 64), the instance
// a launch with (biased != 0) or without a bias takes. info as
// describe_packed fills it.
extern "C" int vivid_flash_packed_info(int d, int biased, int* info) {
  if (d != 32 && d != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64) {
    return biased ? describe_packed(packed_fwd_kernel<64, true>, kPackedSmemBytes<64>, info)
                  : describe_packed(packed_fwd_kernel<64, false>, kPackedSmemBytes<64>, info);
  }
  return biased ? describe_packed(packed_fwd_kernel<32, true>, kPackedSmemBytes<32>, info)
                : describe_packed(packed_fwd_kernel<32, false>, kPackedSmemBytes<32>, info);
}
