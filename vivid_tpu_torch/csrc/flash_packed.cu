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
// not written. The forward's body (packed_fwd) and its softmax step
// (softmax_step) live in flash_packed.cuh: K7 (flash_nomax_packed.cu) is
// their no-max branch (kNoMax), this file the branch with a maximum.
//
// What bounds it on the card: at B = 8, S = 1024, H = 4, D = 64 with two
// sources of 1024 the function needs 4 B H S Sk D = 26 GFLOP against ~34 MB
// moved: the bound is operations (with a std-1 fp32 bias of each source it
// turns to bytes, the bias read once). The exponentials (one a logit) come
// close: 100 M of them against the SFU's ~3.9e12 a second.

#include "flash_packed.cuh"

namespace {

// The pre-pass (flash_packed.cuh's norm_rows).
template <int D>
__global__ void __launch_bounds__(kNormThreads)
packed_fwd_norm_kernel(const __grid_constant__ Params p, __nv_bfloat16* __restrict__ qn,
                       __nv_bfloat16* __restrict__ kn, __nv_bfloat16* __restrict__ vn,
                       long long q_rows, long long kv_rows) {
  norm_rows<D>(p, qn, kn, vn, q_rows, kv_rows);
}

// The output of one (b, h, 64 query rows) (flash_packed.cuh's packed_fwd).
template <int D, bool kBiased>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
packed_fwd_kernel(const __grid_constant__ CUtensorMap kn_map,
                  const __grid_constant__ CUtensorMap vn_map,
                  const __grid_constant__ Params p, __nv_bfloat16* __restrict__ out) {
  packed_fwd<D, kBiased>(&kn_map, &vn_map, p, out);
}

template <int D, bool kBiased>
int launch(const Params& p, __nv_bfloat16* rows, __nv_bfloat16* out, int B, cudaStream_t st) {
  return launch_fwd<D>(packed_fwd_norm_kernel<D>, packed_fwd_kernel<D, kBiased>, p, rows, out,
                       B, st);
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
  const void* feats[2] = {feats0, feats1};
  const void* biases[2] = {bias0, bias1};
  const int sfs[2] = {sf0, sf1};
  Params p;
  const int biased = forward_params(p, qkv, S, H, d, n_src, feats, biases, sfs, eps, zero_sink);
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
