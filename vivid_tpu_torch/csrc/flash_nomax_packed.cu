// Packed-layout attention without a running max (sm_90a: wgmma, TMA,
// mbarriers): the no-max branch of K1/K2's forward.
//
// Replaces the TPU kernel flash_nomax_packed (_kernel_nomax_packed) in
// vivid_tpu/kernels/flash.py: what flash_fused_packed and the unbiased
// flash_fused_packed_xattn compute (flash_packed.cu here), by another
// schedule. Inputs are the part-major packed qkv [B, S, 3*H*D] and up to two
// cross sources [B, Sf, 2*H*D] (k, v part-major), bf16, as the projections
// emit them; the output is [B, S, H*D] in (head, d) order. A "segment" is
// the self k/v inside qkv or one cross source; a launch walks 1 to 3.
//
//   k, v rows: x / (eps + ||x|| / sqrt(D)) in fp32, rounded to bf16
//   q rows:    x * ((1 / sqrt(D)) / (eps + ||x|| / sqrt(D))), rounded once:
//              the softmax scale is folded into q before it is rounded, as
//              the TPU kernel's _rms_norm(..., out_scale=) does
//   p = exp(q . k)       no maximum, no shift, nothing ever rescaled
//   o = sum p v / (sum p + zero_sink)      one fp32 accumulator and one
//              denominator across all segments; each of the `zero_sink`
//              all-zero key columns has logit 0 and adds exp(0) = 1
//
// Why no maximum is needed: the norm bounds every q row by 1 and every k row
// by sqrt(D), so each logit lies within +-sqrt(D) (8 at D = 64, 5.66 at
// D = 32), exp of it stays below 3e3, and the fp32 sums of a few thousand of
// them are safe. That holds for these inputs whatever the caller passes,
// since the pre-pass normalises them; a bias would break the bound, so there
// is none (the biased cross-attention keeps the kernel with a running max).
//
// Design for this card: K1/K2's two launches (flash_packed.cuh), their
// kernels named apart so that each keeps its own machine code:
//   nomax_packed_norm_kernel  the pre-pass (norm_rows with the scale folded
//                             into q's one rounding): every row of q, k and
//                             v normalised once into head-major scratch the
//                             caller gives, each key segment padded with
//                             zero rows to whole 64-row tiles.
//   nomax_packed_kernel       packed_fwd's body with kNoMax: one block per
//                             (b, h, 64 query rows), a TMA producer
//                             warpgroup keeping a 4-stage ring of 64-key
//                             stages (k', v') full over every tile of every
//                             segment, a consumer warpgroup with its rows of
//                             c q' as register A fragments. Per tile: S on
//                             wgmma, p = 0 for the keys at or past the
//                             segment's end, p = ex2(s log2(e)) with no
//                             cross-lane traffic, o += P v' on wgmma. The
//                             quad's partial sums meet once, after the last
//                             tile; the sink joins; one division.
// Two blocks an SM; each output element has one owner and nothing is atomic,
// so two runs give the same bits. Any S and Sf: the tensor maps zero-fill
// past the scratch's end, a query row past S is not written.
//
// What bounds it: operations at S = 1024 (4 B H S Sk D against inputs of a
// few MB; the exponentials, one a logit, come close), bytes and the host's
// two launches at S = 64. Against K2 it saves the maximum's shuffles and the
// rescale of o and l a tile; the products, the pre-pass and the ring are
// K1/K2's.

#include "flash_packed.cuh"

namespace {

// The pre-pass, q's scale folded into its one rounding.
template <int D>
__global__ void __launch_bounds__(kNormThreads)
nomax_packed_norm_kernel(const __grid_constant__ Params p, __nv_bfloat16* __restrict__ qn,
                         __nv_bfloat16* __restrict__ kn, __nv_bfloat16* __restrict__ vn,
                         long long q_rows, long long kv_rows) {
  norm_rows<D, /*kFoldScale=*/true>(p, qn, kn, vn, q_rows, kv_rows);
}

// The output of one (b, h, 64 query rows), by the no-max softmax.
template <int D>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
nomax_packed_kernel(const __grid_constant__ CUtensorMap kn_map,
                    const __grid_constant__ CUtensorMap vn_map,
                    const __grid_constant__ Params p, __nv_bfloat16* __restrict__ out) {
  packed_fwd<D, /*kBiased=*/false, /*kNoMax=*/true>(&kn_map, &vn_map, p, out);
}

}  // namespace

// C entry for ctypes. All tensors are contiguous and 16-byte aligned: qkv
// [B, S, 3*H*d] bf16, out [B, S, H*d] bf16, feats_i [B, sf_i, 2*H*d] bf16.
// Scratch: rows bf16 of B*H*(S + 2*keys)*d elements, keys the sum over the
// self segment (S) and the sources of each length rounded up to 64, as
// vivid_flash_packed_fwd takes it. n_src is 0, 1 or 2; d is 32 or 64;
// zero_sink >= 0. Returns the first error (0 on success; 10000 and above:
// the tensor-map encoder was not found or refused); the caller checks it.
extern "C" int vivid_flash_nomax_packed_fwd(
    const void* qkv, void* out, void* rows, int B, int S, int H, int d, int n_src,
    const void* feats0, int sf0, const void* feats1, int sf1,
    float eps, float zero_sink, void* stream) {
  if (bad_shape(B, H, S, 1, d) || n_src < 0 || n_src > 2 || !(eps > 0.f) ||
      !(zero_sink >= 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* feats[2] = {feats0, feats1};
  const void* const none[2] = {nullptr, nullptr};
  const int sfs[2] = {sf0, sf1};
  Params p;
  if (forward_params(p, qkv, S, H, d, n_src, feats, none, sfs, eps, zero_sink) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* r = static_cast<__nv_bfloat16*>(rows);
  auto* o = static_cast<__nv_bfloat16*>(out);
  return d == 64
      ? launch_fwd<64>(nomax_packed_norm_kernel<64>, nomax_packed_kernel<64>, p, r, o, B, st)
      : launch_fwd<32>(nomax_packed_norm_kernel<32>, nomax_packed_kernel<32>, p, r, o, B, st);
}

// What was built: the forward kernel for head dim d (32 or 64). K7 takes no
// bias: biased != 0 is refused. info as describe_packed fills it.
extern "C" int vivid_flash_nomax_packed_info(int d, int biased, int* info) {
  if ((d != 32 && d != 64) || biased != 0) return static_cast<int>(cudaErrorInvalidValue);
  return d == 64 ? describe_packed(nomax_packed_kernel<64>, kPackedSmemBytes<64>, info)
                 : describe_packed(nomax_packed_kernel<32>, kPackedSmemBytes<32>, info);
}
