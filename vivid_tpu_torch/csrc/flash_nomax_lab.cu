// Lab variants of the big-S no-max attention (sm_90a: wgmma, TMA, mbarriers).
//
// Replaces the TPU kernel nomax_attention (_kernel_nomax) of
// tools/nomax_attn_lab.py: attention on pixel-normalised q [B, H, Sq, D] and
// k, v [B, H, Sk, D] in bf16 with the constant softmax shift sqrt(D) and no
// running max, under three switches that the lab times against each other:
//
//   prescale   q / sqrt(D) in fp32 rounded to bf16 once, then
//              p = exp(q . k - sqrt(D)); without it p = exp(q . k / sqrt(D)
//              - sqrt(D)), the scale on the fp32 logits
//   fold_l     the denominator is summed by the tensor cores, from the p that
//              was rounded to bf16 for P V: the same A fragments times a tile
//              of ones. Without it each thread adds up its unrounded fp32 p.
//   chains     1, 2 or 4 independent accumulator sets, each over its part of
//              a stage's 128 keys (128, 64 or 32), added up after the last
//              tile: a part's products run while the next part's
//              exponentials are taken
//
// Row norms are at most sqrt(D), so every scaled logit lies below sqrt(D)
// and p <= 1: the contract is the caller's, as in flash_nomax.cu.
//
// Design: K6's kernel (flash_fwd.cuh's attn_fwd with kNoMax) with the lab's
// switches as compile-time branches of that body (kChains, kFoldL,
// kPrescale), whose defaults are K6's: one block per (b, h, 192 query rows),
// a TMA producer warpgroup keeping a four-stage ring of 128-key stages (K
// and V) full, three consumer warpgroups of 64 query rows multiplying on
// wgmma with q, then P, as register A fragments. The shift sqrt(D) (and
// without prescale the scale) rides the exponentials' one fused
// multiply-add. fold_l: one m64n8 wgmma a k16 step against a tile of bf16
// ones that the block writes into shared memory once (wgmma takes B from
// there only), so every column of that accumulator is the row sum. One
// chain takes K6's schedule (at D = 32 the exponentials of a tile under the
// product p V of the tile before); 2 and 4 chains issue each part's P V
// before the next part's exponentials. Any Sq and Sk: the tensor maps
// zero-fill past a (b, h)'s end, a key past the end gets p = 0, a query row
// past the end is not written.
//
// What bounds it: at D = 32 the exponentials (one a logit against the
// special-function unit's 16 a clock and SM), at D = 64 operations and
// exponentials alike; the inputs are tens of MB and every query tile of a
// (b, h) reads K and V out of L2. fold_l adds one n8 product to every D-wide
// one and removes an fp32 add a logit. Four chains at D = 64 hold four
// 64 x 64 fp32 accumulators: more registers than a consumer has.

#include <type_traits>

#include "flash_fwd.cuh"

namespace {

using namespace vivid;

template <int D, bool kFoldL, int kChains, bool kPrescale>
__global__ void __launch_bounds__(kThreads, 1)
flash_nomax_lab_kernel(const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
                       int Sq, int Sk) {
  attn_fwd<D, false, true, /*kOverlap=*/kChains == 1 && D == 32, false, kChains, kFoldL,
           kPrescale>(&k_map, &v_map, q, nullptr, nullptr, out, nullptr, Sq, Sk);
}

template <int D, bool kFoldL, int kChains, bool kPrescale>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           __nv_bfloat16* out, int B, int H, int Sq, int Sk, cudaStream_t st) {
  auto* kernel = flash_nomax_lab_kernel<D, kFoldL, kChains, kPrescale>;
  constexpr int kSmem = kLabSmemBytes<D, kFoldL>;
  CUtensorMap k_map, v_map;
  int rc = rows_map(&k_map, k, B * H, Sk, D);
  if (rc == 0) rc = rows_map(&v_map, v, B * H, Sk, D);
  if (rc == 0) rc = allow_smem(kernel, kSmem);
  if (rc != 0) return rc;
  kernel<<<dim3(blocks_of(Sq), H, B), kThreads, kSmem, st>>>(k_map, v_map, q, out, Sq, Sk);
  return static_cast<int>(cudaGetLastError());
}

// The instance of (d, fold_l, chains, prescale): `fn` called with it as a
// function template's arguments. -> what fn returns, or an error for a
// combination the library lacks.
template <typename Fn>
int dispatch(int d, int fold_l, int chains, int prescale, Fn fn) {
  auto by_prescale = [&](auto d_, auto fold_, auto chains_) {
    return prescale ? fn(d_, fold_, chains_, std::true_type{})
                    : fn(d_, fold_, chains_, std::false_type{});
  };
  auto by_chains = [&](auto d_, auto fold_) {
    if (chains == 1) return by_prescale(d_, fold_, std::integral_constant<int, 1>{});
    if (chains == 2) return by_prescale(d_, fold_, std::integral_constant<int, 2>{});
    return by_prescale(d_, fold_, std::integral_constant<int, 4>{});
  };
  auto by_fold = [&](auto d_) {
    return fold_l ? by_chains(d_, std::true_type{}) : by_chains(d_, std::false_type{});
  };
  if ((d != 32 && d != 64) || (chains != 1 && chains != 2 && chains != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return d == 64 ? by_fold(std::integral_constant<int, 64>{})
                 : by_fold(std::integral_constant<int, 32>{});
}

}  // namespace

// C entry for ctypes. All tensors are contiguous and 16-byte aligned: q, out
// [B, H, Sq, d] bf16; k, v [B, H, Sk, d] bf16. d is 32 or 64; chains is 1, 2
// or 4. Returns the first error (0 on success; 10000 and above: the
// tensor-map encoder was not found or refused); the caller checks it.
extern "C" int vivid_flash_nomax_lab_fwd(
    const void* q, const void* k, const void* v, void* out,
    int B, int H, int Sq, int Sk, int d, int fold_l, int chains, int prescale, void* stream) {
  if (bad_shape(B, H, Sq, Sk, d)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(d, fold_l, chains, prescale, [&](auto d_, auto fold_, auto chains_, auto pre_) {
    return launch<decltype(d_)::value, decltype(fold_)::value, decltype(chains_)::value,
                  decltype(pre_)::value>(qp, kp, vp, op, B, H, Sq, Sk, st);
  });
}

// What the instance of (d, fold_l, chains, prescale) was built with, as
// vivid_flash_nomax_info says it for K6.
extern "C" int vivid_flash_nomax_lab_info(int d, int fold_l, int chains, int prescale,
                                          int* info) {
  return dispatch(d, fold_l, chains, prescale, [&](auto d_, auto fold_, auto chains_, auto pre_) {
    constexpr int kD = decltype(d_)::value;
    constexpr bool kFold = decltype(fold_)::value;
    return describe(flash_nomax_lab_kernel<kD, kFold, decltype(chains_)::value,
                                           decltype(pre_)::value>,
                    kLabSmemBytes<kD, kFold>, kFwK, kFwStages, info);
  });
}
