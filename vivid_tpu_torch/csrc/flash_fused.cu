// Blocked online-softmax attention on [B, H, S, D] with the pixel norm and
// the zero sink (sm_90a: wgmma, TMA, mbarriers).
//
// Replaces the TPU kernel flash_fused (_kernel) in vivid_tpu/kernels/flash.py.
// Inputs are q [B, H, Sq, D] and k, v [B, H, Sk, D] in bf16 and an optional
// unscaled fp32 bias [B, H, Sq, Sk]:
//
//   with the norm (eps > 0 given): every q, k and v row is pixel-normalised,
//     x / (eps + ||x|| / sqrt(D)) in fp32, and rounded to bf16, as the TPU
//     kernel's _rms_norm does; without it the rows are taken as they are
//     (the caller has normalised them)
//   s = (q . k) / sqrt(D) + bias      the scale multiplies the fp32 logits,
//                                     as in the TPU kernel, not q
//   o = softmax(s) v                  online softmax with a running max, p
//                                     rounded to bf16 for the second product,
//                                     its row sum kept in fp32
//   zero_sink all-zero key columns (logit 0, value 0): after the last tile
//     the max is raised to max(m, 0) and zero_sink * exp(-m) joins the
//     denominator. A bias and a sink may come together.
//
// Design for this card, two kernels:
//   fused_norm_kernel   the norm as a pre-pass: one launch writes the
//                       normalised rows of q, k and v into scratch the caller
//                       gives. D / 8 threads a row, 16 bytes each, the sum of
//                       squares met by shuffles, fp32 math, one rounding.
//   flash_fused_kernel  the forward body K8's and K6's kernels share
//                       (flash_fwd.cuh, kFused): a TMA producer warpgroup
//                       keeps a four-stage ring of 128-key stages (K and V)
//                       full, three consumer warpgroups on 64-row query tiles
//                       multiply on wgmma. It differs from K8's forward by
//                       compile-time branches alone: q is loaded unscaled,
//                       1/sqrt(D) multiplies the fp32 logits (folded into the
//                       exponentials' fused multiply-add without a bias, into
//                       the one that adds the bias with one), the sink joins
//                       in the epilogue, and no row statistics are written.
// In the TPU kernel every query tile normalises the K and V tiles it reads;
// here that would be Sq / 192 times the norm's work, where the pre-pass
// reads and writes each row once. Any Sq and Sk: the tensor maps zero-fill
// past a (b, h)'s end, a key past the end gets p = 0, a query row past the
// end is not written.
//
// What bounds it: at D = 32 the exponentials (the special-function unit
// makes 16 a clock and SM, one a logit), at D = 64 operations and
// exponentials alike (4 B H Sq Sk D over the tensor-core peak); with a bias
// its fp32 bytes (4 B H Sq Sk) at the 64px model's shapes. The pre-pass is
// bound by bytes: 2 (Sq + 2 Sk) D bytes a (b, h), read once and written once.

#include "flash_fwd.cuh"

namespace {

using namespace vivid;

constexpr int kNormThreads = 256;

// Rows [0, q_rows) of the pre-pass are q's, the next kv_rows k's, the last
// kv_rows v's; each row x becomes x / (eps + ||x|| / sqrt(D)), rounded once.
template <int D>
__global__ void __launch_bounds__(kNormThreads)
fused_norm_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ qn,
                  __nv_bfloat16* __restrict__ kn, __nv_bfloat16* __restrict__ vn,
                  long long q_rows, long long kv_rows, float eps) {
  constexpr int kLanes = D / 8;   // threads a row, 8 values each
  const long long t = static_cast<long long>(blockIdx.x) * kNormThreads + threadIdx.x;
  long long row = t / kLanes;
  const bool ok = row < q_rows + 2 * kv_rows;   // the grid's last threads lie past v's end
  const int col = static_cast<int>(t % kLanes) * 8;
  const __nv_bfloat16* src = q;
  __nv_bfloat16* dst = qn;
  if (row >= q_rows) {
    row -= q_rows;
    src = k;
    dst = kn;
    if (row >= kv_rows) {
      row -= kv_rows;
      src = v;
      dst = vn;
    }
  }
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (ok) raw = *reinterpret_cast<const uint4*>(src + row * D + col);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float x[8];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __bfloat162float(pairs[i].x);
    x[2 * i + 1] = __bfloat162float(pairs[i].y);
    ss += x[2 * i] * x[2 * i] + x[2 * i + 1] * x[2 * i + 1];
  }
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  // Rounded as flash._rms_norm rounds it: product, then sum (no contraction).
  const float den = __fadd_rn(eps, __fmul_rn(1.0f / sqrtf(static_cast<float>(D)), sqrtf(ss)));
  uint4 y;
  uint32_t* packed = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
  for (int i = 0; i < 4; ++i) packed[i] = pack_bf16(x[2 * i] / den, x[2 * i + 1] / den);
  if (ok) *reinterpret_cast<uint4*>(dst + row * D + col) = y;
}

template <int D>
int launch_norm(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                __nv_bfloat16* qn, __nv_bfloat16* kn, __nv_bfloat16* vn, int B, int H, int Sq,
                int Sk, float eps, cudaStream_t st) {
  const long long q_rows = static_cast<long long>(B) * H * Sq;
  const long long kv_rows = static_cast<long long>(B) * H * Sk;
  const long long threads = (q_rows + 2 * kv_rows) * (D / 8);
  fused_norm_kernel<D><<<static_cast<unsigned>((threads + kNormThreads - 1) / kNormThreads),
                         kNormThreads, 0, st>>>(q, k, v, qn, kn, vn, q_rows, kv_rows, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kBiased>
__global__ void __launch_bounds__(kThreads, 1)
flash_fused_kernel(const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __nv_bfloat16* __restrict__ q, const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, int Sq, int Sk, float zero_sink) {
  attn_fwd<D, kBiased, false, false, /*kFused=*/true>(&k_map, &v_map, q, bias, nullptr, out,
                                                      nullptr, Sq, Sk, zero_sink);
}

// With qn, kn and vn (scratch shaped as q, k, v) the pre-pass normalises into
// them and the forward reads them; with null ones it reads q, k and v.
template <int D, bool kBiased>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const float* bias, __nv_bfloat16* out, __nv_bfloat16* qn, __nv_bfloat16* kn,
           __nv_bfloat16* vn, int B, int H, int Sq, int Sk, float eps, float zero_sink,
           cudaStream_t st) {
  const bool norm = qn != nullptr;
  CUtensorMap k_map, v_map;
  int rc = rows_map(&k_map, norm ? kn : k, B * H, Sk, D);
  if (rc == 0) rc = rows_map(&v_map, norm ? vn : v, B * H, Sk, D);
  if (rc == 0) rc = allow_smem(flash_fused_kernel<D, kBiased>, kFwdSmemBytes<D>);
  if (rc == 0 && norm) rc = launch_norm<D>(q, k, v, qn, kn, vn, B, H, Sq, Sk, eps, st);
  if (rc != 0) return rc;
  flash_fused_kernel<D, kBiased><<<dim3(blocks_of(Sq), H, B), kThreads, kFwdSmemBytes<D>, st>>>(
      k_map, v_map, norm ? qn : q, bias, out, Sq, Sk, zero_sink);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries for ctypes. All tensors are contiguous and 16-byte aligned: q,
// out, qn [B, H, Sq, d] bf16; k, v, kn, vn [B, H, Sk, d] bf16; bias
// [B, H, Sq, Sk] fp32 or null. d is 32 or 64. Each returns the first error
// (0 on success; 10000 and above: the tensor-map encoder was not found or
// refused); the caller checks it.

// out is written. norm != 0 normalises q, k and v rows with `eps` > 0 into
// the scratch qn, kn, vn first (otherwise they may be null); zero_sink >= 0.
extern "C" int vivid_flash_fused_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out, void* qn,
    void* kn, void* vn, int B, int H, int Sq, int Sk, int d, int norm, float eps,
    float zero_sink, void* stream) {
  if (bad_shape(B, H, Sq, Sk, d) || !(zero_sink >= 0.f) ||
      (norm && (qn == nullptr || kn == nullptr || vn == nullptr || !(eps > 0.f)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* qnp = norm ? static_cast<__nv_bfloat16*>(qn) : nullptr;
  auto* knp = norm ? static_cast<__nv_bfloat16*>(kn) : nullptr;
  auto* vnp = norm ? static_cast<__nv_bfloat16*>(vn) : nullptr;
  if (d == 64) {
    return bias != nullptr
        ? launch<64, true>(qp, kp, vp, bp, op, qnp, knp, vnp, B, H, Sq, Sk, eps, zero_sink, st)
        : launch<64, false>(qp, kp, vp, bp, op, qnp, knp, vnp, B, H, Sq, Sk, eps, zero_sink, st);
  }
  return bias != nullptr
      ? launch<32, true>(qp, kp, vp, bp, op, qnp, knp, vnp, B, H, Sq, Sk, eps, zero_sink, st)
      : launch<32, false>(qp, kp, vp, bp, op, qnp, knp, vnp, B, H, Sq, Sk, eps, zero_sink, st);
}

// The pre-pass alone: qn, kn, vn are written.
extern "C" int vivid_flash_fused_norm(
    const void* q, const void* k, const void* v, void* qn, void* kn, void* vn,
    int B, int H, int Sq, int Sk, int d, float eps, void* stream) {
  if (bad_shape(B, H, Sq, Sk, d) || !(eps > 0.f)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* qnp = static_cast<__nv_bfloat16*>(qn);
  auto* knp = static_cast<__nv_bfloat16*>(kn);
  auto* vnp = static_cast<__nv_bfloat16*>(vn);
  return d == 64 ? launch_norm<64>(qp, kp, vp, qnp, knp, vnp, B, H, Sq, Sk, eps, st)
                 : launch_norm<32>(qp, kp, vp, qnp, knp, vnp, B, H, Sq, Sk, eps, st);
}

// What the forward was built with, as vivid_flash_nomax_info says it for K6:
// info[0..2] registers a thread at launch, local-memory bytes a thread,
// dynamic shared memory; info[3..8] rows of the output a block owns, keys a
// stage, stages, the registers of a consumer and of the producer thread after
// the warpgroups have traded them, threads a block.
extern "C" int vivid_flash_fused_info(int d, int biased, int* info) {
  if (d != 32 && d != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64) {
    return biased ? describe(flash_fused_kernel<64, true>, kFwdSmemBytes<64>, kFwK, kFwStages, info)
                  : describe(flash_fused_kernel<64, false>, kFwdSmemBytes<64>, kFwK, kFwStages, info);
  }
  return biased ? describe(flash_fused_kernel<32, true>, kFwdSmemBytes<32>, kFwK, kFwStages, info)
                : describe(flash_fused_kernel<32, false>, kFwdSmemBytes<32>, kFwK, kFwStages, info);
}
