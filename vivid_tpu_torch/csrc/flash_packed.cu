// Packed-layout fused attention for the VIVID blocks: the forward kernel
// (sm_90a). Its backward is flash_packed_bwd.cu.
//
// Replaces the TPU kernels in vivid_tpu/kernels/flash.py:
//   * flash_fused_packed       (_kernel_packed): self-attention straight off
//     the part-major packed qkv [B, S, 3*H*D], with the unconditional model's
//     zero-feature sink;
//   * flash_fused_packed_xattn (_kernel_packed_xattn): the same self segment
//     plus up to two cross sources [B, Sf, 2*H*D] (k, v part-major) under one
//     joint softmax, with an optional unscaled per-source logit bias
//     [B, H, S, Sf] (the self segment carries none).
// Both are one kernel: a "segment" is the self k/v inside qkv or one cross
// source, and a launch walks 1 to 3 of them.
//
// What it computes, per (batch b, head h, 64-row query tile):
//   q, k, v rows are pixel-normalised in fp32, x / (eps + ||x|| / sqrt(D)),
//   and rounded to bf16, as the TPU kernel's _rms_norm does; q is then scaled
//   by 1/sqrt(D) and rounded again. Logits q.k^T (+ bias) accumulate in fp32
//   on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 out); an online
//   softmax with a running max keeps the output exact with or without a bias
//   (the TPU's shiftless exp(s) was a speed trick for its VPU). `zero_sink`
//   all-zero key columns add zero_sink * exp(-m) to the denominator after
//   the running max is raised to max(m, 0). Output is bf16 at
//   out[b, s, h*D + j], the (head, d) order the projection expects.
//
// What bounds it on the card: at D = 64 each logit costs 2*D FLOPs against a
// 2*D-byte k row, far below the ~295 FLOP/byte where bf16 tensor cores become
// the limit, so the kernel is a bandwidth problem: its design keeps the
// [S, 3S] logits and probabilities in registers, and they never touch device
// memory, which is what the plain PyTorch version pays for. This first
// version does not reach that bound either: on an H100 (700 W) it runs at
// ~25 TFLOP/s and ~50 GB/s of device memory at S = 1024, held back by the
// synchronous single-buffered tile loads and by every query tile
// re-normalising the same k/v rows. Double buffering (cp.async or TMA),
// normalising k/v once per (b, h), ldmatrix/wgmma and warp specialisation
// are later work.

#include "flash_common.cuh"

namespace {

using namespace vivid;

struct Segment {
  const __nv_bfloat16* base;  // batch 0, row 0, channel 0
  const float* bias;          // [B, H, S, len] fp32, or nullptr
  long long batch_stride;     // elements between batch rows
  int row_stride;             // elements between sequence rows
  int k_off;                  // channel of head 0's k; head h adds h*D
  int v_off;
  int len;
};

struct Params {
  const __nv_bfloat16* qkv;
  __nv_bfloat16* out;
  Segment seg[kMaxSegments];
  int n_seg;
  int S;
  int H;
  float eps;
  float zero_sink;
};

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_packed_kernel(const Params p) {
  constexpr int kPad = D + 8;      // +16 bytes a row: fragment loads hit 32 banks
  constexpr int kPadT = kBlockK + 8;
  constexpr int kPer = D / 32;
  constexpr int kDk = D / 16;      // k16 steps over the head dim
  constexpr int kDn = D / 8;       // n8 tiles over the head dim
  constexpr int kKn = kBlockK / 8; // n8 tiles over a key tile
  __shared__ __align__(16) __nv_bfloat16 qs[kBlockQ][kPad];
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK][kPad];
  __shared__ __align__(16) __nv_bfloat16 vt[D][kPadT];  // v tile, transposed

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

  // Query tile: normalise, round to bf16, scale, round again.
  for (int r = warp; r < kBlockQ; r += kWarps) {
    const int s = q0 + r;
    float x[kPer];
    const float den = load_row<D>(
        s < S ? xb + static_cast<long long>(s) * qkv_row + h * D : nullptr,
        lane, p.eps, x);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const float qn = __bfloat162float(__float2bfloat16(x[e] / den));
      qs[r][lane * kPer + e] = __float2bfloat16(qn * scale);
    }
  }
  __syncthreads();

  // Fragment coordinates: this thread holds rows r0 and r0 + 8 of the warp's
  // 16 query rows, and columns c0, c0 + 1 of every n8 tile.
  const int r0 = warp * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
  uint32_t qf[kDk][4];
#pragma unroll
  for (int kk = 0; kk < kDk; ++kk) {
    qf[kk][0] = ld32(&qs[r0][kk * 16 + c0]);
    qf[kk][1] = ld32(&qs[r0 + 8][kk * 16 + c0]);
    qf[kk][2] = ld32(&qs[r0][kk * 16 + c0 + 8]);
    qf[kk][3] = ld32(&qs[r0 + 8][kk * 16 + c0 + 8]);
  }

  float o[kDn][4];
#pragma unroll
  for (int j = 0; j < kDn; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int si = 0; si < p.n_seg; ++si) {
    const Segment sg = p.seg[si];
    const __nv_bfloat16* seg_b = sg.base + b * sg.batch_stride;
    const float* bias = sg.bias == nullptr
        ? nullptr
        : sg.bias + (static_cast<long long>(b) * H + h) * S * sg.len;

    for (int k0 = 0; k0 < sg.len; k0 += kBlockK) {
      __syncthreads();  // every warp is done with the previous tile
      for (int r = warp; r < kBlockK; r += kWarps) {
        const int j = k0 + r;
        const __nv_bfloat16* row =
            j < sg.len ? seg_b + static_cast<long long>(j) * sg.row_stride : nullptr;
        float x[kPer];
        float den = load_row<D>(row ? row + sg.k_off + h * D : nullptr, lane, p.eps, x);
#pragma unroll
        for (int e = 0; e < kPer; ++e) ks[r][lane * kPer + e] = __float2bfloat16(x[e] / den);
        den = load_row<D>(row ? row + sg.v_off + h * D : nullptr, lane, p.eps, x);
#pragma unroll
        for (int e = 0; e < kPer; ++e) vt[lane * kPer + e][r] = __float2bfloat16(x[e] / den);
      }
      __syncthreads();

      // Logits for the warp's 16 rows against this tile's 64 keys.
      float s[kKn][4];
#pragma unroll
      for (int j = 0; j < kKn; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kDk; ++kk) {
          const __nv_bfloat16* kr = &ks[j * 8 + lane / 4][kk * 16 + c0];
          mma_16816(s[j], qf[kk], ld32(kr), ld32(kr + 8));
        }
      }

      // Bias and the ragged edge; then the online-softmax update.
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kKn; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + c0 + (e & 1);
          const int row = q0 + r0 + (e >> 1) * 8;
          if (col >= sg.len) {
            s[j][e] = -INFINITY;
          } else if (bias != nullptr && row < S) {
            s[j][e] += bias[static_cast<long long>(row) * sg.len + col];
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
      float alpha[2];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = expf(m[i] - mx[i]);
        m[i] = mx[i];
      }
#pragma unroll
      for (int j = 0; j < kKn; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e >> 1]);
          rs[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l[i] = alpha[i] * l[i] + rs[i];
      }
#pragma unroll
      for (int j = 0; j < kDn; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

      // o += p v, with p rounded to bf16 (the accumulator layout of two n8
      // logit tiles is the A-fragment layout of one k16 step).
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const uint32_t a[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < kDn; ++j) {
          const __nv_bfloat16* vr = &vt[j * 8 + lane / 4][kk * 16 + c0];
          mma_16816(o[j], a, ld32(vr), ld32(vr + 8));
        }
      }
    }
  }

  // Zero sink, normalise, write (head, d)-packed bf16.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float corr = 1.f;
    if (p.zero_sink > 0.f) {
      const float m0 = fmaxf(m[i], 0.f);
      corr = expf(m[i] - m0);
      l[i] = l[i] * corr + p.zero_sink * expf(-m0);
    }
    const int row = q0 + r0 + i * 8;
    if (row >= S) continue;
    __nv_bfloat16* orow =
        p.out + (static_cast<long long>(b) * S + row) * (H * D) + h * D;
#pragma unroll
    for (int j = 0; j < kDn; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + c0) = __floats2bfloat162_rn(
          o[j][2 * i] * corr / l[i], o[j][2 * i + 1] * corr / l[i]);
    }
  }
}

}  // namespace

// C entry for ctypes. All tensors are contiguous: qkv [B, S, 3*H*d] bf16,
// out [B, S, H*d] bf16, feats_i [B, sf_i, 2*H*d] bf16, bias_i [B, H, S, sf_i]
// fp32 or null. n_src is 0, 1 or 2; d is 32 or 64. Returns the launch's
// cudaGetLastError() (0 on success); the caller checks it.
extern "C" int vivid_flash_packed_fwd(
    const void* qkv, void* out, int B, int S, int H, int d, int n_src,
    const void* feats0, int sf0, const void* bias0,
    const void* feats1, int sf1, const void* bias1,
    float eps, float zero_sink, void* stream) {
  if (B < 1 || S < 1 || H < 1 || n_src < 0 || n_src > 2 || (d != 32 && d != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.qkv = static_cast<const __nv_bfloat16*>(qkv);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.S = S;
  p.H = H;
  p.eps = eps;
  p.zero_sink = zero_sink;
  p.n_seg = 1 + n_src;
  const long long hd = static_cast<long long>(H) * d;
  p.seg[0] = Segment{p.qkv, nullptr, S * 3 * hd, static_cast<int>(3 * hd),
                     static_cast<int>(hd), static_cast<int>(2 * hd), S};
  const void* feats[2] = {feats0, feats1};
  const void* biases[2] = {bias0, bias1};
  const int sfs[2] = {sf0, sf1};
  for (int i = 0; i < n_src; ++i) {
    if (sfs[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    p.seg[1 + i] = Segment{static_cast<const __nv_bfloat16*>(feats[i]),
                           static_cast<const float*>(biases[i]),
                           sfs[i] * 2 * hd, static_cast<int>(2 * hd), 0,
                           static_cast<int>(hd), sfs[i]};
  }
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) {
    flash_packed_kernel<64><<<grid, kWarps * 32, 0, st>>>(p);
  } else {
    flash_packed_kernel<32><<<grid, kWarps * 32, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
