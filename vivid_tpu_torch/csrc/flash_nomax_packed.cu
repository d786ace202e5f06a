// Packed-layout attention without a running max: the no-max schedule on the
// packed kernels' addressing (sm_90a).
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
// Why no maximum is needed: the norm inside the kernel bounds every q row by
// 1 and every k row by sqrt(D), so each logit lies within +-sqrt(D) (8 at
// D = 64, 5.66 at D = 32), exp of it stays below 3e3, and the fp32 sums of a
// few thousand of them are safe. That holds for these inputs whatever the
// caller passes, since the kernel normalises them itself; a bias would break
// the bound, so there is none (the biased cross-attention keeps the kernel
// with a running max).
//
// Design for this card: flash_packed.cu's addressing and norm on
// flash_nomax.cu's loop. One block of 8 warps per (b, h, 128 query rows); q
// fragments are normalised and scaled in registers (a row's D values lie in
// one quad); the 64-key K and V tiles of all segments form one sequence that
// runs through a two-stage cp.async ring, each tile normalised in place in
// shared memory once it has landed; ldmatrix fragments; each thread adds up
// its own columns and the quad's partial sums meet once, after the last
// tile. Any S and Sf: rows past a segment's end are zero-filled and their
// p is 0; a query row past the end is not written.
//
// What bounds it: operations at S = 1024 (4 B H S Sk D against inputs of a
// few MB), bytes at S = 64. Every query tile normalises the same K and V
// rows again (S / 128 times the norm's work), and the barrier after the norm
// is one more a tile than flash_nomax.cu needs. mma.sync cannot reach the
// wgmma rate.

#include "flash_common.cuh"

namespace {

using namespace vivid;

constexpr int kNpQ = 128;      // query rows per block, 16 per warp
constexpr int kNpK = 64;       // keys per shared-memory tile
constexpr int kNpWarps = 8;
constexpr int kNpThreads = kNpWarps * 32;

struct Segment {
  const __nv_bfloat16* base;  // batch 0, row 0, channel of head 0's k
  long long batch_stride;     // elements between batches
  int row_stride;             // elements between sequence rows
  int v_off;                  // from a head's k to its v
  int len;
  int first_tile;             // index of its first tile in the launch's sequence
};

struct Params {
  const __nv_bfloat16* qkv;
  __nv_bfloat16* out;
  Segment seg[kMaxSegments];
  int n_seg;
  int n_tiles;
  int S;
  int H;
  float eps;
  float zero_sink;
};

template <int D>
__global__ void __launch_bounds__(kNpThreads)
flash_nomax_packed_kernel(const Params p) {
  constexpr int kDk = D / 16;
  constexpr int kDn = D / 8;
  constexpr int kKn = kNpK / 8;
  // 1/sqrt(D) as the nearest fp32, the value the plain version multiplies by.
  constexpr float kScale = D == 32 ? 0.17677669529663687f : 0.125f;
  __shared__ __align__(16) __nv_bfloat16 ks[2][kNpK][D + 8];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kNpK][D + 8];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kNpQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = p.S;
  const int H = p.H;
  const long long qkv_row = 3LL * H * D;

  // Tile t of the launch: its segment, and the first key it holds.
  auto locate = [&](int t, int& si, int& k0) {
    si = 0;
    while (si + 1 < p.n_seg && t >= p.seg[si + 1].first_tile) ++si;
    k0 = (t - p.seg[si].first_tile) * kNpK;
  };
  auto load_tile = [&](int t, int stage) {
    int si, k0;
    locate(t, si, k0);
    const Segment& sg = p.seg[si];
    const __nv_bfloat16* kb = sg.base + b * sg.batch_stride + h * D;
    copy_rows<D, kNpK, kNpThreads>(ks[stage], kb, sg.row_stride, k0, sg.len);
    copy_rows<D, kNpK, kNpThreads>(vs[stage], kb + sg.v_off, sg.row_stride, k0, sg.len);
    cp_async_commit();
  };
  load_tile(0, 0);

  // This thread holds rows r0 and r0 + 8 of the warp's 16 query rows, and
  // columns c0, c0 + 1 of every n8 tile.
  const int r0 = warp * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
  uint32_t qf[kDk][4];
  load_q_fragments<D, true, false>(p.qkv + static_cast<long long>(b) * S * qkv_row + h * D,
                                   qkv_row, q0, S, r0, c0, p.eps, kScale, qf);

  float o[kDn][4];
#pragma unroll
  for (int j = 0; j < kDn; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float l[2] = {0.f, 0.f};   // per-thread partial sums; a quad holds a row

  for (int t = 0; t < p.n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < p.n_tiles) {
      load_tile(t + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // every thread's part of tile t has landed
    normalize_tile<D, kNpK, kNpWarps>(ks[stage], p.eps);
    normalize_tile<D, kNpK, kNpWarps>(vs[stage], p.eps);
    __syncthreads();

    // Logits of the warp's 16 rows against this tile's 64 keys.
    float s[kKn][4];
#pragma unroll
    for (int j = 0; j < kKn; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDk; kk += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &ks[stage][j * 8 + lane % 8][kk * 16 + (lane / 8) * 8]);
        mma_16816(s[j], qf[kk], kf[0], kf[1]);
        mma_16816(s[j], qf[kk + 1], kf[2], kf[3]);
      }
    }

    // p = exp(s); keys past the segment's end count for nothing.
    int si, k0;
    locate(t, si, k0);
    const int len = p.seg[si].len;
    const bool edge = k0 + kNpK > len;
#pragma unroll
    for (int j = 0; j < kKn; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = __expf(s[j][e]);
        if (edge && k0 + j * 8 + c0 + (e & 1) >= len) pr = 0.f;
        s[j][e] = pr;
        l[e >> 1] += pr;
      }
    }

    // o += p v, with p rounded to bf16 (the accumulator layout of two n8
    // logit tiles is the A-fragment layout of one k16 step).
#pragma unroll
    for (int kk = 0; kk < kNpK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < kDn; j += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &vs[stage][kk * 16 + ((lane / 8) % 2) * 8 + lane % 8]
                                 [(j + lane / 16) * 8]);
        mma_16816(o[j], a, vf[0], vf[1]);
        mma_16816(o[j + 1], a, vf[2], vf[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

  // The quad's partial sums meet, the sink's columns join, one division;
  // (head, d)-packed bf16 out.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += p.zero_sink;
    const int row = q0 + r0 + i * 8;
    if (row >= S) continue;
    __nv_bfloat16* orow = p.out + (static_cast<long long>(b) * S + row) * (H * D) + h * D;
#pragma unroll
    for (int j = 0; j < kDn; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + c0) =
          __floats2bfloat162_rn(o[j][2 * i] / l[i], o[j][2 * i + 1] / l[i]);
    }
  }
}

}  // namespace

// C entry for ctypes. All tensors are contiguous: qkv [B, S, 3*H*d] bf16,
// out [B, S, H*d] bf16, feats_i [B, sf_i, 2*H*d] bf16. n_src is 0, 1 or 2; d
// is 32 or 64; zero_sink >= 0. Returns the launch's cudaGetLastError() (0 on
// success); the caller checks it.
extern "C" int vivid_flash_nomax_packed_fwd(
    const void* qkv, void* out, int B, int S, int H, int d, int n_src,
    const void* feats0, int sf0, const void* feats1, int sf1,
    float eps, float zero_sink, void* stream) {
  if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535 || n_src < 0 || n_src > 2 ||
      (d != 32 && d != 64) || zero_sink < 0.f) {
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
  p.seg[0] = Segment{p.qkv + hd, S * 3 * hd, static_cast<int>(3 * hd), static_cast<int>(hd), S, 0};
  const void* feats[2] = {feats0, feats1};
  const int sfs[2] = {sf0, sf1};
  int tiles = (S + kNpK - 1) / kNpK;
  for (int i = 0; i < n_src; ++i) {
    if (sfs[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    p.seg[1 + i] = Segment{static_cast<const __nv_bfloat16*>(feats[i]), sfs[i] * 2 * hd,
                           static_cast<int>(2 * hd), static_cast<int>(hd), sfs[i], tiles};
    tiles += (sfs[i] + kNpK - 1) / kNpK;
  }
  p.n_tiles = tiles;
  const dim3 grid((S + kNpQ - 1) / kNpQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) {
    flash_nomax_packed_kernel<64><<<grid, kNpThreads, 0, st>>>(p);
  } else {
    flash_nomax_packed_kernel<32><<<grid, kNpThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
