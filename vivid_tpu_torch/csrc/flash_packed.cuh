// What the packed-layout attention kernels share, forward (flash_packed.cu,
// K1/K2; flash_nomax_packed.cu, K7) and backward (flash_packed_bwd.cu,
// K3/K4): the segment table of a launch, the norm pre-pass that all run
// first, the block layout of their wgmma kernels, the forward's body (K1/K2
// with a running maximum, K7 its kNoMax branch) and the host code around
// them.
//
// A launch's keys are 1 to 3 segments: the self k/v inside the packed qkv
// [B, S, 3*H*D], then each cross source [B, Sf, 2*H*D] (k, v part-major),
// each with an optional fp32 logit bias [B, H, S, Sf]. The pre-pass writes
// every row of q, k and v pixel-normalised, x / (eps + ||x|| / sqrt(D))
// rounded to bf16 (q then times c = 1/sqrt(D) and rounded again; for K7
// x * (c / (eps + ||x|| / sqrt(D))) rounded once), once, into
// head-major scratch the caller gives: c q' [B*H, S, D], then k' and v'
// [B*H, keys, D] with every segment padded with zero rows to whole 64-row
// tiles, so that no key tile straddles two segments. A kernel that reads the
// keys then walks tiles: tile t belongs to segment segment_of(p, t), and
// its keys at or past that segment's `len` are the padding.
//
// Everything here lives in each including file's anonymous namespace, as
// the kernels that use it do.

#pragma once

#include "flash_fwd.cuh"

namespace {

using namespace vivid;

constexpr int kStages = 4;          // 64 keys (dq, forward) or 64 query rows (dk/dv) a stage
constexpr int kNormThreads = 256;

struct Segment {
  const __nv_bfloat16* base;  // batch 0, row 0, channel 0 of the raw rows
  __nv_bfloat16* dbase;       // gradient of base, same layout (backward; else null)
  const float* bias;          // [B, H, S, len] fp32, or nullptr
  float* dbias;               // gradient of bias, or nullptr
  long long batch_stride;     // elements between batch rows
  int row_stride;             // elements between sequence rows
  int k_off;                  // channel of head 0's k; head h adds h*D
  int v_off;
  int len;
  int tile0;                  // the segment's first 64-row tile in the key scratch
};

// A launch's parameters; the fields a kernel does not use stay null.
struct Params {
  const __nv_bfloat16* qkv;   // [B, S, 3*H*D]
  const __nv_bfloat16* g;     // [B, S, H*D] (backward)
  __nv_bfloat16* dqkv;        // (backward)
  const __nv_bfloat16* qn;    // [B*H, S, D] c q', the pre-pass's
  float* lse2;                // [B*H, s_pad] lse * log2(e), +inf past S (backward)
  float* delta;               // [B*H, s_pad] rowsum(P o dP), 0 past S (backward)
  Segment seg[kMaxSegments];
  int n_seg;
  int key_tiles;              // 64-row tiles of all segments
  int S;
  int s_pad;                  // S rounded up to a whole tile
  int H;
  float eps;
  float zero_sink;
};

// A block of the wgmma kernels: one consumer warpgroup, then one producer;
// two blocks share an SM (128 registers a thread at launch), the registers
// traded as K8's kernels trade them.
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 232;
constexpr int kEmptyArrivals = 4;   // one lane of every consumer warp

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Index of the segment that holds key tile `tile`.
__device__ __forceinline__ int segment_of(const Params& p, int tile) {
  int si = 0;
  while (si + 1 < p.n_seg && tile >= p.seg[si + 1].tile0) ++si;
  return si;
}

// The body of the pre-pass kernels (each file has its own, by name). Rows
// [0, q_rows) of its index space are q's ([B*H, S]), the next kv_rows k's
// and the last kv_rows v's ([B*H, keys], segments padded): x / (eps +
// ||x|| / sqrt(D)) rounded to bf16, for q then times c and rounded again;
// padding rows are zeros. kFoldScale (K7): q's rows are x * (c / (eps +
// ||x|| / sqrt(D))) in fp32, rounded once. D / 8 threads a row, 16 bytes
// each.
template <int D, bool kFoldScale = false>
__device__ __forceinline__ void norm_rows(const Params& p, __nv_bfloat16* __restrict__ qn,
                                          __nv_bfloat16* __restrict__ kn,
                                          __nv_bfloat16* __restrict__ vn,
                                          long long q_rows, long long kv_rows) {
  constexpr int kLanes = D / 8;   // threads a row, 8 values each
  const long long t = static_cast<long long>(blockIdx.x) * kNormThreads + threadIdx.x;
  const long long row = t / kLanes;
  const int col = static_cast<int>(t % kLanes) * 8;
  const bool ok = row < q_rows + 2 * kv_rows;   // the grid's last threads lie past v's end
  const __nv_bfloat16* src = nullptr;           // stays null for a padding row
  __nv_bfloat16* dst = nullptr;
  const bool is_q = row < q_rows;
  if (ok && is_q) {
    const int bh = static_cast<int>(row / p.S);
    const int r = static_cast<int>(row % p.S);
    const int b = bh / p.H, h = bh % p.H;
    src = p.qkv + (static_cast<long long>(b) * p.S + r) * (3 * p.H * D) + h * D + col;
    dst = qn + row * D + col;
  } else if (ok) {
    long long kr = row - q_rows;
    const bool is_v = kr >= kv_rows;
    if (is_v) kr -= kv_rows;
    dst = (is_v ? vn : kn) + kr * D + col;
    const int keys = p.key_tiles * kRows;
    const int bh = static_cast<int>(kr / keys);
    const int pos = static_cast<int>(kr % keys);
    const int b = bh / p.H, h = bh % p.H;
    const Segment& sg = p.seg[segment_of(p, pos / kRows)];
    const int r = pos - sg.tile0 * kRows;
    if (r < sg.len) {
      src = sg.base + b * sg.batch_stride + static_cast<long long>(r) * sg.row_stride
          + (is_v ? sg.v_off : sg.k_off) + h * D + col;
    }
  }
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (src != nullptr) raw = *reinterpret_cast<const uint4*>(src);
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
  const float den = __fadd_rn(p.eps, __fmul_rn(1.0f / sqrtf(static_cast<float>(D)), sqrtf(ss)));
  uint4 y;
  uint32_t* packed = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lo = __bfloat162float(__float2bfloat16(x[2 * i] / den));
    float hi = __bfloat162float(__float2bfloat16(x[2 * i + 1] / den));
    if (is_q) {
      if constexpr (kFoldScale) {   // c / den in one factor, as the TPU kernel's _rms_norm
        lo = x[2 * i] * (kScaleOf<D> / den);
        hi = x[2 * i + 1] * (kScaleOf<D> / den);
      } else {
        lo *= kScaleOf<D>;
        hi *= kScaleOf<D>;
      }
    }
    packed[i] = pack_bf16(lo, hi);
  }
  if (dst != nullptr) *reinterpret_cast<uint4*>(dst) = y;
}

// ---- the forward body (flash_packed.cu's K1/K2, flash_nomax_packed.cu's K7)

template <int D>
constexpr int kPackedSmemBytes = kAlignSlack + kStages * 2 * kRows * 2 * D + 2 * kStages * 8;

// One tile's step of the softmax, in place: s (this thread's part of 64
// rows x 64 keys of logits, -inf where a key is masked) becomes p. With a
// running maximum (K1/K2): p = exp(s - m) about the maximum m of each of its
// two rows, raised by this tile; the partial row sums l and the accumulator
// o are rescaled to the new maximum first, then l takes the unrounded p.
// kNoMax (K7): p = exp(s), nothing rescaled, l takes the unrounded p.
template <int D, bool kNoMax = false>
__device__ __forceinline__ void softmax_step(float (&s)[kRows / 2], float (&m)[2], float (&l)[2],
                                             float (&o)[D / 2]) {
  if constexpr (kNoMax) {
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = fast_exp2(s[4 * j + e] * kLog2e);
        s[4 * j + e] = pe;
        l[e >> 1] += pe;
      }
    }
  } else {
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
}

// The body of the forward kernels: the output of one (b, h, 64 query rows).
// Grid (ceil(S / 64), H, B), kThreads threads, kPackedSmemBytes<D> of
// dynamic shared memory; kn_map and vn_map as rows_map encodes the
// pre-pass's k' and v', p.qn its c q'. kNoMax: K7's softmax (softmax_step),
// the sink's columns exp(0) = 1 each in the denominator; no bias.
template <int D, bool kBiased, bool kNoMax = false>
__device__ __forceinline__ void packed_fwd(const CUtensorMap* kn_map, const CUtensorMap* vn_map,
                                           const Params& p, __nv_bfloat16* __restrict__ out) {
  static_assert(!(kNoMax && kBiased), "a bias breaks the bound that makes a maximum unnecessary");
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
        tma_load_3d(tiles + s * 2 * kBoxBytes, kn_map, &full[s], 0, t * kRows, bh);
        tma_load_3d(tiles + s * 2 * kBoxBytes + kBoxBytes, vn_map, &full[s], 0, t * kRows, bh);
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
      softmax_step<D, kNoMax>(s, m, l, o);

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

    // The sink. With a maximum, the maximum raised to 0 rescales the sum and
    // the accumulator; without one, each sink column adds exp(0) = 1. One
    // division, as the plain version.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float den = quad_sum(l[i]);
      float corr = 1.f;
      if constexpr (kNoMax) {
        den += p.zero_sink;
      } else if (p.zero_sink > 0.f) {
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

// ---- host side -----------------------------------------------------------

// The segment table of a launch with qkv and S, H, d already in p: the self
// segment, then n_src sources (feats_i [B, sf_i, 2*H*d], bias_i and the
// gradients, any of those three null where absent); sets n_seg and
// key_tiles. -> whether a source has a bias, or -1 for a source of no rows.
inline int fill_segments(Params& p, int d, int n_src, const void* const (&feats)[2],
                         void* const (&dfeats)[2], const void* const (&biases)[2],
                         void* const (&dbiases)[2], const int (&sfs)[2]) {
  const int S = p.S;
  const long long hd = static_cast<long long>(p.H) * d;
  p.n_seg = 1 + n_src;
  p.seg[0] = Segment{p.qkv, p.dqkv, nullptr, nullptr, S * 3 * hd, static_cast<int>(3 * hd),
                     static_cast<int>(hd), static_cast<int>(2 * hd), S, 0};
  int tiles = (S + kRows - 1) / kRows;
  bool biased = false;
  for (int i = 0; i < n_src; ++i) {
    if (sfs[i] < 1) return -1;
    biased = biased || biases[i] != nullptr;
    p.seg[1 + i] = Segment{static_cast<const __nv_bfloat16*>(feats[i]),
                           static_cast<__nv_bfloat16*>(dfeats[i]),
                           static_cast<const float*>(biases[i]),
                           static_cast<float*>(dbiases[i]),
                           sfs[i] * 2 * hd, static_cast<int>(2 * hd), 0,
                           static_cast<int>(hd), sfs[i], tiles};
    tiles += (sfs[i] + kRows - 1) / kRows;
  }
  p.key_tiles = tiles;
  return biased ? 1 : 0;
}

// One launch of a pre-pass kernel over the scratch `rows`: c q' [B*H, S, D],
// then k' and v' [B*H, key_tiles * 64, D] each. -> cudaGetLastError().
template <int D, typename Kernel>
int launch_norm(Kernel kernel, const Params& p, __nv_bfloat16* qn, __nv_bfloat16* kn,
                __nv_bfloat16* vn, int B, cudaStream_t st) {
  const long long q_rows = static_cast<long long>(B) * p.H * p.S;
  const long long kv_rows = static_cast<long long>(B) * p.H * p.key_tiles * kRows;
  const long long threads = (q_rows + 2 * kv_rows) * (D / 8);
  kernel<<<static_cast<unsigned>((threads + kNormThreads - 1) / kNormThreads), kNormThreads, 0,
           st>>>(p, qn, kn, vn, q_rows, kv_rows);
  return static_cast<int>(cudaGetLastError());
}

// The two launches of a forward: the pre-pass kernel `norm` over the
// scratch `rows` (c q' [B*H, S, D], then k' and v' [B*H, key_tiles * 64, D]
// each), then the forward kernel `fwd` (packed_fwd's body) on its grid.
// -> the first error.
template <int D, typename Norm, typename Fwd>
int launch_fwd(Norm norm, Fwd fwd, Params p, __nv_bfloat16* rows, __nv_bfloat16* out, int B,
               cudaStream_t st) {
  const int bh = B * p.H;
  const int keys = p.key_tiles * kRows;
  __nv_bfloat16* qn = rows;
  __nv_bfloat16* kn = qn + static_cast<long long>(bh) * p.S * D;
  __nv_bfloat16* vn = kn + static_cast<long long>(bh) * keys * D;
  p.qn = qn;
  CUtensorMap kn_map, vn_map;
  int rc = rows_map(&kn_map, kn, bh, keys, D);
  if (rc == 0) rc = rows_map(&vn_map, vn, bh, keys, D);
  if (rc == 0) rc = launch_norm<D>(norm, p, qn, kn, vn, B, st);
  if (rc == 0) rc = allow_smem(fwd, kPackedSmemBytes<D>);
  if (rc != 0) return rc;
  const dim3 grid((p.S + kRows - 1) / kRows, p.H, B);
  fwd<<<grid, kThreads, kPackedSmemBytes<D>, st>>>(kn_map, vn_map, p, out);
  return static_cast<int>(cudaGetLastError());
}

// The segment table of a forward launch: qkv and the unbiased or biased
// sources, eps and the sink. -> as fill_segments.
inline int forward_params(Params& p, const void* qkv, int S, int H, int d, int n_src,
                          const void* const (&feats)[2], const void* const (&biases)[2],
                          const int (&sfs)[2], float eps, float zero_sink) {
  p = Params{};
  p.qkv = static_cast<const __nv_bfloat16*>(qkv);
  p.S = S;
  p.s_pad = (S + kRows - 1) / kRows * kRows;
  p.H = H;
  p.eps = eps;
  p.zero_sink = zero_sink;
  void* const none[2] = {nullptr, nullptr};
  return fill_segments(p, d, n_src, feats, none, biases, none, sfs);
}

// info[0..2]: registers a thread at launch, local-memory bytes a thread,
// dynamic shared memory; info[3..8]: rows of the outputs a block owns, rows
// or keys a stage, stages, the registers of a consumer and of the producer
// thread after the warpgroups have traded them, threads a block.
template <typename Kernel>
int describe_packed(Kernel kernel, int smem_bytes, int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = smem_bytes;
  info[3] = kRows;
  info[4] = kRows;
  info[5] = kStages;
  info[6] = kConsumerRegs;
  info[7] = kProducerRegs;
  info[8] = kThreads;
  return 0;
}

}  // namespace
