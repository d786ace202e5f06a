// What the packed-layout attention kernels share, forward (flash_packed.cu,
// K1/K2) and backward (flash_packed_bwd.cu, K3/K4): the segment table of a
// launch, the norm pre-pass that both run first, the block layout of their
// wgmma kernels and the host code around them.
//
// A launch's keys are 1 to 3 segments: the self k/v inside the packed qkv
// [B, S, 3*H*D], then each cross source [B, Sf, 2*H*D] (k, v part-major),
// each with an optional fp32 logit bias [B, H, S, Sf]. The pre-pass writes
// every row of q, k and v pixel-normalised, x / (eps + ||x|| / sqrt(D))
// rounded to bf16 (q then times c = 1/sqrt(D) and rounded again), once, into
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
// padding rows are zeros. D / 8 threads a row, 16 bytes each.
template <int D>
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
      lo *= kScaleOf<D>;
      hi *= kScaleOf<D>;
    }
    packed[i] = pack_bf16(lo, hi);
  }
  if (dst != nullptr) *reinterpret_cast<uint4*>(dst) = y;
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
