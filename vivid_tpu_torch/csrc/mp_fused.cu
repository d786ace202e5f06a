// The EDM2 block's elementwise chains, each fused into one pass over the
// activation (plain SIMT kernels: no tensor core, no shared memory).
//
// Replaces no TPU kernel: XLA fuses these chains on the TPU by itself, while
// PyTorch's eager composites (vivid_tpu_torch/nn/mp.py `normalize`,
// `mp_silu`, `mp_sum`, `mp_cat`, and nn/blocks.py's emb scale and clip) run
// one kernel an operator, each a whole pass over device memory. Four kernels,
// on channel-last rows [rows, C], bf16 or fp32, of the no-grad forward:
//   mp_norm_silu   xn = x / (eps + |x| / sqrt(C)) over each pixel's channels,
//                  and mp_silu(xn): an encoder block's residual and the input
//                  of its first convolution;
//   mp_scale_silu  mp_silu(y * c[b, :]), c one row of C a batch row: the emb
//                  scale of the residual branch;
//   mp_sum_clip    (a + t (b - a)) / sqrt((1 - t)^2 + t^2), clamped to
//                  [-clip, clip] unless clip is 0: the residual and the
//                  attention sums and the block's clip;
//   mp_cat_silu    [wa a | wb b] and mp_silu of it: a decoder block's
//                  skip concatenation and the input of its first convolution.
//
// Rounding: every product, SiLU and sum is computed in fp32 and rounded to
// the activation's type where the composite rounds it (the composite runs one
// operator at a time, each rounding its output; a division by a number is a
// product by the fp32 reciprocal, as PyTorch's CUDA kernels take it; no
// multiply-add is contracted across two of the composite's operators), so
// the three kernels without a reduction give the composite's bits. A SiLU
// turns a rounding difference of its input into several of its output (at
// x = -6 about five), so the roundings are kept, not saved: the fused kernels
// save memory passes, not roundings. The pixel norm's denominator alone stays
// fp32, as K5's and the packed kernels' norm pre-passes keep it: the sum of
// squares is added in another order than PyTorch's reduction, and rounding
// the denominator to bf16 as the composite does would move a whole row by an
// ulp wherever the two orders straddle a rounding boundary; kept in fp32, xn
// lies within one ulp of the composite's everywhere (each element is
// multiplied by the row's fp32 reciprocal: one division a row, not one an
// element).
//
// What bounds them: bytes. Each input element is read once and each output
// written once (16-byte vectors, neighbouring threads on neighbouring
// addresses); at [32, 256, 256, 64] bf16 a pass is 268 MB, so the norm moves
// 805 MB (0.240 ms at 3.35 TB/s) where its composite moved 4 GB. The
// SiLU's exponential and division and the three roundings an element stay
// close below that line: on the card the kernels reach 63-92% of the memory
// rate at that shape (PERF.md; rounding on the integer pipe in place of the
// conversion instructions was slower). The norm gives each pixel a group of
// 8 threads that hold the row in registers
// (up to 16 vectors a thread: 1024 bf16 or 512 fp32 channels), sum the
// squares with three shuffles and write both outputs: no second pass over
// device memory and no shared memory. Every output element has one owner,
// so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;          // threads a pixel in the norm
constexpr int kMaxChunks = 16;     // 16-byte vectors a thread of the norm holds

template <typename T> struct Vec;

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&f)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[N]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return r;
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&f)[N]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

// mp_silu of a value of type T, as the composite computes it: F.silu
// (x / (1 + exp(-x)) in fp32, rounded), then the product by 1 / 0.596.
template <typename T>
__device__ __forceinline__ float mp_silu(float x, float inv_div) {
  const float s = Vec<T>::round(__fdiv_rn(x, __fadd_rn(1.0f, expf(-x))));
  return __fmul_rn(s, inv_div);
}

__device__ __forceinline__ float silu_inv_div() { return __fdiv_rn(1.0f, 0.596f); }

template <typename T, int NCH>
__global__ void __launch_bounds__(kThreads)
mp_norm_silu_kernel(const uint4* __restrict__ x, uint4* __restrict__ xn, uint4* __restrict__ xs,
                    unsigned rows, int cv, float rsqrt_c, float eps) {
  using V = Vec<T>;
  constexpr int N = V::N;
  const unsigned g = blockIdx.x * kThreads + threadIdx.x;
  const unsigned row = g / kGroup;
  const int lane = static_cast<int>(g % kGroup);
  if (row >= rows) return;   // a group's 8 threads share their row, so they leave together
  const unsigned group_mask = 0xffu << (threadIdx.x & 24);
  const size_t base = static_cast<size_t>(row) * cv;
  uint4 raw[NCH];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int k = j * kGroup + lane;
    if (k < cv) raw[j] = x[base + k];
  }
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    if (j * kGroup + lane < cv) {
      float f[N];
      V::unpack(raw[j], f);
#pragma unroll
      for (int i = 0; i < N; ++i) ss = fmaf(f[i], f[i], ss);
    }
  }
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(group_mask, ss, o, kGroup);
  const float inv_den = __frcp_rn(__fadd_rn(eps, __fmul_rn(rsqrt_c, sqrtf(ss))));
  const float inv_div = silu_inv_div();
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int k = j * kGroup + lane;
    if (k < cv) {
      float f[N], s[N];
      V::unpack(raw[j], f);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        f[i] = V::round(__fmul_rn(f[i], inv_den));
        s[i] = mp_silu<T>(f[i], inv_div);
      }
      xn[base + k] = V::pack(f);
      xs[base + k] = V::pack(s);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mp_scale_silu_kernel(const uint4* __restrict__ y, const float* __restrict__ c,
                     uint4* __restrict__ out, unsigned n, int cv, unsigned rows_per_image) {
  using V = Vec<T>;
  constexpr int N = V::N;
  const unsigned v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n) return;
  const unsigned row = v / cv;
  const int k = static_cast<int>(v - row * cv);
  const float4* cb = reinterpret_cast<const float4*>(
      c + (static_cast<size_t>(row / rows_per_image) * cv + k) * N);
  float cs[N];
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 q = __ldg(cb + i);
    cs[4 * i] = q.x;
    cs[4 * i + 1] = q.y;
    cs[4 * i + 2] = q.z;
    cs[4 * i + 3] = q.w;
  }
  const float inv_div = silu_inv_div();
  float f[N];
  V::unpack(y[v], f);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float z = V::round(__fmul_rn(f[i], V::round(cs[i])));
    f[i] = mp_silu<T>(z, inv_div);
  }
  out[v] = V::pack(f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mp_sum_clip_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                   uint4* __restrict__ out, unsigned n, float t, float norm, float clip) {
  using V = Vec<T>;
  constexpr int N = V::N;
  const unsigned v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n) return;
  const float inv_norm = __fdiv_rn(1.0f, norm);
  float fa[N], fb[N];
  V::unpack(a[v], fa);
  V::unpack(b[v], fb);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float d = V::round(__fsub_rn(fb[i], fa[i]));
    const float s = V::round(__fadd_rn(fa[i], V::round(__fmul_rn(d, t))));
    float r = V::round(__fmul_rn(s, inv_norm));
    if (clip > 0.0f) r = r < -clip ? -clip : (r > clip ? clip : r);   // NaN stays NaN
    fa[i] = r;
  }
  out[v] = V::pack(fa);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mp_cat_silu_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                   uint4* __restrict__ cat, uint4* __restrict__ xs, unsigned n, int cva,
                   int cvb, float wa, float wb) {
  using V = Vec<T>;
  constexpr int N = V::N;
  const unsigned v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n) return;
  const int cv = cva + cvb;
  const unsigned row = v / cv;
  const int k = static_cast<int>(v - row * cv);
  const bool first = k < cva;
  const uint4 r = first ? a[static_cast<size_t>(row) * cva + k]
                        : b[static_cast<size_t>(row) * cvb + (k - cva)];
  const float w = first ? wa : wb;
  const float inv_div = silu_inv_div();
  float f[N], s[N];
  V::unpack(r, f);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f[i] = V::round(__fmul_rn(f[i], w));
    s[i] = mp_silu<T>(f[i], inv_div);
  }
  cat[v] = V::pack(f);
  xs[v] = V::pack(s);
}

typedef void (*NormKernel)(const uint4*, uint4*, uint4*, unsigned, int, float, float);

template <typename T>
NormKernel norm_kernel(int chunks) {
  switch (chunks) {
    case 1: return mp_norm_silu_kernel<T, 1>;
    case 2: return mp_norm_silu_kernel<T, 2>;
    case 3: return mp_norm_silu_kernel<T, 3>;
    case 4: return mp_norm_silu_kernel<T, 4>;
    case 5: case 6: return mp_norm_silu_kernel<T, 6>;
    case 7: case 8: return mp_norm_silu_kernel<T, 8>;
    default: return mp_norm_silu_kernel<T, kMaxChunks>;
  }
}

// The instance a row of cv vectors takes, or null past kMaxChunks vectors a thread.
NormKernel norm_instance(int fp32, int cv) {
  const int chunks = (cv + kGroup - 1) / kGroup;
  if (cv < 1 || chunks > kMaxChunks) return nullptr;
  return fp32 ? norm_kernel<float>(chunks) : norm_kernel<__nv_bfloat16>(chunks);
}

unsigned blocks_for(unsigned long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

// The launches take element counts that the wrapper has checked: whole
// 16-byte vectors a row, and fewer than 2^31 vectors (threads) a launch.
bool fits(long long threads) { return threads >= 1 && threads < (1LL << 31); }

}  // namespace

// x, xn, xs: [rows, C] of one type (fp32 when `fp32`, else bf16); C a whole
// number of 16-byte vectors.
extern "C" int vivid_mp_norm_silu(const void* x, void* xn, void* xs, long long rows, int C,
                                  int fp32, float eps, void* stream) {
  const int per_vec = fp32 ? 4 : 8;
  if (C < 1 || C % per_vec || !fits(rows * kGroup)) return static_cast<int>(cudaErrorInvalidValue);
  const int cv = C / per_vec;
  const NormKernel kernel = norm_instance(fp32, cv);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const float rsqrt_c = static_cast<float>(std::sqrt(1.0 / C));   // as the composite's
  kernel<<<blocks_for(rows * kGroup), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(xn), static_cast<uint4*>(xs),
      static_cast<unsigned>(rows), cv, rsqrt_c, eps);
  return static_cast<int>(cudaGetLastError());
}

// y, out: [rows, C]; c: [rows / rows_per_image, C] fp32 (rounded to y's type
// inside, as the composite casts it).
extern "C" int vivid_mp_scale_silu(const void* y, const void* c, void* out, long long rows,
                                   long long rows_per_image, int C, int fp32, void* stream) {
  const int per_vec = fp32 ? 4 : 8;
  if (C < 1 || C % per_vec || rows_per_image < 1 || rows % rows_per_image)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = rows * (C / per_vec);
  if (!fits(n)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* yv = static_cast<const uint4*>(y);
  const float* cf = static_cast<const float*>(c);
  uint4* ov = static_cast<uint4*>(out);
  if (fp32)
    mp_scale_silu_kernel<float><<<grid, kThreads, 0, s>>>(
        yv, cf, ov, static_cast<unsigned>(n), C / per_vec, static_cast<unsigned>(rows_per_image));
  else
    mp_scale_silu_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        yv, cf, ov, static_cast<unsigned>(n), C / per_vec, static_cast<unsigned>(rows_per_image));
  return static_cast<int>(cudaGetLastError());
}

// a, b, out: `numel` elements each, a whole number of 16-byte vectors; clip
// 0 clamps nothing.
extern "C" int vivid_mp_sum_clip(const void* a, const void* b, void* out, long long numel,
                                 int fp32, float t, float norm, float clip, void* stream) {
  const int per_vec = fp32 ? 4 : 8;
  if (numel % per_vec || !fits(numel / per_vec) || !(norm > 0.0f) || clip < 0.0f)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = numel / per_vec;
  const unsigned grid = blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* av = static_cast<const uint4*>(a);
  const uint4* bv = static_cast<const uint4*>(b);
  uint4* ov = static_cast<uint4*>(out);
  if (fp32)
    mp_sum_clip_kernel<float><<<grid, kThreads, 0, s>>>(av, bv, ov, static_cast<unsigned>(n),
                                                        t, norm, clip);
  else
    mp_sum_clip_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        av, bv, ov, static_cast<unsigned>(n), t, norm, clip);
  return static_cast<int>(cudaGetLastError());
}

// a: [rows, Ca], b: [rows, Cb]; cat, xs: [rows, Ca + Cb].
extern "C" int vivid_mp_cat_silu(const void* a, const void* b, void* cat, void* xs,
                                 long long rows, int Ca, int Cb, int fp32, float wa, float wb,
                                 void* stream) {
  const int per_vec = fp32 ? 4 : 8;
  if (Ca < 1 || Cb < 1 || Ca % per_vec || Cb % per_vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = rows * ((Ca + Cb) / per_vec);
  if (!fits(n)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* av = static_cast<const uint4*>(a);
  const uint4* bv = static_cast<const uint4*>(b);
  uint4* cv = static_cast<uint4*>(cat);
  uint4* sv = static_cast<uint4*>(xs);
  if (fp32)
    mp_cat_silu_kernel<float><<<grid, kThreads, 0, s>>>(
        av, bv, cv, sv, static_cast<unsigned>(n), Ca / 4, Cb / 4, wa, wb);
  else
    mp_cat_silu_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        av, bv, cv, sv, static_cast<unsigned>(n), Ca / 8, Cb / 8, wa, wb);
  return static_cast<int>(cudaGetLastError());
}

// info[0..1]: registers a thread and bytes of local memory a thread (spills)
// of `kernel` (0 norm, 1 scale, 2 sum, 3 cat) in the type `fp32` names; for
// the norm, the instance a row of C channels takes. info[2]: threads a block.
extern "C" int vivid_mp_fused_info(int kernel, int fp32, int C, int* info) {
  const void* fn = nullptr;
  switch (kernel) {
    case 0: fn = reinterpret_cast<const void*>(norm_instance(fp32, C / (fp32 ? 4 : 8))); break;
    case 1: fn = fp32 ? reinterpret_cast<const void*>(mp_scale_silu_kernel<float>)
                      : reinterpret_cast<const void*>(mp_scale_silu_kernel<__nv_bfloat16>);
            break;
    case 2: fn = fp32 ? reinterpret_cast<const void*>(mp_sum_clip_kernel<float>)
                      : reinterpret_cast<const void*>(mp_sum_clip_kernel<__nv_bfloat16>);
            break;
    case 3: fn = fp32 ? reinterpret_cast<const void*>(mp_cat_silu_kernel<float>)
                      : reinterpret_cast<const void*>(mp_cat_silu_kernel<__nv_bfloat16>);
            break;
    default: break;
  }
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = kThreads;
  return 0;
}
