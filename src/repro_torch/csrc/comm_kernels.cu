// Elementwise kernels of the fused flat-buffer exchange for Hopper (sm_90a):
//
//   K2 eq1_merge        paper Eq. (1) over an arena,
//                       (s2 * x_local + p * x_stale) / (s2 + p), f32 math,
//                       output in the arena's dtype (f32 or bf16)
//   K3 bf16_pack        arena -> bf16 wire buffer, round to nearest even
//   K4 bf16_unpack      bf16 wire buffer -> arena dtype (exact)
//   K5 quantize_int8    arena -> int8 wire values + one f32 scale per block
//                       of the trailing axis, scale = max(absmax, 1e-12)/127,
//                       round half to even or floor(v + u) from caller bits
//   K6 dequantize_int8  int8 values * their block's scale -> f32
//
// Replace the Pallas TPU kernels of repro/kernels/comm_kernels.py:
// `_eq1_kernel` (wrapper `eq1_merge`), `_cast_kernel` (wrappers `bf16_pack`
// and `bf16_unpack`), `_quantize_kernel` (wrapper `quantize_int8`) and
// `_dequantize_kernel` (wrapper `dequantize_int8`). K3 and K4 are two
// instances of one templated cast kernel, as on the TPU.
//
// What bounds them: each element is read once per input and written once,
// with a handful of flops in between: 12 bytes per f32 element for K2, 6 for
// K3 and K4, 4 + 1 + 4/256 for K5 and K6 (8 + 1 + 4/256 for the stochastic
// K5, which reads the bits). All are bound by device memory bandwidth
// (3.35 TB/s on an H100 SXM); the training arena (4 x 505,956,352 f32)
// moves 24.3 GB through K2, 12.1 GB through K3 or K4 and 10.15 GB through
// K5 or K6.
//
// Design, against that bound:
//  - K2 to K4: the arena is one flat contiguous range walked by a
//    grid-stride loop, eight elements per thread and iteration, with 64-bit
//    indices (the training arena holds 2.02e9 elements, 94 % of INT32_MAX).
//    The TPU wrappers padded the arena to a multiple of the block and ran a
//    (rows,) grid, a tiling artifact of the TPU that is not reproduced here.
//  - Where every pointer is 16-byte aligned, the eight elements move as
//    16-byte vector loads and stores (two for f32, one for bf16); the tail
//    and misaligned views take a scalar loop.
//  - K5 / K6: one warp per scale block (a block of a row's trailing axis;
//    blocks never span rows, a row's ragged last block is short, as the
//    reference's zero padding makes it), grid-stride over the blocks. For
//    full blocks of 128 or 256 elements in rows whose start is aligned
//    (N % 4 == 0), each lane moves four consecutive elements per 128, so a
//    warp reads 512 contiguous bytes per 16-byte load and writes 128
//    contiguous int8 per 4-byte store; K5 keeps the block in registers,
//    takes its absmax with __shfl_xor_sync and writes the scale from lane
//    0. Other block sizes, ragged blocks and misaligned rows take a scalar
//    lane-strided loop (K5 reads such a block twice).
//  - Rounding is pinned with intrinsics so the result is bit-exact with the
//    plain PyTorch version (kernels/ref.py) and with the JAX package's
//    reference functions: K2 computes
//    __fdiv_rn(__fadd_rn(__fmul_rn(s2, x), __fmul_rn(p, y)), denom), with
//    denom = s2 + p rounded to f32 by the caller (nvcc would otherwise
//    contract s2*x + p*y into an FMA), and true division, where the Pallas
//    body multiplied by the reciprocal. K3 rounds with __float2bfloat16_rn
//    (ties to even, overflow to inf, subnormals kept: XLA's CPU convert
//    keeps them too). K5 divides truly twice (absmax by 127, x by the
//    scale; XLA turns the Pallas body's `/ 127.0` into a reciprocal
//    multiply, 1 ULP off the reference's scale on some blocks), rounds with
//    rintf (ties to even, as jnp.round) or floorf(__fadd_rn(v, u)), and
//    takes a NaN-propagating absmax (fmaxf drops NaN; jnp.max and
//    torch.amax keep it). A value that is NaN after clipping (a block with
//    an inf or NaN) is stored as 0, the plain version's stated rule: the
//    reference's float -> int8 cast of NaN is undefined. K6 is
//    __fmul_rn(q, scale), exact to one rounding as the reference.
//  - The kernels allocate nothing, launch on the caller's stream and return
//    the launch's cudaError.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPack = 8;  // elements per thread and iteration
constexpr int kBlocksPerSm = 8;

enum DType { kF32 = 0, kBF16 = 1 };

// -- eight elements in and out, as float --------------------------------------

__device__ __forceinline__ void load8(const float* p, float (&v)[kPack]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kPack]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kPack / 2; ++k) {
    v[2 * k] = __low2float(h[k]);
    v[2 * k + 1] = __high2float(h[k]);
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kPack]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kPack]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kPack / 2; ++k)
    h[k] = __halves2bfloat162(__float2bfloat16_rn(v[2 * k]),
                              __float2bfloat16_rn(v[2 * k + 1]));
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float eq1(float x, float y, float s2, float p, float denom) {
  return __fdiv_rn(__fadd_rn(__fmul_rn(s2, x), __fmul_rn(p, y)), denom);
}

// -- K2 ------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
eq1_merge_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 T* __restrict__ out, int64_t n, float s2, float p,
                 float denom, int vec) {
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  const int64_t tid = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t n_packs = vec ? n / kPack : 0;
  for (int64_t i = tid; i < n_packs; i += stride) {
    float a[kPack], b[kPack];
    load8(x + i * kPack, a);
    load8(y + i * kPack, b);
#pragma unroll
    for (int k = 0; k < kPack; ++k) a[k] = eq1(a[k], b[k], s2, p, denom);
    store8(out + i * kPack, a);
  }
  for (int64_t i = n_packs * kPack + tid; i < n; i += stride)
    out[i] = from_float<T>(eq1(to_float(x[i]), to_float(y[i]), s2, p, denom));
}

// -- K3 / K4: one cast kernel --------------------------------------------------

template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
cast_kernel(const In* __restrict__ x, Out* __restrict__ out, int64_t n, int vec) {
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  const int64_t tid = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t n_packs = vec ? n / kPack : 0;
  for (int64_t i = tid; i < n_packs; i += stride) {
    float a[kPack];
    load8(x + i * kPack, a);
    store8(out + i * kPack, a);
  }
  for (int64_t i = n_packs * kPack + tid; i < n; i += stride)
    out[i] = from_float<Out>(to_float(x[i]));
}

// -- K5 / K6: block-scaled int8, one warp per scale block ---------------------

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;

// max that propagates NaN from either side, as jnp.max and torch.amax do
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) m = max_nan(m, __shfl_xor_sync(kFull, m, o));
  return m;
}

__device__ __forceinline__ float block_scale(float absmax, float scale_floor) {
  return __fdiv_rn(max_nan(absmax, scale_floor), 127.0f);
}

template <bool kStochastic>
__device__ __forceinline__ int8_t quantize1(float x, float scale, uint32_t bits) {
  const float v = __fdiv_rn(x, scale);
  float q;
  if constexpr (kStochastic)  // u = top 24 bits * 2^-24, exact
    q = floorf(__fadd_rn(v, __fmul_rn(__uint2float_rn(bits >> 8), 0x1p-24f)));
  else
    q = rintf(v);  // ties to even
  q = isnan(q) ? 0.0f : fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(q));
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  v[0] = __low2float(h[0]); v[1] = __high2float(h[0]);
  v[2] = __low2float(h[1]); v[3] = __high2float(h[1]);
}

// The scale block p of a (rows, n) arena: its first element and length.
struct ScaleBlock {
  int64_t base;
  int len;
};

__device__ __forceinline__ ScaleBlock scale_block(int64_t p, int64_t n, int64_t nb,
                                                  int block) {
  const int64_t row = p / nb, j = p - row * nb;
  const int64_t start = j * block;
  const int64_t left = n - start;
  return {row * n + start, int(left < block ? left : block)};
}

// kChunks x 128 elements, four consecutive ones per lane and chunk
template <int kChunks, bool kStochastic, typename T>
__device__ __forceinline__ float quantize_full(const T* x, const uint32_t* bits,
                                               int8_t* values, int lane,
                                               float scale_floor) {
  float v[kChunks][4];
  float m = 0.0f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    load4(x + c * 128 + lane * 4, v[c]);
#pragma unroll
    for (int k = 0; k < 4; ++k) m = max_nan(m, fabsf(v[c][k]));
  }
  const float scale = block_scale(warp_max(m), scale_floor);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    uint4 b = make_uint4(0, 0, 0, 0);
    if constexpr (kStochastic) b = *reinterpret_cast<const uint4*>(bits + c * 128 + lane * 4);
    const char4 q = make_char4(quantize1<kStochastic>(v[c][0], scale, b.x),
                               quantize1<kStochastic>(v[c][1], scale, b.y),
                               quantize1<kStochastic>(v[c][2], scale, b.z),
                               quantize1<kStochastic>(v[c][3], scale, b.w));
    *reinterpret_cast<char4*>(values + c * 128 + lane * 4) = q;
  }
  return scale;
}

template <typename T, bool kStochastic>
__global__ void __launch_bounds__(kThreads)
quantize_int8_kernel(const T* __restrict__ x, const uint32_t* __restrict__ bits,
                     int8_t* __restrict__ values, float* __restrict__ scales,
                     int64_t rows, int64_t n, int block, float scale_floor,
                     int vec) {
  const int lane = threadIdx.x % kWarp;
  const int64_t nb = (n + block - 1) / block;
  const int64_t n_blocks = rows * nb;
  const int64_t stride = int64_t(gridDim.x) * kWarpsPerBlock;
  for (int64_t p = int64_t(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
       p < n_blocks; p += stride) {  // p is the same across the warp
    const ScaleBlock sb = scale_block(p, n, nb, block);
    const T* xp = x + sb.base;
    const uint32_t* bp = kStochastic ? bits + sb.base : nullptr;
    int8_t* vp = values + sb.base;
    float scale;
    if (vec && sb.len == 256) {
      scale = quantize_full<2, kStochastic>(xp, bp, vp, lane, scale_floor);
    } else if (vec && sb.len == 128) {
      scale = quantize_full<1, kStochastic>(xp, bp, vp, lane, scale_floor);
    } else {
      float m = 0.0f;
      for (int i = lane; i < sb.len; i += kWarp) m = max_nan(m, fabsf(to_float(xp[i])));
      scale = block_scale(warp_max(m), scale_floor);
      for (int i = lane; i < sb.len; i += kWarp)
        vp[i] = quantize1<kStochastic>(to_float(xp[i]), scale, kStochastic ? bp[i] : 0u);
    }
    if (lane == 0) scales[p] = scale;
  }
}

template <int kChunks>
__device__ __forceinline__ void dequantize_full(const int8_t* values, float scale,
                                                float* out, int lane) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const char4 q = *reinterpret_cast<const char4*>(values + c * 128 + lane * 4);
    *reinterpret_cast<float4*>(out + c * 128 + lane * 4) =
        make_float4(__fmul_rn(float(q.x), scale), __fmul_rn(float(q.y), scale),
                    __fmul_rn(float(q.z), scale), __fmul_rn(float(q.w), scale));
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_int8_kernel(const int8_t* __restrict__ values, const float* __restrict__ scales,
                       float* __restrict__ out, int64_t rows, int64_t n, int block,
                       int vec) {
  const int lane = threadIdx.x % kWarp;
  const int64_t nb = (n + block - 1) / block;
  const int64_t n_blocks = rows * nb;
  const int64_t stride = int64_t(gridDim.x) * kWarpsPerBlock;
  for (int64_t p = int64_t(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
       p < n_blocks; p += stride) {
    const ScaleBlock sb = scale_block(p, n, nb, block);
    const float scale = scales[p];
    if (vec && sb.len == 256) {
      dequantize_full<2>(values + sb.base, scale, out + sb.base, lane);
    } else if (vec && sb.len == 128) {
      dequantize_full<1>(values + sb.base, scale, out + sb.base, lane);
    } else {
      for (int i = lane; i < sb.len; i += kWarp)
        out[sb.base + i] = __fmul_rn(float(values[sb.base + i]), scale);
    }
  }
}

// -- launch helpers ------------------------------------------------------------

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

int grid_for(int64_t n, int vec) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t items = vec ? (n / kPack + n % kPack) : n;
  const int64_t want = (items + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(sms) * kBlocksPerSm;
  return int(want < 1 ? 1 : (want < cap ? want : cap));
}

template <typename T>
int launch_eq1(const void* x, const void* y, void* out, int64_t n, float s2,
               float p, float denom, cudaStream_t s) {
  const int vec = aligned(x, 16) && aligned(y, 16) && aligned(out, 16);
  eq1_merge_kernel<T><<<grid_for(n, vec), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out),
      n, s2, p, denom, vec);
  return int(cudaGetLastError());
}

template <typename In, typename Out>
int launch_cast(const void* x, void* out, int64_t n, cudaStream_t s) {
  const int vec = aligned(x, 16) && aligned(out, 16);
  cast_kernel<In, Out><<<grid_for(n, vec), kThreads, 0, s>>>(
      static_cast<const In*>(x), static_cast<Out*>(out), n, vec);
  return int(cudaGetLastError());
}

int warp_grid(int64_t n_blocks) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n_blocks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t cap = int64_t(sms) * kBlocksPerSm;
  return int(want < 1 ? 1 : (want < cap ? want : cap));
}

template <typename T>
int launch_quantize(const void* x, const void* bits, void* values, void* scales,
                    int64_t rows, int64_t n, int block, float scale_floor,
                    cudaStream_t s) {
  // the vector path: scale blocks start 16-byte aligned for f32 (8 for
  // bf16) loads, 16 for the bits, 4 for the int8 stores
  const int vec = n % 4 == 0 && block % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(values, 4) &&
                  (bits == nullptr || aligned(bits, 16));
  const int grid = warp_grid(rows * ((n + block - 1) / block));
  const T* xt = static_cast<const T*>(x);
  int8_t* v = static_cast<int8_t*>(values);
  float* sc = static_cast<float*>(scales);
  if (bits)
    quantize_int8_kernel<T, true><<<grid, kThreads, 0, s>>>(
        xt, static_cast<const uint32_t*>(bits), v, sc, rows, n, block, scale_floor, vec);
  else
    quantize_int8_kernel<T, false><<<grid, kThreads, 0, s>>>(
        xt, nullptr, v, sc, rows, n, block, scale_floor, vec);
  return int(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Each entry point returns the
// launch's cudaError (0 on success); n must be > 0.

extern "C" int eq1_merge(const void* x, const void* y, void* out, int64_t n,
                         int dtype, float s2, float p, float denom, void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_eq1<float>(x, y, out, n, s2, p, denom, s);
    case kBF16: return launch_eq1<__nv_bfloat16>(x, y, out, n, s2, p, denom, s);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" int bf16_pack(const void* x, void* out, int64_t n, int in_dtype,
                         void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case kF32: return launch_cast<float, __nv_bfloat16>(x, out, n, s);
    case kBF16: return launch_cast<__nv_bfloat16, __nv_bfloat16>(x, out, n, s);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" int bf16_unpack(const void* x, void* out, int64_t n, int out_dtype,
                           void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case kF32: return launch_cast<__nv_bfloat16, float>(x, out, n, s);
    case kBF16: return launch_cast<__nv_bfloat16, __nv_bfloat16>(x, out, n, s);
    default: return int(cudaErrorInvalidValue);
  }
}

// K5: x (rows, n) in `in_dtype`, bits (rows, n) uint32 or null (round half to
// even) -> values (rows, n) int8 and scales (rows, ceil(n / block)) f32.
extern "C" int quantize_int8(const void* x, const void* bits, void* values,
                             void* scales, int64_t rows, int64_t n, int block,
                             int in_dtype, float scale_floor, void* stream) {
  if (rows <= 0 || n <= 0 || block <= 0) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case kF32:
      return launch_quantize<float>(x, bits, values, scales, rows, n, block,
                                    scale_floor, s);
    case kBF16:
      return launch_quantize<__nv_bfloat16>(x, bits, values, scales, rows, n, block,
                                            scale_floor, s);
    default: return int(cudaErrorInvalidValue);
  }
}

// K6: values (rows, n) int8, scales (rows, ceil(n / block)) f32 -> out
// (rows, n) f32.
extern "C" int dequantize_int8(const void* values, const void* scales, void* out,
                               int64_t rows, int64_t n, int block, void* stream) {
  if (rows <= 0 || n <= 0 || block <= 0) return int(cudaErrorInvalidValue);
  const int vec = n % 4 == 0 && block % 4 == 0 && aligned(values, 4) && aligned(out, 16);
  dequantize_int8_kernel<<<warp_grid(rows * ((n + block - 1) / block)), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(values), static_cast<const float*>(scales),
      static_cast<float*>(out), rows, n, block, vec);
  return int(cudaGetLastError());
}
