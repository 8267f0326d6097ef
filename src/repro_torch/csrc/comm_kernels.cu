// Elementwise kernels of the fused flat-buffer exchange for Hopper (sm_90a):
//
//   K2 eq1_merge    paper Eq. (1) over an arena,
//                   (s2 * x_local + p * x_stale) / (s2 + p), f32 math,
//                   output in the arena's dtype (f32 or bf16)
//   K3 bf16_pack    arena -> bf16 wire buffer, round to nearest even
//   K4 bf16_unpack  bf16 wire buffer -> arena dtype (exact)
//
// Replace the Pallas TPU kernels of repro/kernels/comm_kernels.py:
// `_eq1_kernel` (wrapper `eq1_merge`) and `_cast_kernel` (wrappers
// `bf16_pack` and `bf16_unpack`). K3 and K4 are two instances of one
// templated cast kernel, as on the TPU.
//
// What bounds them: each element is read once per input and written once,
// with a handful of flops in between: 12 bytes per f32 element for K2, 6 for
// K3 and K4. All three are bound by device memory bandwidth (3.35 TB/s on an
// H100 SXM); the training arena (4 x 505,956,352 f32) moves 24.3 GB through
// K2 and 12.1 GB through K3 or K4.
//
// Design, against that bound:
//  - The arena is one flat contiguous range walked by a grid-stride loop,
//    eight elements per thread and iteration, with 64-bit indices (the
//    training arena holds 2.02e9 elements, 94 % of INT32_MAX). The TPU
//    wrappers padded the arena to a multiple of the block and ran a (rows,)
//    grid, a tiling artifact of the TPU that is not reproduced here.
//  - Where every pointer is 16-byte aligned, the eight elements move as
//    16-byte vector loads and stores (two for f32, one for bf16); the tail
//    and misaligned views take a scalar loop.
//  - Rounding is pinned with intrinsics so the result is bit-exact with the
//    plain PyTorch version (kernels/ref.py) and with the JAX package's
//    `eq1_merge_ref`: K2 computes
//    __fdiv_rn(__fadd_rn(__fmul_rn(s2, x), __fmul_rn(p, y)), denom), with
//    denom = s2 + p rounded to f32 by the caller (nvcc would otherwise
//    contract s2*x + p*y into an FMA), and true division, where the Pallas
//    body multiplied by the reciprocal. K3 rounds with __float2bfloat16_rn
//    (ties to even, overflow to inf, subnormals kept: XLA's CPU convert
//    keeps them too).
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

// -- launch helpers ------------------------------------------------------------

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

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
  const int vec = aligned16(x) && aligned16(y) && aligned16(out);
  eq1_merge_kernel<T><<<grid_for(n, vec), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out),
      n, s2, p, denom, vec);
  return int(cudaGetLastError());
}

template <typename In, typename Out>
int launch_cast(const void* x, void* out, int64_t n, cudaStream_t s) {
  const int vec = aligned16(x) && aligned16(out);
  cast_kernel<In, Out><<<grid_for(n, vec), kThreads, 0, s>>>(
      static_cast<const In*>(x), static_cast<Out*>(out), n, vec);
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
