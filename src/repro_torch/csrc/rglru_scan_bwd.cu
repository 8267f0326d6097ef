// K8-bwd rglru_scan_bwd: the backward of the RG-LRU diagonal recurrence
// (K8, csrc/rglru_scan.cu) for Hopper (sm_90a).
//
//   forward   h_t = a_t * h_{t-1} + gx_t          h_{-1} = h0
//   backward  g_{S-1} = dhs_{S-1} + dh,  g_t = dhs_t + a_{t+1} * g_{t+1}
//             dgx_t = g_t,  da_t = g_t * h_{t-1},  dh0 = a_0 * g_0
//
// Inputs: a (B, S, W) f32 or bf16, read as f32; the forward's states hs
// (B, S, W) f32, their cotangent dhs (B, S, W) f32, h0 (B, W) f32 and the
// cotangent dh of the final state (B, W) f32, or null for none. Outputs: da
// (B, S, W) in a's dtype, dgx (B, S, W) in gx's dtype, dh0 (B, W) f32. All
// contiguous.
//
// Replaces no Pallas kernel: the JAX package differentiates its
// `mamba.linear_recurrence` (a chunked associative scan) with jax.grad.
// This is the backward that `kernels/ops.py::rglru_scan` takes under
// autograd on the card.
//
// What bounds it: bytes. It reads a, hs and dhs once and writes da and dgx
// once: 5 * B * S * W * 4 bytes in f32, 41.9 MB (0.0125 ms at 3.35 TB/s)
// at the recurrentgemma-9b train shape (2, 256, 4096), against 3 flops per
// element.
//
// Design (the forward kernel's, run in reverse):
//  - One thread per (batch, channel), its adjoint g in a register, looping
//    over t from S - 1 down to 0. Threads are numbered over the flattened
//    (B, W), so a warp's loads and stores of one step are 32 neighbouring
//    channels (coalesced); a thread past B * W does nothing.
//  - Rounds of 32 time steps: a thread first issues the loads of a round's
//    dhs_t, a_{t+1} and h_{t-1} into registers (96 loads in flight), then
//    runs the round's dependent chain on them, storing dgx_t and da_t.
//  - The rounding is pinned: __fmul_rn then __fadd_rn, two roundings and no
//    FMA contraction, as the plain version (`a * g` then `dhs + ...`, two
//    eager PyTorch operations) computes it; bf16 outputs round to nearest
//    even, as `.to(torch.bfloat16)` does. The kernel is bit-exact with
//    `kernels/ref.py::rglru_scan_bwd_ref`.
//  - No scratch memory. All offsets are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum : int { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 128;  // (batch, channel) pairs per block
constexpr int kTile = 32;      // time steps whose loads are issued together

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const T* __restrict__ a, const float* __restrict__ hs,
                      const float* __restrict__ dhs, const float* __restrict__ h0,
                      const float* __restrict__ dh, T* __restrict__ da,
                      T* __restrict__ dgx, float* __restrict__ dh0,
                      int64_t B, int64_t S, int64_t W) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= B * W) return;
  const int64_t b = i / W;
  const int64_t base = b * S * W + (i - b * W);  // element (b, 0, w)

  float g = 0.0f;
  for (int64_t t1 = S - 1; t1 >= 0; t1 -= kTile) {  // steps t1, t1 - 1, .., t1 - len + 1
    const int len = t1 + 1 < kTile ? int(t1 + 1) : kTile;
    float rd[kTile], ra[kTile], rh[kTile];
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      if (tt < len) {
        const int64_t t = t1 - tt;
        const int64_t o = base + t * W;
        rd[tt] = dhs[o];
        ra[tt] = t + 1 < S ? to_f32(a[o + W]) : 0.0f;
        rh[tt] = t > 0 ? hs[o - W] : h0[i];
      }
    }
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      if (tt < len) {
        const int64_t t = t1 - tt;
        if (t + 1 < S)
          g = __fadd_rn(rd[tt], __fmul_rn(ra[tt], g));
        else
          g = dh ? __fadd_rn(rd[tt], dh[i]) : rd[tt];
        const int64_t o = base + t * W;
        store(dgx + o, g);
        store(da + o, __fmul_rn(g, rh[tt]));
      }
    }
  }
  dh0[i] = __fmul_rn(to_f32(a[base]), g);
}

template <typename T>
int launch(const void* a, const void* hs, const void* dhs, const void* h0, const void* dh,
           void* da, void* dgx, void* dh0, int64_t B, int64_t S, int64_t W,
           cudaStream_t stream) {
  const int64_t blocks = (B * W + kThreads - 1) / kThreads;
  rglru_scan_bwd_kernel<T><<<unsigned(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const float*>(hs),
      static_cast<const float*>(dhs), static_cast<const float*>(h0),
      static_cast<const float*>(dh), static_cast<T*>(da), static_cast<T*>(dgx),
      static_cast<float*>(dh0), B, S, W);
  return int(cudaGetLastError());
}

}  // namespace

// a, da, dgx (B, S, W) in `dtype` (0 f32, 1 bf16); hs, dhs (B, S, W), h0, dh
// (null: no final-state cotangent) and dh0 (B, W) f32; all contiguous.
// Returns the launch's cudaError.
extern "C" int rglru_scan_bwd(const void* a, const void* hs, const void* dhs,
                              const void* h0, const void* dh, void* da, void* dgx,
                              void* dh0, int dtype, int64_t B, int64_t S, int64_t W,
                              void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || (B * W + kThreads - 1) / kThreads > INT32_MAX)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(a, hs, dhs, h0, dh, da, dgx, dh0, B, S, W, s);
    case kBF16: return launch<__nv_bfloat16>(a, hs, dhs, h0, dh, da, dgx, dh0, B, S, W, s);
    default: return int(cudaErrorInvalidValue);
  }
}
