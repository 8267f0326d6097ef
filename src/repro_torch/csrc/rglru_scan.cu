// K8 rglru_scan: the RG-LRU diagonal linear recurrence for Hopper (sm_90a).
//
//   h_t = a_t * h_{t-1} + gx_t        elementwise over (B, W), t = 0 .. S-1
//
// Inputs: a and gx (B, S, W), both f32 or both bf16, read as f32; h0 (B, W)
// f32. Outputs: every state hs (B, S, W) f32 and the final state h (B, W)
// f32. All contiguous.
//
// Replaces the Pallas TPU kernel of repro/kernels/rglru_scan.py:
// `_rglru_kernel` (wrapper `rglru_scan`). That kernel runs a (batch, W /
// block_w) grid with a (block_w,) state vector in VMEM and a sequential
// loop over time.
//
// What bounds it: bytes. It reads a and gx once and h0 once and writes hs
// and h once; at the recurrentgemma-9b prefill shape (4, 1024, 4096) in f32
// that is 201,457,664 bytes, 0.060 ms at 3.35 TB/s, against 2 flops per
// element (33.5 MFLOP, nothing at the card's rate).
//
// Design (simple and right first, not yet fast):
//  - One thread per (batch, channel), its state h in a register, looping
//    over t. Threads are numbered over the flattened (B, W), so a warp's
//    loads and stores of one step are 32 neighbouring channels (coalesced);
//    a thread past B * W does nothing, which masks a ragged W edge (the
//    Pallas wrapper instead halves its block until it divides W).
//  - Rounds of 32 time steps: a thread first issues the loads of a round's
//    a_t and gx_t into registers (64 loads in flight per thread), then runs
//    the round's dependent chain on them, storing each h_t.
//  - The rounding is pinned: __fmul_rn then __fadd_rn, two roundings and no
//    FMA contraction, as the plain version (`a * h` then `+ gx`, two eager
//    PyTorch operations) computes it. The kernel is bit-exact with it.
//  - All offsets are 64-bit. S = 1 is one round of one step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum : int { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 128;  // (batch, channel) pairs per block
constexpr int kTile = 32;      // time steps whose loads are issued together

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ gx,
                  const float* __restrict__ h0, float* __restrict__ hs,
                  float* __restrict__ hout, int64_t B, int64_t S, int64_t W) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= B * W) return;
  const int64_t b = i / W;
  const int64_t base = b * S * W + (i - b * W);  // element (b, 0, w)
  const T* pa = a + base;
  const T* pg = gx + base;
  float* ph = hs + base;

  float h = h0[i];
  for (int64_t t0 = 0; t0 < S; t0 += kTile) {
    const int len = S - t0 < kTile ? int(S - t0) : kTile;
    float ra[kTile], rg[kTile];
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      if (tt < len) {
        ra[tt] = to_f32(*pa);
        rg[tt] = to_f32(*pg);
        pa += W;
        pg += W;
      }
    }
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      if (tt < len) {
        h = __fadd_rn(__fmul_rn(ra[tt], h), rg[tt]);
        *ph = h;
        ph += W;
      }
    }
  }
  hout[i] = h;
}

template <typename T>
int launch(const void* a, const void* gx, const void* h0, void* hs, void* hout,
           int64_t B, int64_t S, int64_t W, cudaStream_t stream) {
  const int64_t blocks = (B * W + kThreads - 1) / kThreads;
  rglru_scan_kernel<T><<<unsigned(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(gx),
      static_cast<const float*>(h0), static_cast<float*>(hs),
      static_cast<float*>(hout), B, S, W);
  return int(cudaGetLastError());
}

}  // namespace

// a, gx (B, S, W) in `dtype` (0 f32, 1 bf16); h0 (B, W), hs (B, S, W) and
// hout (B, W) f32; all contiguous. Returns the launch's cudaError.
extern "C" int rglru_scan(const void* a, const void* gx, const void* h0, void* hs,
                          void* hout, int dtype, int64_t B, int64_t S, int64_t W,
                          void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || (B * W + kThreads - 1) / kThreads > INT32_MAX)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(a, gx, h0, hs, hout, B, S, W, s);
    case kBF16: return launch<__nv_bfloat16>(a, gx, h0, hs, hout, B, S, W, s);
    default: return int(cudaErrorInvalidValue);
  }
}
