// K7 ssm_scan: the Mamba-1 selective scan for Hopper (sm_90a).
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      (Di, N) per batch
//   y_t = sum_n h_t[:, n] * C_t[n]                          (Di,) per batch
//
// Inputs: x (B, S, Di), Bm and Cm (B, S, N), each f32 or bf16 (one dtype for
// the three); dt (B, S, Di), A (Di, N) and h0 (B, Di, N) in f32. Outputs: y
// (B, S, Di) f32 and the final state h (B, Di, N) f32. State, exp and
// products are f32 whatever the input dtype, as in the Pallas body.
//
// Replaces the Pallas TPU kernel of repro/kernels/ssm_scan.py: `_ssm_kernel`
// (wrapper `ssm_scan`). That kernel runs a (batch, d_inner / block_d) grid
// with a (block_d, N) state tile in VMEM and a sequential loop over time.
//
// What bounds it: the larger of
//  - bytes: x, dt, Bm, Cm and h0 read once, y and h written once, over the
//    memory rate, and
//  - exps: B * S * Di * N of them (536,870,912 at the serving prefill shape
//    (4, 1024, 8192, 16)), each one MUFU ex2, at 16 per SM per clock.
// At that shape the exps bound is the larger (chip_smoke.py computes both
// from its run's inputs and the card's clock). The scan is sequential in t,
// so this simple design is held back by each channel's per-step chain.
//
// Design (simple and right first, not yet fast):
//  - One thread per (batch, channel d), its N <= 32 states and its row of A
//    in registers (the template's NMAX; n >= N is masked), looping over t.
//    A block holds 128 consecutive channels of one batch row, so the x, dt
//    and y accesses of a step are coalesced; grid (ceil(Di / 128), B).
//  - Rounds of 32 time steps: the block stages Bm_t and Cm_t (shared by
//    its channels) and each thread its own x_t and dt_t into shared memory
//    as f32, so a round's global loads are all in flight
//    at once and the sequential loop reads shared memory only.
//  - Di need not be a multiple of the block: threads past Di load their
//    share of the tile and skip the rest (the Pallas wrapper instead halves
//    its block until it divides Di).
//  - Inputs are addressed by (batch, time) strides in elements, the last
//    axis contiguous: Bm and Cm are column slices of x_proj's output (row
//    stride R + 2N). All offsets are 64-bit.
//  - exp is expf (CUDA's accurate single-precision exp, at most 2 ulp), not
//    the __expf intrinsic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum : int { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 128;  // channels per block
constexpr int kTile = 32;      // time steps staged per round

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Strides {  // elements between consecutive batch rows / time steps
  int64_t x_b, x_t, dt_b, dt_t, b_b, b_t, c_b, c_t;
};

template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ hout, int S, int Di,
                int N, Strides st) {
  __shared__ float sB[kTile][NMAX];
  __shared__ float sC[kTile][NMAX];
  __shared__ float sX[kTile][kThreads];
  __shared__ float sDt[kTile][kThreads];
  const int64_t b = blockIdx.y;
  const int64_t d = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = d < Di;

  float a[NMAX], h[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    const bool on = active && n < N;
    a[n] = on ? A[d * N + n] : 0.f;
    h[n] = on ? h0[(b * Di + d) * N + n] : 0.f;
  }

  const T* xb = x + b * st.x_b;
  const float* dtb = dt + b * st.dt_b;
  const T* Bb = Bm + b * st.b_b;
  const T* Cb = Cm + b * st.c_b;
  float* yb = y + b * int64_t(S) * Di;

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int len = min(kTile, S - t0);
    __syncthreads();  // the previous round is done with the tile
    for (int i = threadIdx.x; i < len * N; i += kThreads) {
      const int tt = i / N, n = i - tt * N;
      const int64_t t = t0 + tt;
      sB[tt][n] = to_f32(Bb[t * st.b_t + n]);
      sC[tt][n] = to_f32(Cb[t * st.c_t + n]);
    }
    if (active) {
#pragma unroll 8
      for (int tt = 0; tt < len; ++tt) {
        const int64_t t = t0 + tt;
        sX[tt][threadIdx.x] = to_f32(xb[t * st.x_t + d]);
        sDt[tt][threadIdx.x] = dtb[t * st.dt_t + d];
      }
    }
    __syncthreads();
    if (!active) continue;
    for (int tt = 0; tt < len; ++tt) {
      const int64_t t = t0 + tt;
      const float dtv = sDt[tt][threadIdx.x];
      const float dbx = dtv * sX[tt][threadIdx.x];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) {
          h[n] = expf(dtv * a[n]) * h[n] + dbx * sB[tt][n];
          acc += h[n] * sC[tt][n];
        }
      }
      yb[t * Di + d] = acc;
    }
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) hout[(b * Di + d) * N + n] = h[n];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* h0, void* y, void* hout, int B, int S,
           int Di, int N, const Strides& st, cudaStream_t stream) {
  const dim3 grid((Di + kThreads - 1) / kThreads, B);
  const auto* xp = static_cast<const T*>(x);
  const auto* dtp = static_cast<const float*>(dt);
  const auto* Ap = static_cast<const float*>(A);
  const auto* Bp = static_cast<const T*>(Bm);
  const auto* Cp = static_cast<const T*>(Cm);
  const auto* hp = static_cast<const float*>(h0);
  auto* yp = static_cast<float*>(y);
  auto* op = static_cast<float*>(hout);
#define SSM_LAUNCH(NM)                                                      \
  ssm_scan_kernel<T, NM><<<grid, kThreads, 0, stream>>>(xp, dtp, Ap, Bp, Cp, \
                                                        hp, yp, op, S, Di, N, st)
  if (N <= 4) SSM_LAUNCH(4);
  else if (N <= 8) SSM_LAUNCH(8);
  else if (N <= 16) SSM_LAUNCH(16);
  else SSM_LAUNCH(32);
#undef SSM_LAUNCH
  return int(cudaGetLastError());
}

}  // namespace

// x, Bm, Cm in `dtype` (0 f32, 1 bf16); dt, A, h0, y, hout f32. A and h0 and
// the outputs contiguous; x, dt, Bm, Cm addressed by the given (batch, time)
// strides with the last axis contiguous. Returns the launch's cudaError.
extern "C" int ssm_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* h0, void* y,
                        void* hout, int dtype, int B, int S, int Di, int N,
                        int64_t x_b, int64_t x_t, int64_t dt_b, int64_t dt_t,
                        int64_t b_b, int64_t b_t, int64_t c_b, int64_t c_t,
                        void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || Di <= 0 || N <= 0 || N > 32)
    return int(cudaErrorInvalidValue);
  const Strides st{x_b, x_t, dt_b, dt_t, b_b, b_t, c_b, c_t};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, dt, A, Bm, Cm, h0, y, hout, B, S, Di, N, st, s);
    case kBF16:
      return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, hout, B, S, Di, N, st, s);
    default: return int(cudaErrorInvalidValue);
  }
}
