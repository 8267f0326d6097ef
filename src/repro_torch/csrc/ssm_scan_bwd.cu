// K7-bwd ssm_scan_bwd: the backward of the Mamba-1 selective scan (K7,
// csrc/ssm_scan.cu) for Hopper (sm_90a).
//
//   forward   h_t = da_t * h_{t-1} + (dt_t * x_t) * B_t,  da_t = exp(dt_t * A)
//             y_t = sum_n h_t[:, n] * C_t[n]                h_{-1} = h0
//   backward  the state adjoint g (Di, N) per batch starts at dh; for
//             t = S-1 .. 0:
//               g += dy_t C_t
//               dC_t = sum_d dy_t h_t            dB_t = sum_d g dt_t x_t
//               dx_t = dt_t sum_n g B_t          ddt_t = sum_n g (A da_t h_{t-1} + x_t B_t)
//               dA += sum_b g dt_t da_t h_{t-1}  g = da_t g
//             and dh0 = g.
//
// Inputs: those of K7 (x, Bm, Cm f32 or bf16, one dtype for the three; dt,
// A, h0 f32; x, dt, Bm, Cm addressed by (batch, time) strides with the last
// axis contiguous), dy (B, S, Di) f32 contiguous and dh (B, Di, N) f32 or
// null for none. Outputs, new and contiguous: dx (B, S, Di) in x's dtype,
// ddt (B, S, Di) f32, dA (Di, N) f32, dBm and dCm (B, S, N) in Bm's dtype,
// dh0 (B, Di, N) f32. The arithmetic is f32.
//
// Replaces no Pallas kernel: the JAX package differentiates its
// `mamba.selective_scan` (a chunked associative scan under jax.checkpoint)
// with jax.grad. This is the backward that `kernels/ops.py::ssm_scan` takes
// under autograd on the card; `kernels/ref.py::ssm_scan_bwd_ref` is its
// plain version.
//
// What bounds it: the larger of
//  - exps: the states have to be recomputed (K7 returns only the final
//    one), so at least 2 * B * S * Di * N exps (forward and reverse), 134.2
//    M at the falcon-mamba-7b train shape (2, 256, 8192, 16), and
//  - bytes: x, dt and dy read and dx and ddt written (Bm, Cm, A, h0, dh
//    and their gradients are small beside them), 84 MB there in f32.
//
// Design (simple and right first, not yet fast):
//  - Two kernels, launched together by `ssm_scan_bwd`. The scan kernel: one
//    thread per (batch, channel) with its N states, their A and adjoints
//    in registers; a CTA is one warp of 32 consecutive channels of one
//    batch row, grid (ceil(Di / 32), B).
//  - States come back in reverse by recomputation. Pass 1 re-runs the
//    forward from h0 and keeps the state at the start of every tile of
//    kTile steps in the scratch `ckpt` (B, n_tiles, N, Di) f32 (coalesced
//    over the channels). Pass 2 walks the tiles from the last to the first:
//    it recomputes the tile's kTile + 1 states from its checkpoint into
//    shared memory (the lane's column of (kTile + 1, NMAX, 32) floats), then
//    sweeps the tile backward. Each exp is computed three times (pass 1,
//    the recomputation, the sweep). The state is never recovered by
//    dividing h_t - db_t by da_t, which fails where da_t underflows.
//  - Each tile's x, dt, dy (one value per lane and step) and B, C (NMAX per
//    step, shared by the warp) are staged in shared memory first, their
//    loads issued together.
//  - Sums without atomics, so two launches give the same bits: dB_t and
//    dC_t sum over the channels, first over the warp's 32 with a
//    __shfl_xor_sync butterfly (every lane ends with the same bits), and
//    lane n writes the warp's sums of state n into the scratch `part_bc`
//    (B, S, ceil(Di / 32), 2, N); dA is summed per thread over t and
//    written as `part_a` (B, Di, N). The finish kernel then sums part_bc
//    over the channel blocks and part_a over the batch, each in a fixed
//    order, into dBm, dCm and dA.
//  - Scratch bytes: 4 * (B * ceil(S / kTile) * N * Di + 2 * B * S *
//    ceil(Di / 32) * N + B * Di * N): 34.6 MB at the train shape (2, 256,
//    8192, 16), 270.5 MB at the serving prefill's (4, 1024, 8192, 16).
//  - Channels past a ragged Di compute on zeros and load and store nothing,
//    so every lane runs every shuffle. exp is expf, as in K7. All offsets
//    into the inputs are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum : int { kF32 = 0, kBF16 = 1 };

constexpr int kLanes = 32;      // channels per CTA: one warp
constexpr int kTile = 16;       // time steps per tile
constexpr int kFinishThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The sum over the warp, the same bits in every lane (each round adds the
// same two values in each pair of lanes).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* h0;
  const float* dy;
  const float* dh;  // null: no cotangent of the final state
  void* dx;
  float* ddt;
  float* dh0;
  float* ckpt;     // (B, n_tiles, N, Di)
  float* part_bc;  // (B, S, n_cb, 2, N)
  float* part_a;   // (B, Di, N)
  int S, Di, N;
  int64_t x_b, x_t, dt_b, dt_t, b_b, b_t, c_b, c_t;
};

// Dynamic shared floats of one CTA: the stash of kTile + 1 states, x, dt and
// dy of a tile (one per lane and step), B and C of a tile (NMAX per step).
template <int NMAX>
constexpr int smem_floats() {
  return (kTile + 1) * NMAX * kLanes + 3 * kTile * kLanes + 2 * kTile * NMAX;
}

template <typename T, int NMAX>
__global__ void __launch_bounds__(kLanes)
ssm_scan_bwd_kernel(const Args args) {
  extern __shared__ float smem[];
  float* stash = smem;                               // [(tt * NMAX + n) * 32 + lane]
  float* xs = stash + (kTile + 1) * NMAX * kLanes;   // [tt * 32 + lane]
  float* dts = xs + kTile * kLanes;
  float* dys = dts + kTile * kLanes;
  float* bs = dys + kTile * kLanes;                  // [tt * NMAX + n]
  float* cs = bs + kTile * NMAX;

  const int S = args.S, Di = args.Di, N = args.N;
  const int lane = threadIdx.x;
  const int cb = blockIdx.x;
  const int n_cb = gridDim.x;
  const int64_t b = blockIdx.y;
  const int d = cb * kLanes + lane;
  const bool live = d < Di;
  const int n_tiles = (S + kTile - 1) / kTile;
  const T* x = static_cast<const T*>(args.x) + b * args.x_b + d;
  const float* dt = args.dt + b * args.dt_b + d;
  const float* dy = args.dy + b * int64_t(S) * Di + d;
  const T* Bm = static_cast<const T*>(args.Bm) + b * args.b_b;
  const T* Cm = static_cast<const T*>(args.Cm) + b * args.c_b;
  const int64_t bd = (b * Di + d) * N;  // (b, d, 0) of h0, dh, dh0, part_a

  // Stage steps t0 .. t0 + len - 1: x, dt (and dy) per lane, B and C per state.
  auto load_tile = [&](int t0, int len, bool with_dy) {
    __syncwarp();  // every lane is done with the previous tile's B and C
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      if (tt < len) {
        const int64_t t = t0 + tt;
        xs[tt * kLanes + lane] = live ? to_f32(x[t * args.x_t]) : 0.0f;
        dts[tt * kLanes + lane] = live ? dt[t * args.dt_t] : 0.0f;
        if (with_dy) dys[tt * kLanes + lane] = live ? dy[t * Di] : 0.0f;
      }
    }
    for (int j = lane; j < len * NMAX; j += kLanes) {
      const int tt = j / NMAX, n = j - tt * NMAX;
      const int64_t t = t0 + tt;
      bs[j] = n < N ? to_f32(Bm[t * args.b_t + n]) : 0.0f;
      cs[j] = n < N ? to_f32(Cm[t * args.c_t + n]) : 0.0f;
    }
    __syncwarp();
  };

  float A[NMAX], h[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    A[n] = live && n < N ? args.A[int64_t(d) * N + n] : 0.0f;
    h[n] = live && n < N ? args.h0[bd + n] : 0.0f;
  }

  // Pass 1: the forward from h0, keeping the state at each tile's start.
  float* ckpt = args.ckpt + b * int64_t(n_tiles) * N * Di + d;
  for (int k = 0; k < n_tiles; ++k) {
    if (live) {
#pragma unroll
      for (int n = 0; n < NMAX; ++n)
        if (n < N) ckpt[(int64_t(k) * N + n) * Di] = h[n];
    }
    if (k == n_tiles - 1) break;
    load_tile(k * kTile, kTile, false);
    for (int tt = 0; tt < kTile; ++tt) {
      const float dtv = dts[tt * kLanes + lane];
      const float dbx = dtv * xs[tt * kLanes + lane];
#pragma unroll
      for (int n = 0; n < NMAX; ++n)
        if (n < N) h[n] = expf(dtv * A[n]) * h[n] + dbx * bs[tt * NMAX + n];
    }
  }

  // Pass 2: the tiles in reverse, each recomputed from its checkpoint.
  float g[NMAX], dA[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    g[n] = live && n < N && args.dh ? args.dh[bd + n] : 0.0f;
    dA[n] = 0.0f;
  }
  for (int k = n_tiles - 1; k >= 0; --k) {
    const int t0 = k * kTile;
    const int len = S - t0 < kTile ? S - t0 : kTile;
    load_tile(t0, len, true);
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
        h[n] = live ? ckpt[(int64_t(k) * N + n) * Di] : 0.0f;
        stash[n * kLanes + lane] = h[n];
      }
    }
    for (int tt = 0; tt < len; ++tt) {
      const float dtv = dts[tt * kLanes + lane];
      const float dbx = dtv * xs[tt * kLanes + lane];
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) {
          h[n] = expf(dtv * A[n]) * h[n] + dbx * bs[tt * NMAX + n];
          stash[((tt + 1) * NMAX + n) * kLanes + lane] = h[n];
        }
      }
    }
    for (int tt = len - 1; tt >= 0; --tt) {
      const int64_t t = t0 + tt;
      const float dyv = dys[tt * kLanes + lane];
      const float xv = xs[tt * kLanes + lane];
      const float dtv = dts[tt * kLanes + lane];
      const float dbx = dtv * xv;
      float sx = 0.0f, sdt = 0.0f, my_b = 0.0f, my_c = 0.0f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) {
          const float ht = stash[((tt + 1) * NMAX + n) * kLanes + lane];
          const float hp = stash[(tt * NMAX + n) * kLanes + lane];
          const float bn = bs[tt * NMAX + n], cn = cs[tt * NMAX + n];
          const float da = expf(dtv * A[n]);
          g[n] += dyv * cn;
          const float sum_c = warp_sum(dyv * ht);
          const float sum_b = warp_sum(g[n] * dbx);
          if (lane == n) {
            my_b = sum_b;
            my_c = sum_c;
          }
          sx += g[n] * bn;
          const float dah = da * hp;
          sdt += g[n] * (A[n] * dah + xv * bn);
          dA[n] += g[n] * dtv * dah;
          g[n] *= da;
        }
      }
      if (live) {
        const int64_t o = (b * S + t) * Di + d;
        store(static_cast<T*>(args.dx) + o, dtv * sx);
        args.ddt[o] = sdt;
      }
      if (lane < N) {
        float* p = args.part_bc + (((b * S + t) * n_cb + cb) * 2) * N + lane;
        p[0] = my_b;
        p[N] = my_c;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
        args.dh0[bd + n] = g[n];
        args.part_a[bd + n] = dA[n];
      }
    }
  }
}

// dBm / dCm (b, t, n) = the sum over the channel blocks of part_bc, in
// order; dA (d, n) = the sum over the batch of part_a, in order.
template <typename T>
__global__ void __launch_bounds__(kFinishThreads)
ssm_scan_bwd_finish(const float* __restrict__ part_bc, const float* __restrict__ part_a,
                    T* __restrict__ dBm, T* __restrict__ dCm, float* __restrict__ dA,
                    int B, int S, int Di, int N, int n_cb) {
  const int64_t i = int64_t(blockIdx.x) * kFinishThreads + threadIdx.x;
  const int64_t n_bc = int64_t(B) * S * 2 * N;
  if (i < n_bc) {
    const int64_t n = i % N, rest = i / N, which = rest % 2, bt = rest / 2;
    const float* p = part_bc + bt * n_cb * 2 * N + which * N + n;
    float s = 0.0f;
    for (int c = 0; c < n_cb; ++c) s += p[int64_t(c) * 2 * N];
    store((which ? dCm : dBm) + bt * N + n, s);
  } else if (i - n_bc < int64_t(Di) * N) {
    const int64_t j = i - n_bc;
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s += part_a[int64_t(b) * Di * N + j];
    dA[j] = s;
  }
}

template <typename T, int NMAX>
int launch_n(const Args& args, int B, T* dBm, T* dCm, float* dA, cudaStream_t s) {
  const int n_cb = (args.Di + kLanes - 1) / kLanes;
  constexpr int bytes = smem_floats<NMAX>() * 4;
  const auto kern = ssm_scan_bwd_kernel<T, NMAX>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return int(err);
  kern<<<dim3(n_cb, B), kLanes, bytes, s>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int64_t total = int64_t(B) * args.S * 2 * args.N + int64_t(args.Di) * args.N;
  ssm_scan_bwd_finish<T><<<unsigned((total + kFinishThreads - 1) / kFinishThreads),
                           kFinishThreads, 0, s>>>(args.part_bc, args.part_a, dBm, dCm, dA,
                                                   B, args.S, args.Di, args.N, n_cb);
  return int(cudaGetLastError());
}

template <typename T>
int launch(const Args& args, int B, void* dBm, void* dCm, float* dA, cudaStream_t s) {
  T* db = static_cast<T*>(dBm);
  T* dc = static_cast<T*>(dCm);
  if (args.N <= 4) return launch_n<T, 4>(args, B, db, dc, dA, s);
  if (args.N <= 8) return launch_n<T, 8>(args, B, db, dc, dA, s);
  if (args.N <= 16) return launch_n<T, 16>(args, B, db, dc, dA, s);
  return launch_n<T, 32>(args, B, db, dc, dA, s);
}

}  // namespace

// The scratch floats `ssm_scan_bwd` needs, in order: ckpt (B, ceil(S /
// kTile), N, Di), part_bc (B, S, ceil(Di / 32), 2, N), part_a (B, Di, N).
extern "C" int64_t ssm_scan_bwd_scratch(int B, int S, int Di, int N, int64_t* parts) {
  parts[0] = int64_t(B) * ((S + kTile - 1) / kTile) * N * Di;
  parts[1] = int64_t(B) * S * ((Di + kLanes - 1) / kLanes) * 2 * N;
  parts[2] = int64_t(B) * Di * N;
  return parts[0] + parts[1] + parts[2];
}

// x, Bm, Cm, dx, dBm, dCm in `dtype` (0 f32, 1 bf16); the rest f32. x, dt,
// Bm, Cm addressed by the given (batch, time) strides with the last axis
// contiguous; A, h0, dy, dh (null: none) and the outputs contiguous;
// `scratch` holds ssm_scan_bwd_scratch's floats. Launches the scan kernel
// and the finish kernel on `stream`; returns the first cudaError.
extern "C" int ssm_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* h0, const void* dy, const void* dh,
                            void* dx, void* ddt, void* dA, void* dBm, void* dCm, void* dh0,
                            void* scratch, int dtype, int B, int S, int Di, int N,
                            int64_t x_b, int64_t x_t, int64_t dt_b, int64_t dt_t,
                            int64_t b_b, int64_t b_t, int64_t c_b, int64_t c_t,
                            void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || Di <= 0 || N <= 0 || N > 32)
    return int(cudaErrorInvalidValue);
  int64_t parts[3];
  ssm_scan_bwd_scratch(B, S, Di, N, parts);
  float* ckpt = static_cast<float*>(scratch);
  const Args args{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm,
                  static_cast<const float*>(h0), static_cast<const float*>(dy),
                  static_cast<const float*>(dh), dx, static_cast<float*>(ddt),
                  static_cast<float*>(dh0), ckpt, ckpt + parts[0], ckpt + parts[0] + parts[1],
                  S, Di, N, x_b, x_t, dt_b, dt_t, b_b, b_t, c_b, c_t};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* da = static_cast<float*>(dA);
  switch (dtype) {
    case kF32: return launch<float>(args, B, dBm, dCm, da, s);
    case kBF16: return launch<__nv_bfloat16>(args, B, dBm, dCm, da, s);
    default: return int(cudaErrorInvalidValue);
  }
}
