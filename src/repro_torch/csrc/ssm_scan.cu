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
//    memory rate (340.5 MB, 0.102 ms at the serving prefill shape
//    (4, 1024, 8192, 16) with bf16 x / Bm / Cm), and
//  - exps: B * S * Di * N of them (536,870,912 there), each one MUFU ex2,
//    at 16 per SM per clock (0.128 ms at 1980 MHz).
// Each exp is an accurate expf: seven FP32-pipe instructions and a shift
// around its ex2, and the recurrence and the y term add four more, so
// instruction issue (128 lanes per SM per clock) is the floor in practice,
// above both (chip_smoke.py counts the SASS instructions per exp of the
// inner loop and reports that floor as fp32_issue_ms).
//
// What held the first design back (one thread per (batch, channel), all N
// states in its registers, 128 channels per CTA; measured on an H100,
// PERF.md, Findings): 256 CTAs of 4 warps at the serving shape, 7.8 warps
// per SM; per time step a chain of N dependent FFMAs for y, and the `n < N`
// guards compiled into a branch per state (19.6 SASS instructions per exp);
// loads and scan took turns between two __syncthreads.
//
// Design:
//  - kLanes (L = 4) lanes share one (batch, channel): lane j holds the
//    states n = j * NPL .. j * NPL + NPL - 1 (NPL = NMAX / L) and its slice of
//    A in registers. Each lane sums its partial y; every kLanes steps the
//    group reduce-scatters its kLanes x kLanes partials with
//    __shfl_xor_sync in log2 L rounds (`reduce_scatter`), so each lane ends
//    with the y of one step. The guards are compile-time: N == NMAX takes
//    the unmasked instance; other N the masked one. Every lane of a warp
//    runs every shuffle; lanes of channels past a ragged Di only skip their
//    loads and stores.
//  - A CTA is kChannels (64) consecutive channels of one batch row x L lanes
//    = 256 threads; grid (ceil(Di / 64), B). At the serving shape that is 512
//    CTAs, 4 per SM at <= 64 registers (the launch bound): the whole grid is
//    resident in one wave, 32 warps per SM.
//  - Time goes in tiles of kTile steps through a ring of kStages stages of
//    shared memory. At the start of tile k, thread 0 issues one TMA tensor
//    copy per input (x and dt: 64 channels x kTile steps; Bm and Cm: N x
//    kTile) for tile k + kStages - 1, counted in bytes on that stage's
//    mbarrier, and the CTA scans tile k meanwhile. At the tile's end the
//    CTA waits for the next stage, converts its bf16 B and C to f32 once
//    (the inner loop reads f32 B and C, NPL at a time), and meets at one
//    __syncthreads. Rows past S and channels past Di read as zeros.
//  - y: each lane writes its step's y into a shared tile (two, by tile
//    parity), and after the barrier thread 0 stores the tile with one TMA
//    tensor store (only its part inside (S, Di) is written).
//  - Why tensor copies: per-row bulk copies or cp.async pieces spread over
//    the threads cost each tile's boundary address arithmetic, spills and
//    per-lane loops of copies; with them the memory path took 0.11 ms of a
//    0.42 ms scan, against 0.02 ms with one copy per input and tile (the
//    sizing measurements on an H100, PERF.md, Findings).
//  - Alignment: a tensor map needs a 16-byte aligned base and strides and
//    rows of 16-byte multiples. An input that has none (Di = 100 in bf16:
//    200-byte rows; Bm / Cm as views at an odd column; N * size not a
//    multiple of 16; y rows when Di % 4 != 0) takes plain loads (or stores)
//    by every thread into the same stage, on the same path; the masked
//    instance loads Bm / Cm so, with zeros past N.
//  - Inputs are addressed by (batch, time) strides in elements, the last
//    axis contiguous. All offsets are 64-bit.
//  - exp is expf (CUDA's accurate single-precision exp, at most 2 ulp), not
//    the __expf intrinsic; no fast-math, no .ftz. The y sum runs in another
//    order than one thread's sequential sum: that is the one change in
//    rounding from the first design.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum : int { kF32 = 0, kBF16 = 1 };

constexpr int kLanes = 4;       // lanes per (batch, channel)
constexpr int kChannels = 64;   // channels per CTA
constexpr int kThreads = kLanes * kChannels;
constexpr int kTile = 32;       // time steps per stage
constexpr int kStages = 2;      // stages of the ring
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Strides {  // elements between consecutive batch rows / time steps
  int64_t x_b, x_t, dt_b, dt_t, b_b, b_t, c_b, c_t;
};

// Shared memory of one CTA: kStages stages of (x, dt, B and C as f32, B and
// C as loaded when they are bf16), two y tiles, the stages' mbarriers. Each
// part starts 128-byte aligned (a tensor copy's box).
template <typename T, int NMAX>
struct Layout {
  static constexpr int kNpl = NMAX / kLanes;  // states per lane
  static constexpr int kXBytes = kTile * kChannels * int(sizeof(T));
  static constexpr int kDtBytes = kTile * kChannels * 4;
  static constexpr int kBC = kTile * NMAX;  // values of each of B and C
  static constexpr int kBCBytes = kBC * 4;
  static constexpr int kRawBytes = sizeof(T) == 4 ? 0 : kBC * int(sizeof(T));
  static constexpr int kStageBytes = kXBytes + kDtBytes + 2 * kBCBytes + 2 * kRawBytes;
  static constexpr int kYBytes = kTile * kChannels * 4;
  static constexpr int kBarOffset = kStages * kStageBytes + 2 * kYBytes;
  static constexpr int kBytes = kBarOffset + 8 * kStages;
  // the launch bound: 1024 threads per SM (<= 64 registers) up to 4 states
  // a lane, else 512
  static constexpr int kMinBlocks = (kNpl <= 4 ? 1024 : 512) / kThreads;
  static_assert(kNpl >= 1, "NMAX must be at least kLanes");
  static_assert(kRawBytes % 128 == 0 && kXBytes % 128 == 0, "boxes 128-byte aligned");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// a box of a 3-D tensor map (c0 fastest) -> shared memory, counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// shared memory -> a box of a 3-D tensor map (the part inside the tensor)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// n consecutive floats of shared memory, 16-byte aligned for n % 4 == 0
template <int n>
__device__ __forceinline__ void load_row(const float* p, float (&v)[n]) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int i = 0; i < n; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else if constexpr (n == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) v[i] = p[i];
  }
}

// The group's sums of kLanes partials, one per step: lane j of the group
// holds p[u] for steps u = 0 .. kLanes - 1 and ends with the sum over the
// group's lanes for step j. Each xor round halves the steps a lane keeps:
// log2 kLanes rounds, kLanes - 1 shuffles in all (log2 kLanes per step when
// each step is reduced alone).
__device__ __forceinline__ float reduce_scatter(float (&p)[kLanes], int j) {
#pragma unroll
  for (int o = kLanes / 2; o >= 1; o /= 2) {
    const bool upper = j & o;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float send = upper ? p[i] : p[i + o];
      const float keep = upper ? p[i + o] : p[i];
      p[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  return p[0];
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* h0;
  float* y;
  float* hout;
  int S, Di, N;
  int tma_x, tma_dt, tma_bc, tma_y;  // which tensor maps were encoded
  Strides st;
};

// x (Di, S, B), dt (Di, S, B), Bm and Cm (N, S, B), y (Di, S, B) as 3-D
// tensor maps, c0 fastest
struct Maps {
  CUtensorMap x, dt, b, c, y;
};

template <typename T, int NMAX, bool kMasked>
__global__ void __launch_bounds__(kThreads, Layout<T, NMAX>::kMinBlocks)
ssm_scan_kernel(const Args args, const __grid_constant__ Maps maps) {
  using Lay = Layout<T, NMAX>;
  constexpr int kNpl = Lay::kNpl;
  constexpr bool kRaw = Lay::kRawBytes > 0;  // bf16 B / C: converted once a tile
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x;
  const int c = tid / kLanes, j = tid % kLanes;
  const int64_t b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int n_ch = min(kChannels, args.Di - d0);  // channels of this CTA
  const bool active = c < n_ch;
  const int64_t d = d0 + c;
  const int S = args.S, Di = args.Di, N = args.N;
  const bool tma_bc = args.tma_bc && !kMasked;  // the masked instance pads B / C
  const uint32_t bars = smem_u32(smem + Lay::kBarOffset);

  auto stage = [&](int s) { return smem + s * Lay::kStageBytes; };
  auto sx = [&](int s) { return reinterpret_cast<T*>(stage(s)); };
  auto sdt = [&](int s) { return reinterpret_cast<float*>(stage(s) + Lay::kXBytes); };
  auto sbc = [&](int s) {  // B then C, [t][NMAX] f32 each
    return reinterpret_cast<float*>(stage(s) + Lay::kXBytes + Lay::kDtBytes);
  };
  auto sraw = [&](int s) {  // B then C as loaded, when bf16
    return reinterpret_cast<T*>(stage(s) + Lay::kXBytes + Lay::kDtBytes + 2 * Lay::kBCBytes);
  };
  auto sy = [&](int k) {
    return reinterpret_cast<float*>(smem + kStages * Lay::kStageBytes + (k & 1) * Lay::kYBytes);
  };
  const int n_tiles = (S + kTile - 1) / kTile;

  // Tile k's x_t, dt_t, Bm_t and Cm_t into its stage: thread 0 issues one
  // tensor copy per input (boxes past S or Di read as zeros), counted in
  // bytes on the stage's mbarrier; an input without a tensor map (not
  // 16-byte aligned) takes plain loads by every thread.
  auto issue = [&](int k) {
    const int s = k % kStages, t0 = k * kTile, len = min(kTile, S - t0);
    if (tid == 0) {
      const uint32_t bar = bars + 8 * s;
      mbar_expect_tx(bar, (args.tma_x ? Lay::kXBytes : 0) + (args.tma_dt ? Lay::kDtBytes : 0) +
                              (tma_bc ? 2 * Lay::kBC * int(sizeof(T)) : 0));
      if (args.tma_x) tma_load(smem_u32(sx(s)), &maps.x, bar, d0, t0, int(b));
      if (args.tma_dt) tma_load(smem_u32(sdt(s)), &maps.dt, bar, d0, t0, int(b));
      if (tma_bc) {
        T* dst = kRaw ? sraw(s) : reinterpret_cast<T*>(sbc(s));
        tma_load(smem_u32(dst), &maps.b, bar, 0, t0, int(b));
        tma_load(smem_u32(dst + Lay::kBC), &maps.c, bar, 0, t0, int(b));
      }
    }
    const Strides st = args.st;
    if (!args.tma_x || !args.tma_dt) {
      const T* xs = static_cast<const T*>(args.x) + b * st.x_b + int64_t(t0) * st.x_t + d0;
      const float* dts = args.dt + b * st.dt_b + int64_t(t0) * st.dt_t + d0;
      for (int f = tid; f < len * n_ch; f += kThreads) {
        const int t = f / n_ch, cc = f - t * n_ch;
        if (!args.tma_x) sx(s)[t * kChannels + cc] = xs[t * st.x_t + cc];
        if (!args.tma_dt) sdt(s)[t * kChannels + cc] = dts[t * st.dt_t + cc];
      }
    }
    if (!tma_bc) {  // as f32, zero past N (the masked states)
      const T* Bs = static_cast<const T*>(args.Bm) + b * st.b_b + int64_t(t0) * st.b_t;
      const T* Cs = static_cast<const T*>(args.Cm) + b * st.c_b + int64_t(t0) * st.c_t;
      float* dst = sbc(s);
      for (int f = tid; f < Lay::kBC; f += kThreads) {
        const int t = f / NMAX, n = f % NMAX;
        const bool on = t < len && n < N;
        dst[f] = on ? to_f32(Bs[t * st.b_t + n]) : 0.f;
        dst[Lay::kBC + f] = on ? to_f32(Cs[t * st.c_t + n]) : 0.f;
      }
    }
  };
  // bf16 B and C of stage s, as copied, to f32 (four values a thread)
  auto convert = [&](int s) {
    if constexpr (kRaw) {
      if (tma_bc) {
        const T* src = sraw(s);
        float* dst = sbc(s);
        for (int f = 4 * tid; f < 2 * Lay::kBC; f += 4 * kThreads) {
          const uint2 u = *reinterpret_cast<const uint2*>(src + f);
          const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&u);
          *reinterpret_cast<float4*>(dst + f) = make_float4(
              __low2float(v[0]), __high2float(v[0]), __low2float(v[1]), __high2float(v[1]));
        }
      }
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float a[kNpl], h[kNpl];
#pragma unroll
  for (int k = 0; k < kNpl; ++k) {
    const int n = j * kNpl + k;
    const bool on = active && (!kMasked || n < N);
    a[k] = on ? args.A[d * N + n] : 0.f;
    h[k] = on ? args.h0[(b * Di + d) * N + n] : 0.f;
  }
  __syncthreads();  // barriers initialised
  for (int k = 0; k < kStages - 1 && k < n_tiles; ++k) issue(k);
  mbar_wait(bars, 0);
  convert(0);
  __syncthreads();  // tile 0 in place

  for (int k = 0; k < n_tiles; ++k) {
    const int s = k % kStages, t0 = k * kTile, len = min(kTile, S - t0);
    if (k + kStages - 1 < n_tiles) issue(k + kStages - 1);

    const T* px = sx(s) + c;
    const float* pdt = sdt(s) + c;
    const float* pb = sbc(s) + j * kNpl;
    const float* pc = pb + Lay::kBC;
    float* py = sy(k) + c;
    // one step of this lane's states; returns its partial y_t
    auto step = [&](int t) {
      const float dtv = pdt[t * kChannels];
      const float dbx = dtv * to_f32(px[t * kChannels]);
      float bv[kNpl], cv[kNpl], e[kNpl];
      load_row(pb + t * NMAX, bv);
      load_row(pc + t * NMAX, cv);
#pragma unroll
      for (int q = 0; q < kNpl; ++q) e[q] = expf(dtv * a[q]);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kNpl; ++q) {
        if (!kMasked || j * kNpl + q < N) {
          h[q] = e[q] * h[q] + dbx * bv[q];
          acc += h[q] * cv[q];
        }
      }
      return acc;
    };
    int t = 0;
    // kLanes steps at a time: each lane ends with the group's y of one step
#pragma unroll 2
    for (; t + kLanes <= len; t += kLanes) {
      float p[kLanes];
#pragma unroll
      for (int u = 0; u < kLanes; ++u) p[u] = step(t + u);
      py[(t + j) * kChannels] = reduce_scatter(p, j);
    }
    for (; t < len; ++t) {  // the rest of a ragged last tile
      float acc = step(t);
#pragma unroll
      for (int o = 1; o < kLanes; o <<= 1) acc += __shfl_xor_sync(kFull, acc, o);
      if (j == 0) py[t * kChannels] = acc;
    }

    if (k + 1 < n_tiles) {  // the next tile's stage: landed, B / C as f32
      mbar_wait(bars + 8 * ((k + 1) % kStages), ((k + 1) / kStages) & 1);
      convert((k + 1) % kStages);
    }
    if (args.tma_y) {
      // this thread's y, seen by the tensor store; thread 0's store of the
      // tile before has read the other y tile
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    __syncthreads();  // tile k's y complete; stage s free for tile k + kStages
    const float* ys = sy(k);
    if (args.tma_y) {  // rows past S and channels past Di are not written
      if (tid == 0) {
        tma_store(&maps.y, smem_u32(ys), d0, t0, int(b));
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    } else {
      float* yg = args.y + (b * S + t0) * int64_t(Di) + d0;
      for (int f = tid; f < len * kChannels; f += kThreads) {
        const int tt = f / kChannels, cc = f % kChannels;
        if (cc < n_ch) yg[int64_t(tt) * Di + cc] = ys[tt * kChannels + cc];
      }
    }
  }
  if (args.tma_y && tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

  if (active) {
#pragma unroll
    for (int k = 0; k < kNpl; ++k) {
      const int n = j * kNpl + k;
      if (n < N) args.hout[(b * Di + d) * N + n] = h[k];
    }
  }
}

// cuTensorMapEncodeTiled from the driver, fetched once through the runtime
// (no -lcuda at build time).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// (B, S, cols) at `ptr` with (batch, time) strides in elements and the last
// axis contiguous, as a 3-D map (cols, S, B) of boxes (box_cols, kTile, 1).
// False where a tensor map cannot take it: the base or a stride not 16-byte
// aligned, or a box row that is not a multiple of 16 bytes.
bool encode(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr, int B, int S,
            int cols, int64_t stride_b, int64_t stride_t, int box_cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || (reinterpret_cast<uintptr_t>(ptr) & 15) || (stride_b * elem) % 16 ||
      (stride_t * elem) % 16 || (int64_t(box_cols) * elem) % 16)
    return false;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(S), cuuint64_t(B)};
  // a stride of an axis of extent 1 is never stepped; keep it valid
  const cuuint64_t strides[2] = {cuuint64_t(stride_t * elem) ? cuuint64_t(stride_t * elem) : 16,
                                 cuuint64_t(stride_b * elem) ? cuuint64_t(stride_b * elem) : 16};
  const cuuint32_t box[3] = {cuuint32_t(box_cols), cuuint32_t(kTile), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int NMAX, bool kMasked>
cudaError_t prepare(int* ctas_per_sm) {
  const auto kern = ssm_scan_kernel<T, NMAX, kMasked>;
  constexpr int bytes = Layout<T, NMAX>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && ctas_per_sm)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kern, kThreads, bytes);
  return err;
}

template <typename T, int NMAX>
int launch_n(const Args& args, const Maps& maps, int B, cudaStream_t s) {
  const dim3 grid((args.Di + kChannels - 1) / kChannels, B);
  constexpr int bytes = Layout<T, NMAX>::kBytes;
  cudaError_t err;
  if (args.N == NMAX) {
    err = prepare<T, NMAX, false>(nullptr);
    if (err == cudaSuccess)
      ssm_scan_kernel<T, NMAX, false><<<grid, kThreads, bytes, s>>>(args, maps);
  } else {
    err = prepare<T, NMAX, true>(nullptr);
    if (err == cudaSuccess)
      ssm_scan_kernel<T, NMAX, true><<<grid, kThreads, bytes, s>>>(args, maps);
  }
  return int(err == cudaSuccess ? cudaGetLastError() : err);
}

template <typename T>
int launch(Args args, int B, cudaStream_t s) {
  constexpr int e = sizeof(T);
  constexpr CUtensorMapDataType type =
      e == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const Strides& st = args.st;
  const int S = args.S, Di = args.Di, N = args.N;
  Maps maps{};
  args.tma_x = encode(&maps.x, type, e, args.x, B, S, Di, st.x_b, st.x_t, kChannels);
  args.tma_dt = encode(&maps.dt, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, args.dt, B, S, Di,
                       st.dt_b, st.dt_t, kChannels);
  args.tma_bc = encode(&maps.b, type, e, args.Bm, B, S, N, st.b_b, st.b_t, N) &&
                encode(&maps.c, type, e, args.Cm, B, S, N, st.c_b, st.c_t, N);
  args.tma_y = encode(&maps.y, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, args.y, B, S, Di,
                      int64_t(S) * Di, Di, kChannels);
  if (N <= 4) return launch_n<T, 4>(args, maps, B, s);
  if (N <= 8) return launch_n<T, 8>(args, maps, B, s);
  if (N <= 16) return launch_n<T, 16>(args, maps, B, s);
  return launch_n<T, 32>(args, maps, B, s);
}

template <typename T, int NMAX, bool kMasked>
int config_instance(int* out) {
  int ctas = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = prepare<T, NMAX, kMasked>(&ctas);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, ssm_scan_kernel<T, NMAX, kMasked>);
  if (err != cudaSuccess) return int(err);
  const int cfg[9] = {kLanes, kChannels, kTile, kStages, kThreads, Layout<T, NMAX>::kBytes,
                      ctas, attr.numRegs, int(attr.localSizeBytes)};
  for (int i = 0; i < 9; ++i) out[i] = cfg[i];
  return 0;
}

template <typename T, int NMAX>
int config_n(int N, int* out) {
  return N == NMAX ? config_instance<T, NMAX, false>(out)
                   : config_instance<T, NMAX, true>(out);
}

template <typename T>
int config(int N, int* out) {
  if (N <= 4) return config_n<T, 4>(N, out);
  if (N <= 8) return config_n<T, 8>(N, out);
  if (N <= 16) return config_n<T, 16>(N, out);
  return config_n<T, 32>(N, out);
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
  const Args args{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm,
                  static_cast<const float*>(h0), static_cast<float*>(y),
                  static_cast<float*>(hout), S, Di, N, 0, 0, 0, 0,
                  Strides{x_b, x_t, dt_b, dt_t, b_b, b_t, c_b, c_t}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(args, B, s);
    case kBF16: return launch<__nv_bfloat16>(args, B, s);
    default: return int(cudaErrorInvalidValue);
  }
}

// The design's choice for inputs of `dtype` with N states, on the current
// device: {lanes per channel, channels per CTA, tile (time steps), stages,
// threads per CTA, dynamic shared bytes, resident CTAs per SM (the occupancy
// query's), registers per thread, local (spill) bytes per thread}.
extern "C" int ssm_scan_config(int dtype, int N, int* out) {
  if (N <= 0 || N > 32) return int(cudaErrorInvalidValue);
  switch (dtype) {
    case kF32: return config<float>(N, out);
    case kBF16: return config<__nv_bfloat16>(N, out);
    default: return int(cudaErrorInvalidValue);
  }
}
