// Elementwise kernels of the fused flat-buffer exchange for Hopper (sm_90a):
//
//   K2 eq1_merge        paper Eq. (1) over an arena,
//                       (s2 * x_local + p * x_stale) / (s2 + p), f32 math,
//                       output in the arena's dtype (f32 or bf16)
//   K3 bf16_pack        arena -> bf16 wire buffer, round to nearest even
//   K4 bf16_unpack      bf16 wire buffer -> arena dtype (exact)
//   K5 quantize_int8    arena -> int8 wire values + one f32 scale per block
//                       of the trailing axis, scale = max(absmax, 1e-12)/127,
//                       round half to even or floor(v + u) from caller bits,
//                       the sum taken exactly
//   K6 dequantize_int8  int8 values * their block's scale -> f32
//
// Replace the Pallas TPU kernels of repro/kernels/comm_kernels.py:
// `_eq1_kernel` (wrapper `eq1_merge`), `_cast_kernel` (wrappers `bf16_pack`
// and `bf16_unpack`), `_quantize_kernel` (wrapper `quantize_int8`) and
// `_dequantize_kernel` (wrapper `dequantize_int8`). K3 and K4 are instances
// of one cast op, as on the TPU.
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
//  - K2 to K4 stream the arena as one flat range through one skeleton,
//    `stream_ring_kernel<Op>`, instantiated for Eq. (1) (two inputs) and for
//    the cast (one input). A persistent grid holds the CTAs that fit on the
//    card in one wave (SMs x the residency the occupancy query gives for the
//    ring's shared memory). Indices are 64-bit (the training arena holds
//    2.02e9 elements, 94 % of INT32_MAX).
//  - In each CTA one thread of a producer warp keeps as many chunks of
//    kChunkBytes per input in flight as kRingBytes of shared memory hold,
//    with TMA bulk copies (`cp.async.bulk`), each stage's arrival counted
//    on its `mbarrier`. Eight consumer warps compute a stage from shared
//    memory into its output slot (the first input's slot where the element
//    sizes match), fence it for the async proxy, meet at a named barrier,
//    and one of them writes the slot back with a bulk store. The slot goes
//    back to the producer once that store has read it
//    (`cp.async.bulk.wait_group.read`), one chunk later, so the store
//    overlaps the next chunk.
//  - The producers take chunks in order from one ticket counter per launch,
//    so the whole grid streams one narrow window of the arena. Dealt
//    round-robin, the CTAs drift apart and with them the DRAM pages they
//    touch: on the card that cost K2 4 % and K3 3 %, and an L2 evict-first
//    hint on the copies cost 2 to 3 % more (PERF.md, Findings).
//  - What held the earlier grid-stride kernels back was neither registers
//    (32 for K2, 8 CTAs per SM, one wave) nor the division (a reciprocal
//    multiply gained 1.6 %): too few bytes in flight per SM and default
//    caching, and, once those were fixed, the drift above.
//  - Bulk copies need 16-byte aligned addresses and sizes. Where x, (y) and
//    out reach 16-byte alignment at the same element, a scalar head brings
//    them there, the ring takes the rest in multiples of eight elements and
//    a scalar tail (under eight) finishes the range. Where they do not (an
//    offset view against a fresh output), the whole range takes a scalar
//    grid-stride loop, `stream_loop_kernel<Op>`, on the same entry point.
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
//  - Subnormals are kept (no .ftz form anywhere, nvcc's default -ftz=false),
//    as the plain versions keep them under IEEE arithmetic. XLA on the CPU
//    (and the TPU) flushes subnormal inputs and results of Eq. (1) and of
//    the replica mean to zero, so the JAX reference differs there; the port
//    keeps IEEE subnormals (ROADMAP §3).
//  - The kernels allocate nothing, launch on the caller's stream and return
//    the launch's cudaError.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kPack = 8;  // elements per thread and step: 16 bytes of bf16, 32 of f32
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

// -- K2 to K4: the ops the stream kernels apply -------------------------------

// K2: Eq. (1) over two arenas of one dtype.
template <typename T>
struct Eq1Merge {
  using In = T;
  using Out = T;
  static constexpr int kInputs = 2;
  float s2, p, denom;
  __device__ __forceinline__ Out one(In x, In y) const {
    return from_float<T>(eq1(to_float(x), to_float(y), s2, p, denom));
  }
  __device__ __forceinline__ void pack(const In* x, const In* y, Out* out) const {
    float a[kPack], b[kPack];
    load8(x, a);
    load8(y, b);
#pragma unroll
    for (int k = 0; k < kPack; ++k) a[k] = eq1(a[k], b[k], s2, p, denom);
    store8(out, a);
  }
};

// K3 / K4: the cast between an arena dtype and the bf16 wire (y unused).
template <typename I, typename O>
struct Cast {
  using In = I;
  using Out = O;
  static constexpr int kInputs = 1;
  __device__ __forceinline__ Out one(In x, In) const { return from_float<O>(to_float(x)); }
  __device__ __forceinline__ void pack(const In* x, const In*, Out* out) const {
    float a[kPack];
    load8(x, a);
    store8(out, a);
  }
};

// One flat range: out[i] = op(x[i], y[i]) for i < n. The ring takes
// [head, head + body); the scalar path the head and [head + body, n).
template <typename Op>
struct Stream {
  const typename Op::In* x;
  const typename Op::In* y;  // K2's second input; null for the cast
  typename Op::Out* out;
  int64_t n, head, body;
  unsigned long long* ticket;  // the ring's next chunk, zero at launch
};

template <typename Op>
__device__ __forceinline__ void scalar_step(const Stream<Op>& st, const Op& op, int64_t i) {
  st.out[i] = op.one(st.x[i], Op::kInputs == 2 ? st.y[i] : st.x[i]);
}

// -- the ring: TMA bulk copies, mbarriers, a named barrier ---------------------

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kRingThreads = kConsumers + 32;  // and one producer warp
constexpr int kChunkBytes = 16384;             // per input and stage
constexpr int kRingBytes = 196608;             // a CTA's stages: as many as fit
constexpr int kConsumerBarrier = 1;            // named barrier of the consumers

template <typename Op>
struct Ring {
  using In = typename Op::In;
  using Out = typename Op::Out;
  static constexpr int kChunk = kChunkBytes / sizeof(In);  // elements, a multiple of kPack
  static constexpr bool kInPlace = sizeof(Out) == sizeof(In);
  static constexpr int kOutBytes = kInPlace ? 0 : kChunk * sizeof(Out);
  static constexpr int kStageBytes = Op::kInputs * kChunkBytes + kOutBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;
  // the stages, then per stage a full and an empty mbarrier and its chunk
  static constexpr int kSmemBytes = kStages * (kStageBytes + 3 * 8);
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
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

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <typename Op>
__global__ void __launch_bounds__(kRingThreads)
stream_ring_kernel(const Stream<Op> st, const Op op) {
  using R = Ring<Op>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t full = smem_u32(smem + R::kStages * R::kStageBytes);
  const uint32_t empty = full + 8 * R::kStages;
  // each stage's chunk, written by the producer before the stage's arrival
  int64_t* chunk_of = reinterpret_cast<int64_t*>(smem + R::kStages * (R::kStageBytes + 16));
  const int64_t n_chunks = (st.body + R::kChunk - 1) / R::kChunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    // ---- producer: one thread keeps the ring's stages loading ----
    if (threadIdx.x == 0) {
      for (int k = 0;; ++k) {
        const int s = k % R::kStages;
        if (k >= R::kStages) mbar_wait(empty + 8 * s, (k / R::kStages - 1) & 1);
        const int64_t c = int64_t(atomicAdd(st.ticket, 1ull));
        chunk_of[s] = c;
        if (c >= n_chunks) {  // none left: the stage tells the consumers so
          mbar_arrive(full + 8 * s);
          break;
        }
        const int64_t first = st.head + c * R::kChunk;
        const int64_t left = st.body - c * R::kChunk;
        const uint32_t bytes = uint32_t(left < R::kChunk ? left : R::kChunk) * sizeof(typename R::In);
        const uint32_t slot = smem_u32(smem + s * R::kStageBytes);
        mbar_expect_tx(full + 8 * s, Op::kInputs * bytes);
        bulk_load(slot, st.x + first, bytes, full + 8 * s);
        if constexpr (Op::kInputs == 2)
          bulk_load(slot + kChunkBytes, st.y + first, bytes, full + 8 * s);
      }
    }
    return;
  }

  // ---- consumers ----
  const int ct = threadIdx.x - 32;
  if (blockIdx.x == gridDim.x - 1) {  // the scalar head and tail
    for (int64_t i = ct; i < st.head; i += kConsumers) scalar_step(st, op, i);
    for (int64_t i = st.head + st.body + ct; i < st.n; i += kConsumers) scalar_step(st, op, i);
  }
  for (int k = 0;; ++k) {
    const int s = k % R::kStages;
    mbar_wait(full + 8 * s, (k / R::kStages) & 1);
    const int64_t c = chunk_of[s];
    if (c >= n_chunks) break;
    const int64_t left = st.body - c * R::kChunk;
    const int len = int(left < R::kChunk ? left : R::kChunk);
    uint8_t* slot = smem + s * R::kStageBytes;
    const auto* a = reinterpret_cast<const typename R::In*>(slot);
    const auto* b = reinterpret_cast<const typename R::In*>(slot + kChunkBytes);
    auto* o = reinterpret_cast<typename R::Out*>(
        R::kInPlace ? slot : slot + Op::kInputs * kChunkBytes);
    for (int i = ct; i < len / kPack; i += kConsumers)
      op.pack(a + i * kPack, b + i * kPack, o + i * kPack);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" :: "r"(kConsumerBarrier), "r"(kConsumers) : "memory");
    if (ct == 0) {
      bulk_store(st.out + st.head + c * R::kChunk, smem_u32(o),
                 uint32_t(len) * sizeof(typename R::Out));
      if (k > 0) {  // the previous chunk's slot is read out: hand it back
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        mbar_arrive(empty + 8 * ((k - 1) % R::kStages));
      }
    }
  }
  if (ct == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The range where x, (y) and out are not 16-byte aligned at one element.
template <typename Op>
__global__ void __launch_bounds__(kThreads)
stream_loop_kernel(const Stream<Op> st, const Op op) {
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < st.n; i += stride)
    scalar_step(st, op, i);
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
  if constexpr (kStochastic)  // u = top 24 bits * 2^-24; v + u is exact in f64, where
    // f32 rounds v = -127, u = 1 - 2^-24 up to -126, an error over the scale
    q = float(floor(__dadd_rn(double(v), double(bits >> 8) * 0x1p-24)));
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

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// The ring's chunk tickets: each launch takes the next of kTicketSlots
// counters and zeroes it on its own stream, so launches in flight on other
// streams count on counters of their own.
constexpr int kTicketSlots = 64;
__device__ unsigned long long g_tickets[kTicketSlots];
std::atomic<unsigned> g_next_ticket{0};

cudaError_t take_ticket(cudaStream_t s, unsigned long long** ticket) {
  void* base = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&base, g_tickets);
  if (err != cudaSuccess) return err;
  *ticket = static_cast<unsigned long long*>(base) + g_next_ticket.fetch_add(1) % kTicketSlots;
  return cudaMemsetAsync(*ticket, 0, sizeof(**ticket), s);
}

// The ring's CTAs per SM at its shared memory, or a negative cudaError.
template <typename Op>
int ring_residency() {
  using R = Ring<Op>;
  cudaError_t err = cudaFuncSetAttribute(
      stream_ring_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmemBytes);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, stream_ring_kernel<Op>,
                                                        kRingThreads, R::kSmemBytes);
  if (err == cudaSuccess && ctas < 1) err = cudaErrorInvalidConfiguration;
  return err == cudaSuccess ? ctas : -int(err);
}

// One wave: every chunk's CTA resident at once, or fewer CTAs than that.
int ring_grid(int64_t body, int chunk, int ctas_per_sm) {
  const int64_t n_chunks = (body + chunk - 1) / chunk;
  const int64_t wave = int64_t(sm_count()) * ctas_per_sm;
  return int(n_chunks < 1 ? 1 : (n_chunks < wave ? n_chunks : wave));
}

template <typename Op>
int launch_stream(const void* x, const void* y, void* out, int64_t n, const Op op,
                  cudaStream_t s) {
  using R = Ring<Op>;
  using In = typename R::In;
  using Out = typename R::Out;
  Stream<Op> st{static_cast<const In*>(x), static_cast<const In*>(y),
                static_cast<Out*>(out), n, 0, 0, nullptr};
  // the head: elements before x is 16-byte aligned; the ring needs y and out
  // aligned at the same element
  const uintptr_t mis = reinterpret_cast<uintptr_t>(x) % 16;
  const int64_t head = int64_t((16 - mis) % 16 / sizeof(In));
  st.head = head < n ? head : n;
  const bool ring = mis % sizeof(In) == 0 && aligned(st.out + st.head, 16) &&
                    (Op::kInputs == 1 || aligned(st.y + st.head, 16));
  if (!ring) {
    const int64_t want = (n + kThreads - 1) / kThreads;
    const int64_t cap = int64_t(sm_count()) * kBlocksPerSm;
    stream_loop_kernel<Op><<<int(want < cap ? want : cap), kThreads, 0, s>>>(st, op);
    return int(cudaGetLastError());
  }
  st.body = (n - st.head) / kPack * kPack;
  const int ctas = ring_residency<Op>();
  if (ctas < 0) return -ctas;
  const cudaError_t err = take_ticket(s, &st.ticket);
  if (err != cudaSuccess) return int(err);
  stream_ring_kernel<Op><<<ring_grid(st.body, R::kChunk, ctas), kRingThreads,
                           R::kSmemBytes, s>>>(st, op);
  return int(cudaGetLastError());
}

// {chunk bytes per input, chunk elements, stages, CTAs per SM, dynamic
// shared bytes, grid} of the ring for n elements whose x, (y) and out are
// 16-byte aligned.
template <typename Op>
int ring_config(int64_t n, int* out) {
  using R = Ring<Op>;
  const int ctas = ring_residency<Op>();
  if (ctas < 0) return -ctas;
  const int cfg[6] = {kChunkBytes, R::kChunk, R::kStages, ctas, R::kSmemBytes,
                      ring_grid(n / kPack * kPack, R::kChunk, ctas)};
  for (int i = 0; i < 6; ++i) out[i] = cfg[i];
  return 0;
}

int warp_grid(int64_t n_blocks) {
  const int64_t want = (n_blocks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t cap = int64_t(sm_count()) * kBlocksPerSm;
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

using Bf16 = __nv_bfloat16;

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Each entry point returns the
// launch's cudaError (0 on success); n must be > 0.

extern "C" int eq1_merge(const void* x, const void* y, void* out, int64_t n,
                         int dtype, float s2, float p, float denom, void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_stream(x, y, out, n, Eq1Merge<float>{s2, p, denom}, s);
    case kBF16: return launch_stream(x, y, out, n, Eq1Merge<Bf16>{s2, p, denom}, s);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" int bf16_pack(const void* x, void* out, int64_t n, int in_dtype,
                         void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case kF32: return launch_stream(x, nullptr, out, n, Cast<float, Bf16>{}, s);
    case kBF16: return launch_stream(x, nullptr, out, n, Cast<Bf16, Bf16>{}, s);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" int bf16_unpack(const void* x, void* out, int64_t n, int out_dtype,
                           void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case kF32: return launch_stream(x, nullptr, out, n, Cast<Bf16, float>{}, s);
    case kBF16: return launch_stream(x, nullptr, out, n, Cast<Bf16, Bf16>{}, s);
    default: return int(cudaErrorInvalidValue);
  }
}

// The ring's choice (see ring_config) for entry 0 = eq1_merge at `dtype`,
// 1 = bf16_pack from `dtype`, 2 = bf16_unpack into `dtype`, at n elements.
extern "C" int stream_ring_config(int entry, int dtype, int64_t n, int* out) {
  if (n <= 0 || (dtype != kF32 && dtype != kBF16)) return int(cudaErrorInvalidValue);
  const bool f32 = dtype == kF32;
  switch (entry) {
    case 0: return f32 ? ring_config<Eq1Merge<float>>(n, out) : ring_config<Eq1Merge<Bf16>>(n, out);
    case 1: return f32 ? ring_config<Cast<float, Bf16>>(n, out) : ring_config<Cast<Bf16, Bf16>>(n, out);
    case 2: return f32 ? ring_config<Cast<Bf16, float>>(n, out) : ring_config<Cast<Bf16, Bf16>>(n, out);
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
