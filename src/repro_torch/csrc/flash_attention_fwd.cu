// Flash attention forward for Hopper (sm_90a): bf16 on the tensor cores,
// f32 on the CUDA cores. f32 running max / denominator / accumulator; the
// output has the inputs' dtype.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::_fwd_kernel
// and computes what it computes: causal (and sliding-window) GQA attention
// with an online softmax, q the suffix of kv (q_offset = Sk - Sq), kv head
// h / G with no expanded heads, probabilities cast to v's dtype before the
// PV product, masked scores at -1e30 and the denominator floored at 1e-30.
//
// What bounds it: at the serving shape (B=4, Hq=32, Hk=8, S=1024, D=64,
// bf16) the work is ~17 GFLOP against ~42 MB of q, k, v and o, ~400 FLOP
// per byte, above the card's ~295 FLOP/byte balance point: the tensor-core
// rate bounds it (~17 us). Between tiles the softmax (exp, max, rescale)
// runs on the CUDA cores, which is what keeps a kernel of this shape well
// below that bound.
//
// Design, against that bound:
//  - One block per (q tile, head, batch). The TPU grid walked kv blocks in
//    order inside one core with VMEM-resident K/V; here each block loops
//    over its own kv tiles, staged through shared memory.
//  - bf16: four warps, 16 query rows each (FlashAttention-2 layout). QK^T
//    and PV are mma.sync m16n8k16 products with f32 accumulators; operands
//    come from padded shared memory through ldmatrix (conflict-free rows);
//    the score accumulators are re-packed in registers as the bf16 A operand
//    of PV, which is exactly the cast of p to v's dtype. Each thread keeps
//    a partial row sum and the quad reduces it once at the end.
//  - f32: the tensor cores would round f32 to TF32 (~1e-3), so the f32
//    kernel multiplies on the CUDA cores: a query row is owned by D/16
//    neighbouring lanes, 16 head dims each, and a score is a partial dot
//    product plus a butterfly shuffle; K/V rows are read as float4
//    broadcasts from shared memory.
//  - Tiles above the causal frontier, and below the window of the block's
//    first row, are never loaded; in the bf16 kernel only tiles on an edge
//    compute the mask.
//    The ragged edge (any Sq, Sk) is masked, not padded: the TPU kernel
//    instead halved its block size until it divided.
//  - q tiles are issued in reverse so the longest causal rows start first.
//  - The kernels allocate nothing and launch on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // flash_attention.py:23 NEG_INF
constexpr int kBlockQ = 64;        // query rows per block (bf16 kernel)
constexpr int kBlockK = 64;        // kv rows per shared-memory tile

__device__ __forceinline__ bool visible(int row, int col, int Sk, int causal,
                                        int window) {
  return col < Sk && (!causal || col <= row) && (window <= 0 || col > row - window);
}

// Whether a kv tile [kv0, kv0 + kBlockK) holds a masked entry for some
// query row in [row0, row0 + kBlockQ).
__device__ __forceinline__ bool tile_needs_mask(int kv0, int row0, int Sk,
                                                int causal, int window) {
  return kv0 + kBlockK > Sk || (causal && kv0 + kBlockK - 1 > row0) ||
         (window > 0 && kv0 <= row0 + kBlockQ - 1 - window);
}

// ---------------------------------------------------------------- bf16 ----

constexpr int kWarpsBf16 = kBlockQ / 16;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + nrows) of a (rows, D) bf16 matrix -> padded shared tile,
// rows at or past `limit` zero-filled
template <int D, int LD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int r0,
                                           int nrows, int limit) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < nrows * kChunks; c += kWarpsBf16 * 32) {
    const int r = c / kChunks;
    const int d = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * D + d);
    *reinterpret_cast<uint4*>(dst + r * LD + d) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kWarpsBf16 * 32)
fwd_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int Hq, int Hk, int Sq, int Sk,
                int causal, int window, float scale) {
  constexpr int LD = D + 8;  // padded row: 8 ldmatrix rows hit 32 distinct banks
  constexpr int KC = D / 16;       // k-chunks of QK^T
  constexpr int NT = kBlockK / 8;  // score n-tiles per kv tile
  constexpr int DT = D / 8;        // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockQ * LD;
  __nv_bfloat16* vs = ks + kBlockK * LD;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // accumulator row within the warp's 16 (and +8)
  const int t = lane & 3;   // accumulator column pair
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int q_offset = Sk - Sq;
  const int q0 = qt * kBlockQ;
  const int row0 = q_offset + q0;                 // first absolute row of the block
  const int row_g = row0 + warp * 16 + g;         // absolute row of c0, c1 (c2, c3: +8)

  const __nv_bfloat16* qp = q + (static_cast<size_t>(b) * Hq + h) * Sq * D;
  const __nv_bfloat16* kp = k + (static_cast<size_t>(b) * Hk + hk) * Sk * D;
  const __nv_bfloat16* vp = v + (static_cast<size_t>(b) * Hk + hk) * Sk * D;
  __nv_bfloat16* op = o + (static_cast<size_t>(b) * Hq + h) * Sq * D;

  stage_rows<D, LD>(qs, qp, q0, kBlockQ, Sq);
  __syncthreads();
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    ldmatrix_x4(qf[kc], qs + (warp * 16 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8);

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int last_row = q_offset + min(q0 + kBlockQ, Sq) - 1;
  const int hi = causal ? min(Sk, last_row + 1) : Sk;
  const int lo = window > 0 ? max(0, row0 - window + 1) : 0;

  for (int kv0 = (lo / kBlockK) * kBlockK; kv0 < hi; kv0 += kBlockK) {
    __syncthreads();  // the previous tile has been consumed
    stage_rows<D, LD>(ks, kp, kv0, kBlockK, Sk);
    stage_rows<D, LD>(vs, vp, kv0, kBlockK, Sk);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; kc += 2) {
        uint32_t kb[4];  // b0, b1 of k-chunk kc, then of kc + 1
        ldmatrix_x4(kb, ks + (j * 8 + (lane & 7)) * LD + kc * 16 + (lane >> 3) * 8);
        mma_bf16(s[j], qf[kc], kb[0], kb[1]);
        mma_bf16(s[j], qf[kc + 1], kb[2], kb[3]);
      }
    }

    const bool masked = tile_needs_mask(kv0, row0, Sk, causal, window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (masked && !visible(row_g + (e >> 1) * 8, kv0 + j * 8 + 2 * t + (e & 1),
                               Sk, causal, window))
          x = kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float alpha[2] = {expf(m[0] - mx[0]), expf(m[1] - mx[1])};

    uint32_t pf[kBlockK / 16][4];  // p as the bf16 A operand of PV
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = s[j][e] <= kNegInf ? 0.f : expf(s[j][e] - mx[e >> 1]);
        psum[e >> 1] += p[e];
      }
      pf[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = l[i] * alpha[i] + psum[i];
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t vb[4];  // b0, b1 of output n-tile n, then of n + 1
        ldmatrix_x4_trans(vb, vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  n * 8 + (lane >> 4) * 8);
        mma_bf16(acc[n], pf[kc], vb[0], vb[1]);
        mma_bf16(acc[n + 1], pf[kc], vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qrow = q0 + warp * 16 + g + i * 8;
    if (qrow < Sq) {
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<uint32_t*>(op + static_cast<size_t>(qrow) * D + n * 8 + 2 * t) =
            pack_bf16(acc[n][2 * i] * inv[i], acc[n][2 * i + 1] * inv[i]);
    }
  }
}

// ----------------------------------------------------------------- f32 ----

constexpr int kThreadsF32 = 256;
constexpr int kDimsPerThread = 16;

__device__ __forceinline__ void load4(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
fwd_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int Hq,
               int Hk, int Sq, int Sk, int causal, int window, float scale) {
  constexpr int kLanes = D / kDimsPerThread;      // lanes per query row
  constexpr int kRows = kThreadsF32 / kLanes;     // query rows per pass
  constexpr int kRowsPerBlock = kRows;            // one row per lane group

  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                  // (kBlockK, D)
  float* vs = smem + kBlockK * D;    // (kBlockK, D)

  const int tid = threadIdx.x;
  const int part = tid % kLanes;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int q_offset = Sk - Sq;
  const int q0 = qt * kRowsPerBlock;
  const int qrow = q0 + tid / kLanes;
  const int row = q_offset + qrow;   // absolute position of this query

  const float* qp = q + (static_cast<size_t>(b) * Hq + h) * Sq * D;
  const float* kp = k + (static_cast<size_t>(b) * Hk + hk) * Sk * D;
  const float* vp = v + (static_cast<size_t>(b) * Hk + hk) * Sk * D;
  float* op = o + (static_cast<size_t>(b) * Hq + h) * Sq * D;

  float qr[kDimsPerThread];
  float acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) { qr[i] = 0.f; acc[i] = 0.f; }
  if (qrow < Sq) {
#pragma unroll
    for (int c = 0; c < kDimsPerThread; c += 4)
      load4(qp + static_cast<size_t>(qrow) * D + part * kDimsPerThread + c, qr + c);
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) qr[i] *= scale;
  }
  float m = kNegInf;
  float l = 0.f;

  const int last_row = q_offset + min(q0 + kRowsPerBlock, Sq) - 1;
  const int hi = causal ? min(Sk, last_row + 1) : Sk;
  const int lo = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;

  for (int kv0 = (lo / kBlockK) * kBlockK; kv0 < hi; kv0 += kBlockK) {
    __syncthreads();  // the previous tile has been consumed
    for (int e = tid * 4; e < kBlockK * D; e += kThreadsF32 * 4) {
      const int r = e / D;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (kv0 + r < Sk) {
        kk = *reinterpret_cast<const float4*>(kp + static_cast<size_t>(kv0) * D + e);
        vv = *reinterpret_cast<const float4*>(vp + static_cast<size_t>(kv0) * D + e);
      }
      *reinterpret_cast<float4*>(ks + e) = kk;
      *reinterpret_cast<float4*>(vs + e) = vv;
    }
    __syncthreads();

    float s[kBlockK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D + part * kDimsPerThread);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kDimsPerThread / 4; ++i) {
        const float4 kk = kr[i];
        dot = fmaf(qr[4 * i], kk.x, dot);
        dot = fmaf(qr[4 * i + 1], kk.y, dot);
        dot = fmaf(qr[4 * i + 2], kk.z, dot);
        dot = fmaf(qr[4 * i + 3], kk.w, dot);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[j] = visible(row, kv0 + j, Sk, causal, window) ? dot : kNegInf;
      m_new = fmaxf(m_new, s[j]);
    }

    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = s[j] <= kNegInf ? 0.f : expf(s[j] - m_new);
      psum += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D + part * kDimsPerThread);
#pragma unroll
      for (int i = 0; i < kDimsPerThread / 4; ++i) {
        const float4 vv = vr[i];
        acc[4 * i] = fmaf(p, vv.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (qrow < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < kDimsPerThread; c += 4)
      *reinterpret_cast<float4*>(op + static_cast<size_t>(qrow) * D + part * kDimsPerThread + c) =
          make_float4(acc[c] * inv, acc[c + 1] * inv, acc[c + 2] * inv, acc[c + 3] * inv);
  }
}

// ------------------------------------------------------------- launch ----

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hk, int Sq, int Sk, int causal,
                        int window, float scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const int smem = (kBlockQ + 2 * kBlockK) * (D + 8) * static_cast<int>(sizeof(T));
  auto kernel = fwd_kernel_bf16<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, Hq, B);
  kernel<<<grid, kWarpsBf16 * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hk, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hk, int Sq, int Sk, int causal,
                       int window, float scale, cudaStream_t stream) {
  constexpr int kRows = kThreadsF32 / (D / kDimsPerThread);
  const int smem = 2 * kBlockK * D * static_cast<int>(sizeof(float));
  auto kernel = fwd_kernel_f32<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kRows - 1) / kRows, Hq, B);
  kernel<<<grid, kThreadsF32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hk, Sq, Sk,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B,Hq,Sq,D), k/v (B,Hk,Sk,D), o (B,Hq,Sq,D), all contiguous and 16-byte
// aligned, of one dtype (is_bf16: 0 f32, 1 bf16). D in {32, 64, 128, 256},
// Hq % Hk == 0, 0 < Sq <= Sk. Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int is_bf16, int B, int Hq, int Hk,
                                   int Sq, int Sk, int D, int causal,
                                   int window, float scale, void* stream) {
  if (B <= 0 || Hk <= 0 || Hq % Hk != 0 || Sq <= 0 || Sq > Sk)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_ARGS q, k, v, o, B, Hq, Hk, Sq, Sk, causal, window, scale, s
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 32 * 2 + 1: return launch_bf16<32>(FA_ARGS);
    case 64 * 2 + 1: return launch_bf16<64>(FA_ARGS);
    case 128 * 2 + 1: return launch_bf16<128>(FA_ARGS);
    case 256 * 2 + 1: return launch_bf16<256>(FA_ARGS);  // 101,376 B of shared memory
    case 32 * 2: return launch_f32<32>(FA_ARGS);
    case 64 * 2: return launch_f32<64>(FA_ARGS);
    case 128 * 2: return launch_f32<128>(FA_ARGS);
    case 256 * 2: return launch_f32<256>(FA_ARGS);  // 131,072 B of shared memory
    default: return cudaErrorInvalidValue;
  }
#undef FA_ARGS
}
