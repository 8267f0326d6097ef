// Flash attention forward for Hopper (sm_90a): bf16 through TMA and wgmma,
// f32 on the CUDA cores. f32 running max / denominator / accumulator; the
// output has the inputs' dtype.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::_fwd_kernel
// (wrapper flash_attention, :71) and computes what it computes: causal (and
// sliding-window) GQA attention with an online softmax, q the suffix of kv
// (q_offset = Sk - Sq), kv head h / G with no expanded heads, probabilities
// cast to v's dtype before the PV product while the denominator sums the f32
// probabilities, masked scores at -1e30 and the denominator floored at 1e-30.
//
// What bounds it: at the serving shapes (B=4, Hq=32, Hk=8, S=1024, D=64; and
// B=4, Hq=16, Hk=1, S=1024, D=256, bf16, causal) the work is ~17 and ~34
// GFLOP against ~42 and ~71 MB of q, k, v and o: some 400 and 500 FLOP per
// byte, above the card's ~295 FLOP/byte balance point. The tensor-core rate
// bounds it (~17 and ~35 us). Between the two products the softmax (max,
// exp, rescale) runs beside them: at D = 64 its exps take as long at the
// special-function unit's rate (16 per SM per clock) as the products take
// at the tensor-core rate.
//
// Design of the bf16 kernel, against that bound:
//  - Tensor-core rate: S = Q K^T and O += P V are wgmma products (m64, f32
//    accumulators). Q and K are read from shared memory, both K-major; P
//    goes from the score registers to the A operand as bf16 (the cast of p
//    to v's dtype), and V is read MN-major through the transpose bit.
//  - Loads hidden: one CTA per (128-row q tile, q head, batch) runs a
//    producer warpgroup, one thread of which issues TMA copies (Q once; K and
//    V through a ring of `stages` tiles of `block_kv` rows with full / empty
//    mbarriers), and two consumer warpgroups of 64 q rows each. setmaxnreg
//    moves registers from the producer (24) to the consumers (240).
//  - Softmax overlapped with the products: a consumer issues S of tile i,
//    then PV of tile i - 1, and runs the softmax of tile i while that PV is
//    in flight; the two consumers take turns issuing (ping-pong), so one's
//    softmax runs under the other's products.
//  - Tensor maps are 3-D, (D, S, B*H), so a box never crosses into the next
//    head and rows past Sq or Sk read as zeros. A row of a box is 128 bytes
//    under the 128-byte swizzle (D >= 64: a tile loads as D/64 boxes of 64
//    columns) and 64 bytes under the 64-byte swizzle (D = 32); the wgmma
//    descriptors follow that layout (bf16_desc below).
//  - Tiles above the causal frontier of the CTA's last row, and below the
//    window of its first row, are never loaded; only tiles on an edge
//    (ragged Sk, causal diagonal, window edge) compute the mask. The ragged
//    edge (any Sq, Sk) is masked, not padded: the TPU kernel instead halved
//    its block size until it divided.
//  - p = 2^(s * scale * log2(e) - max * scale * log2(e)): one FMA and one
//    ex2.approx per score. It rounds differently from expf(scale * s - m),
//    far inside the bf16 output's ulp.
//  - The output goes through the consumer's own (spent) Q rows in shared
//    memory and a TMA store, which writes no row at or past Sq.
//  - q tiles are issued in reverse so the longest causal rows start first.
//  - The f32 kernel: the tensor cores would round f32 to TF32 (~1e-3), so it
//    multiplies on the CUDA cores: a query row is owned by D/16 neighbouring
//    lanes, 16 head dims each, and a score is a partial dot product plus a
//    butterfly shuffle; K/V rows are read as float4 broadcasts from shared
//    memory. Tiles above the causal frontier, and below the window of the
//    block's first row, are never loaded.
//  - The kernels allocate nothing and launch on the caller's stream.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // flash_attention.py:23 NEG_INF
constexpr int kBlockK = 64;        // kv rows per shared-memory tile (f32 kernel)

__device__ __forceinline__ bool visible(int row, int col, int Sk, int causal,
                                        int window) {
  return col < Sk && (!causal || col <= row) && (window <= 0 || col > row - window);
}

// ---------------------------------------------------------------- bf16 ----

constexpr int kBlockQ = 128;        // q rows per CTA: two consumer warpgroups
constexpr int kThreadsBf16 = 384;   // producer warpgroup + two consumers
constexpr int kConsumerThreads = 256;

// Tiles per head dim: kv rows per ring stage and ring depth. Shared memory =
// Q (128 x D) + stages x (K + V) (block_kv x D each), bf16, + 1 KB alignment
// slack + the barriers:
//   D =  32: block_kv 128, 3 stages:   8,192 + 3 x 16,384 =  57,344 B
//   D =  64: block_kv 128, 3 stages:  16,384 + 3 x 32,768 = 114,688 B
//   D = 128: block_kv 128, 2 stages:  32,768 + 2 x 65,536 = 163,840 B
//   D = 256: block_kv  64, 2 stages:  65,536 + 2 x 65,536 = 196,608 B
template <int D> struct Bf16Tiles;
template <> struct Bf16Tiles<32> { static constexpr int kBlockKV = 128, kStages = 3; };
template <> struct Bf16Tiles<64> { static constexpr int kBlockKV = 128, kStages = 3; };
template <> struct Bf16Tiles<128> { static constexpr int kBlockKV = 128, kStages = 2; };
template <> struct Bf16Tiles<256> { static constexpr int kBlockKV = 64, kStages = 2; };

template <int D>
constexpr int bf16_smem_bytes() {
  return (kBlockQ + 2 * Bf16Tiles<D>::kStages * Bf16Tiles<D>::kBlockKV) * D * 2 + 1024 +
         8 * (1 + 3 * Bf16Tiles<D>::kStages);
}

template <int D>
int bf16_tiles(int* out) {
  out[0] = kBlockQ;
  out[1] = Bf16Tiles<D>::kBlockKV;
  out[2] = Bf16Tiles<D>::kStages;
  out[3] = bf16_smem_bytes<D>();
  return cudaSuccess;
}

// Shared-memory layout of one tile: D / kCols column blocks, each `rows` rows
// of kRowBytes, swizzled by TMA (128-byte swizzle; 64-byte at D = 32).
template <int D>
struct Bf16Layout {
  static constexpr int kCols = D < 64 ? D : 64;  // bf16 values per box row
  static constexpr int kRowBytes = 2 * kCols;
  static constexpr uint64_t kDescSwizzle = D < 64 ? 2 : 1;  // wgmma: B64, B128
  static constexpr uint32_t kSwizzleMask = D < 64 ? 3 : 7;  // 16-byte chunks XORed
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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0,
                                          int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Keeps the compiler from moving reads of an accumulator above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode. Tiles start 1024-byte
// aligned, so the base-offset field stays 0. K-major (Q, K): 8-row groups
// kRowBytes * 8 apart (SBO); the leading offset is unused under a swizzle.
// MN-major (V, transposed): 8-row groups along K at SBO, column blocks of
// kCols along N at LBO.
template <int D>
__device__ __forceinline__ uint64_t bf16_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (Bf16Layout<D>::kDescSwizzle << 62);
}

// 2^x on the special-function unit (about 2 ulp; results below 2^-126
// flush to 0): one MUFU.EX2, where exp2f adds a range check and two
// multiplies to every score.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = A * B^T, m64n64k16: A and B both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
      "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
      "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]),
      "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]),
      "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]),
      "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// S += A * B^T, m64n64k16: A and B both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// S = A * B^T, m64n128k16: A and B both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_first(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
      "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
      "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]),
      "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]),
      "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]),
      "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
      "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]),
      "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),
      "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]),
      "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
      "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]), "=f"(d[56]),
      "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]),
      "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// S += A * B^T, m64n128k16: A and B both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
      "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// O += P * V, m64n32k16: P (bf16) in registers, V MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
      "}, {%16,%17,%18,%19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P * V, m64n64k16: P (bf16) in registers, V MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P * V, m64n128k16: P (bf16) in registers, V MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
      "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P * V, m64n256k16: P (bf16) in registers, V MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
      "}, {%128,%129,%130,%131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
      "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
      "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
      "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]),
      "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]),
      "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
      "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
      "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
      "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
      "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
      "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
      "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One CTA per (128-row q tile, q head, batch). Warpgroup 0 is the producer
// (one thread issues every TMA copy); warpgroups 1 and 2 each own 64 q rows.
//
// A consumer overlaps its own work across tiles: it issues S of tile i and
// then O += P V of tile i - 1, and runs the softmax of tile i while the PV
// product is in flight. The two consumers also take turns issuing their
// products (named barriers 3 and 4, ping-pong: each waits on its own and
// arrives on the other's once per tile), so that one's softmax runs under
// the other's products. Named barriers 1 and 2 close each consumer's
// epilogue.
template <int D, int BKV, int STAGES>
__global__ void __launch_bounds__(kThreadsBf16, 1)
fwd_kernel_bf16(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap to, int Hq, int Hk, int Sq,
                int Sk, int causal, int window, float scale_log2) {
  using L = Bf16Layout<D>;
  constexpr uint32_t kQBytes = kBlockQ * D * 2;
  constexpr uint32_t kKVBytes = BKV * D * 2;
  constexpr uint32_t kQBlock = kBlockQ * L::kRowBytes;  // one column block of Q
  constexpr uint32_t kKVBlock = BKV * L::kRowBytes;     // one column block of K / V
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + kQBytes;
  const uint32_t sv = sk + STAGES * kKVBytes;
  const uint32_t bar_q = sv + STAGES * kKVBytes;
  const uint32_t bar_k = bar_q + 8;                // full: K of stage s at + 8 s
  const uint32_t bar_v = bar_k + 8 * STAGES;       // full: V of stage s
  const uint32_t bar_e = bar_v + 8 * STAGES;       // empty: stage s consumed

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh_q = blockIdx.z * Hq + blockIdx.y;
  const int bh_k = blockIdx.z * Hk + blockIdx.y / (Hq / Hk);
  const int q_offset = Sk - Sq;
  const int q0 = qt * kBlockQ;
  const int row0 = q_offset + q0;  // absolute row of the CTA's first q row
  const int last_row = q_offset + min(q0 + kBlockQ, Sq) - 1;
  const int hi = causal ? min(Sk, last_row + 1) : Sk;
  const int lo = window > 0 ? max(0, row0 - window + 1) : 0;
  const int kv_first = lo / BKV * BKV;
  const int n_tiles = (hi - kv_first + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform, so that each warpgroup's register budget holds from here
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, kQBytes);
#pragma unroll
      for (int cb = 0; cb < D / L::kCols; ++cb)
        tma_load(sq + cb * kQBlock, &tq, bar_q, cb * L::kCols, q0, bh_q);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(bar_e + 8 * s, ((it / STAGES) & 1) ^ 1);
        const int kv0 = kv_first + it * BKV;
        mbar_expect_tx(bar_k + 8 * s, kKVBytes);
#pragma unroll
        for (int cb = 0; cb < D / L::kCols; ++cb)
          tma_load(sk + s * kKVBytes + cb * kKVBlock, &tk, bar_k + 8 * s, cb * L::kCols,
                   kv0, bh_k);
        mbar_expect_tx(bar_v + 8 * s, kKVBytes);
#pragma unroll
        for (int cb = 0; cb < D / L::kCols; ++cb)
          tma_load(sv + s * kKVBytes + cb * kKVBlock, &tv, bar_v + 8 * s, cb * L::kCols,
                   kv0, bh_k);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int row_w = row0 + 64 * cw;                     // first row of this warpgroup
    const int row_a = row_w + 16 * (tid / 32) + lane / 4;  // rows row_a, row_a + 8
    const int col_t = 2 * (lane % 4);                      // first column of a fragment
    const uint32_t q_rows = sq + 64 * cw * L::kRowBytes;   // this warpgroup's Q rows
    // K-major Q and K: 8-row groups at SBO. MN-major V: 8-row groups along
    // K at SBO, the next 64 columns of N at LBO.
    const uint64_t q_desc = bf16_desc<D>(q_rows, 16, 8 * L::kRowBytes);
    const uint64_t k_desc = bf16_desc<D>(sk, 16, 8 * L::kRowBytes);
    const uint64_t v_desc = bf16_desc<D>(sv, kKVBlock, 8 * L::kRowBytes);
    const int sched_mine = 3 + cw, sched_other = 4 - cw;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max of the raw scores
    float l[2] = {0.f, 0.f};          // this thread's share of the row sums
    float sc[BKV / 2];                // scores, then p in f32
    uint32_t pf[BKV / 16][4];         // p as the bf16 A operand of PV

    // S = Q K^T of the tile in stage s
    auto issue_s = [&](int s) {
      uint64_t qd = q_desc, kd = k_desc + ((s * kKVBytes) >> 4);
      asm volatile("" : "+l"(qd), "+l"(kd));  // per k16 offsets stay immediates
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // column block, then 32 bytes per k16 inside a swizzled row
        const uint32_t blk = kk * 16 / L::kCols, off = (kk * 16 % L::kCols) * 2;
        const uint64_t da = qd + ((blk * kQBlock + off) >> 4);
        const uint64_t db = kd + ((blk * kKVBlock + off) >> 4);
        if (kk == 0)
          wgmma_ss_first(sc, da, db);  // the old scores are dead: write-only operands
        else
          wgmma_ss(sc, da, db);
      }
    };
    // O += P V of the tile in stage s
    auto issue_pv = [&](int s) {
      uint64_t vd = v_desc + ((s * kKVBytes) >> 4);
      asm volatile("" : "+l"(vd));
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc)
        wgmma_rs(o, pf[kc], vd + ((kc * 16 * L::kRowBytes) >> 4));
    };
    // Online softmax of the scores of the tile at kv0: p in f32 into sc (the
    // row sums add these), the running max and sum updated; returns in
    // alpha the factor that rescales O.
    auto softmax = [&](int kv0, float (&alpha)[2]) {
      if (kv0 + BKV > Sk || (causal && kv0 + BKV - 1 > row_w) ||
          (window > 0 && kv0 <= row_w + 63 - window)) {
        // the visible columns of rows row_a and row_a + 8, relative to kv0:
        // [c_lo, c_hi], the range `visible` describes
        int c_lo[2], c_hi[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = row_a + 8 * i;
          c_hi[i] = (causal ? min(r, Sk - 1) : Sk - 1) - kv0 - col_t;
          c_lo[i] = (window > 0 ? r - window + 1 : 0) - kv0 - col_t;
        }
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + (e & 1);
            if (col < c_lo[e >> 1] || col > c_hi[e >> 1]) sc[4 * j + e] = kNegInf;
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float mc[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // a row no visible key has reached yet keeps m at -1e30 and gets
        // p = 0 (the Pallas body gets p = 1 there and zeroes it with the
        // alpha of the first visible key: the same output)
        mc[i] = mx[i] == kNegInf ? 0.f : mx[i] * scale_log2;
        alpha[i] = exp2_approx(fmaf(m[i], scale_log2, -mc[i]));
      }
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * j + e] = exp2_approx(fmaf(sc[4 * j + e], scale_log2, -mc[e >> 1]));
          psum[e >> 1] += sc[4 * j + e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] = l[i] * alpha[i] + psum[i];
        m[i] = mx[i];
      }
    };
    auto pack_p = [&] {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        pf[j / 2][(j & 1) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
        pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
      }
    };
    if (cw == 1) named_arrive(3, kConsumerThreads);  // consumer 0 issues first
    mbar_wait(bar_q, 0);
    float alpha[2];
    mbar_wait(bar_k, 0);
    named_sync(sched_mine, kConsumerThreads);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    named_arrive(sched_other, kConsumerThreads);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(kv_first, alpha);  // O is 0: alpha unused
    pack_p();
    for (int it = 1; it < n_tiles; ++it) {
      const int s = it % STAGES, sp = (it - 1) % STAGES;
      mbar_wait(bar_v + 8 * sp, ((it - 1) / STAGES) & 1);
      mbar_wait(bar_k + 8 * s, (it / STAGES) & 1);
      named_sync(sched_mine, kConsumerThreads);
      wgmma_fence();
      issue_s(s);
      wgmma_commit();
      issue_pv(sp);
      wgmma_commit();
      named_arrive(sched_other, kConsumerThreads);
      wgmma_wait<1>();  // S done, PV of the previous tile in flight
      fence_regs(sc);
      softmax(kv_first + it * BKV, alpha);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(bar_e + 8 * sp);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
      pack_p();
    }
    const int sp = (n_tiles - 1) % STAGES;  // the last tile's PV
    mbar_wait(bar_v + 8 * sp, ((n_tiles - 1) / STAGES) & 1);
    wgmma_fence();
    issue_pv(sp);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(bar_e + 8 * sp);

    // epilogue: o / max(l, 1e-30) as bf16 into this warpgroup's own Q rows
    // (swizzled as TMA reads them), then one TMA store per column block
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + col_t;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t off = (16 * (tid / 32) + lane / 4 + 8 * i) * L::kRowBytes +
                             (col % L::kCols) * 2;
        const uint32_t swz = off ^ ((off >> 3) & (L::kSwizzleMask << 4));
        asm volatile("st.shared.b32 [%0], %1;\n"
                     :: "r"(q_rows + (col / L::kCols) * kQBlock + swz),
                        "r"(pack_bf16(o[4 * n + 2 * i] * inv[i], o[4 * n + 2 * i + 1] * inv[i]))
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1 + cw, 128);
    if (tid == 0 && q0 + 64 * cw < Sq) {
#pragma unroll
      for (int cb = 0; cb < D / L::kCols; ++cb)
        tma_store(&to, q_rows + cb * kQBlock, cb * L::kCols, q0 + 64 * cw, bh_q);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
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

// (B*H, S, D) bf16 as a 3-D map (D, S, B*H): boxes of (kCols, rows, 1), so a
// box never crosses into the next head; out-of-range rows read as zeros and
// are not written.
template <int D>
bool encode_map(CUtensorMap* map, const void* ptr, int S, int BH, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(Bf16Layout<D>::kCols),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            D < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hk, int Sq, int Sk, int causal,
                        int window, float scale, cudaStream_t stream) {
  constexpr int kBKV = Bf16Tiles<D>::kBlockKV;
  constexpr int kStages = Bf16Tiles<D>::kStages;
  CUtensorMap tq, tk, tv, to;
  if (!encode_map<D>(&tq, q, Sq, B * Hq, kBlockQ) ||
      !encode_map<D>(&tk, k, Sk, B * Hk, kBKV) ||
      !encode_map<D>(&tv, v, Sk, B * Hk, kBKV) ||
      !encode_map<D>(&to, o, Sq, B * Hq, kBlockQ / 2))
    return cudaErrorInvalidValue;
  constexpr int smem = bf16_smem_bytes<D>();
  auto kernel = fwd_kernel_bf16<D, kBKV, kStages>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, Hq, B);
  kernel<<<grid, kThreadsBf16, smem, stream>>>(tq, tk, tv, to, Hq, Hk, Sq, Sk, causal,
                                                window, scale * 1.4426950408889634f);
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
// Hq % Hk == 0, 0 < Sq <= Sk. Returns the launch's cudaError_t
// (cudaErrorInvalidValue also when a bf16 tensor map cannot be encoded).
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
    case 256 * 2 + 1: return launch_bf16<256>(FA_ARGS);
    case 32 * 2: return launch_f32<32>(FA_ARGS);
    case 64 * 2: return launch_f32<64>(FA_ARGS);
    case 128 * 2: return launch_f32<128>(FA_ARGS);
    case 256 * 2: return launch_f32<256>(FA_ARGS);  // 131,072 B of shared memory
    default: return cudaErrorInvalidValue;
  }
#undef FA_ARGS
}

// The bf16 kernel's tiles at head dim D: {block_q, block_kv, stages, shared
// memory bytes}. Returns cudaErrorInvalidValue for a D it does not take.
extern "C" int flash_attention_bf16_tiles(int D, int* out) {
  switch (D) {
    case 32: return bf16_tiles<32>(out);
    case 64: return bf16_tiles<64>(out);
    case 128: return bf16_tiles<128>(out);
    case 256: return bf16_tiles<256>(out);
    default: return cudaErrorInvalidValue;
  }
}
