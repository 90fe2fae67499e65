// Fused LoRA projection, for sm_90a:
//   y = x W + bf16(x Aᵀ) (s·B)ᵀ      (s·B passed in pre-scaled as b)
//
// Replaces: src/repro/kernels/lora_matmul.py :: lora_matmul_kernel (the
// Pallas TPU kernel behind repro.kernels.ops.lora_matmul).  Same contract:
// x (M, din), w (din, dout), a (r, din), b (dout, r), all of one dtype
// (bf16 or fp32; the wrapper casts a and s·B to x's dtype as the reference
// does); out (M, dout) in that dtype, fp32 accumulation.  The rank-r
// intermediate z = x Aᵀ never leaves the chip: it is accumulated beside
// the base product, rounded to x's dtype (the reference's rounding point),
// and multiplied into the same output accumulators.
//
// What bounds it on the H100 (data-sheet rates 3.35 TB/s and 989 TFLOP/s
// bf16): operations.  At the train step's shape (M = 4·512 tokens, din =
// dout = 2048, r ≤ 32) the base product is 2·M·din·dout ≈ 17 GFLOP
// against ≈ 25 MB of operands: ~700 flops per byte, far above the card's
// bf16 balance point (~295); at the RWKV6 prefill's M = 8192, ~1000.
//
// Three routes, chosen by the wrapper (lora_matmul.py :: plan):
//
// "wgmma" — bf16 with din and dout multiples of 8 (every main-path shape).
//   * a persistent grid of one block per SM (at most the tile count) walks
//     the 128 × BN output tiles in a grouped raster (8 tile rows a group),
//     so that the blocks in flight share x rows and W columns in L2.  BN is
//     chosen per shape so that the tiles fill the 132 SMs in whole waves
//     (lora_matmul.py :: tile_n): 256 at M 2048 × 2048 (128 tiles, one
//     wave) and M 8192 × 2048 (512 tiles), 64 at M 2048 × 512 (128 tiles);
//   * a producer warpgroup (one thread issues) keeps TMA loads of x (128 ×
//     64), W (64 × BN, as BN/64 panels of 64 columns) and A (RP × 64, the
//     rank padded to 16, 32, 64 or 128, rows past r zero-filled) in flight
//     through a ring of 3–4 stages, 128-byte swizzled, with full/empty
//     mbarrier pairs; it runs ahead across tiles, so a tile's epilogue
//     overlaps the next tile's loads.  TMA zero-fills past M, din and dout:
//     ragged edges cost no masking in the loop;
//   * two consumer warpgroups own 64 rows each.  Per 64-wide k-step each
//     issues wgmma m64nBNk16 for x·W (W is MN-major: dout is contiguous, so
//     it is the transposed B operand, its panels LBO apart) and m64nRPk16
//     for z = x·Aᵀ on the same x stage (A is K-major), so x is read once
//     for both products; fp32 accumulators in registers.  A k-step's
//     products stay in flight while the next step's issue; its stage is
//     released when they are done;
//   * after the k loop z is rounded to bf16 in registers and fed as
//     wgmma's register A operand against the tile's (BN × RP) rows of s·B,
//     which the consumers load into swizzled shared memory (any r: rows of
//     r·2 bytes, which TMA cannot stride when r is not a multiple of 8),
//     into the same accumulators;
//   * the tile leaves as bf16 through swizzled staging panels and TMA
//     stores (clipped at M and dout), 128 columns a round.
//   Budgets (lora_matmul.py :: smem_bytes, tile_widths): stages × (128·64 +
//   64·BN + RP·64)·2 + BN·RP·2 + 2·64·min(BN, 128)·2 bytes ≤ 227 KB with at
//   least three stages.  A block of 384 threads launches with 168
//   registers a thread; the producer warpgroup hands its share to the
//   consumers (setmaxnreg; without it the kernels spill more and M 8192
//   runs 6% slower).  BN/2 + RP/2 accumulators a consumer thread still
//   spill at 256 columns from rank 32 on, which then runs slower than 128
//   columns, so 256 columns are kept for ranks up to 16.
// "wmma" — bf16 with din or dout not a multiple of 8, which TMA cannot
//   describe (its strides are multiples of 16 bytes): WMMA 16×16×16
//   fragments, 128 × 128 tiles, 32-wide k slices through a three-slot
//   cp.async ring, ragged edges masked element by element.
// "fp32" — CUDA cores (64 × 64 tiles, 4 × 4 outputs a thread), used for the
//   parity checks; it computes the same function.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

// ------------------------------------------------------ bf16, wgmma ----
constexpr int kTM = 128;                    // tile rows: two consumer warpgroups of 64
constexpr int kTK = 64;                     // din per k-step: 128 bytes, one swizzle row
constexpr int kConsumers = 2;
constexpr int kTmaThreads = (kConsumers + 1) * 128;   // + one producer warpgroup
constexpr int kGroupM = 8;                  // tile rows per raster group
constexpr int kSmemLimit = 232448;          // dynamic shared memory a block may use
constexpr int kMaxStages = 4;
// registers a thread after the rebalancing: the producer warpgroup gives
// up what the consumers' accumulators use (40·128 + 2·232·128 ≤ 65,536)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Shared-memory plan of one block; lora_matmul.py :: smem_bytes mirrors it.
template <int BN, int RP>
struct Plan {
  static constexpr int X_BYTES = kTM * kTK * 2;         // x stage, 128 rows × 128 B
  static constexpr int W_BYTES = kTK * BN * 2;          // BN/64 panels, 64 rows × 128 B
  static constexpr int A_BYTES = RP * kTK * 2;          // A stage, RP rows × 128 B
  static constexpr int STAGE = X_BYTES + W_BYTES + A_BYTES;
  static constexpr int B_BYTES = BN * RP * 2;           // the tile's s·B rows
  static constexpr int BSW = RP * 2 < 128 ? RP * 2 : 128;   // their swizzle span
  static constexpr int BPC = BSW / 2;                   // ranks per s·B panel
  static constexpr int CW = BN < 128 ? BN : 128;        // output columns per store round
  static constexpr int C_BYTES = kConsumers * 64 * CW * 2;  // y staging, CW/64 panels a warpgroup
  static constexpr int BAR_BYTES = 2 * kMaxStages * 8;
  static constexpr int FIT = (kSmemLimit - 1024 - B_BYTES - C_BYTES - BAR_BYTES) / STAGE;
  static constexpr int STAGES = FIT < kMaxStages ? FIT : kMaxStages;
  static constexpr int B_OFF = STAGES * STAGE;
  static constexpr int C_OFF = B_OFF + B_BYTES;
  static constexpr int BAR_OFF = C_OFF + C_BYTES;
  static constexpr int SMEM = BAR_OFF + BAR_BYTES + 1024;  // + alignment slack
  static constexpr int BLAYOUT = BSW == 128 ? 1 : BSW == 64 ? 2 : 3;   // wgmma swizzle code
  static_assert(STAGES >= 3, "the ring needs three stages");
};

// byte offset -> swizzled byte offset within a 1024-aligned region: the
// 16-byte chunk index is XORed with the row bits, as TMA writes it
template <int SW>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & (SW / 16 - 1)) << 4);
}

// wgmma shared-memory descriptor: start, leading and stride byte offsets,
// swizzle mode
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t a, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(a), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t a, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(a), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t a) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(a) : "memory");
}
// waits for the phase of the given parity to complete; a wait that never
// ends (a lost arrival) traps, so a fault surfaces as a launch error
__device__ __forceinline__ void mbar_wait(uint32_t a, uint32_t parity) {
  uint32_t done;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1u << 22)) __trap();
  }
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1) : "memory");
}
__device__ __forceinline__ void consumers_sync() {   // both consumer warpgroups
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers * 128) : "memory");
}
__device__ __forceinline__ void warpgroup_sync(int wg) {   // one consumer warpgroup
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// keeps the compiler from touching accumulators across an async wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16, bf16 in, fp32 accumulators (N = 2 × the array's size).
// wgmma_ss: A and B from shared memory, B transposed (MN-major) when TB;
// wgmma_rs: A from registers, B K-major in shared memory.

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Output tile t's origin in the grouped raster: kGroupM tile rows at a time,
// column by column within the group.  lora_matmul.py :: tile_origin mirrors it.
__device__ __forceinline__ void tile_origin(int t, int tm, int tn, int bn, int* m0,
                                            int* n0) {
  const int per_group = kGroupM * tn;
  const int first = t / per_group * kGroupM;
  const int rows = min(tm - first, kGroupM);
  const int i = t % per_group;
  *m0 = (first + i % rows) * kTM;
  *n0 = (i / rows) * bn;
}

template <int BN, int RP>
__global__ void __launch_bounds__(kTmaThreads, 1)
lora_matmul_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap ty,
                  const bf16* __restrict__ b, int M, int din, int dout, int r) {
  using P = Plan<BN, RP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sb = base + P::B_OFF;
  const uint32_t bars = base + P::BAR_OFF;        // full[STAGES], empty[STAGES]
  const int tm = (M + kTM - 1) / kTM, tn = (dout + BN - 1) / BN;
  const int n_tiles = tm * tn, nk = (din + kTK - 1) / kTK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (P::STAGES + s), kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {                                // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (tid == 0) {
      int it = 0;                                 // k-steps issued, across tiles
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int m0, n0;
        tile_origin(t, tm, tn, BN, &m0, &n0);
        for (int k = 0; k < nk; ++k, ++it) {
          const int st = it % P::STAGES;
          const uint32_t ph = (it / P::STAGES) & 1;
          mbar_wait(bars + 8 * (P::STAGES + st), ph ^ 1);    // slot released
          const uint32_t s = base + st * P::STAGE, full = bars + 8 * st;
          mbar_expect_tx(full, P::STAGE);
          tma_load_2d(s, &tx, full, k * kTK, m0);
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_load_2d(s + P::X_BYTES + p * kTK * 128, &tw, full, n0 + 64 * p, k * kTK);
          tma_load_2d(s + P::X_BYTES + P::W_BYTES, &ta, full, k * kTK, 0);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));

  // ---- consumers: warpgroup wg owns rows [m0 + 64 wg, m0 + 64 wg + 64) ----
  const int ct = tid - 128, wg = ct / 128, wt = ct % 128;
  const int warp = wt / 32, lane = tid % 32;
  const int ra = warp * 16 + lane / 4, c2 = 2 * (lane % 4);   // rows ra, ra + 8
  const uint32_t sc = base + P::C_OFF + wg * (P::C_BYTES / kConsumers);
  unsigned char* gc = gbase + P::C_OFF + wg * (P::C_BYTES / kConsumers);
  float acc[BN / 2];
  float zacc[RP / 2];
  int it = 0;                                     // k-steps consumed, across tiles
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int m0, n0;
    tile_origin(t, tm, tn, BN, &m0, &n0);
    // the tile's rows of s·B, K-major and swizzled, zeros past dout and r;
    // the barrier before keeps the last tile's z·(s·B)ᵀ readers out of the way
    consumers_sync();
    for (int e = ct; e < BN * RP; e += kConsumers * 128) {
      const int n = e / RP, kr = e % RP;
      const uint32_t off = (kr / P::BPC) * BN * P::BSW + n * P::BSW + (kr % P::BPC) * 2;
      *reinterpret_cast<bf16*>(gbase + P::B_OFF + swz<P::BSW>(off)) =
          n0 + n < dout && kr < r ? b[(long)(n0 + n) * r + kr] : __float2bfloat16(0.f);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
#pragma unroll
    for (int e = 0; e < RP / 2; ++e) zacc[e] = 0.f;

    // each k-step's products stay in flight while the next step's issue;
    // a stage is released once the products that read it are done
    int prev = 0;
    for (int k = 0; k < nk; ++k, ++it) {
      const int st = it % P::STAGES;
      const uint32_t ph = (it / P::STAGES) & 1;
      const uint32_t s = base + st * P::STAGE;
      mbar_wait(bars + 8 * st, ph);               // stage landed
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        const uint64_t da = make_desc(s + wg * 64 * 128 + kk * 32, 16, 1024, 1);
        wgmma_ss<1>(acc, da, make_desc(s + P::X_BYTES + kk * 16 * 128, kTK * 128, 1024, 1));
        wgmma_ss<0>(zacc, da, make_desc(s + P::X_BYTES + P::W_BYTES + kk * 32, 16, 1024, 1));
      }
      wg_commit();
      wg_wait1();
      if (k > 0) mbar_arrive(bars + 8 * (P::STAGES + prev));   // release the last stage
      prev = st;
    }
    wg_wait0();
    reg_fence(acc);
    reg_fence(zacc);
    mbar_arrive(bars + 8 * (P::STAGES + prev));

    // z rounded to bf16 (the reference's point) as wgmma's A fragments
    uint32_t zf[RP / 16][4];
#pragma unroll
    for (int kt = 0; kt < RP / 16; ++kt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        zf[kt][q] = pack_bf16(zacc[8 * kt + 2 * q], zacc[8 * kt + 2 * q + 1]);
    wg_fence();
#pragma unroll
    for (int kt = 0; kt < RP / 16; ++kt) {
      const uint32_t koff = (kt * 16 / P::BPC) * BN * P::BSW + (kt * 16 % P::BPC) * 2;
      wgmma_rs(acc, zf[kt], make_desc(sb + koff, 16, 8 * P::BSW, P::BLAYOUT));
    }
    wg_commit();
    wg_wait0();
    reg_fence(acc);

    // y: CW columns a round as bf16 pairs into the warpgroup's swizzled
    // staging panels, then one TMA store a panel (clipped at M and dout);
    // a round first waits until the last store has read the panels
#pragma unroll
    for (int rnd = 0; rnd < BN / P::CW; ++rnd) {
      if (wt == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      warpgroup_sync(wg);
#pragma unroll
      for (int j = 0; j < P::CW / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 8 * j + c2;
          const uint32_t off = (c / 64) * 8192 + (ra + 8 * h) * 128 + (c % 64) * 2;
          const int e = 4 * (rnd * P::CW / 8 + j) + 2 * h;
          *reinterpret_cast<uint32_t*>(gc + swz<128>(off)) = pack_bf16(acc[e], acc[e + 1]);
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(wg);
      if (wt == 0) {
#pragma unroll
        for (int p = 0; p < P::CW / 64; ++p)
          tma_store_2d(&ty, sc + p * 8192, n0 + rnd * P::CW + 64 * p, m0 + wg * 64);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }
  if (wt == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major (rows × cols) bf16 matrix as a 2-D map {cols, rows}; a box is
// 64 columns (128 bytes, the 128-byte swizzle) by box_rows rows, zero-filled
// past the matrix
int matrix_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  EncodeTiled enc = encoder();
  if (!enc) return -2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult res = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                           dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -3;
}

template <int BN, int RP>
int launch_wgmma(const void* x, const void* w, const void* a, const void* b, void* y,
                 int M, int din, int dout, int r, int grid, cudaStream_t st) {
  using P = Plan<BN, RP>;
  CUtensorMap tx, tw, ta, ty;
  int rc = matrix_map(&tx, x, M, din, kTM);
  if (rc == 0) rc = matrix_map(&tw, w, din, dout, kTK);
  if (rc == 0) rc = matrix_map(&ta, a, r, din, RP);
  if (rc == 0) rc = matrix_map(&ty, y, M, dout, 64);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      lora_matmul_wgmma<BN, RP>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return (int)err;
  lora_matmul_wgmma<BN, RP><<<grid, kTmaThreads, P::SMEM, st>>>(
      tx, tw, ta, ty, static_cast<const bf16*>(b), M, din, dout, r);
  return (int)cudaGetLastError();
}

template <int RP>
int launch_wgmma_bn(int bn, const void* x, const void* w, const void* a, const void* b,
                    void* y, int M, int din, int dout, int r, int grid, cudaStream_t st) {
  if (bn == 64) return launch_wgmma<64, RP>(x, w, a, b, y, M, din, dout, r, grid, st);
  if (bn == 128) return launch_wgmma<128, RP>(x, w, a, b, y, M, din, dout, r, grid, st);
  if constexpr (RP == 16)
    if (bn == 256) return launch_wgmma<256, RP>(x, w, a, b, y, M, din, dout, r, grid, st);
  return -1;
}

// ------------------------------------------------------- bf16, wmma ----
// din or dout not a multiple of 8 (no TMA map describes them).
constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;
constexpr int kLdX = kBK + 8;    // bf16 row strides: multiples of 8, rows 32-byte aligned
constexpr int kLdW = kBN + 8;

constexpr int kStages = 3;      // slices in flight through shared memory

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage 8 consecutive elements of row `row`, columns [col, col + 8), of a
// row-major (nrows × ncols) matrix with leading dimension ld: an
// asynchronous 16-byte copy where the chunk lies inside and is aligned,
// zeros where it lies outside, element by element on a ragged edge.
__device__ __forceinline__ void stage8(bf16* dst, const bf16* __restrict__ src,
                                      long row, long col, long nrows, long ncols,
                                      long ld, bool vec) {
  if (row < nrows && col + 8 <= ncols && vec) {
    cp_async16(dst, src + row * ld + col);
    return;
  }
  if (row >= nrows || col >= ncols) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    dst[i] = (col + i < ncols) ? src[row * ld + col + i] : __float2bfloat16(0.f);
}

template <int RP>   // rank padded to a multiple of 16 (16, 32, 64 or 128)
__global__ void __launch_bounds__(kThreads)
lora_matmul_wmma(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const bf16* __restrict__ a, const bf16* __restrict__ b,
                 bf16* __restrict__ y, int M, int din, int dout, int r) {
  constexpr int kLdR = RP + 8;
  constexpr int kStageElems = kBM * kLdX + kBK * kLdW + RP * kLdX;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);          // kStages × {x, W, A slices}
  bf16* zs = ring + kStages * kStageElems;             // [kBM][kLdR] bf16(z)
  bf16* bs = zs + kBM * kLdR;                          // [kBN][kLdR] s·B rows
  float* stage = reinterpret_cast<float*>(bs + kBN * kLdR);  // [8 warps][16*16]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long m0 = (long)blockIdx.y * kBM, n0 = (long)blockIdx.x * kBN;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 64;   // warp's output sub-tile
  const bool vx = (din % 8 == 0), vw = (dout % 8 == 0);
  float* st = stage + warp * 256;
  const int nk = (din + kBK - 1) / kBK;

  // slice kt of x (kBM × kBK), W (kBK × kBN) and A (RP × kBK) into its slot
  auto load_slice = [&](int kt) {
    bf16* xs = ring + (kt % kStages) * kStageElems;
    bf16* ws = xs + kBM * kLdX;
    bf16* as = ws + kBK * kLdW;
    const int k0 = kt * kBK;
    for (int c = tid; c < kBM * kBK / 8; c += kThreads) {
      const int row = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
      stage8(xs + row * kLdX + col, x, m0 + row, k0 + col, M, din, din, vx);
    }
    for (int c = tid; c < kBK * kBN / 8; c += kThreads) {
      const int row = c / (kBN / 8), col = (c % (kBN / 8)) * 8;
      stage8(ws + row * kLdW + col, w, k0 + row, n0 + col, din, dout, dout, vw);
    }
    for (int c = tid; c < RP * kBK / 8; c += kThreads) {
      const int row = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
      stage8(as + row * kLdX + col, a, row, k0 + col, r, din, din, vx);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4], zacc[RP / 16];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll
  for (int j = 0; j < RP / 16; ++j) wmma::fill_fragment(zacc[j], 0.f);

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_slice(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();       // this thread's copies of slice kt landed
    __syncthreads();                    // everyone's; slot of slice kt-1 is free
    if (kt + kStages - 1 < nk) load_slice(kt + kStages - 1);
    cp_async_commit();
    const bf16* xs = ring + (kt % kStages) * kStageElems;
    const bf16* ws = xs + kBM * kLdX;
    const bf16* as = ws + kBK * kLdW;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], xs + (wr + 16 * i) * kLdX + kk, kLdX);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::load_matrix_sync(fb, ws + kk * kLdW + wc + 16 * j, kLdW);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
      // z rows [16·warp, 16·warp + 16): x slice times Aᵀ (A rows, col-major)
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fz;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fat;
      wmma::load_matrix_sync(fz, xs + (16 * warp) * kLdX + kk, kLdX);
#pragma unroll
      for (int j = 0; j < RP / 16; ++j) {
        wmma::load_matrix_sync(fat, as + (16 * j) * kLdX + kk, kLdX);
        wmma::mma_sync(zacc[j], fz, fat, zacc[j]);
      }
    }
  }
  cp_async_wait<0>();

  // z -> bf16 in shared memory (the reference rounds z to x's dtype)
#pragma unroll
  for (int j = 0; j < RP / 16; ++j) {
    wmma::store_matrix_sync(st, zacc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32)
      zs[(16 * warp + e / 16) * kLdR + 16 * j + e % 16] = __float2bfloat16(st[e]);
    __syncwarp();
  }
  // the block's rows of s·B, zero past dout and past the rank
  for (int e = tid; e < kBN * RP; e += kThreads) {
    const int n = e / RP, k = e % RP;
    bs[n * kLdR + k] = (n0 + n < dout && k < r) ? b[(n0 + n) * (long)r + k]
                                                : __float2bfloat16(0.f);
  }
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < RP; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(fa[i], zs + (wr + 16 * i) * kLdR + kk, kLdR);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::load_matrix_sync(fb, bs + (wc + 16 * j) * kLdR + kk, kLdR);
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
    }
  }
  // store through the warp's staging tile, masked, rounded once to bf16
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const long row = m0 + wr + 16 * i + e / 16, col = n0 + wc + 16 * j + e % 16;
        if (row < M && col < dout) y[row * dout + col] = __float2bfloat16(st[e]);
      }
      __syncwarp();
    }
}

template <int RP>
size_t wmma_smem() {
  return sizeof(bf16) * ((size_t)kStages * (kBM * kLdX + kBK * kLdW + RP * kLdX)
                         + 2 * (size_t)kBM * (RP + 8))
         + sizeof(float) * 8 * 256;
}

template <int RP>
int launch_wmma(const void* x, const void* w, const void* a, const void* b, void* y,
                int M, int din, int dout, int r, cudaStream_t st) {
  const size_t smem = wmma_smem<RP>();
  cudaError_t err = cudaFuncSetAttribute(
      lora_matmul_wmma<RP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((dout + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  lora_matmul_wmma<RP><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(y), M, din, dout, r);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 ----
constexpr int kFM = 64, kFN = 64, kFK = 16;

template <int RP>
__global__ void __launch_bounds__(kThreads)
lora_matmul_f32(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ y, int M, int din, int dout, int r) {
  extern __shared__ __align__(16) float fs[];
  float* xs = fs;                       // [kFK][kFM]   x slice, transposed
  float* ws = xs + kFK * kFM;           // [kFK][kFN]
  float* at = ws + kFK * kFN;           // [kFK][RP]    A slice, transposed
  float* zs = at + kFK * RP;            // [kFM][RP + 1]
  float* bs = zs + kFM * (RP + 1);      // [kFN][RP + 1]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long m0 = (long)blockIdx.y * kFM, n0 = (long)blockIdx.x * kFN;
  float acc[4][4] = {}, zacc[4][RP / 16] = {};

  for (int k0 = 0; k0 < din; k0 += kFK) {
    for (int e = tid; e < kFM * kFK; e += kThreads) {
      const int mm = e / kFK, kk = e % kFK;
      xs[kk * kFM + mm] = (m0 + mm < M && k0 + kk < din) ? x[(m0 + mm) * din + k0 + kk] : 0.f;
    }
    for (int e = tid; e < kFK * kFN; e += kThreads) {
      const int kk = e / kFN, nn = e % kFN;
      ws[kk * kFN + nn] = (k0 + kk < din && n0 + nn < dout) ? w[(long)(k0 + kk) * dout + n0 + nn] : 0.f;
    }
    for (int e = tid; e < RP * kFK; e += kThreads) {
      const int rr = e / kFK, kk = e % kFK;
      at[kk * RP + rr] = (rr < r && k0 + kk < din) ? a[(long)rr * din + k0 + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[kk * kFM + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wv = ws[kk * kFN + tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(xv[i], wv, acc[i][j]);
      }
#pragma unroll
      for (int j = 0; j < RP / 16; ++j) {
        const float av = at[kk * RP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) zacc[i][j] = fmaf(xv[i], av, zacc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RP / 16; ++j) zs[(ty * 4 + i) * (RP + 1) + tx + 16 * j] = zacc[i][j];
  for (int e = tid; e < kFN * RP; e += kThreads) {
    const int n = e / RP, k = e % RP;
    bs[n * (RP + 1) + k] = (n0 + n < dout && k < r) ? b[(n0 + n) * (long)r + k] : 0.f;
  }
  __syncthreads();
  for (int k = 0; k < RP; ++k) {
    float zv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) zv[i] = zs[(ty * 4 + i) * (RP + 1) + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bv = bs[(tx * 4 + j) * (RP + 1) + k];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(zv[i], bv, acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long row = m0 + ty * 4 + i, col = n0 + tx * 4 + j;
      if (row < M && col < dout) y[row * dout + col] = acc[i][j];
    }
}

template <int RP>
int launch_f32(const void* x, const void* w, const void* a, const void* b, void* y,
               int M, int din, int dout, int r, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)kFK * (kFM + kFN + RP)
                                       + (size_t)(kFM + kFN) * (RP + 1));
  cudaError_t err = cudaFuncSetAttribute(
      lora_matmul_f32<RP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((dout + kFN - 1) / kFN, (M + kFM - 1) / kFM);
  lora_matmul_f32<RP><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(y), M, din, dout, r);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for all of x, w, a, b and y.  All
// contiguous and 16-byte aligned; 1 <= r <= 128.  bf16 with bn 64, 128 or
// 256 (and a grid of at most the tile count) takes the wgmma route, which
// needs din and dout multiples of 8 and bn <= 128 at ranks above 64; bf16
// with bn 0 takes the wmma route (lora_matmul.py :: plan chooses).  Returns
// a cudaError_t (0 = launched), -1 for arguments the kernel does not take,
// -2 when the driver has no cuTensorMapEncodeTiled, -3 when it refuses a map.
extern "C" int lora_matmul_launch(const void* x, const void* w, const void* a,
                                  const void* b, void* y, int dtype, int M, int din,
                                  int dout, int r, int bn, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r < 1 || r > 128 || M < 1 || din < 1 || dout < 1) return -1;
  const int rp = r <= 16 ? 16 : r <= 32 ? 32 : r <= 64 ? 64 : 128;
  if (dtype == 1 && bn != 0) {
    if (din % 8 != 0 || dout % 8 != 0 || grid < 1) return -1;
    switch (rp) {
      case 16: return launch_wgmma_bn<16>(bn, x, w, a, b, y, M, din, dout, r, grid, st);
      case 32: return launch_wgmma_bn<32>(bn, x, w, a, b, y, M, din, dout, r, grid, st);
      case 64: return launch_wgmma_bn<64>(bn, x, w, a, b, y, M, din, dout, r, grid, st);
      default: return launch_wgmma_bn<128>(bn, x, w, a, b, y, M, din, dout, r, grid, st);
    }
  }
  if (dtype == 1) {
    switch (rp) {
      case 16: return launch_wmma<16>(x, w, a, b, y, M, din, dout, r, st);
      case 32: return launch_wmma<32>(x, w, a, b, y, M, din, dout, r, st);
      case 64: return launch_wmma<64>(x, w, a, b, y, M, din, dout, r, st);
      default: return launch_wmma<128>(x, w, a, b, y, M, din, dout, r, st);
    }
  }
  if (dtype == 0) {
    switch (rp) {
      case 16: return launch_f32<16>(x, w, a, b, y, M, din, dout, r, st);
      case 32: return launch_f32<32>(x, w, a, b, y, M, din, dout, r, st);
      case 64: return launch_f32<64>(x, w, a, b, y, M, din, dout, r, st);
      default: return launch_f32<128>(x, w, a, b, y, M, din, dout, r, st);
    }
  }
  return -1;
}
