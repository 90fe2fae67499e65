// Causal / windowed grouped-query flash attention, for sm_90a:
//   o[b, s, h] = softmax_t(q[b, s, h] · k[b, t, h/g] / √hd  | mask) · v[b, t, h/g]
// for every head dim hd that is a multiple of 8 from 8 to 128.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention_kernel
// (the Pallas TPU kernel behind repro.kernels.ops.flash_attention).  Same
// contract: q (B,S,H,hd), k/v (B,T,K,hd), bf16 or fp32, out (B,S,H,hd) in
// q's dtype; the KV head of query head h is h / (H/K); causal and window
// masks are applied independently of each other (key t is visible to query
// s iff [t <= s] and [t > s - window]); masked scores are -1e30, the
// normalizer is floored at 1e-30, and P is rounded to v's dtype before the
// P·V product, all as the TPU kernel does.
//
// What bounds it on the H100 (data-sheet rates 3.35 TB/s and 989 TFLOP/s
// bf16): at the train step's shape (B 4, S 512, H 32, K 8, hd 64) q, k, v
// and o are ≈ 21 MB, ≈ 6.3 µs of memory time, against ≈ 4.3 GFLOP of
// causal products, ≈ 4.4 µs of tensor time: bytes, but both are small, so
// latency sets the time — instructions per score element in the softmax,
// operands and state passing through shared memory, loads that nothing
// overlaps.  Measured on the card, the softmax's per-element work (masking
// above all) cost more than the products and the loads together.
//
// What the bf16 design does about it:
//   * products on wgmma (m64n64k16 for Q·Kᵀ, m64nNk16 for P·V, bf16 in,
//     fp32 out): one consumer warpgroup per 64 rows.  S = Q·Kᵀ accumulates
//     in registers; the online softmax runs on those registers (one FFMA
//     and one ex2 an element, the scale folded into the exponent), the row
//     max and sum taken across the four lanes that share a row; P is
//     rounded to bf16 in registers and fed as wgmma's register A operand to
//     P·V; the fp32 O accumulator stays in registers and is rescaled there
//     only when a row's max moved; O is written once, through shared
//     memory, as 16-byte stores;
//   * masking only on the tiles that hold a boundary (the diagonal, the
//     window's edge, keys past T), by two compares of each key against its
//     row's [first, last) visible key; the other tiles take no mask work;
//   * K and V tiles (64 keys) arrive by TMA (cp.async.bulk.tensor with
//     mbarriers) into a two-stage ring, issued by a producer warp while the
//     consumers compute.  The tensor maps read k and v in place over their
//     (B,T,K,hd) strides, in the 32/64/128-byte swizzle wgmma reads; the
//     map zero-fills keys past T.  The block's Q rows are loaded with all
//     their 16-byte loads in flight, then stored in the same swizzle;
//   * a block serves rows of one KV head: its 64 rows are (query, head)
//     pairs s·g + j, so every K/V tile a block reads serves all g = H/K
//     query heads of the group, read once per group, not once per head;
//     160 threads and at most 96 registers a thread (hd ≤ 64) let four
//     blocks share an SM;
//   * causal blocks run longest rows first (the block index walks the query
//     tiles from the end), so the diagonal's longest tiles do not run last;
//     tiles wholly above the diagonal or before the window are skipped.
// fp32 takes a CUDA-core kernel (64 queries of one head a block, softmax
// state in shared memory) that serves the parity checks.
//
// Head dims: both kernels are built for the tile widths HDP = 16, 32, 64
// and 128 and take every hd that is a multiple of 8 up to 128 in the
// next of them (56 and 48 in 64, 96 in 128).  The K/V tensor maps'
// inner extent is the true hd with a box of HDP, so TMA zero-fills the
// columns past hd and Q·Kᵀ is unchanged; Q is stored with zeros there;
// P·V runs at N = HDP and the store drops the columns past hd.  A
// multiple of 8 keeps every row a multiple of 16 bytes, as TMA's strides
// and the 16-byte Q and O chunks need.  The scale is the caller's 1/√hd.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64, kBKV = 64, kThreads = 128;   // fp32: 4 warps x 16 query rows
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int T, int causal,
                                        int window) {
  return kpos < T && (!causal || kpos <= qpos) && (!window || kpos > qpos - window);
}

// The key tiles a query tile [q0, q0 + kBQ) must visit.
__device__ __forceinline__ void tile_range(int q0, int T, int causal, int window,
                                           int* begin, int* end) {
  *end = causal ? min(T, q0 + kBQ) : T;
  *begin = window ? max(0, q0 - window + 1) / kBKV * kBKV : 0;
}

// One online-softmax step for one query row against one key tile: the
// lane holds the raw scores of columns lane and lane + 32.  Updates the
// row's (m, l) in ml[row], ml[kBQ + row], stores alpha in ml[2 kBQ + row]
// and returns the two probabilities.
__device__ __forceinline__ void softmax_row(float s0, float s1, int row, float* ml,
                                            int lane, float* p0, float* p1) {
  const float m_prev = ml[row];
  const float m_cur = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
  const float alpha = expf(m_prev - m_cur);
  *p0 = expf(s0 - m_cur);
  *p1 = expf(s1 - m_cur);
  const float l_new = ml[kBQ + row] * alpha + warp_sum(*p0 + *p1);
  __syncwarp();
  if (lane == 0) {
    ml[row] = m_cur;
    ml[kBQ + row] = l_new;
    ml[2 * kBQ + row] = alpha;
  }
}

// ------------------------------------------------------- bf16, Hopper ----
constexpr int kWgRows = 64;                   // (query, head) rows per consumer warpgroup
constexpr int kConsumers = 1;                 // consumer warpgroups per block
constexpr int kMinBlocks = 4;                 // blocks per SM the registers must allow
constexpr int kBR = kWgRows * kConsumers;     // rows per block
constexpr int kBN = 64;                       // keys per tile
constexpr int kStages = 2;                    // K/V ring depth
constexpr int kWsThreads = kConsumers * 128 + 32;   // + one producer warp

template <int HD>        // HD: the padded tile width HDP
struct Geo {
  static constexpr int SW = HD * 2 < 128 ? HD * 2 : 128;  // swizzle span (bytes)
  static constexpr int PC = SW / 2;                       // head dims per panel
  static constexpr int NP = HD / PC;                      // panels
  static constexpr int Q_BYTES = kBR * HD * 2;
  static constexpr int KV_BYTES = kBN * HD * 2;           // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * kStages * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 3 * kStages * 8 + 1024;   // + alignment slack
  static constexpr int LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3; // wgmma swizzle code
};

// byte offset -> swizzled byte offset within a 1024-aligned region: the
// 16-byte chunk index is XORed with the row bits, as TMA writes it
template <int SW>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & (SW / 16 - 1)) << 4);
}

// wgmma shared-memory descriptor: start, leading and stride byte offsets,
// swizzle mode
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t sbo,
                                              int layout) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
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
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
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
// keeps the compiler from touching accumulators across an async wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ float ex2(float x) {   // 2^x, one MUFU op; 0 for x << 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else wgmma_rs_n16(d, a, db);
}

template <int HD>        // HD: the padded tile width HDP; hd <= HD the true width
__global__ void __launch_bounds__(kWsThreads, HD == 128 ? 1 : kMinBlocks)
flash_bf16(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
           const bf16* __restrict__ q, bf16* __restrict__ o, int B, int S, int T,
           int H, int K, int hd, int causal, int window, float scale_log2, int n_mt) {
  using G = Geo<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sq = base;
  const uint32_t sk = base + G::Q_BYTES;
  const uint32_t sv = sk + kStages * G::KV_BYTES;
  const uint32_t bars = base + G::BAR_OFF;   // full_k[kStages], full_v[kStages], empty[kStages]

  const int g = H / K;
  const int bk = blockIdx.x % (B * K);
  const int mi = blockIdx.x / (B * K);
  const int mt = causal ? n_mt - 1 - mi : mi;      // longest causal rows first
  const int b = bk / K, kh = bk % K;
  const int m0 = mt * kBR;                         // first row s·g + j of the block
  const int s_lo = m0 / g;
  const int s_hi = min(S - 1, (m0 + kBR - 1) / g);
  const int t_end = causal ? min(T, s_hi + 1) : T;
  const int t_begin = window ? max(0, s_lo - window + 1) / kBN * kBN : 0;
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + kBN - 1) / kBN : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), 1);
      mbar_init(bars + 8 * (2 * kStages + s), kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers * 128) {                   // the producer warp
    if (tid == kConsumers * 128) {
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const int t0 = t_begin + i * kBN;
        mbar_wait(bars + 8 * (2 * kStages + st), ph ^ 1);   // slot released
        const uint32_t fk = bars + 8 * st, fv = bars + 8 * (kStages + st);
        mbar_expect_tx(fk, G::KV_BYTES);
#pragma unroll
        for (int p = 0; p < G::NP; ++p)
          tma_load_4d(sk + st * G::KV_BYTES + p * kBN * G::SW, &tk, fk, p * G::PC, kh, t0, b);
        mbar_expect_tx(fv, G::KV_BYTES);
#pragma unroll
        for (int p = 0; p < G::NP; ++p)
          tma_load_4d(sv + st * G::KV_BYTES + p * kBN * G::SW, &tv, fv, p * G::PC, kh, t0, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [m0 + 64 wg, m0 + 64 wg + 64) ----
  const int wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  constexpr int CH = HD / 8;                 // 16-byte chunks per row
  constexpr int CPP = G::SW / 16;            // chunks per panel row
  {   // Q rows, swizzled as TMA would place them, zeros past hd; all loads
      // in flight at once
    constexpr int NQ = kWgRows * CH / 128;
    uint4 val[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int c = wt + 128 * i, r = c / CH, ch = c % CH;
      const int pr = m0 + wg * kWgRows + r, s = pr / g, j = pr % g;
      val[i] = s < S && ch * 8 < hd
                   ? *reinterpret_cast<const uint4*>(
                         q + (((long)b * S + s) * H + kh * g + j) * hd + ch * 8)
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int c = wt + 128 * i, r = c / CH, ch = c % CH;
      const uint32_t off = (ch / CPP) * kBR * G::SW + (wg * kWgRows + r) * G::SW +
                           (ch % CPP) * 16;
      *reinterpret_cast<uint4*>(gbase + swz<G::SW>(off)) = val[i];
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1 + wg);

  const int ra = warp * 16 + lane / 4;       // this thread's rows ra, ra + 8
  // the keys rows ra and ra + 8 see: [lo, hi), by their query positions
  int lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = (m0 + wg * kWgRows + ra + 8 * h) / g;
    lo[h] = window ? max(0, s - window + 1) : 0;
    hi[h] = causal ? min(T, s + 1) : T;
  }
  const int c2 = 2 * (lane % 4);
  float oacc[G::NP][G::PC / 2];
#pragma unroll
  for (int p = 0; p < G::NP; ++p)
#pragma unroll
    for (int e = 0; e < G::PC / 2; ++e) oacc[p][e] = 0.f;
  float sacc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) sacc[e] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  const uint32_t qa = sq + wg * kWgRows * G::SW;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const int t0 = t_begin + i * kBN;
    mbar_wait(bars + 8 * st, ph);                  // K tile landed
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t p = kk * 16 / G::PC, koff = (kk * 16 % G::PC) * 2;
      wgmma_ss_n64(sacc, make_desc(qa + p * kBR * G::SW + koff, 8 * G::SW, G::LAYOUT),
                   make_desc(sk + st * G::KV_BYTES + p * kBN * G::SW + koff, 8 * G::SW,
                             G::LAYOUT),
                   kk > 0);
    }
    wg_commit();
    wg_wait0();
    reg_fence(sacc);

    // mask, online softmax on the raw scores (max and m unscaled; the
    // scale enters the exponent: e^(scale (x - m)) = 2^(x·c - m·c), c =
    // scale·log2 e); rows ra (e < 2), ra + 8
    const bool edge = t0 + kBN > T || (causal && t0 + kBN - 1 > s_lo) ||
                      (window && t0 <= s_hi - window);
    if (edge) {                                    // block-uniform
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l0 = lo[h] - t0 - c2, h0 = hi[h] - t0 - c2;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kk = 8 * j + e;                // key t0 + c2 + kk
            if (kk < l0 || kk >= h0) sacc[4 * j + 2 * h + e] = kNegInf;
          }
      }
    }
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    const float al_a = ex2((m_a - mx_a) * scale_log2), al_b = ex2((m_b - mx_b) * scale_log2);
    m_a = mx_a;
    m_b = mx_b;
    // a row with no visible key yet keeps p = 0 (not the reference's 1):
    // its first visible key rescales whatever it held by alpha = 0
    const float mc_a = m_a == kNegInf ? 0.f : m_a * scale_log2;
    const float mc_b = m_b == kNegInf ? 0.f : m_b * scale_log2;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = ex2(fmaf(sacc[4 * j + e], scale_log2, -(e < 2 ? mc_a : mc_b)));
        sacc[4 * j + e] = pv;
        if (e < 2) sum_a += pv;
        else sum_b += pv;
      }
    l_a = l_a * al_a + sum_a;                      // per-thread partial sums
    l_b = l_b * al_b + sum_b;
    if (al_a != 1.f || al_b != 1.f) {              // a row's max moved
#pragma unroll
      for (int p = 0; p < G::NP; ++p)
#pragma unroll
        for (int e = 0; e < G::PC / 2; ++e) oacc[p][e] *= (e & 2) ? al_b : al_a;
    }
    uint32_t pf[4][4];                             // P as wgmma's A fragments
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pf[kt][r] = pack_bf16(sacc[8 * kt + 2 * r], sacc[8 * kt + 2 * r + 1]);

    mbar_wait(bars + 8 * (kStages + st), ph);      // V tile landed
    wg_fence();
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int p = 0; p < G::NP; ++p)
        wgmma_rs<G::PC>(oacc[p], pf[kt],
                        make_desc(sv + st * G::KV_BYTES + p * kBN * G::SW + kt * 16 * G::SW,
                                  8 * G::SW, G::LAYOUT));
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int p = 0; p < G::NP; ++p) reg_fence(oacc[p]);
    mbar_arrive(bars + 8 * (2 * kStages + st));    // release the slot
  }

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  named_sync(1 + wg);                              // the group's Q reads are done
#pragma unroll
  for (int p = 0; p < G::NP; ++p)
#pragma unroll
    for (int j = 0; j < G::PC / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * kWgRows + ra + 8 * h;
        const float inv = h ? inv_b : inv_a;
        const uint32_t off = p * kBR * G::SW + r * G::SW + (8 * j + c2) * 2;
        *reinterpret_cast<uint32_t*>(gbase + swz<G::SW>(off)) =
            pack_bf16(oacc[p][4 * j + 2 * h] * inv, oacc[p][4 * j + 2 * h + 1] * inv);
      }
  named_sync(1 + wg);
  for (int c = wt; c < kWgRows * CH; c += 128) {
    const int r = c / CH, ch = c % CH;
    const int pr = m0 + wg * kWgRows + r, s = pr / g, j = pr % g;
    if (s >= S || ch * 8 >= hd) continue;
    const uint32_t off = (ch / CPP) * kBR * G::SW + (wg * kWgRows + r) * G::SW +
                         (ch % CPP) * 16;
    *reinterpret_cast<uint4*>(o + (((long)b * S + s) * H + kh * g + j) * hd + ch * 8) =
        *reinterpret_cast<const uint4*>(gbase + swz<G::SW>(off));
  }
}

// ---------------------------------------------------------------- fp32 ----
template <int HD>        // HD: the padded tile width; columns hd .. HD are zeros
__global__ void __launch_bounds__(kThreads)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int S, int T, int H,
          int K, int hd, int causal, int window, float scale) {
  constexpr int LD = HD + 1, LP = kBKV + 1;
  extern __shared__ __align__(16) float fs[];
  float* qs = fs;                    // [kBQ][LD]
  float* ks = qs + kBQ * LD;         // [kBKV][LD]
  float* vs = ks + kBKV * LD;        // [kBKV][LD]
  float* ps = vs + kBKV * LD;        // [kBQ][LP]
  float* os = ps + kBQ * LP;         // [kBQ][HD]
  float* ml = os + kBQ * HD;         // m, l, alpha: [3][kBQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kh = h / (H / K);
  const int q0 = blockIdx.y * kBQ, r0 = 16 * warp;
  const long qstride = (long)H * hd, kstride = (long)K * hd;
  const float* qb = q + ((long)b * S * H + h) * hd;
  const float* kb = k + ((long)b * T * K + kh) * hd;
  const float* vb = v + ((long)b * T * K + kh) * hd;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int row = e / HD, col = e % HD;
    qs[row * LD + col] = q0 + row < S && col < hd ? qb[(q0 + row) * qstride + col] : 0.f;
    os[e] = 0.f;
  }
  for (int e = tid; e < kBQ; e += kThreads) {
    ml[e] = kNegInf;
    ml[kBQ + e] = 0.f;
  }
  int kv_begin, kv_end;
  tile_range(q0, T, causal, window, &kv_begin, &kv_end);

  for (int t0 = kv_begin; t0 < kv_end; t0 += kBKV) {
    __syncthreads();
    for (int e = tid; e < kBKV * HD; e += kThreads) {
      const int row = e / HD, col = e % HD;
      const bool in = t0 + row < T && col < hd;
      ks[row * LD + col] = in ? kb[(t0 + row) * kstride + col] : 0.f;
      vs[row * LD + col] = in ? vb[(t0 + row) * kstride + col] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < 16; ++i) {
      const int row = r0 + i, qpos = q0 + row;
      float d0 = 0.f, d1 = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float qv = qs[row * LD + d];
        d0 = fmaf(qv, ks[lane * LD + d], d0);
        d1 = fmaf(qv, ks[(lane + 32) * LD + d], d1);
      }
      float s0 = d0 * scale, s1 = d1 * scale;
      if (!visible(qpos, t0 + lane, T, causal, window)) s0 = kNegInf;
      if (!visible(qpos, t0 + lane + 32, T, causal, window)) s1 = kNegInf;
      float p0, p1;
      softmax_row(s0, s1, row, ml, lane, &p0, &p1);
      ps[row * LP + lane] = p0;
      ps[row * LP + lane + 32] = p1;
    }
    __syncwarp();
    for (int e = lane; e < 16 * HD; e += 32) {
      const int row = r0 + e / HD, col = e % HD;
      float pv = 0.f;
#pragma unroll 8
      for (int t = 0; t < kBKV; ++t) pv = fmaf(ps[row * LP + t], vs[t * LD + col], pv);
      os[row * HD + col] = os[row * HD + col] * ml[2 * kBQ + row] + pv;
    }
    __syncwarp();
  }
  __syncwarp();
  float* ob = o + ((long)b * S * H + h) * hd;
  for (int e = lane; e < 16 * HD; e += 32) {
    const int row = r0 + e / HD, col = e % HD;
    if (q0 + row < S && col < hd)
      ob[(q0 + row) * qstride + col] = os[row * HD + col] / fmaxf(ml[kBQ + row], 1e-30f);
  }
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

// k or v (B,T,K,hd) bf16 as a 4-D map {hd, K, T, B}; a box is one panel of
// one KV head over kBN keys, zero-filled past hd (and past T)
template <int HD>
int kv_map(CUtensorMap* map, const void* ptr, int B, int T, int K, int hd) {
  using G = Geo<HD>;
  EncodeTiled enc = encoder();
  if (!enc) return -2;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)K, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)K * hd * 2,
                                 (cuuint64_t)T * K * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::PC, 1, (cuuint32_t)kBN, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = G::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : G::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <int HD>        // HD: the padded tile width for head dim hd
int launch(const void* q, const void* k, const void* v, void* o, int dtype, int B,
           int S, int T, int H, int K, int hd, int causal, int window, float scale,
           cudaStream_t st) {
  if (dtype == 1) {
    using G = Geo<HD>;
    CUtensorMap tk, tv;
    int rc = kv_map<HD>(&tk, k, B, T, K, hd);
    if (rc == 0) rc = kv_map<HD>(&tv, v, B, T, K, hd);
    if (rc != 0) return rc;
    const int n_mt = (int)(((long)S * (H / K) + kBR - 1) / kBR);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return (int)err;
    flash_bf16<HD><<<n_mt * B * K, kWsThreads, G::SMEM, st>>>(
        tk, tv, static_cast<const bf16*>(q), static_cast<bf16*>(o), B, S, T, H, K,
        hd, causal, window, scale * 1.4426950408889634f, n_mt);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
    const size_t smem = sizeof(float) * (3 * kBQ * (HD + 1) + kBQ * (kBKV + 1)
                                         + kBQ * HD + 3 * kBQ);
    cudaError_t err = cudaFuncSetAttribute(
        flash_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_f32<HD><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, T, H, K, hd, causal,
        window, scale);
    return (int)cudaGetLastError();
  }
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for q, k, v and o alike.  All
// contiguous and 16-byte aligned; hd a multiple of 8 from 8 to 128, run in
// the tile width HDP = the next of 16, 32, 64, 128 (flash_attention.py ::
// padded_hd); H a multiple of K.  ``scale`` is 1/√hd as the caller
// computes it.  Returns a cudaError_t (0 = launched), -1 for a dtype or
// head dim the kernel does not take, -2 when the driver has no
// cuTensorMapEncodeTiled, -3 when it refuses the map.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int dtype, int B, int S, int T, int H,
                                      int K, int hd, int causal, int window,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || T < 1 || K < 1 || H % K != 0) return -1;
  if (hd < 8 || hd > 128 || hd % 8 != 0) return -1;
  if (hd <= 16) return launch<16>(q, k, v, o, dtype, B, S, T, H, K, hd, causal, window, scale, st);
  if (hd <= 32) return launch<32>(q, k, v, o, dtype, B, S, T, H, K, hd, causal, window, scale, st);
  if (hd <= 64) return launch<64>(q, k, v, o, dtype, B, S, T, H, K, hd, causal, window, scale, st);
  return launch<128>(q, k, v, o, dtype, B, S, T, H, K, hd, causal, window, scale, st);
}
