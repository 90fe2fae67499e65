// RWKV6 WKV recurrence over a whole sequence, for sm_90a.  Per batch row b
// and head h, with an fp32 state S (hd × hd) that starts at zero:
//   y_t[v] = Σ_k r_t[k] · (S[k,v] + u[k] · k_t[k] · v_t[v])
//   S[k,v] ← e^{w_t[k]} · S[k,v] + k_t[k] · v_t[v]
// r, k, v (B,S,H,hd) fp32 or bf16; w (B,S,H,hd) fp32 log-decay; u (H,hd)
// fp32; out y (B,S,H,hd) fp32.  hd = 64 (RWKV6-1.6B) or 32 (its SMOKE config).
//
// Replaces: src/repro/kernels/wkv6.py :: wkv6_kernel (the Pallas TPU kernel
// behind repro.kernels.ops.wkv6, reached from models/rwkv.py's time_mix on
// the full-sequence forward with use_kernels).  The TPU kernel runs a
// (B·H, S/chunk) grid with the chunk axis sequential, carrying S in a VMEM
// scratch from one grid step to the next, and steps one token at a time.
// Blocks on Hopper run in no order, so here one block owns one (b, h) pair
// and walks the whole sequence itself: one launch, and the wrapper's chunk
// argument has no effect.
//
// The chunked form.  The sequence is cut into chunks of C = 16 tokens.
// Within a chunk (tokens 0..C-1, d_j = e^{w_j} per channel, S₀ the state
// entering it):
//   r̃_t = r_t ⊙ Π_{j<t} d_j           k̃_s = k_s ⊙ Π_{j>s} d_j
//   P[t][s] = Σ_k r_t[k] k_s[k] Π_{s<j<t} d_j[k]   (s < t)
//   P[t][t] = Σ_k r_t[k] u[k] k_t[k]               (the bonus)
//   y_t = r̃_tᵀ S₀ + Σ_{s≤t} P[t][s] v_s
//   S   ← (Π_j d_j) ⊙ S₀ + Σ_s k̃_s v_sᵀ
// Every decay is a running product of d inside the chunk (≤ 16 factors of
// ≤ 1): no e^{-a} and no quotient of two products is ever formed, so
// nothing overflows, and a factor underflows only where the true one does
// (exps of differences of cumulative sums lose digits at strong decays:
// at w = −exp(N(3, 1)) the sums reach −3000, whose fp32 ulp is 2.4e-4; a
// single d can underflow there, so no quotient of prefix products works).
// The chunk start is the one reference point and the chunk is the only
// sub-block: r̃ S₀ and the update Σ k̃ vᵀ cost 2·hd² operations a token each
// whatever C is, and a longer chunk cut into sub-blocks adds the bridge
// products between them (≈ 25 k operations a token and head at C 64
// against ≈ 19 k here).  Splitting this chunk into two sub-blocks of 8
// with a tensor-core bridge halves the CUDA-core pairs, but measured slower
// on the H100 (one warp's serial bridge, or the warps' partial sums met by
// shared-memory atomics, cost more than the pairs saved).  The price of
// C = 16 is a state hand-off every 16 tokens, which stays in registers.
//
// What bounds it on the H100 (data-sheet rates 3.35 TB/s, 495 TFLOP/s
// TF32): at B 8, S 1024, H 32, hd 64 the function moves ≈ 235 MB (r, k, v
// in bf16, w and y in fp32: 70.1 µs) and the chunked form's tensor-core
// products are 4·hd² + 2·C·hd operations a token and head (4.8 GFLOP:
// 9.8 µs at the TF32 rate, three times that in 3xTF32), so bytes bound it.
// The sequential form's 5·hd² + 5·hd fp32 operations on the CUDA cores
// (81.4 µs) were the old design's bound.
//
// Design:
//   * one block of 3·hd threads a (b, h): hd/32 consumer warps hold the
//     state and run the products of chunk c while 2·hd producer threads
//     copy, stage and derive chunk c + 1 (warp specialization; named
//     barriers hand each prepared chunk over, two buffers deep);
//   * products on the tensor cores with mma.sync m16n8k8 TF32, in 3xTF32
//     (hi·hi + hi·lo + lo·hi, split_tf32 below): plain TF32 keeps ~3
//     digits and the limits are 1e-4 of a row.  An operand exact in TF32
//     needs no lo part: bf16 v is, r̃, k̃, P and S are not.  mma.sync over
//     wgmma because the state must stay in registers across chunks as an
//     accumulator and be the A operand of the next product: wgmma TF32
//     takes both operands K-major from shared memory, which would cost a
//     16 KB store and load of S every 16 tokens;
//   * the state lives transposed, Sᵀ (v rows × k columns), in the
//     accumulators of the consumer warps, 32 value rows (two m-tiles) a
//     warp, so every fragment of r̃, k̃ and P a warp loads serves two mmas.
//     yᵀ = Sᵀ r̃ᵀ takes Sᵀ's accumulator registers as its A fragments
//     directly (k is the reduction axis: the columns {2c, 2c+1} an
//     accumulator holds are the fragment's columns {c, c+4} once B is read
//     in the same order), the update Sᵀ ← Sᵀ ⊙ D + Vᵀ k̃ accumulates into
//     them, and no warp needs another's rows;
//   * the producers: cp.async fills a ring of raw stages of r, k, v and w,
//     two chunks ahead (zero-filled past S: a ragged tail has r = k = v = 0
//     and d = 1, and no y is stored there); a staging pass takes d = e^w
//     once per element and widens v; a derivation pass, reading r and k
//     raw, runs the prefix (r̃, Π d) and suffix (k̃) products per channel,
//     the bonus, and the 120 in-chunk scores on the CUDA cores in fp32: a
//     thread owns two keys s and 15−s (15 queries between them) over 4
//     channels, carries k_s ⊙ Π d forward one token at a time, and the hd/4
//     threads of a key pair sum their partial scores by recursive halving;
//   * every tile that feeds an mma is stored split (hi, lo) in shared
//     memory, rows padded so each fragment load is free of bank conflicts.
// Shared memory: 93 KB a block at hd 64 with bf16 inputs (111 KB fp32),
// two blocks an SM, so B·H = 256 blocks run in one wave on 132 SMs; at hd
// 32, 52 KB (53 KB), four an SM (kernels/wkv6.py `plan` repeats this
// arithmetic, and chip_smoke.py holds it to the built structs).
//
// What the measurements showed (NVIDIA H100 80GB HBM3, 700 W; PERF.md,
// scripts/wkv6_cutouts.py): the kernel runs ≈ 2.2× its bytes bound at the
// main shape.  Its copies alone (no products, no derivation) take ≈ 69 µs;
// the consumers or the producers alone on top of them each reach ≈ 95 µs,
// together ≈ 150: the two roles slow each other on shared issue slots and
// shared-memory bandwidth rather than overlapping.  The product yᵀ = Sᵀ r̃ᵀ
// (≈ 42 µs when cut out) and the in-chunk scores (≈ 35 µs) cost most.
// What paid most on the way: the roles split over warps, consumers of 32
// rows (not 16), r and k read raw, and the split by integer operations
// instead of cvt.rna; a raw stage is refilled only after every producer
// has passed its last reader (an earlier order raced).
//
// History: the sequential design (one block of hd threads a (b, h), an
// 8 × 8 tile of S a thread on the CUDA cores, tokens one at a time) ran
// 277.0 µs at the main shape (280.7 fp32, 222.9 at hd 32; NVIDIA H100 80GB
// HBM3, 700 W), paced by shared-memory broadcasts and a shuffle chain per
// token (≈ 470 cycles a token against ≈ 240 instructions).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 16;             // tokens a chunk
constexpr int kMT = 2;             // m-tiles (16 value rows) a consumer warp
// threads of a block: hd/32 consumer warps, then 2·hd producer threads
template <int HD> constexpr int kConsumers = 2 * HD / kMT;
template <int HD> constexpr int kBlock = kConsumers<HD> + 2 * HD;
constexpr int kPadQ = 8;           // row pad (floats) of the [token][channel] tiles
constexpr int kLdP = kC + 4;       // row stride of the score tile

template <int HD, typename T>
struct Smem {
  static constexpr int kLd = HD + kPadQ;
  // r̃ and k̃ stored as (hi, lo) pairs per element, rows padded so that the
  // consumers' 16-byte (r̃) and 8-byte (k̃) fragment loads meet no conflict
  static constexpr int kLdQ = 2 * HD + 16, kLdK = 2 * HD + 8;
  // raw stages: three (two chunks in flight) where two blocks (hd 64) or
  // four (hd 32) an SM still fit, else two
  static constexpr int kR = (HD == 32 && sizeof(T) == 4) ? 2 : 3;
  alignas(16) T raw_r[kR][kC * HD];        // cp.async targets, as stored;
  alignas(16) T raw_k[kR][kC * HD];        // derive() reads r and k here
  alignas(16) T raw_v[kR][kC * HD];
  alignas(16) float raw_w[kR][kC * HD];
  alignas(16) float d[kC][kLd];            // e^w of the chunk being derived
  struct Prep {                            // a chunk ready for the products
    alignas(16) float q[kC][kLdQ];                // r̃, (hi, lo) a channel
    alignas(16) float k[kC][kLdK];                // k̃, (hi, lo) a channel
    alignas(16) float vh[kC][kLd], vl[kC][kLd];   // v (lo unused for bf16)
    alignas(16) float ph[kC][kLdP], pl[kC][kLdP]; // P, zero above the diagonal
    alignas(16) float dec[HD];                    // Π_j d_j
  } prep[2];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
// named barriers: `bar_sync` waits for n threads, `bar_arrive` counts this
// warp among them without waiting (release; the waiting side acquires)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = hi + lo for the 3xTF32 split.  The tensor cores read the top 19 bits
// of a tf32 operand, so hi is x itself (read as x truncated to tf32) and lo
// = x − trunc(x) is exact in fp32 (read truncated in turn): one LOP3 and one
// FADD, where cvt.rna.tf32.f32 twice expands to about ten instructions.
// hi·hi + hi·lo + lo·hi keeps ~20 bits of every product; lo·lo (~2^-20
// relative) is dropped.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}
__device__ __forceinline__ void split_store(float x, float* hi, float* lo) {
  uint32_t h, l;
  split_tf32(x, h, l);
  *hi = __uint_as_float(h);
  *lo = __uint_as_float(l);
}
__device__ __forceinline__ void split_store2(float x, float* hilo) {
  uint32_t h, l;
  split_tf32(x, h, l);
  *reinterpret_cast<float2*>(hilo) = make_float2(__uint_as_float(h), __uint_as_float(l));
}

// d += a · b on the tensor cores, m16n8k8, tf32 inputs, fp32 accumulators.
// Fragments (PTX ISA, mma.m16n8k8 .tf32), g = lane / 4, c = lane % 4:
//   a0 (g, c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4)  of A 16×8;
//   b0 (k = c, n = g), b1 (k = c + 4, n = g)                      of B 8×8;
//   d0, d1 (g, 2c + {0, 1}), d2, d3 (g + 8, 2c + {0, 1})          of D 16×8.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a · b in 3xTF32 from pre-split operands, small terms first; with
// kExactA the a operand is exact in tf32 and its lo part is skipped
template <bool kExactA>
__device__ __forceinline__ void mma_3x(float (&d)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], uint32_t bh0,
                                       uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, ah, bl0, bl1);
  if (!kExactA) mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(a.x << 16), __uint_as_float(a.x & 0xffff0000u),
                     __uint_as_float(a.y << 16), __uint_as_float(a.y & 0xffff0000u));
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// cp.async of chunk c's r, k, v and w rows into raw buffer `buf`; rows past
// S are zero-filled (source size 0, from a valid address)
template <int HD, typename T>
__device__ __forceinline__ void issue_chunk(Smem<HD, T>& sm, int buf,
                                            const T* __restrict__ r,
                                            const T* __restrict__ k,
                                            const T* __restrict__ v,
                                            const float* __restrict__ w, long base,
                                            long stride_t, int t0, int S, int tid) {
  constexpr int kThreads = 2 * HD;
  constexpr int kE = 16 / sizeof(T);                 // elements a 16-byte piece
  constexpr int kPR = HD / kE;                       // pieces a row of r, k, v
  static_assert(kC * kPR % kThreads == 0 && kC * HD / 4 % kThreads == 0, "");
#pragma unroll
  for (int it = 0; it < kC * kPR / kThreads; ++it) {
    const int i = tid + it * kThreads, row = i / kPR, col = (i % kPR) * kE;
    const bool ok = t0 + row < S;
    const long off = base + (ok ? (long)(t0 + row) * stride_t + col : 0);
    cp16(smem_addr(&sm.raw_r[buf][row * HD + col]), r + off, ok);
    cp16(smem_addr(&sm.raw_k[buf][row * HD + col]), k + off, ok);
    cp16(smem_addr(&sm.raw_v[buf][row * HD + col]), v + off, ok);
  }
  constexpr int kPW = HD / 4;
#pragma unroll
  for (int it = 0; it < kC * kPW / kThreads; ++it) {
    const int i = tid + it * kThreads, row = i / kPW, col = (i % kPW) * 4;
    const bool ok = t0 + row < S;
    const long off = base + (ok ? (long)(t0 + row) * stride_t + col : 0);
    cp16(smem_addr(&sm.raw_w[buf][row * HD + col]), w + off, ok);
  }
}

// Staging: raw stage `buf` -> d = e^w (scratch) and v widened, split where
// it is not exact (prep[pb]); a thread takes four channels of tokens tt and
// tt + 8, so a row's stores are one contiguous run
template <int HD, typename T, bool kExactV>
__device__ __forceinline__ void stage(Smem<HD, T>& sm, int buf, int pb, int tid) {
  const int c0 = 4 * (tid % (HD / 4));
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int tt = tid / (HD / 4) + 8 * e, src = tt * HD + c0;
    const float4 x = ld4(&sm.raw_v[buf][src]);
    if (kExactV) {
      *reinterpret_cast<float4*>(&sm.prep[pb].vh[tt][c0]) = x;
    } else {
      const float xs[4] = {x.x, x.y, x.z, x.w};
      float hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t h, l;
        split_tf32(xs[i], h, l);
        hi[i] = __uint_as_float(h);
        lo[i] = __uint_as_float(l);
      }
      *reinterpret_cast<float4*>(&sm.prep[pb].vh[tt][c0]) = make_float4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<float4*>(&sm.prep[pb].vl[tt][c0]) = make_float4(lo[0], lo[1], lo[2], lo[3]);
    }
    const float4 wv = ld4(&sm.raw_w[buf][src]);
    *reinterpret_cast<float4*>(&sm.d[tt][c0]) =
        make_float4(__expf(wv.x), __expf(wv.y), __expf(wv.z), __expf(wv.w));
  }
}

// Sum of 16 partials across the G lanes of an aligned group by recursive
// halving: afterwards lane cg of the group holds the totals of indices
// cg·(16/G) + a, a < 16/G, in x[a].
template <int G>
__device__ __forceinline__ void halve16(float (&x)[16], int cg) {
  int n = 16;
#pragma unroll
  for (int m = G / 2; m >= 1; m /= 2) {
    const bool hi = cg & m;
    n /= 2;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      if (a < n) {
        const float mine = hi ? x[a + n] : x[a], other = hi ? x[a] : x[a + n];
        x[a] = mine + __shfl_xor_sync(0xffffffffu, other, m);
      }
    }
  }
}

// Derivation: raw r and k of stage `buf` and d -> prep[pb]: the in-chunk
// scores and the bonus (key pair p, channel group cg), r̃ and Π d (prefix
// products, threads < hd), k̃ (suffix products, threads ≥ hd).  Every load
// comes before the first store, so none waits behind a store it might alias.
template <int HD, typename T>
__device__ __forceinline__ void derive(Smem<HD, T>& sm, int buf, int pb, int tid,
                                       const float4 uu) {
  auto& P = sm.prep[pb];
  const T* rr = sm.raw_r[buf];
  const T* kk = sm.raw_k[buf];
  constexpr int kCG = HD / 4;                        // channel groups of 4
  const int p = tid / kCG, cg = tid % kCG, c0 = 4 * cg;
  // the bonus Σ_k r_t u k_t of tokens 2p and 2p + 1, on the diagonal of P
  float bonus[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float4 rt = ld4(rr + (2 * p + e) * HD + c0), kt = ld4(kk + (2 * p + e) * HD + c0);
    bonus[e] = fmaf(rt.x * uu.x, kt.x, fmaf(rt.y * uu.y, kt.y,
               fmaf(rt.z * uu.z, kt.z, rt.w * uu.w * kt.w)));
  }
  // keys p and 15 - p: value i is the pair (t, s) with
  //   i < 15 - p: s = p, t = p + 1 + i;   15 - p <= i < 15: s = 15 - p, t = i + 1
  float part[kC];
  float4 kf = ld4(kk + p * HD + c0);
  const T* rp = rr + (p + 1) * HD + c0;              // token p + 1 + i, then i + 1
  const float* dp = &sm.d[p + 1][c0];
#pragma unroll
  for (int i = 0; i < kC - 1; ++i) {
    if (i == kC - 1 - p) {                           // the second key, 15 - p
      kf = ld4(kk + (kC - 1 - p) * HD + c0);
      rp = rr + HD + c0;                             // rp + i·HD is token i + 1
      dp = &sm.d[1][c0];
    }
    const float4 rt = ld4(rp + i * HD), dt = ld4(dp + i * Smem<HD, T>::kLd);
    part[i] = fmaf(rt.x, kf.x, fmaf(rt.y, kf.y, fmaf(rt.z, kf.z, rt.w * kf.w)));
    kf.x *= dt.x; kf.y *= dt.y; kf.z *= dt.z; kf.w *= dt.w;
  }
  part[kC - 1] = 0.f;
  // this thread's channel of r (prefix side) or k (suffix side), and d
  const int ch = tid % HD;
  const bool prefix = tid < HD;
  const T* src = (prefix ? rr : kk) + ch;
  float xs[kC], ds[kC];
#pragma unroll
  for (int t = 0; t < kC; ++t) {
    xs[t] = to_f(src[t * HD]);
    ds[t] = sm.d[t][ch];
  }
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int m = kCG / 2; m >= 1; m /= 2)
      bonus[e] += __shfl_xor_sync(0xffffffffu, bonus[e], m);
  halve16<kCG>(part, cg);
  if (cg == 0)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      split_store(bonus[e], &P.ph[2 * p + e][2 * p + e], &P.pl[2 * p + e][2 * p + e]);
#pragma unroll
  for (int a = 0; a < 16 / kCG; ++a) {
    const int i = cg * (16 / kCG) + a;
    if (i < kC - 1) {
      const bool first = i < kC - 1 - p;
      const int t = first ? p + 1 + i : i + 1, s = first ? p : kC - 1 - p;
      split_store(part[a], &P.ph[t][s], &P.pl[t][s]);
    }
  }
  float run = 1.f;
  if (prefix) {
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      split_store2(xs[t] * run, &P.q[t][2 * ch]);
      run *= ds[t];
    }
    P.dec[ch] = run;
  } else {
#pragma unroll
    for (int s = kC - 1; s >= 0; --s) {
      split_store2(xs[s] * run, &P.k[s][2 * ch]);
      run *= ds[s];
    }
  }
}

// Chunk c's products for consumer warp `wp`, which owns value rows
// v0 = 32·wp .. v0 + 31 as two m-tiles (every fragment of r̃, k̃ and P it
// loads serves both):
//   yᵀ = Sᵀ r̃ᵀ + Vᵀ Pᵀ, stored for tokens < S, then Sᵀ ← Sᵀ ⊙ D + Vᵀ k̃
template <int HD, typename T, bool kExactV>
__device__ __forceinline__ void products(Smem<HD, T>& sm, int pb,
                                         float (&st)[kMT][HD / 8][4],
                                         float* __restrict__ y, long ybase,
                                         long stride_t, int t0, int S, int lane,
                                         int wp) {
  constexpr int kNT = HD / 8;
  const auto& P = sm.prep[pb];
  const int g = lane >> 2, c = lane & 3, v0 = 16 * kMT * wp;
  // Vᵀ as the A operand (M = value rows, K = tokens), two k-steps
  uint32_t vah[kMT][2][4], val[kMT][2][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int s0 = 8 * ks + c, vr = v0 + 16 * mt + g;
      vah[mt][ks][0] = bits(P.vh[s0][vr]);
      vah[mt][ks][1] = bits(P.vh[s0][vr + 8]);
      vah[mt][ks][2] = bits(P.vh[s0 + 4][vr]);
      vah[mt][ks][3] = bits(P.vh[s0 + 4][vr + 8]);
#pragma unroll
      for (int i = 0; i < 4; ++i) val[mt][ks][i] = 0u;
      if (!kExactV) {
        val[mt][ks][0] = bits(P.vl[s0][vr]);
        val[mt][ks][1] = bits(P.vl[s0][vr + 8]);
        val[mt][ks][2] = bits(P.vl[s0 + 4][vr]);
        val[mt][ks][3] = bits(P.vl[s0 + 4][vr + 8]);
      }
    }
  float acc[kMT][2][4];                              // [m-tile][token tile]
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    // accumulator columns 8j + 2c, 8j + 2c + 1 are the fragment's c, c + 4
    uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      split_tf32(st[mt][j][0], ah[mt][0], al[mt][0]);
      split_tf32(st[mt][j][2], ah[mt][1], al[mt][1]);
      split_tf32(st[mt][j][1], ah[mt][2], al[mt][2]);
      split_tf32(st[mt][j][3], ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      // (hi, lo) of channels 8j + 2c and 8j + 2c + 1
      const float4 b = *reinterpret_cast<const float4*>(&P.q[8 * nt + g][16 * j + 4 * c]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        mma_3x<false>(acc[mt][nt], ah[mt], al[mt], bits(b.x), bits(b.z), bits(b.y),
                      bits(b.w));
    }
  }
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int t = 8 * nt + g, s0 = 8 * ks + c;
      const uint32_t h0 = bits(P.ph[t][s0]), h1 = bits(P.ph[t][s0 + 4]);
      const uint32_t l0 = bits(P.pl[t][s0]), l1 = bits(P.pl[t][s0 + 4]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        mma_3x<kExactV>(acc[mt][nt], vah[mt][ks], val[mt][ks], h0, h1, l0, l1);
    }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tok = t0 + 8 * nt + 2 * c + e;
        if (tok < S) {
          float* out = y + ybase + (long)tok * stride_t + v0 + 16 * mt + g;
          out[0] = acc[mt][nt][e];
          out[8] = acc[mt][nt][2 + e];
        }
      }
  // Sᵀ ← Sᵀ ⊙ D + Vᵀ k̃  (M = value rows, N = channels 8j.., K = tokens)
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const float2 dd = *reinterpret_cast<const float2*>(&P.dec[8 * j + 2 * c]);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      st[mt][j][0] *= dd.x;
      st[mt][j][1] *= dd.y;
      st[mt][j][2] *= dd.x;
      st[mt][j][3] *= dd.y;
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int s0 = 8 * ks + c, ch = 8 * j + g;
      const float2 b0 = *reinterpret_cast<const float2*>(&P.k[s0][2 * ch]);
      const float2 b1 = *reinterpret_cast<const float2*>(&P.k[s0 + 4][2 * ch]);
      const uint32_t h0 = bits(b0.x), h1 = bits(b1.x), l0 = bits(b0.y), l1 = bits(b1.y);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        mma_3x<kExactV>(st[mt][j], vah[mt][ks], val[mt][ks], h0, h1, l0, l1);
    }
  }
}

// Named barriers: 1 + b, chunk in prep[b] ready (producers arrive,
// consumers wait); 3 + b, prep[b] free (consumers arrive, producers wait);
// 5, among the producers.
constexpr int kFull = 1, kEmpty = 3, kProducers = 5;

// The first hd threads (hd/32 warps) are consumers: they hold Sᵀ and run
// the products.  The other 2·hd are producers: they copy, stage and derive
// chunk c + 1 while the consumers multiply chunk c.
template <int HD, typename T>
__global__ void __launch_bounds__(kBlock<HD>, 128 / HD)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            float* __restrict__ y, int S, int H) {
  constexpr int kCons = kConsumers<HD>, kProd = 2 * HD, kAll = kBlock<HD>;
  constexpr int kR = Smem<HD, T>::kR;
  constexpr bool kExactV = sizeof(T) == 2;           // bf16 v is exact in tf32
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD, T>& sm = *reinterpret_cast<Smem<HD, T>*>(smem_raw);
  const int b = blockIdx.x / H, h = blockIdx.x % H, tid = threadIdx.x;
  const long stride_t = (long)H * HD;                // one token on
  const long base = ((long)b * S * H + h) * HD;      // (b, 0, h, 0)
  const int n_chunks = (S + kC - 1) / kC;

  // P is zero above its diagonal in both buffers, and never written there
  for (int i = tid; i < kC * kLdP; i += kAll) {
    (&sm.prep[0].ph[0][0])[i] = 0.f;
    (&sm.prep[0].pl[0][0])[i] = 0.f;
    (&sm.prep[1].ph[0][0])[i] = 0.f;
    (&sm.prep[1].pl[0][0])[i] = 0.f;
  }
  __syncthreads();

  if (tid >= kCons) {                                // producers
    const int pt = tid - kCons;
    const float4 uu = ld4(u + h * HD + 4 * (pt % (HD / 4)));
    for (int c = 0; c < kR - 1; ++c) {
      if (c < n_chunks) issue_chunk(sm, c, r, k, v, w, base, stride_t, c * kC, S, pt);
      cp_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int pb = c & 1;
      if (c >= 2) bar_sync(kEmpty + pb, kAll);       // chunk c - 2 consumed
      cp_wait<kR - 2>();                             // chunk c has landed
      bar_sync(kProducers, kProd);
      // every producer is past derive() of chunk c - 1, the last reader of
      // raw stage (c - 1) % kR: refill it
      const int nx = c + kR - 1;
      if (nx < n_chunks)
        issue_chunk(sm, nx % kR, r, k, v, w, base, stride_t, nx * kC, S, pt);
      cp_commit();
      stage<HD, T, kExactV>(sm, c % kR, pb, pt);
      bar_sync(kProducers, kProd);
      derive(sm, c % kR, pb, pt, uu);
      bar_arrive(kFull + pb, kAll);
    }
  } else {                                           // consumers
    float st[kMT][HD / 8][4];                        // Sᵀ, this warp's rows
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[mt][j][i] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int pb = c & 1;
      bar_sync(kFull + pb, kAll);
      products<HD, T, kExactV>(sm, pb, st, y, base, stride_t, c * kC, S, tid & 31,
                               tid >> 5);
      if (c + 2 < n_chunks) bar_arrive(kEmpty + pb, kAll);
    }
  }
}

template <int HD, typename T>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           float* y, int B, int S, int H, cudaStream_t st) {
  constexpr size_t smem = sizeof(Smem<HD, T>);
  auto kern = wkv6_kernel<HD, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B * H, kBlock<HD>, smem, st>>>(static_cast<const T*>(r), static_cast<const T*>(k),
                                        static_cast<const T*>(v), w, u, y, S, H);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dtype(int dtype, const void* r, const void* k, const void* v, const float* w,
                 const float* u, float* y, int B, int S, int H, cudaStream_t st) {
  if (dtype == 0) return launch<HD, float>(r, k, v, w, u, y, B, S, H, st);
  if (dtype == 1) return launch<HD, __nv_bfloat16>(r, k, v, w, u, y, B, S, H, st);
  return -1;
}

}  // namespace

// Shared memory a block, for the launch arithmetic's check (kernels/wkv6.py)
extern "C" long wkv6_smem_bytes(int hd, int dtype) {
  if (hd == 64) return dtype ? sizeof(Smem<64, __nv_bfloat16>) : sizeof(Smem<64, float>);
  if (hd == 32) return dtype ? sizeof(Smem<32, __nv_bfloat16>) : sizeof(Smem<32, float>);
  return -1;
}

// dtype code of r, k, v: 0 = float32, 1 = bfloat16.  All tensors contiguous
// and 16-byte aligned, head dim 32 or 64.  Returns a cudaError_t (0 =
// launched), or -1 for arguments the kernel does not take.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v, int dtype,
                           const float* w, const float* u, float* y, int B, int S,
                           int H, int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return -1;
  if (hd == 64) return launch_dtype<64>(dtype, r, k, v, w, u, y, B, S, H, st);
  if (hd == 32) return launch_dtype<32>(dtype, r, k, v, w, u, y, B, S, H, st);
  return -1;
}
