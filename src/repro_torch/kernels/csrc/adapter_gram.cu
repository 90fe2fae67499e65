// Batched Gram matrix of adapter stacks, for sm_90a, in one launch:
//   layout 0 ("col"): x (G, K, r) row-major -> out[g] = x[g]ᵀ x[g]
//   layout 1 ("row"): x (G, r, K) row-major -> out[g] = x[g] x[g]ᵀ
// out (G, r, r) fp32.  K is the reduction axis (m of a tall B stack, n of
// a wide A stack); layout 1 reads a wide A stack where it lies, where
// layout 0 would need a transposed copy of it first.
//
// Replaces: src/repro/kernels/adapter_gram.py :: adapter_gram_kernel (the
// Pallas TPU kernel behind repro.kernels.ops.adapter_gram, the first step
// of the server's Gram SVD route, repro.core.svd._gram_matrix).  The TPU
// kernel takes one (m, r) stack and is vmapped over layers × leaves; here
// the batch axis is written out and one call covers a whole bucket.  Rows
// past K are masked (zero-filled copies), as the tail panel is there.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3 at 700 W; data-sheet
// rates 3.35 TB/s, 67 TFLOP/s fp32 on the CUDA cores, 495 TFLOP/s TF32 on
// the tensor cores): the function reads G·K·r floats and needs G·K·r(r+1)
// operations (xᵀx is symmetric).  At the round's shape (G = 32 layers ×
// leaves, K = 2048, r = Σ r_k = 64) that is 17 MB (≈ 5.2 µs) against
// 0.27 GFLOP (≈ 4 µs): bytes.  At r = 128, 34 MB (≈ 10 µs) against 1.08
// GFLOP (≈ 16 µs on the CUDA cores): operations.  Measured on that card
// (scripts/gram_cutouts.py): mma.sync m16n8k8 TF32 runs ≈ 0.6 G
// instructions a second an SM (≈ 160 TFLOP/s over 132 SMs, a third of the
// data sheet's TF32 rate, which needs wgmma), so the three TF32 products
// cost ≈ 6 µs at r 64 and ≈ 22 µs at r 128 on every SM; and the cluster
// shapes the card holds at once cap the SMs a launch uses (30 clusters of
// 4 = 120 SMs, 39 of 3 = 117).  Cold (L2 flushed by a memset, whose dirty
// lines are written back as x comes in), reading the 17 MB once takes
// 19.0 µs for x.sum(), launch included.
//
// What the design does about it:
//   * one launch, no partial sums in device memory: K is split across the
//     S ≤ 8 blocks of a thread-block cluster (kernels/adapter_gram.py ::
//     plan picks the largest S whose G · tiles clusters the H100 holds in
//     one wave: 3 at the round's shapes, 96 SMs); each block sums its
//     rows' tile in registers, its warps' tiles are summed in warp order
//     in shared memory, and the cluster adds the blocks' tiles through
//     distributed shared memory in rank order (float4 loads, all S in
//     flight), each block writing its share of the output rows.  No
//     atomics: the same input gives the same bits every run.
//   * every element read once, 16 bytes a copy (cp.async, zero-filled
//     past K; 4 bytes where rows are not 16-byte multiples), through a
//     ring of 8 stages of 64 rows (tiles of 64 columns; 4 of 128 rows for
//     32 columns, 3 of 64 rows for 128), so most of a block's rows are in
//     flight at once; a diagonal tile reads one strip and uses it as both
//     operands.  One block of 16 warps an SM.
//   * products on the tensor cores, mma.sync m16n8k8 TF32 in 3xTF32
//     (hi·hi + hi·lo + lo·hi, lo·lo dropped: ~2^-20 of each product),
//     interleaved across accumulators.  Plain TF32 keeps about three
//     digits, and the spectra decide the kept ranks, so it is not used.
//   * only tiles with ti ≤ tj, and only 16×16 sub-blocks on or above the
//     diagonal; each output entry comes from the upper triangle and is
//     written with its mirror, so out[g] is exactly symmetric.
//   * tiles: r ≤ 32 and r ≤ 64 are one diagonal tile of 32 / 64 columns
//     (zero-padded); r > 64 runs tiles of 128.  A diagonal tile's 16-wide
//     row blocks are paired (p, NB−1−p), NB+1 sub-blocks a pair, so the
//     warps share the work evenly: 32/NB warps a pair split the stage's
//     rows; an off-diagonal 128×128 tile gives each row block two warps.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 512, kWarps = 16;  // one block an SM
constexpr int kMaxCluster = 8;
constexpr int kMaxDevices = 16;
constexpr int kSmemLimit = 232448;         // dynamic shared memory a block may use

// Rows of K a stage holds: 64, or 128 with tiles of 32 columns (whose 16
// warps on K need 16 k-steps a stage).  Stages of 64 rows let a ring hold
// more of a block's rows and give a 512-row stack 8 slices.
template <int NB>
struct Rows {
  static constexpr int n = NB == 2 ? 128 : 64;
};
// One strip of a stage: col layout [R][T + 8] (row k, column c), row
// layout [T][R + 4] (column c, row k).  The pads make the fragment loads
// below free of bank conflicts (row strides ≡ 8 and ≡ 4 mod 32).
template <int T, bool ROWL, int R>
struct Strip {
  static constexpr int ld = ROWL ? R + 4 : T + 8;
  static constexpr int floats = ROWL ? T * ld : R * ld;
};
// The reduction tile, aliased onto the ring once the loop is done; rows
// padded to a 16-byte multiple for the float4 reads of write_out.
template <int T>
struct Red {
  static constexpr int ld = T + 4;
  static constexpr int floats = T * ld;
};
template <int NB>
struct Cfg {
  static constexpr int stages = NB == 8 ? 3 : NB == 4 ? 8 : 4;   // cp.async ring depth
};

template <int NB, bool ROWL, bool OFF>
constexpr long smem_bytes() {
  using S = Strip<16 * NB, ROWL, Rows<NB>::n>;
  const long ring = 4L * Cfg<NB>::stages * (OFF ? 2 : 1) * S::floats;
  // the warps' partial tiles (NB ≤ 4: 32 / NB of them), red and
  // write_out's loc (up to T rows of T + 1 floats, at cluster 1)
  const long red = 4L * ((NB <= 4 ? 32 / NB + 1 : 1) * Red<16 * NB>::floats
                         + 16 * NB * (16 * NB + 1));
  return ring > red ? ring : red;
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(in ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
  return v;
}

// A 16-column block of a k-step, split for 3xTF32.  g = lane / 4,
// c = lane % 4; v0 = X[k0 + c][16b + g], v1 = X[k0 + c][16b + g + 8],
// v2 = X[k0 + c + 4][16b + g], v3 = X[k0 + c + 4][16b + g + 8].  As the A
// operand of m16n8k8 (rows = the block's columns) it is {v0, v1, v2, v3};
// as the B operand of the block's n8 half h it is {v_h, v_{h+2}}.
// x = hi + lo: the tensor cores read the top 19 bits of a tf32 operand, so
// hi is x itself and lo = x − trunc(x) is exact in fp32 (one LOP3 and one
// FADD; cvt.rna.tf32.f32 expands to several instructions).
struct Frag {
  uint32_t h[4], l[4];
};

template <int T, bool ROWL, int R>
__device__ __forceinline__ Frag load_frag(const float* buf, int blk, int k0, int off) {
  constexpr int ld = Strip<T, ROWL, R>::ld;
  const float* p = ROWL ? buf + 16 * blk * ld + k0 + off : buf + k0 * ld + 16 * blk + off;
  float v[4];
  if (ROWL) {
    v[0] = p[0]; v[1] = p[8 * ld]; v[2] = p[4]; v[3] = p[8 * ld + 4];
  } else {
    v[0] = p[0]; v[1] = p[8]; v[2] = p[4 * ld]; v[3] = p[4 * ld + 8];
  }
  Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.h[i] = __float_as_uint(v[i]);
    f.l[i] = __float_as_uint(v[i] - __uint_as_float(f.h[i] & 0xffffe000u));
  }
  return f;
}

// d += a · b, m16n8k8, tf32 inputs, fp32 accumulators (PTX ISA fragments:
// a0 (g, c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4); b0 (k = c,
// n = g), b1 (k = c + 4, n = g); d0, d1 (g, 2c + {0, 1}), d2, d3 (g + 8, ...)).
// Not volatile: ptxas may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (16 × 16 sub-block, two n8 halves) += Xiᵀ Xj over one k-step, in
// 3xTF32, small terms first; the two halves' chains interleaved
__device__ __forceinline__ void mma_block(float (&acc)[2][4], const Frag& a, const Frag& b) {
#pragma unroll
  for (int h = 0; h < 2; ++h) mma_tf32(acc[h], a.h, b.l[h], b.l[h + 2]);
#pragma unroll
  for (int h = 0; h < 2; ++h) mma_tf32(acc[h], a.l, b.h[h], b.h[h + 2]);
#pragma unroll
  for (int h = 0; h < 2; ++h) mma_tf32(acc[h], a.h, b.h[h], b.h[h + 2]);
}

// Slot s of pair P of a diagonal tile of NB row blocks: the pair holds row
// blocks a = P and b = NB − 1 − P; slots 0 .. NB−a−1 are (a, a + s), the
// rest (b, b + s − (NB − a)).
template <int NB, int P>
struct Pair {
  static constexpr int a = P, b = NB - 1 - P, slots = NB + 1;
  __host__ __device__ static constexpr int ib(int s) { return s < NB - a ? a : b; }
  __host__ __device__ static constexpr int jb(int s) { return s < NB - a ? a + s : b + s - (NB - a); }
};

// One stage of R rows of a diagonal tile for pair P: the warp's k-steps
// kw, kw + KW, ... (KW = 32 / NB warps a pair, NB / 2 pairs)
template <int NB, int P, bool ROWL, int R>
__device__ __forceinline__ void diag_stage(const float* buf, float (&acc)[NB + 1][2][4],
                                           int kw, int off) {
  using Pr = Pair<NB, P>;
  constexpr int T = 16 * NB, KW = 2 * kWarps / NB;
#pragma unroll
  for (int t = 0; t < R / 8 / KW; ++t) {
    const int k0 = 8 * (kw + t * KW);
    const Frag fa = load_frag<T, ROWL, R>(buf, Pr::a, k0, off);
    const Frag fb = load_frag<T, ROWL, R>(buf, Pr::b, k0, off);
#pragma unroll
    for (int j = Pr::a; j < NB; ++j) {
      Frag fj;
      if (j == Pr::a) fj = fa;
      else if (j == Pr::b) fj = fb;
      else fj = load_frag<T, ROWL, R>(buf, j, k0, off);
      mma_block(acc[j - Pr::a], fa, fj);
      if (j >= Pr::b) mma_block(acc[NB - Pr::a + j - Pr::b], fb, fj);
    }
  }
}

template <int NB, int P, bool ROWL, int R>
__device__ __forceinline__ void diag_dispatch(int group, const float* buf,
                                              float (&acc)[NB + 1][2][4], int kw, int off) {
  if constexpr (P < NB / 2) {
    if (group == P) diag_stage<NB, P, ROWL, R>(buf, acc, kw, off);
    else diag_dispatch<NB, P + 1, ROWL, R>(group, buf, acc, kw, off);
  }
}

// The pair's accumulators into the reduction tile (add = false: store)
template <int NB, int P>
__device__ __forceinline__ void diag_store(float* red, const float (&acc)[NB + 1][2][4],
                                           int lane, bool add) {
  using Pr = Pair<NB, P>;
  constexpr int ld = Red<16 * NB>::ld;
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int s = 0; s < Pr::slots; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* p = red + (16 * Pr::ib(s) + g + 8 * (e / 2)) * ld
                   + 16 * Pr::jb(s) + 8 * h + 2 * c + (e % 2);
        *p = add ? *p + acc[s][h][e] : acc[s][h][e];
      }
}

template <int NB, int P>
__device__ __forceinline__ void diag_store_dispatch(int group, float* red,
                                                    const float (&acc)[NB + 1][2][4],
                                                    int lane, bool add) {
  if constexpr (P < NB / 2) {
    if (group == P) diag_store<NB, P>(red, acc, lane, add);
    else diag_store_dispatch<NB, P + 1>(group, red, acc, lane, add);
  }
}

// Copy rows [k, k + R) of a strip (columns or rows c0 .. c0 + w − 1 of r)
// into buf; rows past K are zero-filled.  Columns past w were zeroed once
// at the start and are never written.
template <int T, bool ROWL, int R, bool VEC4>
__device__ __forceinline__ void issue(float* buf, const float* xg, int K, int r,
                                      int k, int c0, int w, int tid) {
  constexpr int ld = Strip<T, ROWL, R>::ld;
  if constexpr (!ROWL) {
    if constexpr (VEC4) {
      const int per = w / 4;
      for (int e = tid; e < R * per; e += kThreads) {
        const int rr = e / per, q = e - rr * per;
        const bool in = k + rr < K;
        cp16(buf + rr * ld + 4 * q, xg + (in ? (long)(k + rr) * r + c0 + 4 * q : 0), in);
      }
    } else {
      for (int e = tid; e < R * w; e += kThreads) {
        const int rr = e / w, q = e - rr * w;
        const bool in = k + rr < K;
        cp4(buf + rr * ld + q, xg + (in ? (long)(k + rr) * r + c0 + q : 0), in);
      }
    }
  } else {
    if constexpr (VEC4) {
      for (int e = tid; e < w * (R / 4); e += kThreads) {
        const int i = e / (R / 4), q = e % (R / 4);
        const bool in = k + 4 * q < K;
        cp16(buf + i * ld + 4 * q, xg + (in ? (long)(c0 + i) * K + k + 4 * q : 0), in);
      }
    } else {
      for (int e = tid; e < w * R; e += kThreads) {
        const int i = e / R, q = e % R;
        const bool in = k + q < K;
        cp4(buf + i * ld + q, xg + (in ? (long)(c0 + i) * K + k + q : 0), in);
      }
    }
  }
}

// Zero the columns (rows, in the row layout) w .. T−1 of every stage's strip
template <int T, bool ROWL, int R>
__device__ __forceinline__ void zero_pad(float* buf, int w, int tid) {
  constexpr int ld = Strip<T, ROWL, R>::ld;
  if (w >= T) return;
  if constexpr (!ROWL) {
    for (int e = tid; e < R * (T - w); e += kThreads) {
      const int rr = e / (T - w);
      buf[rr * ld + w + (e - rr * (T - w))] = 0.f;
    }
  } else {
    for (int e = tid; e < (T - w) * R; e += kThreads)
      buf[(w + e / R) * ld + e % R] = 0.f;
  }
}

// The tile's output from the cluster's reduction tiles.  Block q owns tile
// rows [q·⌈T/S⌉, (q+1)·⌈T/S⌉): for each owned row i and group of 4 columns
// it loads the S blocks' float4 (all S loads in flight before the first
// add) and adds them in rank order into loc (its own shared memory, past
// red); then it writes its rows out[i][·] and their mirror, out[j][i] for
// its i, each along a row of out.  On a diagonal tile only entries with
// j ≥ i exist (red's lower sub-blocks were never written); the owner of
// row j writes the rest as its mirror.
template <int T>
__device__ __forceinline__ void write_out(float* __restrict__ og, const float* red,
                                          float* loc, int r, int ti, int tj, int S,
                                          uint32_t q, int tid) {
  constexpr int ld = Red<T>::ld, G4 = T / 4, lld = T + 1;
  const bool diag = ti == tj;
  const int rows = (T + S - 1) / S, i0 = q * rows, i1 = min(T, i0 + rows), n = i1 - i0;
  uint32_t base[kMaxCluster];
#pragma unroll
  for (int p = 0; p < kMaxCluster; ++p) base[p] = p < S ? map_rank(red, p) : 0;
  for (int e = tid; e < n * G4; e += kThreads) {
    const int i = i0 + e / G4, j0 = 4 * (e % G4);
    if (diag && j0 + 3 < i) continue;
    float4 v[kMaxCluster];
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p)
      if (p < S) v[p] = ld_cluster4(base[p] + 4 * (i * ld + j0));
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p)
      if (p < S) {
        s[0] += v[p].x; s[1] += v[p].y; s[2] += v[p].z; s[3] += v[p].w;
      }
#pragma unroll
    for (int c = 0; c < 4; ++c) loc[(i - i0) * lld + j0 + c] = s[c];
  }
  __syncthreads();
  const int ri = ti * T, rj = tj * T;                 // the tile's first row, column
  for (int e = tid; e < n * T; e += kThreads) {       // out[i][j], along j
    const int i = i0 + e / T, j = e % T;
    if (ri + i < r && rj + j < r && !(diag && j < i))
      og[(long)(ri + i) * r + rj + j] = loc[(i - i0) * lld + j];
  }
  for (int e = tid; e < T * n; e += kThreads) {       // out[j][i], along i
    const int j = e / n, i = i0 + e % n;
    if (ri + i < r && rj + j < r && !(diag && j <= i))
      og[(long)(rj + j) * r + ri + i] = loc[(i - i0) * lld + j];
  }
}

// grid (S · tiles, G), cluster (S, 1, 1); block (tile, rank q) sums K slices
// [q · per, (q + 1) · per) of R rows each.  OFF: the launch has
// off-diagonal tiles (r > 128), two strips a stage.
template <int NB, bool ROWL, bool VEC4, bool OFF>
__global__ void __launch_bounds__(kThreads, 1)
gram_mma(const float* __restrict__ x, float* __restrict__ out, int K, int r, int per) {
  constexpr int T = 16 * NB, NST = Cfg<NB>::stages, R = Rows<NB>::n;
  constexpr int SF = Strip<T, ROWL, R>::floats, ld = Strip<T, ROWL, R>::ld;
  constexpr int stride = OFF ? 2 * SF : SF;           // floats a stage
  extern __shared__ __align__(16) float smem[];
  const uint32_t q = cluster_rank();
  int nclu;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(nclu));
  const int tile = blockIdx.x / nclu, g = blockIdx.y;
  int ti = 0, tj = tile;
  {
    const int strips = (r + T - 1) / T;
    while (tj >= strips - ti) { tj -= strips - ti; ++ti; }
    tj += ti;
  }
  const bool diag = !OFF || ti == tj;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wi = min(T, r - ti * T), wj = min(T, r - tj * T);
  const float* xg = x + (long)g * K * r;
  for (int s = 0; s < NST; ++s) {
    zero_pad<T, ROWL, R>(smem + s * stride, wi, tid);
    if (!diag) zero_pad<T, ROWL, R>(smem + s * stride + SF, wj, tid);
  }
  const int n_slices = (K + R - 1) / R;
  const int s0 = q * per, n = max(0, min(n_slices, s0 + per) - s0);
  auto load_stage = [&](int it) {
    float* buf = smem + (it % NST) * stride;
    const int k = (s0 + it) * R;
    issue<T, ROWL, R, VEC4>(buf, xg, K, r, k, ti * T, wi, tid);
    if (!diag) issue<T, ROWL, R, VEC4>(buf + SF, xg, K, r, k, tj * T, wj, tid);
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n) load_stage(s);
    cp_commit();
  }
  const int off = ROWL ? (lane / 4) * ld + lane % 4 : (lane % 4) * ld + lane / 4;
  float acc[NB + 1][2][4] = {};
  // a diagonal tile: NB / 2 pairs of row blocks, KW warps a pair on K; an
  // off-diagonal one: warp w takes row block w % 8, warps w and w + 8 on K
  constexpr int NG = NB / 2, KW = 2 * kWarps / NB;
  const int group = diag ? warp % NG : warp % 8;
  const int kw = diag ? warp / NG : warp / 8;
  for (int it = 0; it < n; ++it) {
    cp_wait<NST - 2>();
    __syncthreads();                                  // stage it landed; it − 1 consumed
    if (it + NST - 1 < n) load_stage(it + NST - 1);
    cp_commit();
    const float* buf = smem + (it % NST) * stride;
    if (diag) {
      diag_dispatch<NB, 0, ROWL, R>(group, buf, acc, kw, off);
    } else if constexpr (OFF) {
#pragma unroll 2
      for (int t = kw; t < R / 8; t += 2) {
        const Frag fa = load_frag<T, ROWL, R>(buf, group, 8 * t, off);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          mma_block(acc[j], fa, load_frag<T, ROWL, R>(buf + SF, j, 8 * t, off));
      }
    }
  }
  cp_wait<0>();
  __syncthreads();                                    // the ring is free: alias red on it
  constexpr int rld = Red<T>::ld;
  float* red = smem + (NB <= 4 ? KW * Red<T>::floats : 0);
  if constexpr (NB <= 4) {
    // every warp's partial tile at once, then their sum in warp order
    diag_store_dispatch<NB, 0>(group, smem + kw * Red<T>::floats, acc, lane, false);
    __syncthreads();
    for (int e = tid; e < T * T; e += kThreads) {
      const int i = e / T, j = e % T;
      if (i / 16 > j / 16) continue;                  // a sub-block no pair computes
      float v = smem[i * rld + j];
#pragma unroll
      for (int w = 1; w < KW; ++w) v += smem[w * Red<T>::floats + i * rld + j];
      red[i * rld + j] = v;
    }
  }
  const int nkw = NB <= 4 ? 0 : diag ? KW : 2;
  for (int w = 0; w < nkw; ++w) {                     // the warps on K, in order
    if (kw == w) {
      if (diag) {
        diag_store_dispatch<NB, 0>(group, red, acc, lane, w > 0);
      } else if constexpr (OFF) {
        const int gq = lane / 4, c = lane % 4;
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float* p = red + (16 * group + gq + 8 * (e / 2)) * rld + 16 * j + 8 * h
                         + 2 * c + (e % 2);
              *p = w > 0 ? *p + acc[j][h][e] : acc[j][h][e];
            }
      }
    }
    __syncthreads();
  }
  cluster_sync();                                     // every block's tile is ready
  write_out<T>(out + (long)g * r * r, red, red + Red<T>::floats, r, ti, tj, nclu, q, tid);
  __syncwarp();
  cluster_sync();                                     // no block leaves while read
}

template <int NB, bool ROWL, bool VEC4, bool OFF>
int launch(const float* x, float* out, int G, int K, int r, int S, int per, int tiles,
           int smem, cudaStream_t st, int* max_clusters) {
  auto kern = gram_mma<NB, ROWL, VEC4, OFF>;
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return -1;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * tiles, G, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters) return (int)cudaOccupancyMaxActiveClusters(max_clusters, kern, &cfg);
  err = cudaLaunchKernelEx(&cfg, kern, x, out, K, r, per);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int NB, bool OFF>
long smem_for(int layout) {
  return layout ? smem_bytes<NB, true, OFF>() : smem_bytes<NB, false, OFF>();
}

template <int NB, bool OFF>
int launch_nb(const float* x, float* out, int G, int K, int r, int layout, bool vec4,
              int S, int per, int tiles, int smem, cudaStream_t st, int* mc) {
  if (layout)
    return vec4 ? launch<NB, true, true, OFF>(x, out, G, K, r, S, per, tiles, smem, st, mc)
                : launch<NB, true, false, OFF>(x, out, G, K, r, S, per, tiles, smem, st, mc);
  return vec4 ? launch<NB, false, true, OFF>(x, out, G, K, r, S, per, tiles, smem, st, mc)
              : launch<NB, false, false, OFF>(x, out, G, K, r, S, per, tiles, smem, st, mc);
}

}  // namespace

// Shared memory a block, for the launch arithmetic's check
// (kernels/adapter_gram.py :: plan): tile 32, 64 or 128 columns, layout 0
// (col) or 1 (row), one strip a stage (diagonal tiles only) or two.
extern "C" long adapter_gram_smem_bytes(int tile, int layout, int strips) {
  if (tile == 32 && strips == 1) return smem_for<2, false>(layout);
  if (tile == 64 && strips == 1) return smem_for<4, false>(layout);
  if (tile == 128 && strips == 1) return smem_for<8, false>(layout);
  if (tile == 128 && strips == 2) return smem_for<8, true>(layout);
  return -1;
}

// Checks the arguments and launches the build for them, or (mc not null)
// asks the CUDA runtime how many of its clusters the card holds at once.
static int dispatch(const float* x, float* out, int G, int K, int r, int layout, int tile,
             int cluster, int per, int smem, cudaStream_t st, int* mc) {
  if (G < 1 || G > 65535 || K < 1 || r < 1 || layout < 0 || layout > 1 || cluster < 1
      || cluster > kMaxCluster || per < 1)
    return -1;
  const int want_tile = r <= 32 ? 32 : r <= 64 ? 64 : 128;
  if (tile != want_tile) return -1;
  const int strips = (r + tile - 1) / tile;
  const long tiles = (long)strips * (strips + 1) / 2;
  if (tiles * cluster > 0x7fffffffL) return -1;
  const int two = strips > 1;
  if ((long)cluster * per * (tile == 32 ? 128 : 64) < K) return -1;
  if (smem != adapter_gram_smem_bytes(tile, layout, 1 + two) || smem > kSmemLimit) return -1;
  const bool vec4 = reinterpret_cast<uintptr_t>(x) % 16 == 0
                    && (layout ? K % 4 == 0 : r % 4 == 0);
  if (tile == 32)
    return launch_nb<2, false>(x, out, G, K, r, layout, vec4, cluster, per, 1, smem, st, mc);
  if (tile == 64)
    return launch_nb<4, false>(x, out, G, K, r, layout, vec4, cluster, per, 1, smem, st, mc);
  return two ? launch_nb<8, true>(x, out, G, K, r, layout, vec4, cluster, per, (int)tiles,
                                  smem, st, mc)
             : launch_nb<8, false>(x, out, G, K, r, layout, vec4, cluster, per, 1, smem, st,
                                   mc);
}

// x: layout 0 (G, K, r) or layout 1 (G, r, K), fp32, contiguous; out (G, r,
// r) fp32.  tile, cluster (S) and per (K slices of 64 rows a block) are
// adapter_gram.py :: plan's, smem its shared bytes.  Copies are 16 bytes
// where x is 16-byte aligned and rows are multiples of 4 floats, else 4.
// Returns a cudaError_t (0 = launched), or -1 for arguments the kernel
// does not take.
extern "C" int adapter_gram_launch(const float* x, float* out, int G, int K, int r,
                                   int layout, int tile, int cluster, int per, int smem,
                                   void* stream) {
  return dispatch(x, out, G, K, r, layout, tile, cluster, per, smem,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// Clusters of this launch the card holds at once (cudaOccupancyMaxActiveClusters,
// x aligned), or a negative error
extern "C" int adapter_gram_max_clusters(int G, int K, int r, int layout, int tile,
                                         int cluster, int per, int smem) {
  int n = 0;
  const int err = dispatch(reinterpret_cast<const float*>(256), nullptr, G, K, r, layout,
                           tile, cluster, per, smem, nullptr, &n);
  return err ? -err : n;
}
