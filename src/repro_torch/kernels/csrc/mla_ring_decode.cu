// Flash-decoding over the MLA compressed-latent ring cache, for sm_90a.
//
// Replaces: src/repro/kernels/mla_ring_decode.py :: mla_ring_decode_kernel
// (the Pallas TPU kernel behind repro.kernels.ops.mla_ring_decode).  Same
// contract: absorbed queries q_eff (B,C,H,kvr+rope) fp32 attend the latent
// ring c_kv (B,cap,kvr) and k_rope (B,cap,rope), stored as fp32, bf16 or
// int8 (int8 with SEPARATE per-token (B,cap,1) fp32 scales for the two
// halves: absmax is taken per half, so one concatenated scale would be
// wrong).  It is MQA over the latent: the key of slot s is [c_kv | k_rope],
// its value is c_kv itself, shared by every head.  pos/length/n_tokens (B,)
// are the ring state AFTER the chunk write; the residency ∧ causal ∧ window
// mask is built in-kernel from those scalars; `scale` is passed in (the
// un-absorbed 1/√(nope+rope), not derivable from q's width).  The output
// out_lat (B,C,H,kvr) fp32 is defined on valid query positions
// t < n_tokens[b]; rows with n_tokens = 0 are written as zeros.
//
// What bounds it on the H100.  One call reads the resident latent slots
// once (576 elements a slot) and does 2·(576 + 512) flops per (query row,
// visible slot).  At the main path's shapes (B 8, H 128, kvr 512, rope 64,
// cap 1024, bf16, full ring) that is ≈ 13.9 MB and 2.28 GFLOP at C = 1
// (bytes-bound: ≈ 4 µs at 3.35 TB/s) and ≈ 81 MB and 36.5 GFLOP at C = 16
// (operations-bound on bf16 tensor cores: ≈ 37 µs).  Products on the CUDA
// cores (67 TFLOP/s fp32) cannot come near either; this kernel keeps fp32
// accuracy and still uses the tensor cores (see 3xTF32 below).
//
// What the design does about it:
//   * the TPU grid is (B·H, cap/bk): every query head re-reads the whole
//     latent ring, 128 times per call.  Here a block serves 32 query rows
//     (t, h) of one batch row, so a latent tile is read from device memory
//     once per 32 rows (4 times per batch row at C = 1, the repeats hitting
//     L2) — MLA is ring_decode.cu's grouped case with one KV head,
//     g = H = 128, key width 576 and value width 512;
//   * the accumulators do not fit a block whole (128 heads × 512 fp32 is
//     256 KB per query position), so heads are split across blocks: a block
//     keeps 32 rows × 512 fp32 accumulators in registers, 64 per thread, in
//     the tensor cores' fragment layout;
//   * both products run on the tensor cores as m16n8k8 TF32 mma.sync in
//     3xTF32: every fp32 operand is split into two TF32 parts and
//     hi·hi + hi·lo + lo·hi is accumulated in fp32, which keeps ~21 bits of
//     each product — the fp32 route's accuracy (the plain version is fp32),
//     not TF32's 10 bits.  bf16 cache values are exact in TF32, so their lo
//     product is skipped.  S = Q Kᵀ splits the 576-wide key across the 8
//     warps (72 columns each); a warp accumulates all 32 × 32 scores of its
//     columns in 8 independent 16×8 tiles (no chain of dependent mma), and
//     the partial sums meet in shared memory in the softmax step, which
//     runs row by row with lane = slot; O = O·α + P V gives each warp 16
//     rows × 128 latent columns;
//   * the ring is split across blocks as well (flash-decoding): grid
//     (B · row blocks, nsplit); each block folds its share of the slot tiles
//     into partial (acc, m, l) and a second small kernel merges the splits.
//     At C = 1 there are only 32 row blocks for 132 SMs; the wrapper picks
//     nsplit for ~2 blocks per SM, and nsplit = 1 (no merge, in-block
//     normalisation) when the rows alone fill the card (C = 16);
//   * one shared-memory tile of 32 slots holds [c_kv | k_rope] in fp32;
//     scores read all 576 columns of it and P·V the first 512, so the value
//     is never loaded twice.  Row strides of 4 mod 32 words keep the
//     fragment loads of Q, K and P free of bank conflicts (V's are 2-way);
//   * the next tile's 16-byte loads travel in registers during the current
//     tile's softmax and P·V (issued after the scores, so the score phase's
//     accumulators and the staged loads are never live together); int8 halves are dequantized with their own scales as
//     they are staged, so no full-precision cache copy exists.
// Masking deviations from the TPU kernel, with why the result is unchanged:
//   * tiles that hold no resident slot are skipped (the resident slots are
//     one ring interval, so the test is arithmetic).  Every score of such a
//     tile is masked, and a masked score contributes exp(-1e30 - m) = 0 once
//     any visible slot has been seen (a row's own slot is always visible),
//     so skipping it changes nothing;
//   * the TPU wrapper pads cap to a bk multiple (ops.py); here the ragged
//     last tile is masked in-kernel (slots >= cap are never read and score
//     -1e30), so no padded or transposed copy of the cache is made.
// Latent widths: the kernel is built for the padded widths (LATP, ROPEP) =
// (32, 32), (64, 64), (128, 64), (256, 64) and (512, 64) (a key of a
// multiple of 64 columns, split over the 8 warps) and takes every latent
// kvr that is a multiple of 16 up to 512 with every RoPE width that is a
// multiple of 16 up to 64, in the first pair that holds both
// (mla_ring_decode.py :: padded_widths): DeepSeek-V3's 512 + 64 as they
// are, its SMOKE config's 32 + 16 in (32, 32).  A tile row is [c_kv, zeros
// to LATP | k_rope, zeros to ROPEP], the queries are laid out the same
// way, so the scores are unchanged; P·V's columns past kvr are zeros and
// are not stored.  Multiples of 16 keep every row a whole number of
// 16-byte loads for all three cache dtypes.
// Not done yet: wgmma with TMA-fed tiles, a bf16 route (one product instead
// of two or three) where its rounding is acceptable.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;             // query rows (t, h) per block
constexpr int kRW = kRows / kWarps;   // rows per warp
constexpr int kBK = 32;               // latent slots per tile: one per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// absolute position held by ring slot s; floor modulo, as jnp.mod: last - s
// is negative for never-written slots and slots ahead of the write head
__device__ __forceinline__ int slot_pos(int last, int s, int cap) {
  return last - (((last - s) % cap) + cap) % cap;
}

// 16 bytes of cache elements to floats, in registers (bf16 -> fp32 is a
// shift; int8 is sign-extended byte by byte)
__device__ __forceinline__ void unpack(uint4 r, float (&o)[4]) {
  o[0] = __uint_as_float(r.x); o[1] = __uint_as_float(r.y);
  o[2] = __uint_as_float(r.z); o[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(uint4 r, float (&o)[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(uint4 r, float (&o)[16]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      o[4 * i + b] = static_cast<float>(static_cast<int>(w[i] << (24 - 8 * b)) >> 24);
}

// first tile in [s0, s_end) that holds a resident slot (s_end if none).  The
// resident slots are the ring interval of `len` slots starting at
// (pos - len) mod cap, so the test is two interval intersections; every
// thread computes the same answer, with no barrier.
__device__ __forceinline__ int next_tile(int s0, int s_end, int pos, int len,
                                         int cap) {
  if (len <= 0) return s_end;
  const int start = ((pos - len) % cap + cap) % cap;
  for (; s0 < s_end; s0 += kBK) {
    const int s1 = min(s0 + kBK, cap);
    if ((start < s1 && s0 < start + len) ||
        (start - cap < s1 && s0 < start + len - cap))
      return s0;
  }
  return s_end;
}

struct Args {
  const float* q;
  long q_sb, q_sc, q_sh;
  const void* ckv;
  long ckv_sb, ckv_ss;
  const void* kr;
  long kr_sb, kr_ss;
  const float* ckv_scale;
  const float* kr_scale;
  long sc_sb, sc_ss;
  const int* pos;
  const int* len;
  const int* n;
  float* out;        // (B, C, H, kvr)
  float* part_o;     // (nsplit, B, C, H, kvr) unnormalized accumulators
  float* part_ml;    // (nsplit, B, C, H, 2) running max and normalizer
  int B, C, H, lat, rope, cap, window, nsplit, tiles_per_split;
  float scale;
};

constexpr int kPad = 4;      // shared row pad: a stride of 4 mod 32 words keeps
                             // the mma fragment loads free of bank conflicts
constexpr int kSP = kBK + kPad;   // row stride of the score / probability tile

template <int LAT, int ROPE>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * (size_t)kRows * (LAT + ROPE + kPad) +
                          (size_t)(kWarps + 1) * kRows * kSP + 3 * (size_t)kRows);
}

// fp32 -> tf32 (round to nearest), the tensor cores' 19-bit input format
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with hi, lo both tf32: the 3xTF32 split.  hi·hi + hi·lo +
// lo·hi keeps ~21 bits of every product, fp32-level accuracy from tensor
// cores; lo·lo (~2^-22 relative) is dropped.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a · b on the tensor cores, m16n8k8, tf32 inputs, fp32 accumulators.
// Fragments (PTX ISA, mma.m16n8k8 .tf32), g = lane / 4, t = lane % 4:
//   a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)  of A 16×8;
//   b0 (k = t, n = g), b1 (k = t + 4, n = g)                      of B 8×8;
//   d0, d1 (g, 2t + {0, 1}), d2, d3 (g + 8, 2t + {0, 1})          of D 16×8.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a · b in 3xTF32, small terms first; with kExactB the b operand is
// exact in tf32 (bf16 cache values), so its lo part is zero and skipped
template <bool kExactB>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0,
                                           float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  if (!kExactB) mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// LAT and ROPE are the padded widths; a.lat <= LAT and a.rope <= ROPE the true ones
template <int LAT, int ROPE, typename KV>
__global__ void __launch_bounds__(kThreads, 1)
mla_ring_decode_kernel(const Args a) {
  constexpr int DQ = LAT + ROPE;                 // padded key (and query) width
  constexpr int KS = DQ + kPad;                  // shared row stride of a slot / query
  constexpr int kVec = 16 / sizeof(KV);          // cache elements per 16-byte load
  constexpr int kC1 = LAT / kVec;                // 16-byte chunks of a c_kv row
  constexpr int kRowChunks = kC1 + ROPE / kVec;  // ... of a [c_kv | k_rope] row
  constexpr int kChunks = kBK * kRowChunks;      // chunks per tile
  constexpr int kPer = (kChunks + kThreads - 1) / kThreads;
  constexpr int kNT = LAT / 4 / 8;               // P·V n-tiles of 8 columns per warp
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr bool kExact = sizeof(KV) == 2;       // bf16 values are exact in tf32
  static_assert(kRows == 32 && kBK == 32 && kWarps == 8,
                "the warp layout below assumes 32 rows, 32 slots, 8 warps");
  static_assert(LAT % 32 == 0 && ROPE % 16 == 0 && DQ % (8 * kWarps) == 0 &&
                    KS % 32 == kPad,
                "latent width a multiple of 32, rope of 16, key of 64");
  constexpr int kKW = DQ / 8 / kWarps;          // score k-steps of 8 per warp

  const KV* __restrict__ ckv = static_cast<const KV*>(a.ckv);
  const KV* __restrict__ kr = static_cast<const KV*>(a.kr);
  const int C = a.C, H = a.H, cap = a.cap, window = a.window;
  const int lat = a.lat, rope = a.rope;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int row_blocks = (C * H + kRows - 1) / kRows;
  const int b = blockIdx.x / row_blocks;
  const int row0 = (blockIdx.x % row_blocks) * kRows;   // rows are t·H + h
  const int nrows = min(kRows, C * H - row0);
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;                         // mma fragment coordinates
  const int tg = lane % 4;

  float* qs = smem;                               // [kRows][KS] queries
  float* ks = qs + kRows * KS;                    // [kBK][KS]: [c_kv | k_rope]
  float* sp = ks + kBK * KS;                      // [kRows][kSP] probabilities
  float* red = sp + kRows * kSP;                  // [kWarps][kRows][kSP] partial scores
  float* alpha_s = red + kWarps * kRows * kSP;    // [kRows] rescale of this tile
  float* m_s = alpha_s + kRows;                   // [kRows] final running max
  float* l_s = m_s + kRows;                       // [kRows] final normalizer

  const int pos = a.pos[b];
  const int len = a.len[b];
  const int n = a.n[b];
  const int last = pos - 1;
  const long brow = (long)b * C * H + row0;       // output row of this block's row 0
  // this block's key range; the merge kernel handles rows with n <= 0
  const int s_begin = split * a.tiles_per_split * kBK;
  const int s_end = min(cap, s_begin + a.tiles_per_split * kBK);

  if (n <= 0) {                                   // inactive row: defined zeros
    if (a.nsplit == 1)
      for (int i = tid; i < nrows * lat; i += kThreads) a.out[brow * lat + i] = 0.f;
    return;
  }

  // queries, a row per warp at a time in 16-byte loads, laid out as the
  // tiles are ([latent, zeros to LAT | rope, zeros to ROPE]); rows past
  // nrows are zeros (computed, never written out)
  for (int r = warp; r < kRows; r += kWarps) {
    const int rr = row0 + r;
    const float* src = a.q + b * a.q_sb + (long)(rr / H) * a.q_sc + (long)(rr % H) * a.q_sh;
    for (int d = 4 * lane; d < DQ; d += 4 * 32) {
      const int col = d < LAT ? (d < lat ? d : -1) : (d - LAT < rope ? lat + d - LAT : -1);
      *reinterpret_cast<float4*>(qs + r * KS + d) =
          r < nrows && col >= 0 ? *reinterpret_cast<const float4*>(src + col)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  const KV* cb = ckv + b * a.ckv_sb;
  const KV* rb = kr + b * a.kr_sb;
  const float* csb = kQuant ? a.ckv_scale + b * a.sc_sb : nullptr;
  const float* rsb = kQuant ? a.kr_scale + b * a.sc_sb : nullptr;

  // the next tile's 16-byte chunks travel in registers while the current
  // tile is computed from shared memory
  uint4 raw[kPer];
  float scl[kPer];
  auto load = [&](int s0) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int c = tid + p * kThreads;
      const int s = s0 + c / kRowChunks;
      const int w = c % kRowChunks;
      raw[p] = make_uint4(0, 0, 0, 0);
      scl[p] = 1.f;
      if (c < kChunks && s < cap &&
          (w < kC1 ? w * kVec < lat : (w - kC1) * kVec < rope)) {   // zeros past the widths
        if (w < kC1) {
          raw[p] = *reinterpret_cast<const uint4*>(cb + s * a.ckv_ss + w * kVec);
          if (kQuant) scl[p] = csb[s * a.sc_ss];
        } else {
          raw[p] = *reinterpret_cast<const uint4*>(rb + s * a.kr_ss + (w - kC1) * kVec);
          if (kQuant) scl[p] = rsb[s * a.sc_ss];
        }
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int c = tid + p * kThreads;
      if (c >= kChunks) continue;
      const int j = c / kRowChunks;
      const int w = c % kRowChunks;
      const int col = w < kC1 ? w * kVec : LAT + (w - kC1) * kVec;
      float e[kVec];
      unpack(raw[p], e);
      float* dst = ks + j * KS + col;
#pragma unroll
      for (int v = 0; v < kVec; v += 4)
        *reinterpret_cast<float4*>(dst + v) =
            make_float4(e[v] * scl[p], e[v + 1] * scl[p], e[v + 2] * scl[p],
                        e[v + 3] * scl[p]);
    }
  };

  // online-softmax state: warp w owns rows 4w .. 4w + 3 (lane = slot)
  float m[kRW], l[kRW];
#pragma unroll
  for (int i = 0; i < kRW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  // P·V accumulators: warp w owns rows 16 (w / 4) + {g, g + 8} and latent
  // columns 128 (w % 4) + 8 j + 2 tg + {0, 1}
  const int pv_row = 16 * (warp / 4);
  const int pv_col = (LAT / 4) * (warp % 4);
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int s0 = next_tile(s_begin, s_end, pos, len, cap);
  if (s0 < s_end) load(s0);
  while (s0 < s_end) {
    __syncthreads();              // every warp is done with the last tile
    store();
    __syncthreads();

    // scores S = Q Kᵀ, the 576-wide key split across warps: warp w sums its
    // kKW k-steps for all 32 × 32 scores (2 × 4 independent 16×8 tiles, so
    // the tensor cores see 8 independent accumulator chains) and leaves the
    // partial sums in red[w]
    {
      float c[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0.f;
#pragma unroll 3
      for (int kk = 0; kk < kKW; ++kk) {
        const int k0 = 8 * (warp * kKW + kk);
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* qa = qs + (16 * mt + g) * KS + k0 + tg;
          split_tf32(qa[0], ah[mt][0], al[mt][0]);
          split_tf32(qa[8 * KS], ah[mt][1], al[mt][1]);
          split_tf32(qa[4], ah[mt][2], al[mt][2]);
          split_tf32(qa[8 * KS + 4], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* kb = ks + (8 * nt + g) * KS + k0 + tg;
          const float b0 = kb[0], b1 = kb[4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_3xtf32<kExact>(c[mt][nt], ah[mt], al[mt], b0, b1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float* so = red + (warp * kRows + 16 * mt + g) * kSP + 8 * nt + 2 * tg;
          so[0] = c[mt][nt][0];
          so[1] = c[mt][nt][1];
          so[8 * kSP] = c[mt][nt][2];
          so[8 * kSP + 1] = c[mt][nt][3];
        }
    }
    // the next tile's loads fly during the softmax and P·V
    const int s_next = next_tile(s0 + kBK, s_end, pos, len, cap);
    if (s_next < s_end) load(s_next);
    __syncthreads();

    // mask and online softmax, row by row: lane owns slot s0 + lane
    const int s = s0 + lane;
    const int p_abs = slot_pos(last, s, cap);
    const bool res = s < cap && p_abs >= pos - len;
#pragma unroll
    for (int i = 0; i < kRW; ++i) {
      const int r = warp * kRW + i;
      const int qpos = pos - n + (row0 + r) / H;
      const bool ok = res && p_abs <= qpos && (window == 0 || p_abs > qpos - window);
      float dot = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) dot += red[(w * kRows + r) * kSP + lane];
      const float x = ok ? dot * a.scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float alpha = expf(m[i] - m_new);
      const float p = expf(x - m_new);
      sp[r * kSP + lane] = p;
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

    // O = O · alpha + P V; the value is the c_kv part of the same tile
    {
      const float al0 = alpha_s[pv_row + g], al1 = alpha_s[pv_row + g + 8];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        acc[j][0] *= al0;
        acc[j][1] *= al0;
        acc[j][2] *= al1;
        acc[j][3] *= al1;
      }
      const float* pa = sp + (pv_row + g) * kSP + tg;
#pragma unroll
      for (int k0 = 0; k0 < kBK; k0 += 8) {
        uint32_t ah[4], al[4];
        split_tf32(pa[k0], ah[0], al[0]);
        split_tf32(pa[8 * kSP + k0], ah[1], al[1]);
        split_tf32(pa[k0 + 4], ah[2], al[2]);
        split_tf32(pa[8 * kSP + k0 + 4], ah[3], al[3]);
        const float* vb = ks + (k0 + tg) * KS + pv_col + g;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_3xtf32<kExact>(acc[j], ah, al, vb[8 * j], vb[4 * KS + 8 * j]);
      }
    }
    s0 = s_next;
  }

  // the row owners publish m and l; every warp writes its accumulators
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < kRW; ++i) {
      m_s[warp * kRW + i] = m[i];
      l_s[warp * kRW + i] = l[i];
    }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = pv_row + g + 8 * h;
    if (r >= nrows) continue;
    const long row = brow + r;
    if (a.nsplit == 1) {
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        if (pv_col + 8 * j < lat)
          *reinterpret_cast<float2*>(a.out + row * lat + pv_col + 8 * j + 2 * tg) =
              make_float2(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
    } else {
      const long prow = (long)split * a.B * C * H + row;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        if (pv_col + 8 * j < lat)
          *reinterpret_cast<float2*>(a.part_o + prow * lat + pv_col + 8 * j + 2 * tg) =
              make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      if (warp % 4 == 0 && tg == 0) {
        a.part_ml[prow * 2] = m_s[r];
        a.part_ml[prow * 2 + 1] = l_s[r];
      }
    }
  }
}

// merge the splits of one query row (b, t, h): out = Σ_s acc_s e^(m_s - M) /
// Σ_s l_s e^(m_s - M), M = max_s m_s; rows with n_tokens = 0 get zeros
__global__ void merge_splits_kernel(const Args a, int lat) {
  const long row = blockIdx.x;                    // (b * C + t) * H + h
  const int d = threadIdx.x;
  const int b = row / ((long)a.C * a.H);
  const long rows = (long)a.B * a.C * a.H;
  if (d >= lat) return;
  if (a.n[b] <= 0) {
    a.out[row * lat + d] = 0.f;
    return;
  }
  float M = kNegInf;
  for (int s = 0; s < a.nsplit; ++s) M = fmaxf(M, a.part_ml[(s * rows + row) * 2]);
  float L = 0.f, o = 0.f;
  for (int s = 0; s < a.nsplit; ++s) {
    const float w = expf(a.part_ml[(s * rows + row) * 2] - M);
    L += a.part_ml[(s * rows + row) * 2 + 1] * w;
    o += a.part_o[(s * rows + row) * lat + d] * w;
  }
  a.out[row * lat + d] = o / fmaxf(L, 1e-30f);
}

template <int LAT, int ROPE, typename KV>
int launch(const Args& a, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<LAT, ROPE>();
  auto kern = mla_ring_decode_kernel<LAT, ROPE, KV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * ((a.C * a.H + kRows - 1) / kRows), a.nsplit);
  kern<<<grid, kThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return (int)err;
  merge_splits_kernel<<<a.B * a.C * a.H, a.lat, 0, st>>>(a, a.lat);
  return (int)cudaGetLastError();
}

template <int LAT, int ROPE>
int launch_kv(int kv_dtype, const Args& a, cudaStream_t st) {
  if (kv_dtype == 0) return launch<LAT, ROPE, float>(a, st);
  if (kv_dtype == 1) return launch<LAT, ROPE, __nv_bfloat16>(a, st);
  if (kv_dtype == 2) return launch<LAT, ROPE, int8_t>(a, st);
  return -1;
}

}  // namespace

// dtype codes (cache): 0 = float32, 1 = bfloat16, 2 = int8; q is fp32.
// Strides are in elements; the last axis of q, c_kv and k_rope is
// contiguous, the scales' last axis has extent 1 and both scales share
// strides; cache rows start on 16-byte boundaries.  With nsplit > 1 the
// caller provides part_o (nsplit,B,C,H,kvr) and part_ml (nsplit,B,C,H,2)
// fp32 scratch; tiles_per_split·nsplit tiles of 32 slots cover cap.  kvr
// is a multiple of 16 up to 512 and rope a multiple of 16 up to 64, run in
// the first padded pair that holds both.  Returns a cudaError_t (0 =
// launched), or -1 for a latent width / dtype the kernel does not take.
extern "C" int mla_ring_decode_launch(
    const float* q, long q_sb, long q_sc, long q_sh, const void* ckv, long ckv_sb,
    long ckv_ss, const void* kr, long kr_sb, long kr_ss, int kv_dtype,
    const float* ckv_scale, const float* kr_scale, long sc_sb, long sc_ss,
    const int* pos, const int* len, const int* n, float* out, float* part_o,
    float* part_ml, int B, int C, int H, int kvr, int rope, int cap, int window,
    int nsplit, int tiles_per_split, float scale, void* stream) {
  const Args a{q, q_sb, q_sc, q_sh, ckv, ckv_sb, ckv_ss, kr, kr_sb, kr_ss,
               ckv_scale, kr_scale, sc_sb, sc_ss, pos, len, n, out, part_o,
               part_ml, B, C, H, kvr, rope, cap, window, nsplit, tiles_per_split,
               scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kvr < 16 || kvr > 512 || kvr % 16 || rope < 16 || rope > 64 || rope % 16)
    return -1;
  if (kvr <= 32 && rope <= 32) return launch_kv<32, 32>(kv_dtype, a, st);
  if (kvr <= 64) return launch_kv<64, 64>(kv_dtype, a, st);
  if (kvr <= 128) return launch_kv<128, 64>(kv_dtype, a, st);
  if (kvr <= 256) return launch_kv<256, 64>(kv_dtype, a, st);
  return launch_kv<512, 64>(kv_dtype, a, st);
}
