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
// once (576 elements a slot), the queries and writes the output, and does
// 2·(576 + 512) flops per (query row, visible slot).  At the main path's
// shapes (B 8, H 128, kvr 512, rope 64, ring 1024, bf16; chip_smoke.py's
// rows hold 4,152 resident slots) that is ≈ 9.2 MB, 2.8 µs at 3.35 TB/s,
// at C = 1, and ≈ 76 MB, 22.7 µs, at C = 16, where the 11.9 GFLOP of
// visible pairs take 12 µs on bf16 tensor cores (24 µs as the split
// operands below run them): bytes both times, and at C = 1 latency.  The
// reference computes in fp32; the port keeps fp32-level results on the
// tensor cores by splitting the fp32 operands into bf16 or TF32 parts.
//
// Two routes (mla_ring_decode.py :: route):
//
// "wgmma" — a bf16 cache at DeepSeek-V3's widths (512 + 64), the MLA
// engine's path.  The shape Hopper's MLA decode kernels take:
//   * a block serves 64 query rows (t, h) of one batch row — one wgmma M
//     tile — so the latent ring is read once per 64 rows (twice per batch
//     row at C = 1, 32 times at C = 16), half as often as route "mma";
//   * two warpgroups; thread 0 also issues the TMA loads (a ninth,
//     producer warp would put three warps on one SM sub-partition, whose
//     16 K registers then cap a thread at 168 and spill the accumulators):
//     [c_kv | k_rope] tiles of 32 slots in their stored bf16, 128-byte
//     swizzled (nine 64-column panels), into a two-stage mbarrier ring; the
//     ragged last tile is zero-filled by the map and masked.  Only the
//     ring's resident tiles are visited;
//   * the block's 64 fp32 query rows arrive as one TMA box, raw, in the
//     space their bf16 hi + lo parts then take (Q = hi + lo to ≈ 2^-17 of
//     each element; the cache values are exact in bf16, so each product is
//     exact in fp32; a third part does not fit beside two stages);
//   * S = (Q_hi + Q_lo) Kᵀ runs on wgmma m64n32k16 from shared memory,
//     warpgroup w summing key columns [288 w, 288 w + 288); the two halves
//     meet through 8 KB of shared memory, so both hold S whole and run the
//     same online softmax in registers (one FFMA + ex2 an element, the
//     scale folded into the exponent);
//   * O = P V runs on wgmma m64n64k16 with P as the register A operand,
//     split into an exact-enough bf16 hi + lo pair (≈ 2^-17 of P), and V the
//     c_kv columns of the same staged tile (an MN-major B operand): the
//     value is never loaded twice.  The 64 × 512 fp32 accumulators are
//     split over the two warpgroups, 64 × 256 each, in registers;
//   * where the rows alone do not fill the card (C = 1: 16 row blocks for
//     132 SMs) the ring's resident tiles are split across up to 8 blocks
//     that form one thread-block cluster, as many as one wave holds
//     (mla_ring_decode.py :: splits asks the driver how many such clusters
//     fit: on the H100 fewer than 16 of 8 or 7 blocks, so a C = 1 call
//     runs 6).  A row
//     uses ne = min(nsplit, its resident tiles) splits; with ne = 1
//     (short rings) split 0 normalises in-block and the others leave at
//     once.  Otherwise each block stores its O and (m, l) in its freed
//     query space, and the block of cluster rank k weights and sums one
//     slice of the latent columns over the ne splits through distributed
//     shared memory — the merge runs in the same launch.
//
// "mma" — every other case (fp32 and int8 caches, latent widths other than
// 512 + 64, such as the SMOKE config's 32 + 16), 3xTF32 on mma.sync:
//   * a block serves 32 query rows (t, h) of one batch row, so a latent
//     tile is read once per 32 rows — MLA is ring_decode.cu's grouped case
//     with one KV head, g = H, key width 576 and value width 512;
//   * a block keeps 32 rows × 512 fp32 accumulators in registers, 64 per
//     thread, in the tensor cores' fragment layout;
//   * both products run on the tensor cores as m16n8k8 TF32 mma.sync in
//     3xTF32: every fp32 operand is split into two TF32 parts and
//     hi·hi + hi·lo + lo·hi is accumulated in fp32, which keeps ~21 bits of
//     each product.  bf16 cache values are exact in TF32, so their lo
//     product is skipped.  S = Q Kᵀ splits the 576-wide key across the 8
//     warps (72 columns each); the partial sums meet in shared memory in
//     the softmax step, which runs row by row with lane = slot; O = O·α +
//     P V gives each warp 16 rows × 128 latent columns;
//   * the ring is split across blocks as well (flash-decoding): grid
//     (B · row blocks, nsplit); each block folds its share of the slot
//     tiles into partial (acc, m, l) and a second kernel,
//     mla_merge_splits, merges the splits (the wrapper counts it as a
//     launch).  nsplit = 1 (no merge, in-block normalisation) where the
//     rows alone fill the card;
//   * one shared-memory tile of 32 slots holds [c_kv | k_rope] in fp32;
//     scores read all 576 columns of it and P·V the first 512.  Row strides
//     of 4 mod 32 words keep the fragment loads of Q, K and P free of bank
//     conflicts (V's are 2-way);
//   * the next tile's 16-byte loads travel in registers during the current
//     tile's softmax and P·V; int8 halves are dequantized with their own
//     scales as they are staged.
// Masking deviations from the TPU kernel, with why the result is unchanged:
//   * tiles that hold no resident slot are skipped (the resident slots are
//     one ring interval, so the test is arithmetic).  Every score of such a
//     tile is masked, and a masked score contributes exp(-1e30 - m) = 0 once
//     any visible slot has been seen (a row's own slot is always visible),
//     so skipping it changes nothing;
//   * the TPU wrapper pads cap to a bk multiple (ops.py); here the ragged
//     last tile is masked in-kernel (slots >= cap are never read and score
//     -1e30), so no padded or transposed copy of the cache is made.
// Latent widths on route "mma": the kernel is built for the padded widths
// (LATP, ROPEP) = (32, 32), (64, 64), (128, 64), (256, 64) and (512, 64)
// (a key of a multiple of 64 columns, split over the 8 warps) and takes
// every latent kvr that is a multiple of 16 up to 512 with every RoPE width
// that is a multiple of 16 up to 64, in the first pair that holds both
// (mla_ring_decode.py :: padded_widths).  A tile row is [c_kv, zeros to
// LATP | k_rope, zeros to ROPEP], the queries are laid out the same way, so
// the scores are unchanged; P·V's columns past kvr are zeros and are not
// stored.  Multiples of 16 keep every row a whole number of 16-byte loads
// for all three cache dtypes.
#include <cuda.h>
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

// ------------------------------------------------------ route "wgmma" ----
// bf16 cache at DeepSeek-V3's widths (512 + 64); mla_ring_decode.py ::
// route, splits, split_tiles and smem_bytes mirror the arithmetic below.
constexpr int kWRows = 64;                 // query rows (t, h) a block: one wgmma M tile
constexpr int kWBK = 32;                   // slots a tile
constexpr int kWLat = 512, kWRope = 64;
constexpr int kPanels = (kWLat + kWRope) / 64;      // 128-byte panels of a key row
constexpr int kQParts = 2;                 // Q = hi + lo, both bf16
constexpr int kWStages = 2;
constexpr int kWConsumers = 2;             // warpgroups; each owns 256 latent columns of O
constexpr int kWThreads = kWConsumers * 128;        // thread 0 also issues the TMA loads
constexpr int kQPanel = kWRows * 128;      // bytes of one Q panel (64 rows × 64 columns)
constexpr int kQBytes = kQParts * kPanels * kQPanel;
constexpr int kTPanel = kWBK * 128;        // bytes of one tile panel (32 slots × 64 columns)
constexpr int kTBytes = kPanels * kTPanel; // one stage: [c_kv | k_rope] of 32 slots
constexpr int kWBarOff = kQBytes + kWStages * kTBytes;
constexpr int kWMlOff = kWBarOff + 64;     // [kWRows] (m, l) for the cluster merge
constexpr int kWXOff = kWMlOff + kWRows * 8;          // [4][128] float4: S exchange
constexpr int kWSmem = kWXOff + 4 * 128 * 16 + 1024;  // + alignment slack
constexpr int kKSteps = (kWLat + kWRope) / 16 / kWConsumers;   // S k-steps a warpgroup
constexpr int kMergeLd = kWLat + 8;        // floats a row of the merge buffer: 8 mod 32
                                           // words, so a warp's float2 stores of 8
                                           // rows take two wavefronts
constexpr int kMaxDevices = 64;
constexpr int kMaxSplits = 8;              // a cluster's size at most
static_assert(kWRows * kMergeLd * 4 <= kQBytes, "the merge buffer reuses Q's space");
static_assert(kMaxSplits * kWRows * (8 + 4) <= 4 * 128 * 16, "(m, l) and weights in the exchange space");
static_assert(kWRows * (kWLat + kWRope) * 4 == kQBytes, "raw fp32 Q rows fill Q's space");
static_assert(kWSmem <= 232448, "shared memory of a block");

// byte offset -> 128-byte-swizzled offset within a 1024-aligned region, as
// TMA writes it and wgmma reads it
__device__ __forceinline__ uint32_t swz128(uint32_t off) {
  return off ^ (((off >> 7) & 7u) << 4);
}
// wgmma shared-memory descriptor: start, stride byte offset, 128-byte swizzle
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
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
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(bar)
      : "memory");
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ float2 ld_cluster_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void consumers_sync() {   // the two consumer warpgroups
  asm volatile("bar.sync 1, %0;\n" :: "n"(kWConsumers * 128) : "memory");
}
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the address of the same shared variable in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t saddr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(saddr), "r"(rank));
  return r;
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
// (x0, x1) = hi + lo with hi, lo bf16 pairs (round to nearest; lo keeps
// the next 8 bits), each pair packed as wgmma reads it (x0 in the low half)
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// S += Q Kᵀ over one k-step: m64n32k16, A and B from swizzled shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}
// O += P V over one k-step: m64n64k16, P from registers, V (MN-major) from
// swizzled shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The resident slots are the ring interval of `len` slots starting at
// (pos - len) mod cap: tiles a0 .. a0 + na - 1, then (wrapped) 0 .. nb - 1,
// each tile once (mla_ring_decode.py :: resident_tiles).
struct Resident {
  int a0, na, nb;
  __device__ __forceinline__ int count() const { return na + nb; }
  __device__ __forceinline__ int tile(int i) const { return i < na ? a0 + i : i - na; }
};
__device__ __forceinline__ Resident resident(int pos, int len, int cap) {
  if (len <= 0) return {0, 0, 0};
  const int start = ((pos - len) % cap + cap) % cap;
  const int end_a = min(start + len, cap);
  const int a0 = start / kWBK;
  const int nb = start + len > cap ? min((start + len - cap - 1) / kWBK + 1, a0) : 0;
  return {a0, (end_a - 1) / kWBK - a0 + 1, nb};
}

// One block: 64 query rows (t, h) of batch row b against its split's share
// of the row's resident slot tiles.  Two warpgroups; thread 0 also issues
// the tiles' TMA loads (a ninth, producer warp would put three warps on one
// SM sub-partition and cap a thread at 168 registers, which spills the
// accumulators).  The grid is (nsplit, B · row blocks);
// with nsplit > 1 the splits of a row block form one cluster and merge
// through distributed shared memory.
__global__ void __launch_bounds__(kWThreads, 1)
mla_ring_decode_wgmma(const __grid_constant__ CUtensorMap tc,
                      const __grid_constant__ CUtensorMap tr,
                      const __grid_constant__ CUtensorMap tq, const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sq = base;                        // [part][panel][64 rows][128 B]
  const uint32_t st0 = base + kQBytes;             // [stage][panel][32 slots][128 B]
  const uint32_t bars = base + kWBarOff;           // full[kWStages], empty[kWStages]
  const uint32_t qbar = bars + 8 * (2 * kWStages); // the query rows landed
  float2* ml = reinterpret_cast<float2*>(gbase + kWMlOff);
  float4* xs = reinterpret_cast<float4*>(gbase + kWXOff);

  const int C = a.C, H = a.H, cap = a.cap, window = a.window;
  const int row_blocks = (C * H + kWRows - 1) / kWRows;
  const int split = blockIdx.x, nsplit = a.nsplit;
  const int b = blockIdx.y / row_blocks;
  const int row0 = (blockIdx.y % row_blocks) * kWRows;   // rows are t·H + h
  const int nrows = min(kWRows, C * H - row0);
  const int tid = threadIdx.x;
  const int pos = a.pos[b], len = a.len[b], n = a.n[b];
  float* out = a.out + ((long)b * C * H + row0) * kWLat;

  if (n <= 0) {                                    // inactive row: defined zeros
    if (split == 0)
      for (int i = tid; i < nrows * kWLat; i += kWThreads) out[i] = 0.f;
    return;                                        // the whole cluster shares b
  }
  const Resident res = resident(pos, len, cap);
  // the row's resident tiles in ne contiguous shares of a tile at least;
  // every block of the cluster computes the same ne.  With one share,
  // split 0 normalises in-block and the others leave at once
  const int ne = max(1, min(nsplit, res.count()));
  if (split >= ne && ne == 1) return;
  const int i0 = split < ne ? split * res.count() / ne : 0;
  const int i1 = split < ne ? (split + 1) * res.count() / ne : 0;
  const int ntiles = i1 - i0;

  if (tid == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kWStages + s), kWConsumers * 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const float c = a.scale * 1.4426950408889634f;   // scores enter ex2 as x·c
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float oacc[4][32];
  const int wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int ra = warp * 16 + lane / 4;             // this thread's rows ra, ra + 8
  const int c2 = 2 * (lane % 4);

  // tile i of this split into stage i % kWStages, once both warpgroups
  // released the tile that stage held
  auto issue = [&](int i) {
    const int st = i % kWStages;
    const int s0 = res.tile(i0 + i) * kWBK;
    if (i >= kWStages) mbar_wait(bars + 8 * (kWStages + st), ((i / kWStages) & 1) ^ 1);
    const uint32_t full = bars + 8 * st, dst = st0 + st * kTBytes;
    mbar_expect_tx(full, kTBytes);
#pragma unroll
    for (int p = 0; p < kWLat / 64; ++p)
      tma_load_3d(dst + p * kTPanel, &tc, full, 64 * p, s0, b);
    tma_load_3d(dst + (kWLat / 64) * kTPanel, &tr, full, 0, s0, b);
  };
  if (tid == 0)
    for (int i = 0; i < min(kWStages, ntiles); ++i) issue(i);
  {   // both warpgroups: the queries, then the tiles
    // Q rows as bf16 hi and lo parts, swizzled as TMA would place them: the
    // fp32 rows land first, raw, in the same space (64 × 576 fp32 is exactly
    // its size), as one TMA box issued by thread 0 (rows past the last
    // (b, t, h) are zero-filled; a block's padding rows past nrows may hold
    // the next batch row's queries, which no output row reads)
    if (ntiles > 0) {
      constexpr int kV4 = (kWLat + kWRope) / 4;    // 16-byte chunks a row
      constexpr int kPer = kWRows * kV4 / kWThreads;
      float4* raw4 = reinterpret_cast<float4*>(gbase);
      if (tid == 0) {
        mbar_expect_tx(qbar, kQBytes);
        tma_load_3d(sq, &tq, qbar, 0, 0, (b * C) * H + row0);
      }
      mbar_wait(qbar, 0);
      float4 v[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) v[k] = raw4[tid + kWThreads * k];
      consumers_sync();                            // every raw row is read
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int idx = tid + kWThreads * k, r = idx / kV4, col = 4 * (idx % kV4);
        uint32_t h0, l0, h1, l1;
        split_bf16x2(v[k].x, v[k].y, h0, l0);
        split_bf16x2(v[k].z, v[k].w, h1, l1);
        const uint32_t off = (col / 64) * kQPanel + swz128(r * 128 + (col % 64) * 2);
        *reinterpret_cast<uint2*>(gbase + off) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(gbase + kPanels * kQPanel + off) = make_uint2(l0, l1);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();

    // query positions of rows ra, ra + 8 (a padding row sees no slot)
    int qpos[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ra + 8 * h;
      qpos[h] = r < nrows ? pos - n + (row0 + r) / H : -(1 << 30);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) oacc[p][e] = 0.f;
    const int last = pos - 1;

    for (int i = 0; i < ntiles; ++i) {
      const int st = i % kWStages;
      const uint32_t ph = (i / kWStages) & 1;
      const int s0 = res.tile(i0 + i) * kWBK;
      const uint32_t tile = st0 + st * kTBytes;
      mbar_wait(bars + 8 * st, ph);                // the tile landed

      // S = (Q_hi + Q_lo) Kᵀ: warpgroup wg sums key columns [288 wg, 288 wg +
      // 288), then the two halves meet through shared memory, so that both
      // hold S whole (each thread's 16 scores sit at the same place in both)
      float sacc[16];
      wg_fence();
#pragma unroll
      for (int qp = 0; qp < kQParts; ++qp)
#pragma unroll
        for (int k = 0; k < kKSteps; ++k) {
          const int kk = kKSteps * wg + k;
          const uint32_t p = kk / 4, koff = (kk % 4) * 32;
          wgmma_ss_n32(sacc, make_desc(sq + qp * kPanels * kQPanel + p * kQPanel + koff, 1024),
                       make_desc(tile + p * kTPanel + koff, 1024), qp | k);
        }
      wg_commit();
      wg_wait0();
      reg_fence(sacc);
      if (wg == 1)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xs[e * 128 + wt] = make_float4(sacc[4 * e], sacc[4 * e + 1], sacc[4 * e + 2],
                                         sacc[4 * e + 3]);
      consumers_sync();
      if (wg == 0)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 o = xs[e * 128 + wt];
          sacc[4 * e] += o.x;
          sacc[4 * e + 1] += o.y;
          sacc[4 * e + 2] += o.z;
          sacc[4 * e + 3] += o.w;
          xs[e * 128 + wt] = make_float4(sacc[4 * e], sacc[4 * e + 1], sacc[4 * e + 2],
                                         sacc[4 * e + 3]);
        }
      consumers_sync();
      if (wg == 1)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 o = xs[e * 128 + wt];
          sacc[4 * e] = o.x;
          sacc[4 * e + 1] = o.y;
          sacc[4 * e + 2] = o.z;
          sacc[4 * e + 3] = o.w;
        }

      // mask (residency ∧ causal ∧ window) and online softmax, rows ra (e <
      // 2) and ra + 8; columns 8 j + c2 + e of the tile.  Slot s0 + o holds
      // position base + o, or base + o - cap past the write head (o > d0):
      // one modulo a tile, not one a score
      const int d0 = (((last - s0) % cap) + cap) % cap, base = last - d0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = 8 * j + c2 + e, s = s0 + o;
          const int p_abs = base + o - (o > d0 ? cap : 0);
          const bool live = s < cap && p_abs >= pos - len;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool ok = live && p_abs <= qpos[h] &&
                            (window == 0 || p_abs > qpos[h] - window);
            if (!ok) sacc[4 * j + 2 * h + e] = kNegInf;
          }
        }
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
      }
      const float al_a = ex2((m_a - mx_a) * c), al_b = ex2((m_b - mx_b) * c);
      m_a = mx_a;
      m_b = mx_b;
      const float mc_a = m_a == kNegInf ? 0.f : m_a * c;
      const float mc_b = m_b == kNegInf ? 0.f : m_b * c;
      float sum_a = 0.f, sum_b = 0.f;
      uint32_t ph_[2][4], pl_[2][4];               // P hi and lo as wgmma A fragments
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pv[e] = ex2(fmaf(sacc[4 * j + e], c, -(e < 2 ? mc_a : mc_b)));
          if (e < 2) sum_a += pv[e];
          else sum_b += pv[e];
        }
        // j = 2 kt + u: u = 0 gives registers 0 (row ra) and 1 (row ra +
        // 8), u = 1 registers 2 and 3 (columns + 8)
        split_bf16x2(pv[0], pv[1], ph_[j / 2][2 * (j % 2)], pl_[j / 2][2 * (j % 2)]);
        split_bf16x2(pv[2], pv[3], ph_[j / 2][2 * (j % 2) + 1], pl_[j / 2][2 * (j % 2) + 1]);
      }
      l_a = l_a * al_a + sum_a;                    // per-thread partial sums
      l_b = l_b * al_b + sum_b;
      if (al_a != 1.f || al_b != 1.f) {            // a row's max moved
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int e = 0; e < 32; ++e) oacc[p][e] *= (e & 2) ? al_b : al_a;
      }

      // O += (P_hi + P_lo) V: V is the c_kv columns of the same tile
      wg_fence();
#pragma unroll
      for (int kt = 0; kt < kWBK / 16; ++kt)
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const uint64_t dv = make_desc(tile + (4 * wg + p) * kTPanel + kt * 16 * 128, 1024);
          wgmma_rs_n64(oacc[p], pl_[kt], dv);
          wgmma_rs_n64(oacc[p], ph_[kt], dv);
        }
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int p = 0; p < 4; ++p) reg_fence(oacc[p]);
      mbar_arrive(bars + 8 * (kWStages + st));     // release the slot
      if (tid == 0 && i + kWStages < ntiles) issue(i + kWStages);
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
    }
  }

  if (ne == 1) {
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ra + 8 * h;
      if (r >= nrows) continue;
      const float inv = h ? inv_b : inv_a;
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(out + (long)r * kWLat + 256 * wg + 64 * p + 8 * j + c2) =
              make_float2(oacc[p][4 * j + 2 * h] * inv, oacc[p][4 * j + 2 * h + 1] * inv);
    }
    return;
  }

  // ---- merge of the cluster's splits: every block stores its O and its
  // rows' (m, l) in its (now free) query space; the block of cluster rank k
  // weights and sums latent columns [k·4w4, (k+1)·4w4) over all blocks of
  // the cluster, reading theirs through distributed shared memory ----
  float* mbuf = reinterpret_cast<float*>(gbase);   // [kWRows][kMergeLd]
  consumers_sync();                                // both warpgroups are done with Q
  if (tid < 128 && lane % 4 == 0) {               // warpgroup 0 publishes (m, l)
    ml[ra] = make_float2(m_a, l_a);
    ml[ra + 8] = make_float2(m_b, l_b);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(mbuf + (ra + 8 * h) * kMergeLd + 256 * wg + 64 * p + 8 * j + c2) =
            make_float2(oacc[p][4 * j + 2 * h], oacc[p][4 * j + 2 * h + 1]);
  __syncwarp();
  cluster_sync_all();                              // every split's O and (m, l) are stored
  float* wts = reinterpret_cast<float*>(xs);       // [kWRows][kMaxSplits] merge weights
  if (tid < kWRows) {
    const uint32_t ml_s = static_cast<uint32_t>(__cvta_generic_to_shared(ml + tid));
    float2 v[kMaxSplits];                          // every split's (m, l), loads in flight
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k)
      v[k] = k < ne ? ld_cluster_f2(map_rank(ml_s, k)) : make_float2(kNegInf, 0.f);
    float M = kNegInf;
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k) M = fmaxf(M, v[k].x);
    float L = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k) L += v[k].y * ex2((v[k].x - M) * c);
    const float inv = L > 0.f ? 1.f / L : 0.f;
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k) wts[tid * kMaxSplits + k] = ex2((v[k].x - M) * c) * inv;
  }
  __syncthreads();
  {
    const uint32_t rank = cluster_rank();
    const int w4 = (kWLat / 4 + nsplit - 1) / nsplit;   // float4 columns a slice
    const int f0 = rank * w4, f1 = min(kWLat / 4, f0 + w4);
    const uint32_t mb_s = static_cast<uint32_t>(__cvta_generic_to_shared(mbuf));
    for (int i = tid; i < nrows * (f1 - f0); i += kWThreads) {
      const int r = i / (f1 - f0), f = f0 + i % (f1 - f0);
      const uint32_t off = mb_s + (r * kMergeLd + 4 * f) * 4;
      float4 v[kMaxSplits];                        // loads in flight together
#pragma unroll
      for (int k = 0; k < kMaxSplits; ++k)
        v[k] = k < ne ? ld_cluster_f4(map_rank(off, k)) : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kMaxSplits; ++k) {
        const float w = wts[r * kMaxSplits + k];
        s.x += w * v[k].x; s.y += w * v[k].y; s.z += w * v[k].z; s.w += w * v[k].w;
      }
      *reinterpret_cast<float4*>(out + (long)r * kWLat + 4 * f) = s;
    }
  }
  __syncwarp();
  cluster_sync_all();                              // no block leaves while read
}

// route "mma"'s merge of the splits of one query row (b, t, h), a thread
// per latent column: out = Σ_s acc_s e^(m_s - M) / Σ_s l_s e^(m_s - M),
// M = max_s m_s; rows with n_tokens = 0 get zeros
__global__ void mla_merge_splits(const Args a, int lat) {
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

// a (B, cap, width) bf16 cache half as a 3-D map {width, cap, B} over its
// strides; a box is one 64-column panel of 32 slots, 128-byte swizzled,
// zero-filled past cap
int cache_map(CUtensorMap* map, EncodeTiled enc, const void* ptr, int width, int cap,
              int B, long s_slot, long s_batch) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)cap, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)s_slot * 2, (cuuint64_t)s_batch * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)kWBK, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

// the queries (rows, 576) fp32, rows `s_row` floats apart (B·C·H of them,
// contiguous), as a 3-D map {64, 9, rows}: a box is 64 whole rows, laid out
// row after row, zero-filled past the last row
int query_map(CUtensorMap* map, EncodeTiled enc, const float* q, int rows, long s_row) {
  const cuuint64_t dims[3] = {64, (cuuint64_t)(kWLat + kWRope) / 64, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {64 * 4, (cuuint64_t)s_row * 4};
  const cuuint32_t box[3] = {64, (kWLat + kWRope) / 64, (cuuint32_t)kWRows};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(q),
                         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

// raises a kernel's dynamic shared-memory limit once per device
template <typename K>
int smem_attr(K kern, int bytes, bool (&ready)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return -1;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  return 0;
}

bool wgmma_ready[kMaxDevices] = {};   // route "wgmma"'s shared-memory limit raised

int launch_wgmma(const Args& a, cudaStream_t st) {
  EncodeTiled enc = encoder();
  if (!enc) return -2;
  CUtensorMap tc, tr;
  int rc = cache_map(&tc, enc, a.ckv, kWLat, a.cap, a.B, a.ckv_ss, a.ckv_sb);
  if (rc == 0) rc = cache_map(&tr, enc, a.kr, kWRope, a.cap, a.B, a.kr_ss, a.kr_sb);
  CUtensorMap tq;
  if (rc == 0) rc = query_map(&tq, enc, a.q, a.B * a.C * a.H, a.q_sh);
  if (rc != 0) return rc;
  rc = smem_attr(mla_ring_decode_wgmma, kWSmem, wgmma_ready);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nsplit, a.B * ((a.C * a.H + kWRows - 1) / kWRows), 1);
  cfg.blockDim = dim3(kWThreads, 1, 1);
  cfg.dynamicSmemBytes = kWSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, mla_ring_decode_wgmma, tc, tr, tq, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int LAT, int ROPE, typename KV>
int launch(const Args& a, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<LAT, ROPE>();
  auto kern = mla_ring_decode_kernel<LAT, ROPE, KV>;
  static bool ready[kMaxDevices] = {};
  const int rc = smem_attr(kern, (int)smem, ready);
  if (rc != 0) return rc;
  const dim3 grid(a.B * ((a.C * a.H + kRows - 1) / kRows), a.nsplit);
  kern<<<grid, kThreads, smem, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return (int)err;
  mla_merge_splits<<<a.B * a.C * a.H, a.lat, 0, st>>>(a, a.lat);
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

// How many clusters of `nsplit` blocks of route "wgmma" the current device
// holds at once (cudaOccupancyMaxActiveClusters), into *out.  Returns a
// cudaError_t.  mla_ring_decode.py :: splits lowers nsplit until a C = 1
// call's clusters run in one wave.
extern "C" int mla_ring_decode_max_clusters(int nsplit, int* out) {
  const int rc = smem_attr(mla_ring_decode_wgmma, kWSmem, wgmma_ready);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, 1, 1);
  cfg.blockDim = dim3(kWThreads, 1, 1);
  cfg.dynamicSmemBytes = kWSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, mla_ring_decode_wgmma, &cfg);
}

// dtype codes (cache): 0 = float32, 1 = bfloat16, 2 = int8; q is fp32.
// Strides are in elements; the last axis of q, c_kv and k_rope is
// contiguous, the scales' last axis has extent 1 and both scales share
// strides; cache rows start on 16-byte boundaries.  `route` is 1 for
// "wgmma" (bf16 cache at kvr 512, rope 64; nsplit ≤ 8 splits of each row's
// resident tiles, one cluster, merged in the launch) and 0 for "mma"
// (every dtype and width; with nsplit > 1 the caller provides part_o
// (nsplit,B,C,H,kvr) and part_ml (nsplit,B,C,H,2) fp32 scratch,
// tiles_per_split·nsplit tiles of 32 slots cover cap, and a second kernel,
// mla_merge_splits, merges the splits).  On route "mma" kvr is a multiple
// of 16 up to 512 and rope a multiple of 16 up to 64, run in the first padded pair that holds
// both.  Returns a cudaError_t (0 = launched), -1 for a route, latent width
// or dtype the kernel does not take, -2 when the driver has no
// cuTensorMapEncodeTiled, -3 when it refuses a map.
extern "C" int mla_ring_decode_launch(
    const float* q, long q_sb, long q_sc, long q_sh, const void* ckv, long ckv_sb,
    long ckv_ss, const void* kr, long kr_sb, long kr_ss, int kv_dtype,
    const float* ckv_scale, const float* kr_scale, long sc_sb, long sc_ss,
    const int* pos, const int* len, const int* n, float* out, float* part_o,
    float* part_ml, int B, int C, int H, int kvr, int rope, int cap,
    int window, int route, int nsplit, int tiles_per_split, float scale, void* stream) {
  const Args a{q, q_sb, q_sc, q_sh, ckv, ckv_sb, ckv_ss, kr, kr_sb, kr_ss,
               ckv_scale, kr_scale, sc_sb, sc_ss, pos, len, n, out, part_o,
               part_ml, B, C, H, kvr, rope, cap, window, nsplit,
               tiles_per_split, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (kv_dtype != 1 || kvr != kWLat || rope != kWRope || nsplit < 1 ||
        nsplit > kMaxSplits)
      return -1;
    return launch_wgmma(a, st);
  }
  if (route != 0) return -1;
  if (kvr < 16 || kvr > 512 || kvr % 16 || rope < 16 || rope > 64 || rope % 16)
    return -1;
  if (kvr <= 32 && rope <= 32) return launch_kv<32, 32>(kv_dtype, a, st);
  if (kvr <= 64) return launch_kv<64, 64>(kv_dtype, a, st);
  if (kvr <= 128) return launch_kv<128, 64>(kv_dtype, a, st);
  if (kvr <= 256) return launch_kv<256, 64>(kv_dtype, a, st);
  return launch_kv<512, 64>(kv_dtype, a, st);
}
