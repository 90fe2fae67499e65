// Flash-decoding over a per-slot ring-buffer KV cache (GQA), for sm_90a.
//
// Replaces: src/repro/kernels/ring_decode.py :: ring_decode_kernel (the
// Pallas TPU kernel behind repro.kernels.ops.ring_decode).  Same contract:
// q (B,C,H,hd) attends k/v (B,cap,K,hd) stored as fp32, bf16 or int8 (int8
// with per-token (B,cap,K,1) fp32 scales); pos/length/n_tokens (B,) are the
// ring state AFTER the chunk write; the residency ∧ causal ∧ window mask is
// built in-kernel from those scalars; the output is (B,C,H,hd) fp32 and is
// defined on valid query positions t < n_tokens[b] (rows with n_tokens = 0
// are written as zeros).  Scores, softmax and sums are fp32 from the stored
// values, as the reference computes them.
//
// What bounds it on the H100: reading K/V.  One decode step of one layer
// reads B·cap·K·hd·2 cache elements and does 4·B·H·C·cap·hd flops, so at
// C = 1 it is far below the card's ~295 flop/byte balance point: memory
// bound (3.35 TB/s; 2.6 µs at the main shape).  At C = 16 (g = 4) it does
// 64 flops per byte of bf16 cache, more than fp32 CUDA cores keep up with
// but far below the bf16 tensor cores' balance point.  A launch this small
// is set by latency: how many bytes each SM keeps in flight, and how soon
// the last split's result is merged.
//
// What the design does about it:
//   * a block serves one (b, kv head) and a group of its g = H/K query heads
//     × C queries, so every K/V tile is read once per group;
//   * the ring's RESIDENT tiles (one ring interval, so the set is
//     arithmetic) are split across blocks: each (b, kv head, row group)
//     runs as many splits as give every split at least kMinTiles tiles, up
//     to the grid's nsplit; a split whose share is empty exits at once.
//     The last split to finish (an atomic ticket on a per-group counter,
//     reset by that block) merges the partial (acc, m, l) of all splits in
//     the same launch: no second kernel;
//   * tiles of 64 slots travel by cp.async into a ring of 2–4 shared-memory
//     stages (as many as fit in 112 KB; 72 KB on the arithmetic-bound
//     kRows route, for more blocks an SM), in their storage dtype — bf16,
//     int8 or fp32, never widened — with int8's per-token scales beside
//     them; values are converted to fp32 (and int8 scaled) in registers as
//     they are used.  Rows are padded by 16 bytes so that the 16-byte reads
//     of eight neighbouring slots hit distinct banks;
//   * four routes share the ring, the split and the merge, chosen by the
//     dtypes and the g·C rows of a KV head.  bf16 queries and cache take
//     the tensor cores (mma.sync m16n8k16 / m16n8k8, bf16 → fp32; the
//     products of bf16 values are exact in fp32, so only the summation
//     order differs from the reference; P enters P·V as a bf16 hi + lo
//     pair against the bf16 V, so it keeps fp32 precision to ≈ 2^-16):
//     kNarrow up to 16 rows (decode at C = 1: one 16-row tile, each of the
//     8 warps on 8 keys of every tile), kTensor above (the engine's prefill
//     chunk: 64 rows, each warp on 16 rows and 32 keys).  fp32 and int8
//     caches, and fp32 queries, take the CUDA cores: kKeys up to 8 rows
//     (each warp on 8 keys for all rows: four lanes a key for the scores,
//     lanes over head dims for P·V), kRows above (32 rows, each warp on 4
//     of them for all 64 keys, P through shared memory).  Where warps
//     share rows, each keeps its own online-softmax state, combined once,
//     in shared memory, after the last tile;
//   * the cache is read in its (B,cap,K,hd) layout through strides, and the
//     ragged last tile is masked in-kernel: no transposed or padded copy.
//
// Head dims: the routes are built for the tile widths HDP = 16, 32, 64 and
// 128 and take every hd that is a multiple of 8 up to 128 in the next of
// them.  The ring stages HDP-wide tiles whose columns past hd are
// zero-filled by the copies (cp.async with a source size of 0), queries
// are zeros there too, so scores are unchanged, P·V's extra columns are
// zeros, and the combine and merge write hd columns.  A row of hd elements
// is a multiple of 16 bytes for fp32 and bf16; an int8 row whose hd is not
// a multiple of 16 (hd 56: 56 bytes) starts on an 8-byte boundary only,
// so such tiles travel as 8-byte copies.  The tensor-core routes keep a
// build with hd fixed at the tile width for the widths that fill it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;            // key slots per tile
// routes: CUDA cores with each warp on 8 keys of a tile for all of at most
// 8 rows (kKeys); CUDA cores with each warp on 4 of 32 rows for all keys
// (kRows); tensor cores with each warp on 8 keys of a tile for one 16-row
// tile (kNarrow); tensor cores with each warp on 16 of 64 rows and 32 keys
// (kTensor)
enum Route { kKeys = 0, kRows = 1, kTensor = 2, kNarrow = 3 };
constexpr int kCoreRows = 8;       // query rows per block, kKeys
constexpr int kNarrowRows = 16;    // query rows per block, kNarrow
constexpr int kSplitRows = 32;     // query rows per block, kRows
constexpr int kWideRows = 64;      // query rows per block, kTensor
constexpr int kMinTiles = 4;       // a split walks at least this many resident tiles
constexpr int kRingBudget = 112 * 1024;   // leaves room for two blocks an SM
constexpr int kRowsRingBudget = 72 * 1024; // kRows is bound by arithmetic: blocks over stages
constexpr float kNegInf = -1e30f;
constexpr int kNoPos = -(1 << 30);   // query position of a padding row: sees no key

template <int HD, typename KV, int ROUTE>
struct Ring {
  static constexpr bool QUANT = sizeof(KV) == 1;
  static constexpr int VEC = 16 / sizeof(KV);          // elements per 16-byte chunk
  static constexpr int CH = HD * sizeof(KV) / 16;      // chunks per slot row
  static constexpr int ROW = HD * sizeof(KV) + 16;     // padded slot row, bytes
  static constexpr int TILE = kBK * ROW;
  static constexpr int STAGE = 2 * TILE + (QUANT ? 2 * kBK * 4 : 0);
  static constexpr int FIT = (ROUTE == kRows ? kRowsRingBudget : kRingBudget) / STAGE;
  static constexpr int STAGES = FIT < 2 ? 2 : FIT > 4 ? 4 : FIT;
  static constexpr int BYTES = STAGES * STAGE;
  // shared bytes of one launch: the ring (reused, after the last tile, for
  // the warps' partial states), the CUDA-core routes' fp32 queries at QOFF
  // and kRows' probabilities at POFF, a flag
  static constexpr int COMB = kWarps * 16 * (HD + 4) * 4;
  static constexpr int QOFF = BYTES > COMB ? BYTES : COMB;
  static constexpr int POFF = QOFF + (ROUTE == kKeys ? kCoreRows : ROUTE == kRows ? kSplitRows : 0) * HD * 4;
  static constexpr int SMEM = POFF + (ROUTE == kRows ? kSplitRows * kBK * 4 : 0) + 16;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

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

// absolute position held by ring slot s; floor modulo, as jnp.mod: last - s
// is negative for never-written slots and slots ahead of the write head
__device__ __forceinline__ int slot_pos(int last, int s, int cap) {
  return last - (((last - s) % cap) + cap) % cap;
}

// slot_pos over one tile with one modulo: slot s0 + o (s0 + o < cap) holds
// base + o, or base + o - cap past the write head (o > d0)
struct TilePos {
  int base, d0;
  __device__ __forceinline__ int at(int o, int cap) const {
    return base + o - (o > d0 ? cap : 0);
  }
};
__device__ __forceinline__ TilePos tile_pos(int last, int s0, int cap) {
  const int d0 = last - slot_pos(last, s0, cap);
  return {last - d0, d0};
}

// The resident slots are the ring interval of `len` slots starting at
// (pos - len) mod cap: tiles a0 .. a0 + na - 1, then (wrapped) 0 .. nb - 1,
// each tile once.  ring_decode.py :: resident_tiles mirrors this.
struct Resident {
  int a0, na, nb;
  __device__ __forceinline__ int count() const { return na + nb; }
  __device__ __forceinline__ int tile(int i) const { return i < na ? a0 + i : i - na; }
};
__device__ __forceinline__ Resident resident(int pos, int len, int cap) {
  if (len <= 0) return {0, 0, 0};
  const int start = ((pos - len) % cap + cap) % cap;
  const int end_a = min(start + len, cap);
  const int a0 = start / kBK;
  const int nb = start + len > cap ? min((start + len - cap - 1) / kBK + 1, a0) : 0;
  return {a0, (end_a - 1) / kBK - a0 + 1, nb};
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x1_t(uint32_t addr, uint32_t& r0) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
               : "=r"(r0) : "r"(addr));
}
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0, uint32_t a1,
                                            uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

struct Args {
  const void* q;
  long q_sb, q_sc, q_sh;
  const void* k;
  const void* v;
  long kv_sb, kv_ss, kv_sk;
  const float* k_scale;
  const float* v_scale;
  long sc_sb, sc_ss, sc_sk;
  const int* pos;
  const int* len;
  const int* n;
  float* out;        // (B, C, H, hd)
  float* part_o;     // (nsplit, B, C, H, hd) unnormalized accumulators
  float* part_ml;    // (nsplit, B, C, H, 2) running max and normalizer
  int* tickets;      // (B, K, groups) zeros; each merging block resets its own
  int B, C, H, K, hd, cap, window, nsplit;
  float scale;
};

// HD is the padded tile width; a.hd <= HD the true head dim, or HD itself
// when EXACT
template <int HD, typename KV, typename Q, int ROUTE, bool EXACT>
__global__ void __launch_bounds__(kThreads)
ring_decode_kernel(const Args a) {
  using R = Ring<HD, KV, ROUTE>;
  constexpr bool TC = ROUTE == kTensor || ROUTE == kNarrow;
  constexpr int RG = ROUTE == kKeys ? kCoreRows : ROUTE == kNarrow ? kNarrowRows
                     : ROUTE == kRows ? kSplitRows : kWideRows;
  constexpr int RW = ROUTE == kRows ? kSplitRows / kWarps : 8;   // CUDA cores: rows a warp
  constexpr int WPR = ROUTE == kNarrow ? kWarps : 2;   // tensor cores: warps per 16-row tile
  constexpr int KW = kBK / WPR;                        // ... and keys per warp
  constexpr int NT = KW / 8;
  constexpr int RS = TC ? 16 : 8;                   // rows per warp's partial state
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  float* qs = reinterpret_cast<float*>(smem + R::QOFF);
  float* pbuf = reinterpret_cast<float*>(smem + R::POFF);   // kRows: [warp][RW][kBK]
  int* flag = reinterpret_cast<int*>(smem + R::SMEM - 16);

  const int C = a.C, H = a.H, K = a.K, cap = a.cap, window = a.window;
  const int hd = EXACT ? HD : a.hd;
  const int g = H / K;
  const int b = blockIdx.x / K, kh = blockIdx.x % K;
  const int split = blockIdx.y;
  const int row0 = blockIdx.z * RG;
  const int nrows = min(RG, g * C - row0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pos = a.pos[b], len = a.len[b], n = a.n[b], last = pos - 1;
  const long rows_total = (long)a.B * C * H;
  auto row_index = [&](int r) {            // block row r -> ((b·C + t)·H + h)
    const int rr = row0 + r;
    return ((long)b * C + rr % C) * H + kh * g + rr / C;
  };

  if (n <= 0) {                                     // inactive row: defined zeros
    if (split == 0)
      for (int i = tid; i < nrows * hd; i += kThreads) a.out[row_index(i / hd) * hd + i % hd] = 0.f;
    return;
  }
  const Resident res = resident(pos, len, cap);
  const int nt = res.count();
  const int ne = max(1, min(a.nsplit, nt / kMinTiles));   // splits this group runs
  if (split >= ne) return;
  const int lo = (int)((long)split * nt / ne), hi = (int)((long)(split + 1) * nt / ne);
  const int my_n = hi - lo;

  const KV* kb = static_cast<const KV*>(a.k) + b * a.kv_sb + kh * a.kv_sk;
  const KV* vb = static_cast<const KV*>(a.v) + b * a.kv_sb + kh * a.kv_sk;
  const float* ksb = R::QUANT ? a.k_scale + b * a.sc_sb + kh * a.sc_sk : nullptr;
  const float* vsb = R::QUANT ? a.v_scale + b * a.sc_sb + kh * a.sc_sk : nullptr;
  const long kv_ss = a.kv_ss, sc_ss = a.sc_ss;

  // int8 rows whose hd is not a multiple of 16 bytes travel as 8-byte copies
  const bool narrow = R::QUANT && hd % 16 != 0;
  auto issue = [&](int i, int stage) {              // tile lo + i into a ring stage
    const int s0 = res.tile(lo + i) * kBK;
    const uint32_t kd = ring + stage * R::STAGE, vd = kd + R::TILE;
    // a thread copies the same chunk of every row it visits (kThreads is a
    // multiple of the chunks a row holds), zeros past hd
    if (!narrow) {
      const int ch = tid % R::CH;
      const bool col = ch * R::VEC < hd;
      for (int j = tid / R::CH; j < kBK; j += kThreads / R::CH) {
        const int s = s0 + j;
        const bool ok = s < cap && col;
        const long off = ok ? s * kv_ss + ch * R::VEC : 0;
        cp16(kd + j * R::ROW + ch * 16, kb + off, ok);
        cp16(vd + j * R::ROW + ch * 16, vb + off, ok);
      }
    } else {
      constexpr int U = HD * sizeof(KV) / 8;         // 8-byte units per padded row
      const int u = tid % U;
      const bool col = u * 8 < hd;
      for (int j = tid / U; j < kBK; j += kThreads / U) {
        const int s = s0 + j;
        const bool ok = s < cap && col;
        const long off = ok ? s * kv_ss + u * 8 : 0;
        cp8(kd + j * R::ROW + u * 8, kb + off, ok);
        cp8(vd + j * R::ROW + u * 8, vb + off, ok);
      }
    }
    if constexpr (R::QUANT) {
      for (int j = tid; j < kBK; j += kThreads) {
        const int s = s0 + j;
        const bool ok = s < cap;
        const long off = ok ? s * sc_ss : 0;
        cp4(vd + R::TILE + j * 4, ksb + off, ok);
        cp4(vd + R::TILE + kBK * 4 + j * 4, vsb + off, ok);
      }
    }
  };

  // ---- per-warp online-softmax state ----
  // CUDA cores: up to RW rows a warp (kKeys: the block's rows r; kRows:
  // rows warp + 8 i, nr of them), lanes over head dims lane + 32 e
  constexpr int DL = (HD + 31) / 32;
  float m_c[8], l_c[8], acc_c[8][DL];
  int qpos_c[8];
  const int nr = ROUTE == kRows ? (nrows > warp ? (nrows - warp + kWarps - 1) / kWarps : 0)
                                : nrows;
  // tensor cores: rows ra = 16 rt + lane/4 and ra + 8; keys KW kq .. KW kq + KW - 1
  const int rt = warp / WPR, kq = warp % WPR;
  const int ra = rt * 16 + lane / 4, c2 = 2 * (lane % 4);
  const bool tc_active = TC && rt * 16 < nrows;
  float m_t[2] = {kNegInf, kNegInf}, l_t[2] = {0.f, 0.f};
  float acc_t[TC ? HD / 8 : 1][4];
  uint32_t qf[TC ? HD / 16 : 1][4];
  int qpos_t[2];

  if constexpr (TC) {
#pragma unroll
    for (int e = 0; e < HD / 8; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc_t[e][i] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ra + 8 * h;
      qpos_t[h] = r < nrows ? pos - n + (row0 + r) % C : kNoPos;
    }
    const Q* q = static_cast<const Q*>(a.q);
    auto qe = [&](int r, int d) -> bf16 {
      if (r >= nrows) return __float2bfloat16(0.f);
      const int rr = row0 + r;
      return q[b * a.q_sb + (rr % C) * a.q_sc + (kh * g + rr / C) * a.q_sh + d];
    };
    // zeros past hd, decided per 8 columns (hd is a multiple of 8)
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const int d = ks * 16 + c2;
      const bool lo = ks * 16 < hd, hi = ks * 16 + 8 < hd;
      qf[ks][0] = lo ? pack_raw(qe(ra, d), qe(ra, d + 1)) : 0u;
      qf[ks][1] = lo ? pack_raw(qe(ra + 8, d), qe(ra + 8, d + 1)) : 0u;
      qf[ks][2] = hi ? pack_raw(qe(ra, d + 8), qe(ra, d + 9)) : 0u;
      qf[ks][3] = hi ? pack_raw(qe(ra + 8, d + 8), qe(ra + 8, d + 9)) : 0u;
    }
  } else {
    const Q* q = static_cast<const Q*>(a.q);
    for (int i = tid; i < RG * HD; i += kThreads) {
      const int r = i / HD, rr = row0 + r, d = i % HD;
      qs[i] = r < nrows && d < hd
                  ? to_f(q[b * a.q_sb + (rr % C) * a.q_sc + (kh * g + rr / C) * a.q_sh + d])
                  : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = ROUTE == kRows ? warp + 8 * r : r;
      m_c[r] = kNegInf;
      l_c[r] = 0.f;
      qpos_c[r] = row < nrows ? pos - n + (row0 + row) % C : kNoPos;
#pragma unroll
      for (int e = 0; e < DL; ++e) acc_c[r][e] = 0.f;
    }
  }

#pragma unroll
  for (int p = 0; p < R::STAGES - 1; ++p) {
    if (p < my_n) issue(p, p);
    cp_commit();
  }
  for (int i = 0; i < my_n; ++i) {
    cp_wait<R::STAGES - 2>();
    __syncthreads();                  // tile i landed; every warp is done with tile i - 1
    if (i + R::STAGES - 1 < my_n) issue(i + R::STAGES - 1, (i + R::STAGES - 1) % R::STAGES);
    cp_commit();
    const int stage = i % R::STAGES;
    const int s0 = res.tile(lo + i) * kBK;
    const TilePos tp = tile_pos(last, s0, cap);
    const unsigned char* kt = smem + stage * R::STAGE;
    const unsigned char* vt = kt + R::TILE;

    if constexpr (TC) {
      if (tc_active) {
        const uint32_t kta = ring + stage * R::STAGE, vta = kta + R::TILE;
        float sc[NT][4];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[t][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < HD / 16; ++ks) {
            uint32_t b0, b1;
            ldsm_x2(kta + (kq * KW + t * 8 + lane % 8) * R::ROW +
                        (ks * 16 + ((lane / 8) & 1) * 8) * 2, b0, b1);
            mma_bf16(sc[t], qf[ks], b0, b1);
          }
        }
        // a tile of consecutive resident positions that every valid row
        // sees whole (at or before the chunk's first query, inside the
        // window of its last) needs no mask
        const bool whole = s0 + kBK <= cap && tp.d0 >= kBK - 1 && tp.base >= pos - len &&
                           tp.base + kBK - 1 <= pos - n &&
                           (window == 0 || tp.base > last - window);
        float mx[2] = {m_t[0], m_t[1]};
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[t][e] * a.scale;
            if (!whole) {
              const int o = kq * KW + t * 8 + c2 + (e & 1);
              const int pa = tp.at(o, cap), qp = qpos_t[e >> 1];
              const bool ok = s0 + o < cap && pa >= pos - len && pa <= qp &&
                              (window == 0 || pa > qp - window);
              if (!ok) x = kNegInf;
            }
            sc[t][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float al[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          al[h] = __expf(m_t[h] - mx[h]);
          m_t[h] = mx[h];
        }
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = __expf(sc[t][e] - m_t[e >> 1]);
            sc[t][e] = p;
            sum[e >> 1] += p;
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) l_t[h] = l_t[h] * al[h] + sum[h];
        if (al[0] != 1.f || al[1] != 1.f) {      // a row's max moved
#pragma unroll
          for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc_t[dn][e] *= al[e >> 1];
        }
        // P as A fragments, split into bf16 hi + lo so P·V keeps fp32 P
        if constexpr (KW == 8) {                   // one k8 step: m16n8k8
          uint32_t ph[2], pl[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float x0 = sc[0][2 * r], x1 = sc[0][2 * r + 1];
            const bf16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
            ph[r] = pack_raw(h0, h1);
            pl[r] = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
          }
#pragma unroll
          for (int dn = 0; dn < HD / 8; ++dn) {
            uint32_t b0;
            ldsm_x1_t(vta + (kq * 8 + lane % 8) * R::ROW + dn * 16, b0);
            mma_bf16_k8(acc_t[dn], ph[0], ph[1], b0);
            mma_bf16_k8(acc_t[dn], pl[0], pl[1], b0);
          }
        }
#pragma unroll
        for (int k2 = 0; k2 < KW / 16; ++k2) {
          uint32_t ph[4], pl[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float x0 = sc[2 * k2 + r / 2][2 * (r % 2)];
            const float x1 = sc[2 * k2 + r / 2][2 * (r % 2) + 1];
            const bf16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
            ph[r] = pack_raw(h0, h1);
            pl[r] = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
          }
#pragma unroll
          for (int dn = 0; dn < HD / 8; ++dn) {
            uint32_t b0, b1;
            ldsm_x2_t(vta + (kq * KW + k2 * 16 + lane % 16) * R::ROW + dn * 16, b0, b1);
            mma_bf16(acc_t[dn], ph, b0, b1);
            mma_bf16(acc_t[dn], pl, b0, b1);
          }
        }
      }
    } else if constexpr (ROUTE == kRows) {
      // scores: lane owns keys lane and lane + 32 for the warp's rows
      float sc[RW][2];
#pragma unroll
      for (int i = 0; i < RW; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll
      for (int ch = 0; ch < R::CH; ++ch) {
        float k0[R::VEC], k1[R::VEC];
        unpack(*reinterpret_cast<const uint4*>(kt + lane * R::ROW + ch * 16), k0);
        unpack(*reinterpret_cast<const uint4*>(kt + (lane + 32) * R::ROW + ch * 16), k1);
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          if (i < nr) {
#pragma unroll
            for (int e = 0; e < R::VEC; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(
                  qs + (warp + 8 * i) * HD + ch * R::VEC + e);
              sc[i][0] += qv.x * k0[e] + qv.y * k0[e + 1] + qv.z * k0[e + 2] + qv.w * k0[e + 3];
              sc[i][1] += qv.x * k1[e] + qv.y * k1[e + 1] + qv.z * k1[e + 2] + qv.w * k1[e + 3];
            }
          }
        }
      }
      const float* scl = reinterpret_cast<const float*>(vt + R::TILE);
      int pa[2];
      bool ok_s[2];
      float kscl[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int s = s0 + lane + 32 * jj;
        pa[jj] = tp.at(lane + 32 * jj, cap);
        ok_s[jj] = s < cap && pa[jj] >= pos - len;
        kscl[jj] = R::QUANT ? scl[lane + 32 * jj] : 1.f;
      }
      float* pw = pbuf + warp * RW * kBK;
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (i < nr) {
          const int qp = qpos_c[i];
          float x[2];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            x[jj] = ok_s[jj] && pa[jj] <= qp && (window == 0 || pa[jj] > qp - window)
                        ? sc[i][jj] * kscl[jj] * a.scale : kNegInf;
          const float m_new = fmaxf(m_c[i], warp_max(fmaxf(x[0], x[1])));
          const float alpha = expf(m_c[i] - m_new);
          const float p0 = expf(x[0] - m_new), p1 = expf(x[1] - m_new);
          l_c[i] = l_c[i] * alpha + warp_sum(p0 + p1);
          m_c[i] = m_new;
#pragma unroll
          for (int e = 0; e < DL; ++e) acc_c[i][e] *= alpha;
          pw[i * kBK + lane] = p0;
          pw[i * kBK + lane + 32] = p1;
        }
      }
      __syncwarp();
      // values: lane owns head dims lane + 32 e
#pragma unroll 2
      for (int j = 0; j < kBK; j += 4) {
        float vv[4][DL];
#pragma unroll
        for (int jq = 0; jq < 4; ++jq) {
          const KV* vrow = reinterpret_cast<const KV*>(vt + (j + jq) * R::ROW);
          const float vscl = R::QUANT ? scl[kBK + j + jq] : 1.f;
#pragma unroll
          for (int e = 0; e < DL; ++e)
            vv[jq][e] = lane + 32 * e < HD ? to_f(vrow[lane + 32 * e]) * vscl : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          if (i < nr) {
            const float4 p4 = *reinterpret_cast<const float4*>(pw + i * kBK + j);
#pragma unroll
            for (int e = 0; e < DL; ++e)
              acc_c[i][e] += p4.x * vv[0][e] + p4.y * vv[1][e] + p4.z * vv[2][e] +
                             p4.w * vv[3][e];
          }
        }
      }
      __syncwarp();
    } else {
      // scores: lane (jj = lane / 4, quarter c) takes key 8 warp + jj, chunks c, c + 4, ...
      const int jj = lane / 4, cq = lane % 4, key = 8 * warp + jj;
      float sc[kCoreRows];
#pragma unroll
      for (int r = 0; r < kCoreRows; ++r) sc[r] = 0.f;
#pragma unroll
      for (int ch = cq; ch < R::CH; ch += 4) {
        float kf[R::VEC];
        unpack(*reinterpret_cast<const uint4*>(kt + key * R::ROW + ch * 16), kf);
#pragma unroll
        for (int r = 0; r < kCoreRows; ++r) {
          if (r < nrows) {
#pragma unroll
            for (int e = 0; e < R::VEC; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qs + r * HD + ch * R::VEC + e);
              sc[r] = fmaf(qv.x, kf[e], sc[r]);
              sc[r] = fmaf(qv.y, kf[e + 1], sc[r]);
              sc[r] = fmaf(qv.z, kf[e + 2], sc[r]);
              sc[r] = fmaf(qv.w, kf[e + 3], sc[r]);
            }
          }
        }
      }
      const float kscl = R::QUANT ? reinterpret_cast<const float*>(vt + R::TILE)[key] : 1.f;
      const int s = s0 + key;
      const int pa = tp.at(key, cap);
      const bool resident_s = s < cap && pa >= pos - len;
      float pr[kCoreRows];
#pragma unroll
      for (int r = 0; r < kCoreRows; ++r) {
        if (r < nrows) {
          float x = sc[r];
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          x += __shfl_xor_sync(0xffffffffu, x, 2);
          const int qp = qpos_c[r];
          const bool ok = resident_s && pa <= qp && (window == 0 || pa > qp - window);
          x = ok ? x * kscl * a.scale : kNegInf;
          float mt = x;
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
          const float m_new = fmaxf(m_c[r], mt);
          const float alpha = expf(m_c[r] - m_new);
          const float p = expf(x - m_new);
          float ps = p;
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
          l_c[r] = l_c[r] * alpha + ps;
          m_c[r] = m_new;
#pragma unroll
          for (int e = 0; e < DL; ++e) acc_c[r][e] *= alpha;
          pr[r] = p;
        }
      }
      // values: lane owns head dims lane + 32 e
#pragma unroll
      for (int j2 = 0; j2 < 8; ++j2) {
        const int kv = 8 * warp + j2;
        const KV* vrow = reinterpret_cast<const KV*>(vt + kv * R::ROW);
        const float vscl = R::QUANT ? reinterpret_cast<const float*>(vt + R::TILE)[kBK + kv] : 1.f;
        float vv[DL];
#pragma unroll
        for (int e = 0; e < DL; ++e)
          vv[e] = lane + 32 * e < HD ? to_f(vrow[lane + 32 * e]) * vscl : 0.f;
#pragma unroll
        for (int r = 0; r < kCoreRows; ++r) {
          if (r < nrows) {
            const float p = __shfl_sync(0xffffffffu, pr[r], 4 * j2);
#pragma unroll
            for (int e = 0; e < DL; ++e) acc_c[r][e] = fmaf(p, vv[e], acc_c[r][e]);
          }
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();                     // the ring is free: reuse it for the warps' states

  // each warp's partial state per row: comb[(warp · RS + slot) · CS] holds
  // acc[0 .. HD), m, l (rows padded to 16 bytes)
  constexpr int CS = HD + 4;
  float* comb = reinterpret_cast<float*>(smem);
  if constexpr (TC) {
    if (tc_active) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l_t[h] += __shfl_xor_sync(0xffffffffu, l_t[h], 1);
        l_t[h] += __shfl_xor_sync(0xffffffffu, l_t[h], 2);
        float* row = comb + (warp * RS + lane / 4 + 8 * h) * CS;
#pragma unroll
        for (int dn = 0; dn < HD / 8; ++dn) {
          row[dn * 8 + c2] = acc_t[dn][2 * h];
          row[dn * 8 + c2 + 1] = acc_t[dn][2 * h + 1];
        }
        if (lane % 4 == 0) {
          row[HD] = m_t[h];
          row[HD + 1] = l_t[h];
        }
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      if (r < nr) {
        float* row = comb + (warp * RS + r) * CS;
#pragma unroll
        for (int e = 0; e < DL; ++e)
          if (lane + 32 * e < HD) row[lane + 32 * e] = acc_c[r][e];
        if (lane == 0) {
          row[HD] = m_c[r];
          row[HD + 1] = l_c[r];
        }
      }
    }
  }
  __syncthreads();

  // combine the warps holding each row: all 8 (kKeys, kNarrow), its one
  // warp (kRows), or the two warps 2 rt, 2 rt + 1 of its 16-row tile
  // (kTensor); four head dims a thread, as 16-byte loads and stores; the
  // loop walks the padded width (shifts, not divisions) and skips the
  // columns past hd
  constexpr int V4 = HD / 4;
  for (int i = tid; i < nrows * V4; i += kThreads) {
    const int r = i / V4, d = (i % V4) * 4;
    if (d >= hd) continue;
    const int w0 = TC ? WPR * (r / 16) : ROUTE == kRows ? r % 8 : 0;
    const int nw = TC ? WPR : ROUTE == kRows ? 1 : kWarps;
    const int slot = TC ? r % 16 : ROUTE == kRows ? r / kWarps : r;
    float M = kNegInf;
    for (int w = w0; w < w0 + nw; ++w) M = fmaxf(M, comb[(w * RS + slot) * CS + HD]);
    float L = 0.f;
    float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = w0; w < w0 + nw; ++w) {
      const float* row = comb + (w * RS + slot) * CS;
      const float wt = expf(row[HD] - M);
      const float4 o = *reinterpret_cast<const float4*>(row + d);
      L += row[HD + 1] * wt;
      O.x += o.x * wt; O.y += o.y * wt; O.z += o.z * wt; O.w += o.w * wt;
    }
    const long ri = row_index(r);
    if (ne == 1) {
      const float inv = 1.f / fmaxf(L, 1e-30f);
      *reinterpret_cast<float4*>(a.out + ri * hd + d) =
          make_float4(O.x * inv, O.y * inv, O.z * inv, O.w * inv);
    } else {
      const long pr = split * rows_total + ri;
      *reinterpret_cast<float4*>(a.part_o + pr * hd + d) = O;
      if (d == 0) *reinterpret_cast<float2*>(a.part_ml + pr * 2) = make_float2(M, L);
    }
  }
  if (ne == 1) return;

  // the last split of this (b, kv head, row group) to finish merges all of them
  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + ((long)blockIdx.x * gridDim.z + blockIdx.z);
  if (tid == 0) *flag = atomicAdd(ticket, 1) == ne - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // one pass per four head dims with a running max; the loads of a
  // thread's splits are independent, so they overlap
  const float* __restrict__ pml = a.part_ml;
  const float* __restrict__ po = a.part_o;
  float* __restrict__ out = a.out;
  for (int i = tid; i < nrows * V4; i += kThreads) {
    const int r = i / V4, d = (i % V4) * 4;
    if (d >= hd) continue;
    const long ri = row_index(r);
    float M = kNegInf, L = 0.f;
    float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sp = 0; sp < ne; ++sp) {
      const long pr = sp * rows_total + ri;
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(pml + pr * 2));
      const float4 o = __ldcg(reinterpret_cast<const float4*>(po + pr * hd + d));
      const float mn = fmaxf(M, ml.x);
      const float w_old = expf(M - mn), w_new = expf(ml.x - mn);
      L = L * w_old + ml.y * w_new;
      O.x = O.x * w_old + o.x * w_new;
      O.y = O.y * w_old + o.y * w_new;
      O.z = O.z * w_old + o.z * w_new;
      O.w = O.w * w_old + o.w * w_new;
      M = mn;
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    *reinterpret_cast<float4*>(out + ri * hd + d) =
        make_float4(O.x * inv, O.y * inv, O.z * inv, O.w * inv);
  }
  if (tid == 0) *ticket = 0;           // ready for the next launch
}

template <int HD, typename KV, typename Q, int ROUTE>
int launch(const Args& a, cudaStream_t st) {
  constexpr int smem = Ring<HD, KV, ROUTE>::SMEM;
  // the tensor-core routes have a build with hd fixed at the tile width:
  // with hd a runtime value their query-fragment loads cost 3–7% of a
  // launch at hd 64 (PERF.md)
  auto kern = ring_decode_kernel<HD, KV, Q, ROUTE, false>;
  if constexpr (ROUTE == kTensor || ROUTE == kNarrow)
    if (a.hd == HD) kern = ring_decode_kernel<HD, KV, Q, ROUTE, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = (a.H / a.K) * a.C;
  const int rg = ROUTE == kKeys ? kCoreRows : ROUTE == kNarrow ? kNarrowRows
                 : ROUTE == kRows ? kSplitRows : kWideRows;
  const dim3 grid(a.B * a.K, a.nsplit, (rows + rg - 1) / rg);
  kern<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int HD, typename KV>
int launch_q(int q_dtype, const Args& a, cudaStream_t st) {
  const int rows = (a.H / a.K) * a.C;
  const bool wide = rows > kCoreRows;
  if (q_dtype == 0)
    return wide ? launch<HD, KV, float, kRows>(a, st) : launch<HD, KV, float, kKeys>(a, st);
  if (q_dtype == 1) {
    if constexpr (sizeof(KV) == 2) {
      return rows > kNarrowRows ? launch<HD, KV, bf16, kTensor>(a, st)
                                : launch<HD, KV, bf16, kNarrow>(a, st);
    }
    return wide ? launch<HD, KV, bf16, kRows>(a, st) : launch<HD, KV, bf16, kKeys>(a, st);
  }
  return -1;
}

template <int HD>
int launch_kv(int q_dtype, int kv_dtype, const Args& a, cudaStream_t st) {
  if (kv_dtype == 0) return launch_q<HD, float>(q_dtype, a, st);
  if (kv_dtype == 1) return launch_q<HD, bf16>(q_dtype, a, st);
  if (kv_dtype == 2) return launch_q<HD, int8_t>(q_dtype, a, st);
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (caches only).  Strides
// are in elements; the last axis of q/k/v is contiguous, the scales' last
// axis has extent 1, cache rows start on 16-byte boundaries (8-byte for an
// int8 cache whose hd is not a multiple of 16).  hd is a multiple of 8 from
// 8 to 128, run in the tile width HDP = the next of 16, 32, 64, 128
// (ring_decode.py :: padded_hd).  The grid is
// (B·K, nsplit, row groups): a group is 64 rows on the tensor-core route
// (bf16 q and cache, g·C > 8), else 8.  part_o (nsplit,B,C,H,hd) and
// part_ml (nsplit,B,C,H,2) are fp32 scratch (unused with nsplit = 1);
// tickets holds B·K·groups zeros, left zero by every launch that completes.
// Returns a cudaError_t (0 = launched), or -1 for a head dim / dtype the
// kernel does not take.
extern "C" int ring_decode_launch(
    const void* q, int q_dtype, long q_sb, long q_sc, long q_sh, const void* k,
    const void* v, int kv_dtype, long kv_sb, long kv_ss, long kv_sk,
    const float* k_scale, const float* v_scale, long sc_sb, long sc_ss, long sc_sk,
    const int* pos, const int* len, const int* n, float* out, float* part_o,
    float* part_ml, int* tickets, int B, int C, int H, int K, int hd, int cap,
    int window, int nsplit, void* stream) {
  const Args a{q, q_sb, q_sc, q_sh, k, v, kv_sb, kv_ss, kv_sk, k_scale, v_scale,
               sc_sb, sc_ss, sc_sk, pos, len, n, out, part_o, part_ml, tickets,
               B, C, H, K, hd, cap, window, nsplit, (float)(1.0 / sqrt((double)hd))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd < 8 || hd > 128 || hd % 8 != 0) return -1;
  if (hd <= 16) return launch_kv<16>(q_dtype, kv_dtype, a, st);
  if (hd <= 32) return launch_kv<32>(q_dtype, kv_dtype, a, st);
  if (hd <= 64) return launch_kv<64>(q_dtype, kv_dtype, a, st);
  return launch_kv<128>(q_dtype, kv_dtype, a, st);
}
