// Flash-decoding over a per-slot ring-buffer KV cache (GQA), for sm_90a.
//
// Replaces: src/repro/kernels/ring_decode.py :: ring_decode_kernel (the
// Pallas TPU kernel behind repro.kernels.ops.ring_decode).  Same contract:
// q (B,C,H,hd) attends k/v (B,cap,K,hd) stored as fp32, bf16 or int8 (int8
// with per-token (B,cap,K,1) fp32 scales); pos/length/n_tokens (B,) are the
// ring state AFTER the chunk write; the residency ∧ causal ∧ window mask is
// built in-kernel from those scalars; the output is (B,C,H,hd) fp32 and is
// defined on valid query positions t < n_tokens[b] (rows with n_tokens = 0
// are written as zeros).
//
// What bounds it on the H100: reading K/V.  One decode step of one layer
// reads B·cap·K·hd·2 cache elements and does 4·B·H·C·cap·hd flops, so at
// C = 1 it is far below the card's ~295 flop/byte balance point: memory
// bound (3.35 TB/s).  At C = 16 (g = 4) it does 64 flops per byte of bf16
// cache: still below the bf16 tensor-core balance point, but above what fp32
// CUDA-core arithmetic (67 TFLOP/s) can keep up with, which this kernel uses.
//
// What the design does about it:
//   * a block serves one (b, kv_head) and all g = H/K query heads × C
//     queries of that group, so every K/V tile is read from device memory
//     once per group, never once per query head;
//   * the ring is split across blocks (flash-decoding): grid (B·K, nsplit),
//     each block folds its share of the key tiles into partial
//     (acc, m, l), and a second small kernel merges the splits.  At the
//     main path's shapes B·K is only 64, so without the split most SMs idle
//     while a few walk all 16 tiles; the wrapper picks nsplit for ~4 blocks
//     per SM and allocates the partials;
//   * the cache is read in its (B,cap,K,hd) layout through strides, and the
//     ragged last tile is masked in-kernel — no transposed or padded copy of
//     the cache is made (the TPU wrapper's transpose and pad would each be a
//     whole-cache copy per layer per step on the GPU);
//   * only tiles that hold resident slots are read (the resident slots are
//     one ring interval, so the test is arithmetic), so a short sequence in
//     a large ring reads only its resident tiles;
//   * K/V tiles are read with 16-byte loads into registers while the
//     previous tile is computed from shared memory, so load latency
//     overlaps arithmetic;
//   * int8 tiles are dequantized with their per-token scales while they are
//     staged into shared memory; no full-precision cache copy exists;
//   * each warp owns up to 8 query rows and keeps their online-softmax state
//     (m, l and the fp32 accumulator) in registers; a key loaded from shared
//     memory is reused across all of the warp's rows.
// Not done yet: tensor-core products for wide chunks (C = 16), cp.async/TMA
// staging.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsMax = 64;     // query rows (group heads × chunk) per block
constexpr int kBK = 64;          // key slots per shared-memory tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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
  int B, C, H, K, cap, window, nsplit, tiles_per_split;
  float scale;
};

template <int HD, typename KV, typename Q>
__global__ void __launch_bounds__(kThreads)
ring_decode_kernel(const Args a) {
  constexpr int kVec = 16 / sizeof(KV);          // cache elements per 16-byte load
  constexpr int kRowChunks = HD / kVec;          // 16-byte chunks per slot row
  constexpr int kChunks = kBK * kRowChunks;      // chunks per tile (K or V)
  constexpr int kPer = (kChunks + kThreads - 1) / kThreads;
  constexpr int kRW = kRowsMax / kWarps;         // query rows per warp (max)
  constexpr int kDL = (HD + 31) / 32;            // head dims per lane
  constexpr int kJL = kBK / 32;                  // keys per lane
  constexpr bool kQuant = sizeof(KV) == 1;

  const Q* __restrict__ q = static_cast<const Q*>(a.q);
  const KV* __restrict__ k = static_cast<const KV*>(a.k);
  const KV* __restrict__ v = static_cast<const KV*>(a.v);
  const int C = a.C, H = a.H, K = a.K, cap = a.cap, window = a.window;
  const long kv_ss = a.kv_ss, sc_ss = a.sc_ss;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int g = H / K;
  const int b = blockIdx.x / K;
  const int kh = blockIdx.x % K;
  const int split = blockIdx.y;
  const int row0 = blockIdx.z * kRowsMax;
  const int nrows = min(kRowsMax, g * C - row0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nr = (nrows - warp + kWarps - 1) / kWarps;   // rows of this warp

  float* qs = smem;                               // [nrows][HD]
  float* ks = qs + nrows * HD;                    // [kBK][HD + 1]
  float* vs = ks + kBK * (HD + 1);                // [kBK][HD]
  float* pbuf = vs + kBK * HD;                    // [kWarps][kRW][kBK]

  const int pos = a.pos[b];
  const int len = a.len[b];
  const int n = a.n[b];
  const int last = pos - 1;
  // this block's key range; the merge kernel handles rows with n <= 0
  const int s_begin = split * a.tiles_per_split * kBK;
  const int s_end = min(cap, s_begin + a.tiles_per_split * kBK);

  if (n <= 0) {                                   // inactive row: defined zeros
    if (a.nsplit == 1)
      for (int i = tid; i < nrows * HD; i += kThreads) {
        const int rr = row0 + i / HD;
        a.out[(((long)b * C + rr % C) * H + kh * g + rr / C) * HD + i % HD] = 0.f;
      }
    return;
  }

  for (int i = tid; i < nrows * HD; i += kThreads) {
    const int rr = row0 + i / HD;
    qs[i] = to_f(q[b * a.q_sb + (rr % C) * a.q_sc + (kh * g + rr / C) * a.q_sh + i % HD]);
  }

  const KV* kb = k + b * a.kv_sb + kh * a.kv_sk;
  const KV* vb = v + b * a.kv_sb + kh * a.kv_sk;
  const float* ksb = kQuant ? a.k_scale + b * a.sc_sb + kh * a.sc_sk : nullptr;
  const float* vsb = kQuant ? a.v_scale + b * a.sc_sb + kh * a.sc_sk : nullptr;

  // the next tile's K/V chunks travel in registers while the current tile
  // is computed from shared memory
  uint4 kraw[kPer], vraw[kPer];
  float kscl[kPer], vscl[kPer];
  auto load = [&](int s0) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int c = tid + p * kThreads;
      const int s = s0 + c / kRowChunks;
      const int d0 = (c % kRowChunks) * kVec;
      kraw[p] = vraw[p] = make_uint4(0, 0, 0, 0);
      kscl[p] = vscl[p] = 1.f;
      if (c < kChunks && s < cap) {
        kraw[p] = *reinterpret_cast<const uint4*>(kb + s * kv_ss + d0);
        vraw[p] = *reinterpret_cast<const uint4*>(vb + s * kv_ss + d0);
        if (kQuant) {
          kscl[p] = ksb[s * sc_ss];
          vscl[p] = vsb[s * sc_ss];
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
      const int d0 = (c % kRowChunks) * kVec;
      float ke[kVec], ve[kVec];
      unpack(kraw[p], ke);
      unpack(vraw[p], ve);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        ks[j * (HD + 1) + d0 + e] = ke[e] * kscl[p];
        vs[j * HD + d0 + e] = ve[e] * vscl[p];
      }
    }
  };

  float acc[kRW][kDL], m[kRW], l[kRW];
#pragma unroll
  for (int i = 0; i < kRW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kDL; ++e) acc[i][e] = 0.f;
  }

  int s0 = next_tile(s_begin, s_end, pos, len, cap);
  if (s0 < s_end) load(s0);
  while (s0 < s_end) {
    __syncthreads();              // every warp is done with the last tile
    store();
    __syncthreads();
    const int s_next = next_tile(s0 + kBK, s_end, pos, len, cap);
    if (s_next < s_end) load(s_next);

    // scores: lane owns keys lane + 32 jj, warp owns rows warp + kWarps i
    float sc[kRW][kJL];
#pragma unroll
    for (int i = 0; i < kRW; ++i)
#pragma unroll
      for (int jj = 0; jj < kJL; ++jj) sc[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float kv[kJL][4];
#pragma unroll
      for (int jj = 0; jj < kJL; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) kv[jj][e] = ks[(lane + 32 * jj) * (HD + 1) + d + e];
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        if (i < nr) {
          const float4 qv =
              *reinterpret_cast<const float4*>(&qs[(warp + kWarps * i) * HD + d]);
#pragma unroll
          for (int jj = 0; jj < kJL; ++jj)
            sc[i][jj] += qv.x * kv[jj][0] + qv.y * kv[jj][1] + qv.z * kv[jj][2] +
                         qv.w * kv[jj][3];
        }
      }
    }

    int p_abs[kJL];
    bool res[kJL];
#pragma unroll
    for (int jj = 0; jj < kJL; ++jj) {
      const int s = s0 + lane + 32 * jj;
      p_abs[jj] = slot_pos(last, s, cap);
      res[jj] = s < cap && p_abs[jj] >= pos - len;
    }
#pragma unroll
    for (int i = 0; i < kRW; ++i) {
      if (i < nr) {
        const int qpos = pos - n + (row0 + warp + kWarps * i) % C;
        float mt = kNegInf;
#pragma unroll
        for (int jj = 0; jj < kJL; ++jj) {
          const bool ok = res[jj] && p_abs[jj] <= qpos &&
                          (window == 0 || p_abs[jj] > qpos - window);
          sc[i][jj] = ok ? sc[i][jj] * a.scale : kNegInf;
          mt = fmaxf(mt, sc[i][jj]);
        }
        mt = warp_max(mt);
        const float m_new = fmaxf(m[i], mt);
        const float alpha = expf(m[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int jj = 0; jj < kJL; ++jj) {
          const float p = expf(sc[i][jj] - m_new);
          pbuf[(warp * kRW + i) * kBK + lane + 32 * jj] = p;
          psum += p;
        }
        l[i] = l[i] * alpha + warp_sum(psum);
        m[i] = m_new;
#pragma unroll
        for (int e = 0; e < kDL; ++e) acc[i][e] *= alpha;
      }
    }
    __syncwarp();

    // values: lane owns head dims lane + 32 e
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float vv[4][kDL];
#pragma unroll
      for (int jq = 0; jq < 4; ++jq)
#pragma unroll
        for (int e = 0; e < kDL; ++e)
          vv[jq][e] = lane + 32 * e < HD ? vs[(j + jq) * HD + lane + 32 * e] : 0.f;
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        if (i < nr) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(&pbuf[(warp * kRW + i) * kBK + j]);
#pragma unroll
          for (int e = 0; e < kDL; ++e)
            acc[i][e] += p4.x * vv[0][e] + p4.y * vv[1][e] + p4.z * vv[2][e] +
                         p4.w * vv[3][e];
        }
      }
    }
    s0 = s_next;
  }

#pragma unroll
  for (int i = 0; i < kRW; ++i) {
    if (i < nr) {
      const int rr = row0 + warp + kWarps * i;
      const long row = ((long)b * C + rr % C) * H + kh * g + rr / C;
      if (a.nsplit == 1) {
        const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int e = 0; e < kDL; ++e)
          if (lane + 32 * e < HD) a.out[row * HD + lane + 32 * e] = acc[i][e] * inv;
      } else {
        const long prow = (long)split * a.B * C * H + row;
#pragma unroll
        for (int e = 0; e < kDL; ++e)
          if (lane + 32 * e < HD) a.part_o[prow * HD + lane + 32 * e] = acc[i][e];
        if (lane == 0) {
          a.part_ml[prow * 2] = m[i];
          a.part_ml[prow * 2 + 1] = l[i];
        }
      }
    }
  }
}

// merge the splits of one query row (b, t, h): out = Σ_s acc_s e^(m_s - M) /
// Σ_s l_s e^(m_s - M), M = max_s m_s; rows with n_tokens = 0 get zeros
__global__ void merge_splits_kernel(const Args a, int HD) {
  const long row = blockIdx.x;                    // ((b * C) + t) * H + h
  const int d = threadIdx.x;
  const int b = row / ((long)a.C * a.H);
  const long rows = (long)a.B * a.C * a.H;
  if (d >= HD) return;
  if (a.n[b] <= 0) {
    a.out[row * HD + d] = 0.f;
    return;
  }
  float M = kNegInf;
  for (int s = 0; s < a.nsplit; ++s) M = fmaxf(M, a.part_ml[(s * rows + row) * 2]);
  float L = 0.f, o = 0.f;
  for (int s = 0; s < a.nsplit; ++s) {
    const float w = expf(a.part_ml[(s * rows + row) * 2] - M);
    L += a.part_ml[(s * rows + row) * 2 + 1] * w;
    o += a.part_o[(s * rows + row) * HD + d] * w;
  }
  a.out[row * HD + d] = o / fmaxf(L, 1e-30f);
}

template <int HD, typename KV, typename Q>
int launch(const Args& a, cudaStream_t st) {
  const int rows = (a.H / a.K) * a.C;
  const int nrows = rows < kRowsMax ? rows : kRowsMax;
  const size_t smem = sizeof(float) * (nrows * HD + kBK * (HD + 1) + kBK * HD +
                                       kRowsMax * kBK);
  auto kern = ring_decode_kernel<HD, KV, Q>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.K, a.nsplit, (rows + kRowsMax - 1) / kRowsMax);
  kern<<<grid, kThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return (int)err;
  merge_splits_kernel<<<a.B * a.C * a.H, HD, 0, st>>>(a, HD);
  return (int)cudaGetLastError();
}

template <int HD, typename KV>
int launch_q(int q_dtype, const Args& a, cudaStream_t st) {
  if (q_dtype == 0) return launch<HD, KV, float>(a, st);
  if (q_dtype == 1) return launch<HD, KV, __nv_bfloat16>(a, st);
  return -1;
}

template <int HD>
int launch_kv(int q_dtype, int kv_dtype, const Args& a, cudaStream_t st) {
  if (kv_dtype == 0) return launch_q<HD, float>(q_dtype, a, st);
  if (kv_dtype == 1) return launch_q<HD, __nv_bfloat16>(q_dtype, a, st);
  if (kv_dtype == 2) return launch_q<HD, int8_t>(q_dtype, a, st);
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (caches only).  Strides
// are in elements; the last axis of q/k/v is contiguous, the scales' last
// axis has extent 1, cache rows start on 16-byte boundaries.  With
// nsplit > 1 the caller provides part_o (nsplit,B,C,H,hd) and part_ml
// (nsplit,B,C,H,2) fp32 scratch; tiles_per_split·nsplit covers cap.
// Returns a cudaError_t (0 = launched), or -1 for a head dim / dtype the
// kernel does not take.
extern "C" int ring_decode_launch(
    const void* q, int q_dtype, long q_sb, long q_sc, long q_sh, const void* k,
    const void* v, int kv_dtype, long kv_sb, long kv_ss, long kv_sk,
    const float* k_scale, const float* v_scale, long sc_sb, long sc_ss, long sc_sk,
    const int* pos, const int* len, const int* n, float* out, float* part_o,
    float* part_ml, int B, int C, int H, int K, int hd, int cap, int window,
    int nsplit, int tiles_per_split, void* stream) {
  const Args a{q, q_sb, q_sc, q_sh, k, v, kv_sb, kv_ss, kv_sk, k_scale, v_scale,
               sc_sb, sc_ss, sc_sk, pos, len, n, out, part_o, part_ml, B, C, H, K,
               cap, window, nsplit, tiles_per_split,
               (float)(1.0 / sqrt((double)hd))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_kv<16>(q_dtype, kv_dtype, a, st);
    case 32: return launch_kv<32>(q_dtype, kv_dtype, a, st);
    case 64: return launch_kv<64>(q_dtype, kv_dtype, a, st);
    case 128: return launch_kv<128>(q_dtype, kv_dtype, a, st);
  }
  return -1;
}
