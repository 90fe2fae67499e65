// Causal / windowed grouped-query flash attention, for sm_90a:
//   o[b, s, h] = softmax_t(q[b, s, h] · k[b, t, h/g] / √hd  | mask) · v[b, t, h/g]
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
// What bounds it on the H100 (NVIDIA H100 80GB HBM3 at 700 W; data-sheet
// rates 3.35 TB/s and 989 TFLOP/s bf16): bytes at the train step's shape (B 4, S 512,
// H 32, K 8, hd 64): q, k, v and o are ≈ 21 MB, the causal products
// ≈ 4.3 GFLOP, so ≈ 6 µs of memory time against ≈ 4 µs of bf16 tensor
// time; both are small next to launch and latency costs of a simple kernel.
//
// What the design does about it: one block of 4 warps per (b·H + h,
// 64-query tile); the TPU's sequential KV grid axis becomes a loop inside
// the block over 64-key tiles, with the running max, normalizer and fp32
// output accumulator kept in shared memory.  K and V are read in place
// from their (B,T,K,hd) layout for the group's KV head, never repeated in
// memory.  Tiles wholly above the causal diagonal or wholly before the
// window are skipped (the online softmax gives them zero weight anyway);
// the ragged last query and key tiles are masked in the kernel, so no
// padded copies are made.  bf16 runs Q·Kᵀ and P·V on the tensor cores
// (WMMA 16×16×16, fp32 accumulation), each warp owning 16 query rows; the
// softmax runs one row at a time across a warp's 32 lanes.  fp32 takes a
// CUDA-core kernel of the same structure, for the parity checks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBQ = 64, kBKV = 64, kThreads = 128;   // 4 warps x 16 query rows
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

// ---------------------------------------------------------------- bf16 ----
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o, int S, int T, int H,
           int K, int causal, int window, float scale) {
  constexpr int LD = HD + 8, LS = kBKV + 4, LP = kBKV + 8, LO = HD + 4;
  constexpr int CH = HD / 8;                       // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);        // [kBQ][LD]
  bf16* ks = qs + kBQ * LD;                        // [kBKV][LD]
  bf16* vs = ks + kBKV * LD;                       // [kBKV][LD]
  bf16* ps = vs + kBKV * LD;                       // [kBQ][LP]
  float* ss = reinterpret_cast<float*>(ps + kBQ * LP);   // [kBQ][LS]
  float* os = ss + kBQ * LS;                       // [kBQ][LO]
  float* ml = os + kBQ * LO;                       // m, l, alpha: [3][kBQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kh = h / (H / K);
  const int q0 = blockIdx.y * kBQ, r0 = 16 * warp;
  const long qstride = (long)H * HD, kstride = (long)K * HD;
  const bf16* qb = q + ((long)b * S * H + h) * HD;
  const bf16* kb = k + ((long)b * T * K + kh) * HD;
  const bf16* vb = v + ((long)b * T * K + kh) * HD;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int c = tid; c < kBQ * CH; c += kThreads) {
    const int row = c / CH, col = (c % CH) * 8;
    *reinterpret_cast<uint4*>(qs + row * LD + col) =
        q0 + row < S ? *reinterpret_cast<const uint4*>(qb + (q0 + row) * qstride + col)
                     : zero;
  }
  for (int e = tid; e < kBQ * LO; e += kThreads) os[e] = 0.f;
  for (int e = tid; e < kBQ; e += kThreads) {
    ml[e] = kNegInf;
    ml[kBQ + e] = 0.f;
  }
  int kv_begin, kv_end;
  tile_range(q0, T, causal, window, &kv_begin, &kv_end);

  for (int t0 = kv_begin; t0 < kv_end; t0 += kBKV) {
    __syncthreads();                                // previous tile consumed
    for (int c = tid; c < kBKV * CH; c += kThreads) {
      const int row = c / CH, col = (c % CH) * 8;
      const bool in = t0 + row < T;
      *reinterpret_cast<uint4*>(ks + row * LD + col) =
          in ? *reinterpret_cast<const uint4*>(kb + (t0 + row) * kstride + col) : zero;
      *reinterpret_cast<uint4*>(vs + row * LD + col) =
          in ? *reinterpret_cast<const uint4*>(vb + (t0 + row) * kstride + col) : zero;
    }
    __syncthreads();
    {   // scores of the warp's 16 rows: Q Kᵀ
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[kBKV / 16];
#pragma unroll
      for (int j = 0; j < kBKV / 16; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
        wmma::load_matrix_sync(fq, qs + r0 * LD + kk, LD);
#pragma unroll
        for (int j = 0; j < kBKV / 16; ++j) {
          wmma::load_matrix_sync(fk, ks + (16 * j) * LD + kk, LD);
          wmma::mma_sync(sacc[j], fq, fk, sacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kBKV / 16; ++j)
        wmma::store_matrix_sync(ss + r0 * LS + 16 * j, sacc[j], LS, wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = 0; i < 16; ++i) {
      const int row = r0 + i, qpos = q0 + row;
      float s0 = ss[row * LS + lane] * scale, s1 = ss[row * LS + lane + 32] * scale;
      if (!visible(qpos, t0 + lane, T, causal, window)) s0 = kNegInf;
      if (!visible(qpos, t0 + lane + 32, T, causal, window)) s1 = kNegInf;
      float p0, p1;
      softmax_row(s0, s1, row, ml, lane, &p0, &p1);
      ps[row * LP + lane] = __float2bfloat16(p0);
      ps[row * LP + lane + 32] = __float2bfloat16(p1);
    }
    __syncwarp();
    for (int e = lane; e < 16 * HD; e += 32) {
      const int row = r0 + e / HD;
      os[row * LO + e % HD] *= ml[2 * kBQ + row];
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {   // O += P V
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, os + r0 * LO + 16 * c, LO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fp, ps + r0 * LP + kk, LP);
        wmma::load_matrix_sync(fv, vs + kk * LD + 16 * c, LD);
        wmma::mma_sync(oacc, fp, fv, oacc);
      }
      wmma::store_matrix_sync(os + r0 * LO + 16 * c, oacc, LO, wmma::mem_row_major);
    }
  }
  __syncwarp();
  bf16* ob = o + ((long)b * S * H + h) * HD;
  for (int e = lane; e < 16 * HD; e += 32) {
    const int row = r0 + e / HD, col = e % HD;
    if (q0 + row < S)
      ob[(q0 + row) * qstride + col] =
          __float2bfloat16(os[row * LO + col] / fmaxf(ml[kBQ + row], 1e-30f));
  }
}

// ---------------------------------------------------------------- fp32 ----
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int S, int T, int H,
          int K, int causal, int window, float scale) {
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
  const long qstride = (long)H * HD, kstride = (long)K * HD;
  const float* qb = q + ((long)b * S * H + h) * HD;
  const float* kb = k + ((long)b * T * K + kh) * HD;
  const float* vb = v + ((long)b * T * K + kh) * HD;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int row = e / HD, col = e % HD;
    qs[row * LD + col] = q0 + row < S ? qb[(q0 + row) * qstride + col] : 0.f;
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
      const bool in = t0 + row < T;
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
  float* ob = o + ((long)b * S * H + h) * HD;
  for (int e = lane; e < 16 * HD; e += 32) {
    const int row = r0 + e / HD, col = e % HD;
    if (q0 + row < S)
      ob[(q0 + row) * qstride + col] = os[row * HD + col] / fmaxf(ml[kBQ + row], 1e-30f);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int dtype, int B,
           int S, int T, int H, int K, int causal, int window, float scale,
           cudaStream_t st) {
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  if (dtype == 1) {
    const size_t smem = sizeof(bf16) * (3 * kBQ * (HD + 8) + kBQ * (kBKV + 8))
                        + sizeof(float) * (kBQ * (kBKV + 4) + kBQ * (HD + 4) + 3 * kBQ);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_bf16<HD><<<grid, kThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), S, T, H, K, causal,
        window, scale);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    const size_t smem = sizeof(float) * (3 * kBQ * (HD + 1) + kBQ * (kBKV + 1)
                                         + kBQ * HD + 3 * kBQ);
    cudaError_t err = cudaFuncSetAttribute(
        flash_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_f32<HD><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, T, H, K, causal,
        window, scale);
    return (int)cudaGetLastError();
  }
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for q, k, v and o alike.  All
// contiguous and 16-byte aligned; hd in {16, 32, 64, 128}; H a multiple of
// K.  ``scale`` is 1/√hd as the caller computes it.  Returns a cudaError_t
// (0 = launched), or -1 for a dtype or head dim the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int dtype, int B, int S, int T, int H,
                                      int K, int hd, int causal, int window,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || T < 1 || K < 1 || H % K != 0) return -1;
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, dtype, B, S, T, H, K, causal, window, scale, st);
    case 32: return launch<32>(q, k, v, o, dtype, B, S, T, H, K, causal, window, scale, st);
    case 64: return launch<64>(q, k, v, o, dtype, B, S, T, H, K, causal, window, scale, st);
    case 128: return launch<128>(q, k, v, o, dtype, B, S, T, H, K, causal, window, scale, st);
    default: return -1;
  }
}
