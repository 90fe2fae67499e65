// Batched-gather multi-tenant LoRA delta (BGMV), for sm_90a:
//   y[b] = scale[id_b] · (x[b] A_bᵀ) B_bᵀ,   id_b = ids[b],
// with A_b / B_b gathered page by page from paged pools through the
// adapter's row of the page table, and lanes >= rank[id_b] masked.
//
// Replaces: src/repro/kernels/bgmv.py :: bgmv_kernel (the Pallas TPU kernel
// behind repro.kernels.ops.bgmv).  Same contract: x (B,C,din) fp32/bf16;
// a_pages (P,pr,din) and b_pages (P,dout,pr) fp32/bf16; table (maxA,Pmax),
// rank/scale (maxA,), ids (B,); out (B,C,dout) fp32.  A row whose adapter
// has rank 0 (the base id 0, or an evicted id) writes exact zeros.
//
// What bounds it on the H100: bytes.  A row reads its rank_b·(din+dout)
// adapter elements, x and writes y, doing 2·C·rank·(din+dout) flops — a few
// flops per byte, far below the card's balance point.  The decode batch is
// small (B slots), so the whole call is a few hundred KB per projection and
// launch latency matters as much as bandwidth.
//
// What the design does about it: ONE kernel per call over the grid
// (B rows, dout tiles of 256 columns).  Each block first forms the small
// z = x_b A_bᵀ (C × rank, fp32, in shared memory; a warp dots one x row
// with 4 A rows over din with 16-byte loads), then expands its 256 output
// columns from z and B's pages, one column per thread with the column's B
// values held in registers across the C queries.  The z recompute per dout
// tile re-reads x_b and A_b from L2 instead of device memory, and saves the
// second launch and the HBM round trip of z that a shrink kernel + expand
// kernel pair would need.  The
// indirection (ids -> table row, rank, scale) is read inside the kernel, so
// the wrapper launches nothing else.  Lanes at or above the rank are never
// read, so stale pages of evicted adapters cannot leak.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = kThreads;   // output columns per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// 8 consecutive elements (16 bytes of bf16, 32 of fp32) as floats
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename TX, typename TP>
__global__ void __launch_bounds__(kThreads)
bgmv_kernel(const TX* __restrict__ x, const TP* __restrict__ a_pages,
            const TP* __restrict__ b_pages, const int* __restrict__ table,
            const int* __restrict__ rank, const float* __restrict__ scale,
            const int* __restrict__ ids, float* __restrict__ y, int C, int din,
            int dout, int pr, int Pmax) {
  extern __shared__ float z[];                 // [C][R], R = Pmax * pr
  const int R = Pmax * pr;
  const int b = blockIdx.x;
  const int col = blockIdx.y * kTileN + threadIdx.x;
  const int id = ids[b];
  const int r_b = min(rank[id], R);
  const int* pages = table + (long)id * Pmax;
  float* yb = y + (long)b * C * dout;

  if (r_b <= 0) {                              // base / evicted: exact zero
    if (col < dout)
      for (int c = 0; c < C; ++c) yb[(long)c * dout + col] = 0.f;
    return;
  }

  // shrink: z[c][r] = x[b, c] · A-row r.  One warp per (c, group of 4
  // ranks): each lane reads 8 consecutive elements of x once per step and
  // dots them with the group's 4 A rows (din % 8 == 0, 16-byte loads)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const TX* xb = x + (long)b * C * din;
  const int groups = (r_b + 3) / 4;
  for (int item = warp; item < C * groups; item += kWarps) {
    const int c = item / groups;
    const int r0 = (item % groups) * 4;
    const TX* xrow = xb + (long)c * din;
    const TP* arow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = min(r0 + i, r_b - 1);
      arow[i] = a_pages + ((long)pages[r / pr] * pr + r % pr) * din;
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int d = lane * 8; d < din; d += 32 * 8) {
      float xv[8];
      load8(xrow + d, xv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float av[8];
        load8(arow[i] + d, av);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i] += xv[e] * av[e];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      for (int o = 16; o > 0; o >>= 1)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
      if (lane == 0 && r0 + i < r_b) z[c * R + r0 + i] = acc[i];
    }
  }
  __syncthreads();

  // expand: this thread's column, ranks in groups of 16 held in registers
  if (col >= dout) return;
  const float s = scale[id];
  for (int r0 = 0; r0 < r_b; r0 += 16) {
    float bv[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = r0 + i;
      bv[i] = r < r_b ? to_f(b_pages[((long)pages[r / pr] * dout + col) * pr + r % pr])
                      : 0.f;
    }
    for (int c = 0; c < C; ++c) {
      const float* zc = z + c * R + r0;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (r0 + i < r_b) acc += zc[i] * bv[i];
      float* out = yb + (long)c * dout + col;
      *out = (r0 == 0 ? 0.f : *out) + acc * s;
    }
  }
}

template <typename TX, typename TP>
int launch(const void* x, const void* a, const void* bp, const int* table,
           const int* rank, const float* scale, const int* ids, float* y, int B,
           int C, int din, int dout, int pr, int Pmax, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)C * Pmax * pr;
  auto kern = bgmv_kernel<TX, TP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, (dout + kTileN - 1) / kTileN);
  kern<<<grid, kThreads, smem, st>>>(static_cast<const TX*>(x),
                                     static_cast<const TP*>(a),
                                     static_cast<const TP*>(bp), table, rank, scale,
                                     ids, y, C, din, dout, pr, Pmax);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  All tensors contiguous; x and
// a_pages 16-byte aligned with din a multiple of 8.  Returns
// a cudaError_t (0 = launched), or -1 for a dtype the kernel does not take.
extern "C" int bgmv_launch(const void* x, int x_dtype, const void* a_pages,
                           const void* b_pages, int p_dtype, const int* table,
                           const int* rank, const float* scale, const int* ids,
                           float* y, int B, int C, int din, int dout, int pr, int Pmax,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && p_dtype == 0)
    return launch<float, float>(x, a_pages, b_pages, table, rank, scale, ids, y, B, C,
                                din, dout, pr, Pmax, st);
  if (x_dtype == 0 && p_dtype == 1)
    return launch<float, __nv_bfloat16>(x, a_pages, b_pages, table, rank, scale, ids, y,
                                        B, C, din, dout, pr, Pmax, st);
  if (x_dtype == 1 && p_dtype == 0)
    return launch<__nv_bfloat16, float>(x, a_pages, b_pages, table, rank, scale, ids, y,
                                        B, C, din, dout, pr, Pmax, st);
  if (x_dtype == 1 && p_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, a_pages, b_pages, table, rank, scale,
                                                ids, y, B, C, din, dout, pr, Pmax, st);
  return -1;
}
