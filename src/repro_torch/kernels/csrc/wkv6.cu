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
// scratch from one grid step to the next.  Blocks on Hopper run in no
// order, so here one block owns one (b, h) pair and walks the whole
// sequence itself: one launch, and the chunk size has no effect.
//
// What bounds it on the H100 (data-sheet rates 3.35 TB/s, 67 TFLOP/s fp32):
// at B 8, S 1024, H 32, hd 64 the function moves ≈ 235 MB (r, k, v in bf16,
// w and y in fp32: 70 µs) and does 5·hd² + 5·hd operations per token and
// head (r·S, e^w ⊙ S + k ⊗ v, and the bonus as one dot product Σ r u k
// times v), 5.45 GFLOP in fp32 (81 µs): operations, on the CUDA cores.
// The columns of S are independent, but each element's update is a chain
// over time.
// What limits this kernel in practice is feeding the FMAs: every token
// needs r, k and e^w of all 64 rows, and a shared-memory broadcast of a
// float4 costs as much as any other 16-byte-per-lane load.  One thread
// per column (64 threads, 3 FP32 instructions per float read) and four
// threads per column both ran at ≈ 470 µs, bound by those loads; giving
// each thread an 8 × 8 tile of S (24 FP32 instructions per float4) halved
// the loads per FMA, and the kernel now runs ≈ 275 µs (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md).
//
// What the design does about it:
//   * the block's hd threads each keep an 8-row tile of S in registers
//     for the whole sequence (hd/8 columns hd/8·(t/(hd/8)) + a, rows
//     hd/2·q + 4·(t%(hd/8)) + i: 8 × 8 at hd 64), so S never touches memory;
//   * tokens are staged 16 at a time in shared memory (r, k, e^w, v), double
//     buffered: the next tile's loads are issued before the current tile's
//     updates and stored after them, so there is one barrier per tile;
//   * e^w is taken once per element while staging, never in the inner loop;
//   * the bonus term v_v · Σ_k r_k u_k k_k is one scalar per token: each
//     warp reduces its half of the sum with shuffles while staging, and it
//     enters each column once, in row group 0;
//   * per token a thread reads eight float4s (the eight row groups of a
//     warp on adjacent addresses: no bank conflict) for 192 FP32
//     instructions, and the eight threads of a column group sum their
//     partial y by recursive halving, after which thread t holds y[t] (a
//     coalesced store);
//   * a ragged last tile is masked: tokens past S are never computed or
//     written.
// B·H = 256 blocks of two warps give each scheduler one warp; the token's
// shuffle chain and shared loads then stall it (≈ 470 cycles a token
// against ≈ 240 instructions).  The tensor-core chunked form is the next
// step.
//
// Head dims: the design is templated on hd with hd threads a block, each
// holding hd elements of S as 8 rows × hd/8 columns.  At hd 64 that is the
// 8 × 8 tile above; at hd 32 it is 32 threads with 8 rows × 4 columns,
// chosen over 16 threads with 8 × 8 tiles because 32 threads are one whole
// warp: each still stages one element of every token, the bonus is one
// warp's reduction, the row-side loads keep their two float4s, and y's
// halving takes 2 shuffle steps instead of 3; 16 threads would leave half
// of each warp idle and need partial-warp shuffles.  The same template
// does not stretch to hd 128 (64 KB of staged tiles, over the 48 KB of
// static shared memory) or hd 16 (half a warp).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;          // tokens per staged tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// This thread's lane (element `tid` of each token) of a tile, as stored: a
// bf16 value is widened only when the tile is written to shared memory,
// after the current tile's updates, so nothing waits on the loads early.
template <typename T>
struct Tile {
  T r[kTile], k[kTile], v[kTile];
  float w[kTile];
};

template <typename T>
__device__ __forceinline__ void load_tile(Tile<T>& p, const T* __restrict__ r,
                                          const T* __restrict__ k,
                                          const T* __restrict__ v,
                                          const float* __restrict__ w, long base,
                                          long stride_t, int t0, int S) {
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    if (t0 + j < S) {
      const long off = base + (long)(t0 + j) * stride_t;
      p.r[j] = r[off];
      p.k[j] = k[off];
      p.v[j] = v[off];
      p.w[j] = w[off];
    } else {            // past S: never computed, but e^0 = 1 and k·v = 0
      p.r[j] = p.k[j] = p.v[j] = T(0.f);
      p.w[j] = 0.f;
    }
  }
}

template <int HD>                  // head dim = threads per block
struct Smem {
  static constexpr int kWarps = HD / 32;
  float r[2][kTile][HD];
  float k[2][kTile][HD];
  float e[2][kTile][HD];
  float v[2][kTile][HD];
  float bonus[2][kWarps][kTile];   // per-warp partials of Σ_k r_k u_k k_k
};

template <int HD, typename T>
__device__ __forceinline__ void store_tile(Smem<HD>& sm, const Tile<T>& p, int buf,
                                           int tid, float uk) {
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const float rj = to_f(p.r[j]), kj = to_f(p.k[j]);
    sm.r[buf][j][tid] = rj;
    sm.k[buf][j][tid] = kj;
    sm.e[buf][j][tid] = expf(p.w[j]);
    sm.v[buf][j][tid] = to_f(p.v[j]);
    float part = rj * uk * kj;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) sm.bonus[buf][warp][j] = part;
  }
}

// Thread t owns CW = hd/8 columns v = CW·(t / CW) + jv and 8 rows k =
// hd/2·q + 4·(t % CW) + i of S (jv < CW, q < 2, i < 4): an 8 × 8 tile at
// hd 64.  Per token it reads 8 r, 8 k, 8 e^w and CW v from shared memory
// (float4 loads, the CW row groups of a warp on adjacent addresses) for
// 24·CW FMAs, and the CW threads of a column group sum their partial y by
// recursive halving, after which thread t holds y[t].
template <int HD, typename T>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            float* __restrict__ y, int S, int H) {
  constexpr int CW = HD / 8;                                // columns a thread = row groups
  __shared__ __align__(16) Smem<HD> sm;
  const int b = blockIdx.x / H, h = blockIdx.x % H, tid = threadIdx.x;
  const int cg = tid / CW, rg = tid % CW;
  const long stride_t = (long)H * HD;                       // one token on
  const long base = ((long)b * S * H + h) * HD + tid;       // (b, 0, h, tid)
  const float uk = u[h * HD + tid];

  float st[CW][8];                                          // [jv][4q + i]
#pragma unroll
  for (int a = 0; a < CW; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) st[a][c] = 0.f;

  Tile<T> p;
  load_tile(p, r, k, v, w, base, stride_t, 0, S);
  store_tile(sm, p, 0, tid, uk);
  __syncthreads();

  const int n_tiles = (S + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1, t0 = it * kTile;
    const bool more = it + 1 < n_tiles;
    if (more) load_tile(p, r, k, v, w, base, stride_t, t0 + kTile, S);
    const int nt = min(kTile, S - t0);
#pragma unroll 1
    for (int j = 0; j < nt; ++j) {
      float rr[8], kk[8], ee[8], vv[CW];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int row = HD / 2 * q + 4 * rg;
        *reinterpret_cast<float4*>(rr + 4 * q) =
            *reinterpret_cast<const float4*>(&sm.r[buf][j][row]);
        *reinterpret_cast<float4*>(kk + 4 * q) =
            *reinterpret_cast<const float4*>(&sm.k[buf][j][row]);
        *reinterpret_cast<float4*>(ee + 4 * q) =
            *reinterpret_cast<const float4*>(&sm.e[buf][j][row]);
      }
#pragma unroll
      for (int q = 0; q < CW / 4; ++q)
        *reinterpret_cast<float4*>(vv + 4 * q) =
            *reinterpret_cast<const float4*>(&sm.v[buf][j][CW * cg + 4 * q]);
      // the bonus v_v · Σ_k r_k u_k k_k enters once per column, in row group 0
      float bonus = 0.f;
      if (rg == 0)
#pragma unroll
        for (int wp = 0; wp < Smem<HD>::kWarps; ++wp) bonus += sm.bonus[buf][wp][j];
      float yp[CW];
#pragma unroll
      for (int a = 0; a < CW; ++a) {
        float acc = bonus * vv[a];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          acc = fmaf(rr[c], st[a][c], acc);
          st[a][c] = fmaf(ee[c], st[a][c], kk[c] * vv[a]);
        }
        yp[a] = acc;
      }
      // recursive halving over the row groups (lane bits CW/2 .. 1): after
      // each step a thread keeps the half of its columns its bit selects
#pragma unroll
      for (int m = CW / 2; m >= 1; m /= 2) {
        const bool hi = rg & m;
#pragma unroll
        for (int a = 0; a < m; ++a) {
          const float mine = hi ? yp[a + m] : yp[a], other = hi ? yp[a] : yp[a + m];
          yp[a] = mine + __shfl_xor_sync(0xffffffffu, other, m);
        }
      }
      y[base + (long)(t0 + j) * stride_t] = yp[0];          // column tid
    }
    // The other buffer was last read in tile it - 1, which every thread
    // finished before the barrier that closed it.
    if (more) store_tile(sm, p, buf ^ 1, tid, uk);
    __syncthreads();
  }
}

template <int HD, typename T>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           float* y, int B, int S, int H, cudaStream_t st) {
  wkv6_kernel<HD, T><<<B * H, HD, 0, st>>>(static_cast<const T*>(r),
                                           static_cast<const T*>(k),
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

// dtype code of r, k, v: 0 = float32, 1 = bfloat16.  All tensors contiguous,
// head dim 32 or 64.  Returns a cudaError_t (0 = launched), or -1 for
// arguments the kernel does not take.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v, int dtype,
                           const float* w, const float* u, float* y, int B, int S,
                           int H, int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return -1;
  if (hd == 64) return launch_dtype<64>(dtype, r, k, v, w, u, y, B, S, H, st);
  if (hd == 32) return launch_dtype<32>(dtype, r, k, v, w, u, y, B, S, H, st);
  return -1;
}
