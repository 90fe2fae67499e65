// Fused LoRA projection, for sm_90a:
//   y = x W + bf16(x Aᵀ) (s·B)ᵀ      (s·B passed in pre-scaled as b)
//
// Replaces: src/repro/kernels/lora_matmul.py :: lora_matmul_kernel (the
// Pallas TPU kernel behind repro.kernels.ops.lora_matmul).  Same contract:
// x (M, din), w (din, dout), a (r, din), b (dout, r), all of one dtype
// (bf16 or fp32; the wrapper casts a and s·B to x's dtype as the reference
// does); out (M, dout) in that dtype, fp32 accumulation.  The rank-r
// intermediate z = x Aᵀ never leaves the chip: it is accumulated beside
// the base product, rounded to x's dtype (the reference's rounding point),
// and multiplied into the output tile from shared memory.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3 at 700 W; data-sheet
// rates 3.35 TB/s and 989 TFLOP/s bf16): operations.  At the train step's shape
// (M = 4·512 tokens, din = dout = 2048, r ≤ 32) the base product is
// 2·M·din·dout ≈ 17 GFLOP against ≈ 25 MB of operands: ~700 flops per
// byte, far above the card's bf16 balance point (~295).
//
// What the design does about it: bf16 runs on the tensor cores through the
// WMMA API (16×16×16 fragments, fp32 accumulators).  One block of 8 warps
// per 128 × 128 output tile walks din in 32-wide slices that stream
// through a three-slot ring in shared memory by cp.async, so the next two
// slices load while the current one multiplies; each warp owns a 32 × 64
// sub-tile of the base product
// and 16 rows of z (the same x slice feeds both products, so z costs r/128
// of the base product and no extra read of x).  After the loop z goes
// through shared memory, is rounded to bf16 and multiplied with the
// block's (128 × r) slice of s·B into the same accumulators.  Ragged M,
// dout, din and r are masked in the loads and stores: no padded copies.
// There is no TMA and no wgmma yet (the mma.sync-class WMMA path reaches
// a fraction of the card's bf16 rate); that is later work.
//
// fp32 takes a CUDA-core kernel (64 × 64 tiles, 4 × 4 outputs a thread),
// used for the parity checks; it computes the same function.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

// ---------------------------------------------------------------- bf16 ----
constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;
constexpr int kLdX = kBK + 8;    // bf16 row strides: multiples of 8, rows 32-byte aligned
constexpr int kLdW = kBN + 8;

constexpr int kStages = 3;      // slices in flight through shared memory

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage 8 consecutive elements of row `row`, columns [col, col + 8), of a
// row-major (nrows × ncols) matrix with leading dimension ld: an
// asynchronous 16-byte copy where the chunk lies inside and is aligned,
// zeros where it lies outside, element by element on a ragged edge.
__device__ __forceinline__ void stage8(bf16* dst, const bf16* __restrict__ src,
                                      long row, long col, long nrows, long ncols,
                                      long ld, bool vec) {
  if (row < nrows && col + 8 <= ncols && vec) {
    cp_async16(dst, src + row * ld + col);
    return;
  }
  if (row >= nrows || col >= ncols) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    dst[i] = (col + i < ncols) ? src[row * ld + col + i] : __float2bfloat16(0.f);
}

template <int RP>   // rank padded to a multiple of 16 (16, 32, 64 or 128)
__global__ void __launch_bounds__(kThreads)
lora_matmul_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const bf16* __restrict__ a, const bf16* __restrict__ b,
                 bf16* __restrict__ y, int M, int din, int dout, int r) {
  constexpr int kLdR = RP + 8;
  constexpr int kStageElems = kBM * kLdX + kBK * kLdW + RP * kLdX;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);          // kStages × {x, W, A slices}
  bf16* zs = ring + kStages * kStageElems;             // [kBM][kLdR] bf16(z)
  bf16* bs = zs + kBM * kLdR;                          // [kBN][kLdR] s·B rows
  float* stage = reinterpret_cast<float*>(bs + kBN * kLdR);  // [8 warps][16*16]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long m0 = (long)blockIdx.y * kBM, n0 = (long)blockIdx.x * kBN;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 64;   // warp's output sub-tile
  const bool vx = (din % 8 == 0), vw = (dout % 8 == 0);
  float* st = stage + warp * 256;
  const int nk = (din + kBK - 1) / kBK;

  // slice kt of x (kBM × kBK), W (kBK × kBN) and A (RP × kBK) into its slot
  auto load_slice = [&](int kt) {
    bf16* xs = ring + (kt % kStages) * kStageElems;
    bf16* ws = xs + kBM * kLdX;
    bf16* as = ws + kBK * kLdW;
    const int k0 = kt * kBK;
    for (int c = tid; c < kBM * kBK / 8; c += kThreads) {
      const int row = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
      stage8(xs + row * kLdX + col, x, m0 + row, k0 + col, M, din, din, vx);
    }
    for (int c = tid; c < kBK * kBN / 8; c += kThreads) {
      const int row = c / (kBN / 8), col = (c % (kBN / 8)) * 8;
      stage8(ws + row * kLdW + col, w, k0 + row, n0 + col, din, dout, dout, vw);
    }
    for (int c = tid; c < RP * kBK / 8; c += kThreads) {
      const int row = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
      stage8(as + row * kLdX + col, a, row, k0 + col, r, din, din, vx);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4], zacc[RP / 16];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll
  for (int j = 0; j < RP / 16; ++j) wmma::fill_fragment(zacc[j], 0.f);

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_slice(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();       // this thread's copies of slice kt landed
    __syncthreads();                    // everyone's; slot of slice kt-1 is free
    if (kt + kStages - 1 < nk) load_slice(kt + kStages - 1);
    cp_async_commit();
    const bf16* xs = ring + (kt % kStages) * kStageElems;
    const bf16* ws = xs + kBM * kLdX;
    const bf16* as = ws + kBK * kLdW;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], xs + (wr + 16 * i) * kLdX + kk, kLdX);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::load_matrix_sync(fb, ws + kk * kLdW + wc + 16 * j, kLdW);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
      // z rows [16·warp, 16·warp + 16): x slice times Aᵀ (A rows, col-major)
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fz;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fat;
      wmma::load_matrix_sync(fz, xs + (16 * warp) * kLdX + kk, kLdX);
#pragma unroll
      for (int j = 0; j < RP / 16; ++j) {
        wmma::load_matrix_sync(fat, as + (16 * j) * kLdX + kk, kLdX);
        wmma::mma_sync(zacc[j], fz, fat, zacc[j]);
      }
    }
  }
  cp_async_wait<0>();

  // z -> bf16 in shared memory (the reference rounds z to x's dtype)
#pragma unroll
  for (int j = 0; j < RP / 16; ++j) {
    wmma::store_matrix_sync(st, zacc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32)
      zs[(16 * warp + e / 16) * kLdR + 16 * j + e % 16] = __float2bfloat16(st[e]);
    __syncwarp();
  }
  // the block's rows of s·B, zero past dout and past the rank
  for (int e = tid; e < kBN * RP; e += kThreads) {
    const int n = e / RP, k = e % RP;
    bs[n * kLdR + k] = (n0 + n < dout && k < r) ? b[(n0 + n) * (long)r + k]
                                                : __float2bfloat16(0.f);
  }
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < RP; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(fa[i], zs + (wr + 16 * i) * kLdR + kk, kLdR);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::load_matrix_sync(fb, bs + (wc + 16 * j) * kLdR + kk, kLdR);
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
    }
  }
  // store through the warp's staging tile, masked, rounded once to bf16
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const long row = m0 + wr + 16 * i + e / 16, col = n0 + wc + 16 * j + e % 16;
        if (row < M && col < dout) y[row * dout + col] = __float2bfloat16(st[e]);
      }
      __syncwarp();
    }
}

template <int RP>
size_t bf16_smem() {
  return sizeof(bf16) * ((size_t)kStages * (kBM * kLdX + kBK * kLdW + RP * kLdX)
                         + 2 * (size_t)kBM * (RP + 8))
         + sizeof(float) * 8 * 256;
}

template <int RP>
int launch_bf16(const void* x, const void* w, const void* a, const void* b, void* y,
                int M, int din, int dout, int r, cudaStream_t st) {
  const size_t smem = bf16_smem<RP>();
  cudaError_t err = cudaFuncSetAttribute(
      lora_matmul_bf16<RP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((dout + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  lora_matmul_bf16<RP><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(y), M, din, dout, r);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 ----
constexpr int kFM = 64, kFN = 64, kFK = 16;

template <int RP>
__global__ void __launch_bounds__(kThreads)
lora_matmul_f32(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ y, int M, int din, int dout, int r) {
  extern __shared__ __align__(16) float fs[];
  float* xs = fs;                       // [kFK][kFM]   x slice, transposed
  float* ws = xs + kFK * kFM;           // [kFK][kFN]
  float* at = ws + kFK * kFN;           // [kFK][RP]    A slice, transposed
  float* zs = at + kFK * RP;            // [kFM][RP + 1]
  float* bs = zs + kFM * (RP + 1);      // [kFN][RP + 1]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long m0 = (long)blockIdx.y * kFM, n0 = (long)blockIdx.x * kFN;
  float acc[4][4] = {}, zacc[4][RP / 16] = {};

  for (int k0 = 0; k0 < din; k0 += kFK) {
    for (int e = tid; e < kFM * kFK; e += kThreads) {
      const int mm = e / kFK, kk = e % kFK;
      xs[kk * kFM + mm] = (m0 + mm < M && k0 + kk < din) ? x[(m0 + mm) * din + k0 + kk] : 0.f;
    }
    for (int e = tid; e < kFK * kFN; e += kThreads) {
      const int kk = e / kFN, nn = e % kFN;
      ws[kk * kFN + nn] = (k0 + kk < din && n0 + nn < dout) ? w[(long)(k0 + kk) * dout + n0 + nn] : 0.f;
    }
    for (int e = tid; e < RP * kFK; e += kThreads) {
      const int rr = e / kFK, kk = e % kFK;
      at[kk * RP + rr] = (rr < r && k0 + kk < din) ? a[(long)rr * din + k0 + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[kk * kFM + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wv = ws[kk * kFN + tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(xv[i], wv, acc[i][j]);
      }
#pragma unroll
      for (int j = 0; j < RP / 16; ++j) {
        const float av = at[kk * RP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) zacc[i][j] = fmaf(xv[i], av, zacc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RP / 16; ++j) zs[(ty * 4 + i) * (RP + 1) + tx + 16 * j] = zacc[i][j];
  for (int e = tid; e < kFN * RP; e += kThreads) {
    const int n = e / RP, k = e % RP;
    bs[n * (RP + 1) + k] = (n0 + n < dout && k < r) ? b[(n0 + n) * (long)r + k] : 0.f;
  }
  __syncthreads();
  for (int k = 0; k < RP; ++k) {
    float zv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) zv[i] = zs[(ty * 4 + i) * (RP + 1) + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bv = bs[(tx * 4 + j) * (RP + 1) + k];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(zv[i], bv, acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long row = m0 + ty * 4 + i, col = n0 + tx * 4 + j;
      if (row < M && col < dout) y[row * dout + col] = acc[i][j];
    }
}

template <int RP>
int launch_f32(const void* x, const void* w, const void* a, const void* b, void* y,
               int M, int din, int dout, int r, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)kFK * (kFM + kFN + RP)
                                       + (size_t)(kFM + kFN) * (RP + 1));
  cudaError_t err = cudaFuncSetAttribute(
      lora_matmul_f32<RP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((dout + kFN - 1) / kFN, (M + kFM - 1) / kFM);
  lora_matmul_f32<RP><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(y), M, din, dout, r);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for all of x, w, a, b and y.  All
// contiguous and 16-byte aligned; 1 <= r <= 128.  Returns a cudaError_t
// (0 = launched), or -1 for a dtype or rank the kernel does not take.
extern "C" int lora_matmul_launch(const void* x, const void* w, const void* a,
                                  const void* b, void* y, int dtype, int M, int din,
                                  int dout, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r < 1 || r > 128 || M < 1 || din < 1 || dout < 1) return -1;
  const int rp = r <= 16 ? 16 : r <= 32 ? 32 : r <= 64 ? 64 : 128;
  if (dtype == 1) {
    switch (rp) {
      case 16: return launch_bf16<16>(x, w, a, b, y, M, din, dout, r, st);
      case 32: return launch_bf16<32>(x, w, a, b, y, M, din, dout, r, st);
      case 64: return launch_bf16<64>(x, w, a, b, y, M, din, dout, r, st);
      default: return launch_bf16<128>(x, w, a, b, y, M, din, dout, r, st);
    }
  }
  if (dtype == 0) {
    switch (rp) {
      case 16: return launch_f32<16>(x, w, a, b, y, M, din, dout, r, st);
      case 32: return launch_f32<32>(x, w, a, b, y, M, din, dout, r, st);
      case 64: return launch_f32<64>(x, w, a, b, y, M, din, dout, r, st);
      default: return launch_f32<128>(x, w, a, b, y, M, din, dout, r, st);
    }
  }
  return -1;
}
