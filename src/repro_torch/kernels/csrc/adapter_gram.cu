// Batched tall-skinny Gram matrix, for sm_90a:
//   out[g] = x[g]ᵀ x[g]   for x (G, m, r) fp32 -> out (G, r, r) fp32.
//
// Replaces: src/repro/kernels/adapter_gram.py :: adapter_gram_kernel (the
// Pallas TPU kernel behind repro.kernels.ops.adapter_gram, the first step
// of the server's Gram SVD route, repro.core.svd._gram_matrix).  The TPU
// kernel takes one (m, r) stack and is vmapped over layers × leaves; here
// the batch axis is written out and one call covers a whole bucket.  The
// tail panel (rows past m) is masked, as there.  Products and sums are
// plain fp32 FMAs, not TF32: the spectra decide the kept ranks.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3 at 700 W; data-sheet
// rates 3.35 TB/s and 67 TFLOP/s fp32): xᵀx is symmetric, so the function
// needs G·m·r(r+1) operations.  At the round's shape (G = 32 layers ×
// leaves, m = 2048, r = Σ r_k = 64) that is 0.27 GFLOP (≈ 4 µs) against
// 17 MB read (≈ 5.2 µs): bytes.  At r = 128, 1.1 GFLOP (≈ 16 µs) against
// 34 MB (≈ 11 µs): operations.  This kernel computes both triangles.
//
// What the design does about it: the TPU walks m sequentially with one
// resident r×r accumulator; Hopper needs hundreds of blocks in flight.  So
// m is split into panels across blocks, and each block accumulates one
// 64 × 64 tile of one partial r×r Gram over its panel: 32-row slices of
// both column strips are staged in shared memory and each thread keeps a
// 4 × 4 block of outputs in registers (16 FMAs per two 16-byte loads).
// A second kernel sums the panels' partials in panel order — no atomics,
// so the result is the same from run to run.  With one panel the partial
// kernel writes the output directly.  Tiling over r handles any rank, up
// to the delta route's min(m, n).
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64, kRows = 32, kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
gram_partial(const float* __restrict__ x, float* __restrict__ part, int m, int r,
             int panel_rows, int n_panels, int n_tiles) {
  __shared__ __align__(16) float xi[kRows][kTile];
  __shared__ __align__(16) float xj[kRows][kTile];
  const int g = blockIdx.z, p = blockIdx.y;
  const int ti = blockIdx.x / n_tiles, tj = blockIdx.x % n_tiles;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int row0 = p * panel_rows, row1 = min(m, row0 + panel_rows);
  const float* xg = x + (long)g * m * r;
  float acc[4][4] = {};

  for (int rs = row0; rs < row1; rs += kRows) {
    for (int e = tid; e < kRows * kTile; e += kThreads) {
      const int rr = e / kTile, c = e % kTile;
      const int row = rs + rr, ci = ti * kTile + c, cj = tj * kTile + c;
      const bool in = row < row1;
      xi[rr][c] = (in && ci < r) ? xg[(long)row * r + ci] : 0.f;
      xj[rr][c] = (in && cj < r) ? xg[(long)row * r + cj] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kRows; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&xi[rr][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&xj[rr][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + ((long)g * n_panels + p) * r * r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int oi = ti * kTile + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int oj = tj * kTile + tx * 4 + j;
      if (oi < r && oj < r) out[(long)oi * r + oj] = acc[i][j];
    }
  }
}

__global__ void gram_reduce(const float* __restrict__ part, float* __restrict__ out,
                            long G, int r, int n_panels) {
  const long rr = (long)r * r;
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < G * rr;
       e += (long)gridDim.x * blockDim.x) {
    const long g = e / rr, ij = e % rr;
    const float* src = part + g * n_panels * rr + ij;
    float s = 0.f;
    for (int p = 0; p < n_panels; ++p) s += src[p * rr];
    out[e] = s;
  }
}

}  // namespace

// x (G, m, r) and out (G, r, r) fp32, contiguous.  ``part`` holds
// G · n_panels · r · r floats when n_panels > 1 (unused, may be null, for
// one panel).  ``panel_rows`` is a multiple of 32 with
// n_panels = ceil(m / panel_rows).  Returns a cudaError_t (0 = launched),
// or -1 for arguments the kernel does not take.
extern "C" int adapter_gram_launch(const float* x, float* out, float* part, int G,
                                   int m, int r, int panel_rows, int n_panels,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || m < 1 || r < 1 || panel_rows < 1 || n_panels < 1
      || (long)(n_panels - 1) * panel_rows >= m || (n_panels > 1 && part == nullptr))
    return -1;
  const int n_tiles = (r + kTile - 1) / kTile;
  const dim3 grid(n_tiles * n_tiles, n_panels, G);
  gram_partial<<<grid, kThreads, 0, st>>>(x, n_panels > 1 ? part : out, m, r,
                                          panel_rows, n_panels, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_panels == 1) return (int)err;
  gram_reduce<<<264, 256, 0, st>>>(part, out, G, r, n_panels);
  return (int)cudaGetLastError();
}
