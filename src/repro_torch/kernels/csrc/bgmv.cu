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
// Precision follows the reference: z = x Aᵀ accumulated in fp32 (bf16 x on
// bf16 pages on the bf16 tensor cores, whose products are exact in fp32;
// every other dtype pair on the CUDA cores in fp32), then z·Bᵀ in fp32.
//
// What bounds it on the H100: bytes, and below them latency.  A row reads
// its rank_b·(din+dout) adapter elements, x, and writes y, doing
// 2·C·rank·(din+dout) flops — a few flops per byte, far below the card's
// balance point.  A decode call moves a few hundred KB (≈ 0.1 µs at 3.35
// TB/s), so what a launch costs is its chain of dependent steps: ids ->
// table and rank -> pages -> the shrink -> the sum of z -> the expand.
//
// What the design does about it (bgmv.py :: plan mirrors the arithmetic):
//   * z is formed once per CLUSTER of 8 blocks, not once per output tile.
//     The grid is (8 · clusters, B): the blocks of a cluster share row b;
//     block q of the cluster shrinks chunks q, q + 8, q + 16, ... of din
//     (x's C rows and the adapter's A rows, loaded once for all C queries),
//     stores its partial z into slot q of every other block of the cluster
//     (remote shared-memory stores, no round trip), and after one cluster
//     barrier sums the 8 slots it holds; then it expands its own tile of
//     tile_n output columns.  A row runs as many clusters as its columns
//     need at tile_n ≤ 1024 (one at dout 512 … 7168, three at 24576), so z
//     is formed 1–3 times a row where the one-block-a-tile design formed it
//     dout/256 times;
//   * a rank-0 row (every row of the engines' base-model traffic) leaves
//     as soon as its rank is read, before any copy: its blocks only write
//     zeros;
//   * every load of a block is in flight at once: the first chunk's x rows
//     (they depend on b alone), then the B tile (for each of the row's
//     pages the contiguous tile_n·pr elements of its columns — it depends
//     only on the page table, not on z) and the first chunk's A rows, as
//     16-byte cp.async copies, the next chunk behind them.  Chunks are as
//     large as two stages in ~200 KB allow, so at the main shapes a block
//     walks one or two.  Rows past C and ranks past rank_b are zero-filled
//     by the copies (source size 0), never read from memory;
//   * the shrink: bf16 x on bf16 pages with C ≥ 8 runs mma.sync m16n8k16
//     (the C query rows padded to 16, ranks in 8-wide n-tiles, each warp
//     on one n-tile and a share of the k-steps); C < 8 and the other dtype
//     pairs take the CUDA cores in fp32, a group of lanes per (query row,
//     rank) dotting 16-byte chunks of both rows (faster than a 16-row mma
//     tile that is mostly padding).  Partial sums meet in shared memory
//     in a fixed order (the same bits every run);
//   * the expand: a thread per output column holds 4 ranks of B at a time
//     in registers (one vector load where pr is a multiple of 4) against 8
//     query rows of z broadcast from shared memory; stores are coalesced
//     across the columns.  B's lanes at or above the rank are copied with
//     their page but selected away, so a stale lane of an evicted adapter
//     cannot reach the sum;
//   * the shared-memory attribute is set once per dtype pair and device,
//     not on every call.
// The indirection (ids -> table row, rank, scale) is read inside the
// kernel, so the wrapper launches nothing else.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;        // blocks that share a row's z
constexpr int kPad = 16;           // bytes after each staged row
constexpr int kSmemLimit = 232448; // dynamic shared memory a block may use
constexpr int kMaxDevices = 64;

struct Args {
  const void* x;
  const void* a;
  const void* bp;
  const int* table;
  const int* rank;
  const float* scale;
  const int* ids;
  float* y;
  int C, din, dout, pr, Pmax;
  int tile_n;    // output columns a block expands
  int kc;        // din elements a chunk
  int nchunk;    // chunks of din
  int c_pad;     // rows of z (C padded to 16)
  int r_pad;     // ranks of z (Pmax·pr padded to 8)
  int x_rows;    // staged x rows (c_pad on the mma route, C otherwise)
};

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
// 4 consecutive elements as floats
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(r.x << 16);
  o[1] = __uint_as_float(r.x & 0xffff0000u);
  o[2] = __uint_as_float(r.y << 16);
  o[3] = __uint_as_float(r.y & 0xffff0000u);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait0() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// d += a · b on the tensor cores, m16n8k16, bf16 inputs, fp32 accumulators.
// Fragments (PTX ISA, mma.m16n8k16 .bf16), g = lane / 4, t = lane % 4:
//   a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..);
//   b0 (k = 2t..2t+1, n = g), b1 (k = 2t + 8.., n = g);
//   d0, d1 (g, 2t + {0, 1}), d2, d3 (g + 8, 2t + {0, 1}).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename TX, typename TP, bool MMA>
__global__ void __launch_bounds__(kThreads)
bgmv_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int q = blockIdx.x % kCluster;          // the block's rank in its cluster
  const int col0 = blockIdx.x * a.tile_n;
  const int ncol = max(0, min(a.tile_n, a.dout - col0));
  const int C = a.C, din = a.din, dout = a.dout, pr = a.pr, RZ = a.r_pad;
  const int R = a.Pmax * pr;
  const int id = a.ids[b];
  const int* table = a.table + (long)id * a.Pmax;
  const int pg = tid < a.Pmax ? table[tid] : 0;  // in flight beside the rank
  const int r_b = min(a.rank[id], R);
  float* yb = a.y + (long)b * C * dout + col0;
  if (r_b <= 0) {                 // base / evicted: exact zero (the whole cluster)
    for (int c = 0; c < C; ++c)
      for (int j = tid; j < ncol; j += kThreads) yb[(long)c * dout + j] = 0.f;
    return;
  }
  cluster_arrive_relaxed();                     // waited on before the first remote store

  // shared memory: B tile | two din stages (x rows, then A rows) | the
  // cluster's partial z's, block k's in slot k | z | the adapter's page ids
  constexpr int XE = sizeof(TX), PE = sizeof(TP);
  const int xs = a.kc * XE + kPad;              // bytes per staged x row
  const int as = a.kc * PE + kPad;              // bytes per staged A row
  const int stage = a.x_rows * xs + RZ * as;
  const int btile = a.tile_n * R * PE;
  unsigned char* bt = smem;
  unsigned char* stages = smem + btile;
  const int cz = a.c_pad * RZ;
  float* zr = reinterpret_cast<float*>(stages + 2 * stage);   // [kCluster][c_pad][RZ]
  float* zp = zr + q * cz;                                    // this block's partial z
  float* zf = zr + kCluster * cz;                             // [c_pad][RZ]
  int* pages = reinterpret_cast<int*>(zf + cz);               // [Pmax]

  // chunk j's copies into stage s: x rows (they depend on b alone) and A
  // rows (through the page ids); rows past C and ranks past r_b zero-filled
  const TX* xb = static_cast<const TX*>(a.x) + (long)b * C * din;
  const TP* apages = static_cast<const TP*>(a.a);
  auto load_x = [&](int j, int s) {
    const int d0 = j * a.kc;
    unsigned char* sx = stages + s * stage;
    constexpr int XV = 16 / XE;                 // elements per 16 bytes
    const int xu = a.kc / XV;
    for (int i = tid; i < a.x_rows * xu; i += kThreads) {
      const int c = i / xu, d = d0 + (i % xu) * XV;
      const bool ok = c < C && d < din;
      cp16(sx + c * xs + (i % xu) * 16, ok ? xb + (long)c * din + d : xb, ok);
    }
  };
  auto load_a = [&](int j, int s) {
    const int d0 = j * a.kc;
    unsigned char* sa = stages + s * stage + a.x_rows * xs;
    constexpr int PV = 16 / PE;
    const int au = a.kc / PV;
    for (int i = tid; i < RZ * au; i += kThreads) {
      const int r = i / au, d = d0 + (i % au) * PV;
      const bool ok = r < r_b && d < din;
      cp16(sa + r * as + (i % au) * 16,
           ok ? apages + ((long)pages[r / pr] * pr + r % pr) * din + d : apages, ok);
    }
  };

  // the first chunk's x rows fly while the page ids reach shared memory
  const int mine = q < a.nchunk ? (a.nchunk - q + kCluster - 1) / kCluster : 0;
  if (mine > 0) load_x(q, 0);
  cp_commit();
  if (tid < a.Pmax) pages[tid] = pg;
  for (int i = tid + kThreads; i < a.Pmax; i += kThreads) pages[i] = table[i];
  __syncthreads();

  // the B tile: for each page the contiguous ncol·pr elements of this
  // block's columns, in 16-byte copies; then the first chunk's A rows
  const TP* bpages = static_cast<const TP*>(a.bp);
  const int np = (r_b + pr - 1) / pr;
  const int units = ncol * pr * PE / 16;        // 16-byte units of one page's tile
  for (int i = tid; i < np * units; i += kThreads) {
    const int p = i / units, u = i % units;
    const TP* src = bpages + ((long)pages[p] * dout + col0) * pr;
    cp16(bt + (p * a.tile_n * pr) * PE + u * 16,
         reinterpret_cast<const unsigned char*>(src) + u * 16, true);
  }
  if (mine > 0) load_a(q, 0);
  cp_commit();
  for (int i = tid; i < cz; i += kThreads) zp[i] = 0.f;

  const int warp = tid / 32, lane = tid % 32;
  for (int i = 0; i < mine; ++i) {
    if (i + 1 < mine) {
      load_x(q + kCluster * (i + 1), (i + 1) & 1);
      load_a(q + kCluster * (i + 1), (i + 1) & 1);
    }
    cp_commit();
    cp_wait1();                                  // chunk i (and the B tile) landed
    __syncthreads();
    const unsigned char* sx = stages + (i & 1) * stage;
    const unsigned char* sa = sx + a.x_rows * xs;
    if constexpr (MMA) {
      // warp jobs: (m-tile, n-tile) items × k-groups; each job accumulates
      // its k-steps in registers and adds them to z once.  The k-groups of
      // an item add in the order kg = 0, 1, ... (a barrier between them),
      // so z has the same bits every run; shared-memory atomics would sum
      // in the order the warps arrive.  With kw > 1 every job fits in one
      // pass of the warps, so the barriers are reached by the whole block.
      const int mt = a.c_pad / 16, nt = (r_b + 7) / 8, ks = a.kc / 16;
      const int items = mt * nt;
      const int kw = items >= kWarps ? 1 : kWarps / items;
      const int g = lane / 4, t = lane % 4;
      for (int job0 = 0; job0 < items * kw; job0 += kWarps) {
        const int job = job0 + warp;
        const bool has = job < items * kw;
        const int item = job / kw, kg = job % kw;
        const int m = item / nt, n = item % nt;
        const unsigned char* xr = sx + (16 * m + g) * xs + 4 * t;
        const unsigned char* ar = sa + (8 * n + g) * as + 4 * t;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = kg; has && k < ks; k += kw) {
          const int ko = 32 * k;                 // 16 bf16 a k-step
          mma_bf16(acc, *reinterpret_cast<const uint32_t*>(xr + ko),
                   *reinterpret_cast<const uint32_t*>(xr + 8 * xs + ko),
                   *reinterpret_cast<const uint32_t*>(xr + ko + 16),
                   *reinterpret_cast<const uint32_t*>(xr + 8 * xs + ko + 16),
                   *reinterpret_cast<const uint32_t*>(ar + ko),
                   *reinterpret_cast<const uint32_t*>(ar + ko + 16));
        }
        float* z0 = zp + (16 * m + g) * RZ + 8 * n + 2 * t;
        for (int turn = 0; turn < kw; ++turn) {
          if (has && kg == turn) {
            z0[0] += acc[0];
            z0[1] += acc[1];
            z0[8 * RZ] += acc[2];
            z0[8 * RZ + 1] += acc[3];
          }
          if (kw > 1) __syncthreads();
        }
      }
    } else {
      // a group of tpp lanes per (query row, rank) pair; the loop is uniform
      // across the block so that every lane reaches the shuffles
      const int pairs = C * r_b;
      int tpp = 32;
      while (tpp > 1 && pairs * tpp > kThreads) tpp >>= 1;
      const int per = kThreads / tpp, units8 = a.kc / 8;
      for (int p0 = 0; p0 < pairs; p0 += per) {
        const int pair = p0 + tid / tpp;
        float acc = 0.f;
        if (pair < pairs) {
          const int c = pair / r_b, r = pair % r_b;
          const TX* xr = reinterpret_cast<const TX*>(sx + c * xs);
          const TP* ar = reinterpret_cast<const TP*>(sa + r * as);
          for (int u = tid % tpp; u < units8; u += tpp) {
            float xv[8], av[8];
            load8(xr + 8 * u, xv);
            load8(ar + 8 * u, av);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc = fmaf(xv[e], av[e], acc);
          }
        }
        for (int o = tpp / 2; o > 0; o >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (pair < pairs && tid % tpp == 0)
          atomicAdd(zp + (pair / r_b) * RZ + pair % r_b, acc);
      }
    }
    __syncthreads();                             // stage i & 1 free for chunk i + 2
  }
  cp_wait0();                                    // the B tile, where no chunk waited
  __syncthreads();

  // z = Σ over the cluster's partial sums: each block stores its C rows
  // into slot q of every other block (remote stores, no round trip), then
  // sums the slots it received
  cluster_wait();                                // every block of the cluster has started
  for (int i = tid; i < C * RZ; i += kThreads) {
    const float v = zp[i];
#pragma unroll
    for (int k = 1; k < kCluster; ++k) {
      const int dst = (q + k) % kCluster;
      st_cluster(map_rank(zr + q * cz + i, dst), v);
    }
  }
  cluster_arrive();
  cluster_wait();                                // every partial z has arrived
  for (int i = tid; i < cz; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kCluster; ++k) s += zr[k * cz + i];
    zf[i] = i < C * RZ && i % RZ < r_b ? s : 0.f;
  }
  __syncthreads();

  // expand: a thread per column, 8 query rows × 4 ranks at a time
  const float s = a.scale[id];
  const TP* bs = reinterpret_cast<const TP*>(bt);
  const bool vec = pr % 4 == 0;
  for (int j = tid; j < ncol; j += kThreads) {
    for (int c0 = 0; c0 < C; c0 += 8) {
      float acc[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] = 0.f;
      for (int r0 = 0; r0 < r_b; r0 += 4) {
        float bv[4];
        if (vec) {
          load4(bs + ((r0 / pr) * a.tile_n + j) * pr + r0 % pr, bv);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = min(r0 + e, r_b - 1);
            bv[e] = to_f(bs[((r / pr) * a.tile_n + j) * pr + r % pr]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) bv[e] = r0 + e < r_b ? bv[e] : 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float4 z4 = *reinterpret_cast<const float4*>(zf + (c0 + c) * RZ + r0);
          acc[c] = fmaf(z4.x, bv[0], fmaf(z4.y, bv[1], fmaf(z4.z, bv[2], fmaf(z4.w, bv[3], acc[c]))));
        }
      }
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c0 + c < C) yb[(long)(c0 + c) * dout + j] = acc[c] * s;
    }
  }
}

// launch with the plan's layout (bgmv.py :: plan); the shared-memory
// attribute is raised to the card's limit once per instantiation and device
template <typename TX, typename TP, bool MMA>
int launch(const Args& a, int B, int clusters, int smem, cudaStream_t st) {
  auto kern = bgmv_kernel<TX, TP, MMA>;
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
  cfg.gridDim = dim3(clusters * kCluster, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  All tensors contiguous; x,
// a_pages and b_pages 16-byte aligned, din a multiple of 8 and dout·pr a
// multiple of 8.  The route (mma = 1: the shrink on mma.sync, bf16 x on
// bf16 pages only) and the layout (tile_n, kc, nchunk, c_pad, r_pad,
// clusters, smem) are bgmv.py :: plan's for these shapes and dtypes.  Returns a
// cudaError_t (0 = launched), or -1 for a dtype pair or layout the kernel
// does not take.
extern "C" int bgmv_launch(const void* x, int x_dtype, const void* a_pages,
                           const void* b_pages, int p_dtype, const int* table,
                           const int* rank, const float* scale, const int* ids,
                           float* y, int B, int C, int din, int dout, int pr, int Pmax,
                           int mma, int tile_n, int kc, int nchunk, int c_pad,
                           int r_pad, int clusters, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem > kSmemLimit || tile_n % 64 || kc % 64 || c_pad % 16 || r_pad % 8 ||
      din % 8 || (dout * pr) % 8 || (mma && (x_dtype != 1 || p_dtype != 1)))
    return -1;
  const Args a{x, a_pages, b_pages, table, rank, scale, ids, y, C, din, dout, pr,
               Pmax, tile_n, kc, nchunk, c_pad, r_pad, mma ? c_pad : C};
  if (x_dtype == 0 && p_dtype == 0)
    return launch<float, float, false>(a, B, clusters, smem, st);
  if (x_dtype == 0 && p_dtype == 1)
    return launch<float, __nv_bfloat16, false>(a, B, clusters, smem, st);
  if (x_dtype == 1 && p_dtype == 0)
    return launch<__nv_bfloat16, float, false>(a, B, clusters, smem, st);
  if (x_dtype == 1 && p_dtype == 1)
    return mma ? launch<__nv_bfloat16, __nv_bfloat16, true>(a, B, clusters, smem, st)
               : launch<__nv_bfloat16, __nv_bfloat16, false>(a, B, clusters, smem, st);
  return -1;
}
