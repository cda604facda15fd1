// The bvh16-walk step microbenchmarks (kernels K7, K8 and K9 of the port).
//
// Replaces: scripts/bench_wkernels.py, the three Pallas TPU microkernels
// that isolate one step of the wtrace walk (ops/wtrace.py, K3):
//   K7 <- k1 / k1_kernel   the leaf-step row fetch: `iters` repeats of
//                          gathering `rows` random 512 B rows leaf[idx.flat[r]]
//                          into a (2048, 128) buffer; out = the buffer's first
//                          16 rows
//   K8 <- k2 / k2_kernel   the interior-step fetch: per step i and sub-row g,
//                          the 96-value column tab[:, (idx[g] + i) % Ip] of a
//                          (96, Ip) bf16 table; out = sum over g = 0..15, in
//                          that order, of row 0 of the last step's columns
//   K9 <- k2b / k2b_kernel the same fetch from the hc-ordered table, row
//                          h*96 + c = tab[c, 128h + l]
// The TPU built K8's and K9's columns as bf16 one-hot MXU products, which
// are exact, so each column is a plain gather here, bf16 widened to fp32
// exactly (bits << 16).
//
// What bounds them on the H100: K7 moves 512 B in and 512 B out per row and
// step. The 32 MB leaf table fits the 50 MB L2, so the rows come from L2
// (`ld.global.cg`, as the TPU's DMAs came from HBM each step, never from
// the SM's own L1). K8 and K9 fetch 2,048 columns of 96 bf16 values a step
// (393 KB) from a table of 96 x Ip x 2 B (860 KB at Ip 4480): the bound is
// the table read once, and what sets the time is where each fetch reads
// from. Reading it from L2 at every step (one thread a fetch, 96 scattered
// 2-byte loads in series, on 16 SMs) cost one L2 round trip per value.
//
// K8 / K9 design: the table is held on chip for the whole call, as the TPU
// held it in VMEM. At Ip 4480 it does not fit one CTA's 227 KB, so a
// thread-block cluster of 8 holds it, each CTA a slice of whole columns
// (one CTA holds a table that fits, as at Ip 512), staged once from global
// memory column-major: a column's 96 values are 192 contiguous bytes. After
// a cluster barrier every fetch reads its column from the owning CTA's
// shared memory through distributed shared memory (`mapa`,
// `ld.shared::cluster.v4`: twelve 16-byte pieces a column, each 8-lane
// phase from 32 distinct banks); a last cluster barrier keeps every slice
// alive until the other CTAs' reads are done. (A column stored row-major
// and read as 96 scattered 2-byte remote loads was far slower: the SM-to-SM
// network serves a remote request per lane.) The work spreads over the card: one CTA per lane (128
// CTAs), one half-warp per sub-row g (a warp serves two fetches), and each
// step reads that step's own column. Loads of STEP_BATCH steps go out before
// their sums; no load covers two steps' columns and no value is reused
// across steps. What bounds them now: the SM-to-SM network (7/8 of the
// reads are remote at Ip 4480), the staging, and clusters of 8 reaching
// only 120 of the 132 SMs, so that 8 SMs run two CTAs. The cluster size,
// the columns per CTA, the pitch and the shared bytes come from
// ops/wkernels.py's int_fetch_layout, where the CPU tests reach them.
//
// Design against the loop elision that invalidated the TPU numbers (the
// script's CAVEAT): every value fetched feeds a checksum that is written
// out; K7's loads and stores, and K8's and K9's shared-memory loads, are
// `asm volatile`, so no iteration can be hoisted or dropped; K8's and K9's
// columns move with the step i. The checksums are a side output:
// chip_smoke.py holds them to the plain versions' within a relative 1e-5
// (their sums run in another order), far below what a skipped row or step
// would move them. K7: one warp a row, one float4 a lane. K8 / K9: the 16
// sub-rows of a lane (the 16 half-warps of its CTA) add row 0 of their last
// columns in order g = 0..15 through shared memory, as the TPU kernel's
// `acc` does, so `out` is bit-exact.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int LANE = 128;
constexpr int SUB = 16;
constexpr int NCOL = 96;          // interior values per column (16 boxes x 6)
constexpr int K89_THREADS = SUB * 16;   // K8 / K9: a half-warp per sub-row
constexpr int STEP_BATCH = 8;     // K8 / K9 steps whose loads go out before their sums
constexpr int STAGE_BATCH = 8;    // K8 / K9 staging items whose loads go out before their stores

__device__ __forceinline__ float4 ld_cg(const float4* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_cg(float4* p, float4 v) {
  asm volatile("st.global.cg.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

// The shared::cluster address of `cta_addr` (a shared::cta address) in the
// shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t cta_addr, uint32_t rank) {
  uint32_t a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(cta_addr), "r"(rank));
  return a;
}

__device__ __forceinline__ uint4 ld_cluster_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

// K7: warp w of the grid owns row w (< rows); lane l moves float4 l of it.
__global__ void leaf_gather_kernel(const int* __restrict__ idx, const float* leaf,
                                   float* buf, float* __restrict__ out,
                                   float* __restrict__ checksum, int rows, int iters,
                                   int n_leaf) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int l = threadIdx.x & 31;
  if (row >= rows) return;
  int src = idx[row];
  src = src < 0 ? 0 : (src >= n_leaf ? n_leaf - 1 : src);
  const float4* from = reinterpret_cast<const float4*>(leaf + (size_t)src * LANE) + l;
  float4* to = reinterpret_cast<float4*>(buf + (size_t)row * LANE) + l;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  float s = 0.0f;
  for (int i = 0; i < iters; ++i) {
    v = ld_cg(from);
    st_cg(to, v);
    s += (v.x + v.y) + (v.z + v.w);
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (l == 0) checksum[row] = s;
  if (row < SUB) reinterpret_cast<float4*>(out + row * LANE)[l] = v;
}

template <bool HC>
__device__ __forceinline__ size_t col_offset(int c, int col, int Ip) {
  // (96, Ip): tab[c, col]; hc: row (col / 128) * 96 + c, lane col % 128
  return HC ? ((size_t)(col / LANE) * NCOL + c) * LANE + (col % LANE)
            : (size_t)c * Ip + col;
}

// Stage columns [rank * cols, rank * cols + cols) of the table (those below
// Ip) column-major: value c of local column j at tab_s[j * pitch + c]. A
// warp's 32 items are 16 row pairs (2p, 2p + 1) x 2 adjacent runs of 8
// columns: two 16-byte loads an item (a warp's load touches 16 rows, 32
// bytes each), eight 4-byte stores of a row pair's two values in one column
// each. The second half-warp stores its columns in the order 1, 2, .., 7, 0
// so that a store instruction's 32 words lie in 32 distinct banks (pitch
// 96: columns 8 apart share a bank; an odd step apart they do not).
// STAGE_BATCH items' loads go out before their stores. A table whose
// columns do not come in aligned runs of 8 (K8 with Ip not a multiple of
// 8) is staged one value at a time.
template <bool HC>
__device__ void stage_slice(const uint16_t* __restrict__ tab, uint16_t* tab_s, int rank,
                            int cols, int pitch, int Ip) {
  const int c0 = rank * cols;
  if (((Ip | cols | pitch) & 7) == 0 && ((uintptr_t)tab & 15) == 0) {
    constexpr int PAIR_BLOCKS = NCOL / 32;           // 3 blocks of 16 row pairs
    const int runs = cols / 8;
    const int n = 32 * PAIR_BLOCKS * ((runs + 1) / 2);
    const int wpc = pitch / 2;                       // 4-byte words a column
    const int half = (threadIdx.x >> 4) & 1;
    uint32_t* tab_w = reinterpret_cast<uint32_t*>(tab_s);
    for (int base = threadIdx.x; base < n; base += STAGE_BATCH * blockDim.x) {
      uint4 a[STAGE_BATCH], b[STAGE_BATCH];
#pragma unroll
      for (int u = 0; u < STAGE_BATCH; ++u) {
        const int t = base + u * blockDim.x, blk = t >> 5;
        const int p = 16 * (blk % PAIR_BLOCKS) + (t & 15);
        const int q = 2 * (blk / PAIR_BLOCKS) + half, col = c0 + 8 * q;
        if (t < n && q < runs && col < Ip) {
          a[u] = __ldg(reinterpret_cast<const uint4*>(tab + col_offset<HC>(2 * p, col, Ip)));
          b[u] = __ldg(reinterpret_cast<const uint4*>(tab + col_offset<HC>(2 * p + 1, col, Ip)));
        }
      }
#pragma unroll
      for (int u = 0; u < STAGE_BATCH; ++u) {
        const int t = base + u * blockDim.x, blk = t >> 5;
        const int p = 16 * (blk % PAIR_BLOCKS) + (t & 15);
        const int q = 2 * (blk / PAIR_BLOCKS) + half;
        if (t < n && q < runs && c0 + 8 * q < Ip) {
          // words[m]: rows (2p, 2p + 1) of column 8q + m
          const uint32_t wa[4] = {a[u].x, a[u].y, a[u].z, a[u].w};
          const uint32_t wb[4] = {b[u].x, b[u].y, b[u].z, b[u].w};
          uint32_t words[8];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            words[2 * k] = (wa[k] & 0xffffu) | (wb[k] << 16);
            words[2 * k + 1] = (wa[k] >> 16) | (wb[k] & 0xffff0000u);
          }
          uint32_t* dst = tab_w + (size_t)(8 * q) * wpc + p;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int m = (k + half) & 7;
            dst[m * wpc] = half ? words[(k + 1) & 7] : words[k];
          }
        }
      }
    }
  } else {
    for (int q = threadIdx.x; q < NCOL * cols; q += blockDim.x) {
      const int j = q / NCOL, c = q - j * NCOL;
      if (c0 + j < Ip) tab_s[j * pitch + c] = tab[col_offset<HC>(c, c0 + j, Ip)];
    }
  }
}

// The next step's column: col + 1 (mod Ip), owned by CTA owner at local j
// (selects, no branch: the two half-warps walk different columns).
__device__ __forceinline__ void next_col(int& col, int& owner, int& j, int cols, int Ip) {
  ++col;
  ++j;
  const bool next_slice = j == cols, wrap = col == Ip;
  owner = wrap ? 0 : owner + (int)next_slice;
  j = (wrap || next_slice) ? 0 : j;
  col = wrap ? 0 : col;
}

// The sum of the 8 bf16 values of a 16-byte piece, widened to fp32.
__device__ __forceinline__ float piece_sum(uint4 x) {
  const float s0 = __uint_as_float(x.x << 16) + __uint_as_float(x.x & 0xffff0000u);
  const float s1 = __uint_as_float(x.y << 16) + __uint_as_float(x.y & 0xffff0000u);
  const float s2 = __uint_as_float(x.z << 16) + __uint_as_float(x.z & 0xffff0000u);
  const float s3 = __uint_as_float(x.w << 16) + __uint_as_float(x.w & 0xffff0000u);
  return (s0 + s1) + (s2 + s3);
}

// K8 (HC = false) and K9 (HC = true): CTA = lane (grid 128), 8 warps, each
// half-warp one sub-row g (warp w: g = 2w, 2w + 1); a cluster of `cluster`
// CTAs (the launch attribute) holds the table, CTA rank r owning columns
// [r * cols, (r + 1) * cols). Lanes h < 12 of a half-warp read 16-byte piece
// h (values 8h .. 8h + 7) of each step's column: one
// `ld.shared::cluster.v4` instruction a warp a step serves two fetches.
template <bool HC>
__global__ void __launch_bounds__(K89_THREADS, 2)   // <= 128 registers: two CTAs an SM
int_fetch_kernel(const int* __restrict__ idx, const uint16_t* __restrict__ tab,
                 float* __restrict__ out, float* __restrict__ checksum, int iters, int Ip,
                 int cols, int pitch) {
  extern __shared__ __align__(16) uint16_t tab_s[];
  float* row0 = reinterpret_cast<float*>(tab_s + (size_t)cols * pitch);   // (16,) after
  const int lane = blockIdx.x, g = threadIdx.x >> 4, h = threadIdx.x & 15;
  const bool reader = h < NCOL / 8;
  int col = idx[g * LANE + lane] % Ip;           // issued before the staging's loads
  cg::cluster_group cluster = cg::this_cluster();
  stage_slice<HC>(tab, tab_s, (int)cluster.block_rank(), cols, pitch, Ip);
  col = col < 0 ? col + Ip : col;
  int owner = col / cols, j = col - owner * cols;
  const uint32_t piece = (uint32_t)__cvta_generic_to_shared(tab_s) + 16u * (uint32_t)h;
  const uint32_t col_bytes = 2u * (uint32_t)pitch;
  cluster.sync();                      // every slice staged before any remote read
  float s = 0.0f, v0 = 0.0f;
  int i = 0;
  for (; i + STEP_BATCH <= iters; i += STEP_BATCH) {
    uint4 x[STEP_BATCH];
#pragma unroll
    for (int u = 0; u < STEP_BATCH; ++u) {
      if (reader) x[u] = ld_cluster_v4(cluster_addr(piece + (uint32_t)j * col_bytes, owner));
      next_col(col, owner, j, cols, Ip);
    }
    if (reader) {
#pragma unroll
      for (int u = 0; u < STEP_BATCH; ++u) s += piece_sum(x[u]);
      v0 = __uint_as_float(x[STEP_BATCH - 1].x << 16);
    }
  }
  for (; i < iters; ++i) {
    if (reader) {
      const uint4 x = ld_cluster_v4(cluster_addr(piece + (uint32_t)j * col_bytes, owner));
      s += piece_sum(x);
      v0 = __uint_as_float(x.x << 16);
    }
    next_col(col, owner, j, cols, Ip);
  }
  for (int off = 8; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (h == 0) {                        // lane h = 0 read values 0..7: row c = 0 is its first
    checksum[g * LANE + lane] = s;
    row0[g] = v0;
  }
  cluster.sync();                      // the others' reads of this slice are done
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int q = 0; q < SUB; ++q) acc = acc + row0[q];
    out[lane] = acc;
  }
}

// K8's / K9's launch configuration: grid 128, 8 warps, `cluster` CTAs a
// cluster, `smem` dynamic shared bytes (the limit raised on first use).
template <bool HC>
cudaError_t int_fetch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int cluster,
                             int smem, cudaStream_t stream) {
  static int smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        int_fetch_kernel<HC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(LANE);
  cfg.blockDim = dim3(K89_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <bool HC>
cudaError_t int_fetch_max_clusters(int* n, int cluster, int smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = int_fetch_config<HC>(cfg, attr, cluster, smem, 0);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(n, (const void*)int_fetch_kernel<HC>, &cfg);
}

template <bool HC>
int launch_int_fetch(const void* idx, const void* tab, void* out, void* checksum, int iters,
                     int Ip, int cluster, int cols, int pitch, int smem, cudaStream_t stream) {
  static int placed_cluster = 0, placed_smem = 0;   // the last layout found placeable
  if (cluster != placed_cluster || smem != placed_smem) {
    int n = 0;
    const cudaError_t e = int_fetch_max_clusters<HC>(&n, cluster, smem);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;   // no SM group can hold a cluster
    placed_cluster = cluster;
    placed_smem = smem;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = int_fetch_config<HC>(cfg, attr, cluster, smem, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, int_fetch_kernel<HC>, (const int*)idx, (const uint16_t*)tab,
                         (float*)out, (float*)checksum, iters, Ip, cols, pitch);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// idx (16, 128) i32, leaf (n_leaf, 128) f32, buf (2048, 128) f32 scratch,
// out (16, 128) f32, checksum (rows,) f32
int hr_wk_leaf_gather(const void* idx, const void* leaf, void* buf, void* out, void* checksum,
                      int rows, int iters, int n_leaf, void* stream) {
  const int threads = 256;                       // 8 rows a CTA
  const int blocks = (rows * 32 + threads - 1) / threads;
  leaf_gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)leaf, (float*)buf, (float*)out, (float*)checksum, rows,
      iters, n_leaf);
  return (int)cudaGetLastError();
}

// idx (16, 128) i32, tab (96, Ip) bf16 (K8) or (Ip / 128 * 96, 128) bf16
// (K9, hc-ordered), out (128,) f32, checksum (16, 128) f32; cluster, cols,
// pitch and smem from ops/wkernels.py's int_fetch_layout(Ip, hc)
int hr_wk_int_fetch(const void* idx, const void* tab, void* out, void* checksum, int iters,
                    int Ip, int hc, int cluster, int cols, int pitch, int smem, void* stream) {
  return hc ? launch_int_fetch<true>(idx, tab, out, checksum, iters, Ip, cluster, cols, pitch,
                                     smem, (cudaStream_t)stream)
            : launch_int_fetch<false>(idx, tab, out, checksum, iters, Ip, cluster, cols, pitch,
                                      smem, (cudaStream_t)stream);
}

// How many clusters of K8's (hc = 0) or K9's (hc = 1) kernel with that
// layout the card can hold at once, into *n (cudaOccupancyMaxActiveClusters)
int hr_wk_int_fetch_max_clusters(int hc, int cluster, int smem, void* n) {
  return (int)(hc ? int_fetch_max_clusters<true>((int*)n, cluster, smem)
                  : int_fetch_max_clusters<false>((int*)n, cluster, smem));
}

}  // extern "C"
