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
// the SM's own L1). K8 and K9 move 96 x 2 B per fetch, 2,048 fetches a
// step, strided by Ip (K8) or by 128 (K9) elements: L2 latency bound.
//
// Design against the loop elision that invalidated the TPU numbers (the
// script's CAVEAT): every value fetched feeds a per-thread checksum that is
// written out; K7's loads and stores are `asm volatile`, so no iteration can
// be hoisted or dropped; K8's and K9's columns move with the step i. The
// checksums are a side output: chip_smoke.py holds them to the plain
// versions' within a relative 1e-5 (their sums run in another order), far
// below what a skipped row or step would move them. Rows spread over the
// CTAs (K7: one warp a row, one float4 a lane); K8 and K9 run one thread per
// (sub-row g, lane), and the 16 sub-rows of a lane add in order g = 0..15
// through shared memory, as the TPU kernel's `acc` does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE = 128;
constexpr int SUB = 16;
constexpr int NCOL = 96;          // interior values per column (16 boxes x 6)
constexpr int K8_LANES = 8;       // lanes per CTA of K8 / K9 (x 16 sub-rows)

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

// K8 (HC = false) and K9 (HC = true): block = 8 lanes x 16 sub-rows.
template <bool HC>
__global__ void int_fetch_kernel(const int* __restrict__ idx,
                                 const uint16_t* __restrict__ tab, float* __restrict__ out,
                                 float* __restrict__ checksum, int iters, int Ip) {
  __shared__ float row0[SUB][K8_LANES];
  const int ll = threadIdx.x % K8_LANES;
  const int g = threadIdx.x / K8_LANES;
  const int lane = blockIdx.x * K8_LANES + ll;
  const int base = idx[g * LANE + lane];
  float s = 0.0f;
  float v0 = 0.0f;
  for (int i = 0; i < iters; ++i) {
    int col = (base + i) % Ip;
    col = col < 0 ? col + Ip : col;
    float part = 0.0f;
#pragma unroll 16
    for (int c = 0; c < NCOL; ++c) {
      const float x = __uint_as_float((unsigned)tab[col_offset<HC>(c, col, Ip)] << 16);
      if (c == 0) v0 = x;
      part += x;
    }
    s += part;
  }
  row0[g][ll] = v0;
  checksum[g * LANE + lane] = s;
  __syncthreads();
  if (g == 0) {
    float acc = 0.0f;
    for (int k = 0; k < SUB; ++k) acc = acc + row0[k][ll];
    out[lane] = acc;
  }
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
// (K9, hc-ordered), out (128,) f32, checksum (16, 128) f32
int hr_wk_int_fetch(const void* idx, const void* tab, void* out, void* checksum, int iters,
                    int Ip, int hc, void* stream) {
  const dim3 grid(LANE / K8_LANES), block(K8_LANES * SUB);
  if (hc)
    int_fetch_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int*)idx, (const uint16_t*)tab, (float*)out, (float*)checksum, iters, Ip);
  else
    int_fetch_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int*)idx, (const uint16_t*)tab, (float*)out, (float*)checksum, iters, Ip);
  return (int)cudaGetLastError();
}

}  // extern "C"
