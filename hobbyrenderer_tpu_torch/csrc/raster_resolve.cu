// Tile raster with fused attribute resolve (kernel K1 of the port) and the
// depth / visibility-only tile raster (kernel K5), which share loop 1.
//
// K1 replaces: hobbyrenderer_tpu/ops/raster_pallas.py::_raster_resolve_kernel /
// raster_resolve_tiles (the Pallas TPU kernel). Same inputs and outputs:
//   records    (S*32, 128) f32  per 32-triangle chunk row: lanes 0:9 the
//                               l1/l2/depth planes, 16:64 the 16 attribute
//                               planes [16 x | 16 y | 16 c]
//   tile_start (T+1,) i32       left searchsorted of the tile-sorted worklist
//   work_slot  (Wcap,) i32      chunk slot of each worklist item
//   depth (T,1024) f32, visid (T,1024) i32 (= chunk_slot*32 + row),
//   attrs (T,16,1024) f32.
//
// K5 replaces: hobbyrenderer_tpu/ops/raster_pallas.py::_raster_kernel /
// raster_tiles: loop 1 alone, over records of any row width ``lanes`` >= 9
// (the port's depth records are 16 lanes wide: the TPU padded them to 128
// only for its DMA alignment). It writes depth and, unless depth_only, the
// winner id; with depth_only every visid is -1, as on the TPU.
//
// What bounds them on the H100: per (tile, chunk) item the block reads 32x9
// plane floats (1152 B) and evaluates 32 triangles x 1024 pixels (~20 flops
// each). The first Raster call of the 1080p stress frame has 8391 items over
// 2040 tiles: ~5.5 GFLOP, ~10 MB of plane reads in loop 1 and ~240 MB of
// winner-row gathers in loop 2 (192 B per drawn pixel), so neither FLOPs
// nor bandwidth bind; the serial walk of each tile's items (a barrier per
// item) and the uneven item count per tile do. The shadow atlas (K5) has
// 4096 tiles, most of them empty or with few items: its time is the same
// serial walk over the few busy tiles.
//
// Design: one block per 32x32 tile, one thread per pixel. The block walks
// its tile's worklist span in order, staging each chunk's raster planes in
// shared memory; each thread keeps the max reversed-Z depth and the winner
// id with the TPU kernel's tie rules (lowest row among equal maxima inside a
// chunk; strict > across items, so the earlier item wins). K1's loop 2 does
// not re-stream the span: each pixel reads its winner row's 48
// attribute-plane lanes (192 B) by id and evaluates the 16
// perspective-correct planes. The TPU re-streamed records to avoid
// per-pixel gathers; on Hopper the gather is cheap. Planes are evaluated
// with __fmul_rn/__fadd_rn in _plane_eval's order (re-centred on the tile
// origin) so nvcc cannot contract them into FMAs: the plain PyTorch
// versions round every step the same way.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int PIX = TILE * TILE;
constexpr int ROWS = 32;        // triangles per chunk record
constexpr int LANES = 128;      // floats per triangle row of K1's records
constexpr int ATTR_ROWS = 16;

__device__ __forceinline__ float plane_eval(const float* A, float oxf, float oyf,
                                            float xl, float yl) {
  // c = A0*ox + A1*oy + A2 ; v = A0*xl + A1*yl + c   (rounded per step)
  const float c = __fadd_rn(__fadd_rn(__fmul_rn(A[0], oxf), __fmul_rn(A[1], oyf)), A[2]);
  return __fadd_rn(__fadd_rn(__fmul_rn(A[0], xl), __fmul_rn(A[1], yl)), c);
}

// Loop 1 over the tile's worklist span [s0, s1): max reversed-Z depth and,
// when kIds, the winner id. Every thread of the block must call it.
template <bool kIds>
__device__ __forceinline__ void raster_span(const float* __restrict__ records, int lanes,
                                            const int* __restrict__ work_slot,
                                            int s0, int s1, float oxf, float oyf,
                                            float xl, float yl, float* planes,
                                            float& z_out, int& id_out) {
  const int p = threadIdx.x;
  float z_acc = 0.0f;
  int id_acc = -1;
  for (int j = s0; j < s1; ++j) {
    const int slot = work_slot[j];
    __syncthreads();                       // previous item's planes consumed
    if (p < ROWS * 9) {
      const int r = p / 9, k = p % 9;
      planes[p] = records[((size_t)slot * ROWS + r) * lanes + k];
    }
    __syncthreads();
    float best = -1.0f;
    int brow = 0;
    for (int r = 0; r < ROWS; ++r) {
      const float* A = planes + r * 9;
      const float l1 = plane_eval(A + 0, oxf, oyf, xl, yl);
      const float l2 = plane_eval(A + 3, oxf, oyf, xl, yl);
      const float z = plane_eval(A + 6, oxf, oyf, xl, yl);
      const bool inside = (l1 >= 0.0f) && (l2 >= 0.0f) && (__fadd_rn(l1, l2) <= 1.0f);
      const float zm = inside ? z : -1.0f;
      if (zm > best) { best = zm; brow = r; }   // first (lowest) row keeps ties
    }
    if (best > z_acc) {                         // earlier item keeps ties
      z_acc = best;
      if (kIds && best > 0.0f) id_acc = slot * ROWS + brow;
    }
  }
  z_out = z_acc;
  id_out = (z_acc > 0.0f) ? id_acc : -1;
}

__global__ void __launch_bounds__(PIX)
raster_resolve_kernel(const float* __restrict__ records,
                      const int* __restrict__ tile_start,
                      const int* __restrict__ work_slot,
                      float* __restrict__ depth, int* __restrict__ visid,
                      float* __restrict__ attrs, int tx) {
  __shared__ float planes[ROWS * 9];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float oxf = (float)((t % tx) * TILE) + 0.5f;
  const float oyf = (float)((t / tx) * TILE) + 0.5f;
  const float xl = (float)(p % TILE);
  const float yl = (float)(p / TILE);

  // ---- loop 1: max reversed-Z depth + winner id ----
  float z_acc;
  int idf;
  raster_span<true>(records, LANES, work_slot, tile_start[t], tile_start[t + 1],
                    oxf, oyf, xl, yl, planes, z_acc, idf);
  const size_t o = (size_t)t * PIX + p;
  depth[o] = fmaxf(z_acc, 0.0f);
  visid[o] = idf;

  // ---- loop 2: perspective-correct attributes of the winner ----
  float* out = attrs + (size_t)t * ATTR_ROWS * PIX + p;
  if (idf < 0) {
    for (int k = 0; k < ATTR_ROWS; ++k) out[k * PIX] = 0.0f;
    return;
  }
  const float* rec = records + (size_t)idf * LANES;
  const float pxg = __fadd_rn(xl, oxf);
  const float pyg = __fadd_rn(yl, oyf);
  float vals[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    vals[k] = __fadd_rn(__fadd_rn(__fmul_rn(rec[16 + k], pxg),
                                  __fmul_rn(rec[32 + k], pyg)), rec[48 + k]);
  }
  const float inv_w = 1.0f / fmaxf(vals[11], 1e-12f);
#pragma unroll
  for (int k = 0; k < 11; ++k) out[k * PIX] = __fmul_rn(vals[k], inv_w);
#pragma unroll
  for (int k = 12; k < 16; ++k) out[(k - 1) * PIX] = vals[k];
  out[15 * PIX] = 0.0f;
}

template <bool kIds>
__global__ void __launch_bounds__(PIX)
raster_tiles_kernel(const float* __restrict__ records, int lanes,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ work_slot,
                    float* __restrict__ depth, int* __restrict__ visid, int tx) {
  __shared__ float planes[ROWS * 9];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float oxf = (float)((t % tx) * TILE) + 0.5f;
  const float oyf = (float)((t / tx) * TILE) + 0.5f;
  float z_acc;
  int idf;
  raster_span<kIds>(records, lanes, work_slot, tile_start[t], tile_start[t + 1],
                    oxf, oyf, (float)(p % TILE), (float)(p / TILE), planes, z_acc, idf);
  const size_t o = (size_t)t * PIX + p;
  depth[o] = fmaxf(z_acc, 0.0f);
  visid[o] = idf;
}

}  // namespace

extern "C" int hr_raster_resolve_tiles(const void* records, const void* tile_start,
                                       const void* work_slot, void* depth,
                                       void* visid, void* attrs, int T, int tx,
                                       void* stream) {
  if (T > 0) {
    raster_resolve_kernel<<<T, PIX, 0, (cudaStream_t)stream>>>(
        (const float*)records, (const int*)tile_start, (const int*)work_slot,
        (float*)depth, (int*)visid, (float*)attrs, tx);
  }
  return (int)cudaGetLastError();
}

extern "C" int hr_raster_tiles(const void* records, const void* tile_start,
                               const void* work_slot, void* depth, void* visid,
                               int T, int tx, int lanes, int depth_only, void* stream) {
  if (T > 0) {
    if (depth_only) {
      raster_tiles_kernel<false><<<T, PIX, 0, (cudaStream_t)stream>>>(
          (const float*)records, lanes, (const int*)tile_start, (const int*)work_slot,
          (float*)depth, (int*)visid, tx);
    } else {
      raster_tiles_kernel<true><<<T, PIX, 0, (cudaStream_t)stream>>>(
          (const float*)records, lanes, (const int*)tile_start, (const int*)work_slot,
          (float*)depth, (int*)visid, tx);
    }
  }
  return (int)cudaGetLastError();
}
