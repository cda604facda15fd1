// Tile raster with fused attribute resolve (kernel K1 of the port) and the
// depth / visibility-only tile raster (kernel K5), one kernel template.
//
// K1 replaces: hobbyrenderer_tpu/ops/raster_pallas.py::_raster_resolve_kernel /
// raster_resolve_tiles (the Pallas TPU kernel). Same inputs and outputs:
//   records    (S*32, 128) f32  per 32-triangle chunk row: lanes 0:9 the
//                               l1/l2/depth planes, 16:64 the 16 attribute
//                               planes [16 x | 16 y | 16 c]
//   work_tile  (Wcap,) i32      tile of each worklist item, sorted (padding: T)
//   work_slot  (Wcap,) i32      chunk slot of each worklist item
//   depth (T,1024) f32, visid (T,1024) i32 (= chunk_slot*32 + row),
//   attrs (T,16,1024) f32.
//
// K5 replaces: hobbyrenderer_tpu/ops/raster_pallas.py::_raster_kernel /
// raster_tiles: the same raster without attributes, over records of any row
// width ``lanes`` >= 12 that is a multiple of 4 (the port's depth records
// are 16 lanes wide: the TPU padded them to 128 only for its DMA
// alignment). It writes depth and, unless depth_only, the winner id; with
// depth_only every visid is -1, as on the TPU.
//
// What bounds them on the H100. Per (tile, chunk) item, evaluating all 32
// triangles at all 1024 pixels is ~13 fp32 operations a (row, pixel): the
// first Raster call of the 1080p stress frame has 8,391 items over 2,040
// tiles, the shadow atlas 16,706 over 4,096, many of them in a few busy
// tiles. A 32-triangle meshlet chunk covers a small part of a 32x32 tile,
// so most of those evaluations are of rows no pixel is inside (the strip
// test below keeps 3% of them in the Raster call, 11% in the atlas); and a
// busy tile walked by one block in order sets the whole call's time.
//
// Design.
// - Work units. A first small kernel (one CTA) plans the call: each tile's
//   start in the sorted worklist, and each non-empty tile's span cut into
//   units of at most UNIT items, written as (tile, first item,
//   items, units of the tile). Persistent CTAs of 8 warps first clear the
//   empty tiles (which have no unit), then take units from an atomic queue
//   (the last CTA out resets it), so a busy tile's units run on many SMs
//   at once.
// - Per warp row culling. Warp w owns pixel rows w, w+8, w+16, w+24 (one
//   lane a pixel). For each item, lane r tests triangle row r against each
//   of the warp's four 32x1 pixel rows (float64 at the row's ends with a
//   1e-5 relative margin, the rule of
//   ops/raster_kernel.py::_rows_outside_strips; the parts that do not
//   depend on the pixel row are computed once); each ballot is a pixel
//   row's mask of triangle rows, and the warp evaluates only its set bits.
// - Staging. A unit's rows (lanes 0:12 of each, 48 B) are loaded into
//   shared memory, and each row's three plane constants re-centred on the
//   tile origin once.
// - An order-free merge. Each pixel's running best over its unit is the
//   depth and the item-row index j*32+r, taken where strictly deeper (so
//   the earliest item, then the lowest row, keeps ties: the serial walk's
//   rule). A tile of one unit writes its result directly. The units of a
//   split tile merge the 64-bit key (depth bits << 32 | ~(j*32+r)) with
//   atomicMax in a scratch the kernel leaves at zero: z > 0, so its bits
//   order as integers, and the largest key is the serial winner whatever
//   order the units ran in. The last unit of a tile to finish (a counter
//   after __threadfence) reads the keys back and writes the outputs; for
//   K1 it then resolves the attributes, as a tile of one unit does: each
//   pixel reads its winner row's 48 attribute-plane lanes (192 B) and
//   evaluates the 16 perspective-correct planes.
// Planes are evaluated with __fmul_rn/__fadd_rn in _plane_eval's order
// (re-centred on the tile origin) so nvcc cannot contract them into FMAs:
// the plain PyTorch versions round every step the same way.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int PIX = TILE * TILE;
constexpr int ROWS = 32;          // triangles per chunk record
constexpr int LANES = 128;        // floats per triangle row of K1's records
constexpr int ATTR_ROWS = 16;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PER_WARP = TILE / WARPS;    // pixel rows a warp owns
constexpr int SROW = 12;          // floats of a staged row
constexpr int UNIT = 4;           // most items a unit (ops/raster_kernel.py UNIT_ITEMS)
constexpr int PLAN_THREADS = 1024;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned NONE = 0xFFFFFFFFu;

struct Args {
  const float* records;
  int lanes;
  const int* tile_start;      // (T+1,) the plan's tile starts
  const int* work_slot;
  const int4* units;          // the plan's units: (tile, first item, items, tile's units)
  const int* n_units;         // the plan's unit count
  int T, tx;
  float* depth;
  int* visid;
  float* attrs;
  unsigned long long* keys;   // (T, PIX) split tiles' merge, left at zero
  int* done;                  // (T,) units finished, left at zero
  int* queue;                 // head, CTAs done; left at zero
};

// The call's plan, by one CTA: tile_start[t] = the first item with
// work_tile >= t (a boundary of the sorted work_tile sets the starts of the
// tiles it crosses; the starts are kept in shared memory), and each
// non-empty tile's units, the units of split tiles first (they are the
// longest), each group in tile order; counted in *n_units.
__global__ void __launch_bounds__(PLAN_THREADS)
plan_kernel(const int* __restrict__ work_tile, int wcap, int T,
            int* __restrict__ tile_start, int4* __restrict__ units, int* __restrict__ n_units) {
  extern __shared__ int ts[];                   // T + 1 tile starts
  __shared__ int warp_tot[2][PLAN_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int base = tid; base <= wcap; base += 4 * PLAN_THREADS) {
    int prev[4], cur[4];                        // four loads in flight a thread
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = base + k * PLAN_THREADS;
      prev[k] = j > 0 && j <= wcap ? __ldg(work_tile + j - 1) : -1;
      cur[k] = j < wcap ? min(__ldg(work_tile + j), T) : T;
    }
    bool past = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (base + k * PLAN_THREADS > wcap || prev[k] >= T) {   // padding from here on
        past = true;
        continue;
      }
      for (int t = prev[k] + 1; t <= cur[k]; ++t) ts[t] = base + k * PLAN_THREADS;
    }
    if (past) break;
  }
  __syncthreads();
  // this thread's tiles [t0, t1): units of split tiles, and single units
  const int per = (T + PLAN_THREADS - 1) / PLAN_THREADS;
  const int t0 = min(T, tid * per), t1 = min(T, t0 + per);
  int c[2] = {0, 0};
  for (int t = t0; t < t1; ++t) {
    const int u = (ts[t + 1] - ts[t] + UNIT - 1) / UNIT;
    c[0] += u > 1 ? u : 0;
    c[1] += u == 1;
  }
  int incl[2] = {c[0], c[1]};                   // block-wide inclusive scans
#pragma unroll
  for (int g = 0; g < 2; ++g) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, incl[g], off);
      if (lane >= off) incl[g] += v;
    }
    if (lane == 31) warp_tot[g][warp] = incl[g];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      int v = warp_tot[g][lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int w = __shfl_up_sync(FULL, v, off);
        if (lane >= off) v += w;
      }
      warp_tot[g][lane] = v;
    }
  }
  __syncthreads();
  const int split_total = warp_tot[0][PLAN_THREADS / 32 - 1];
  int q[2];
#pragma unroll
  for (int g = 0; g < 2; ++g)
    q[g] = incl[g] - c[g] + (warp > 0 ? warp_tot[g][warp - 1] : 0) + (g ? split_total : 0);
  for (int t = t0; t < t1; ++t) {
    const int s0 = ts[t], n = ts[t + 1] - s0;
    const int u = (n + UNIT - 1) / UNIT;
    int& dst = q[u > 1 ? 0 : 1];
    for (int k = 0; k < u; ++k)
      units[dst++] = make_int4(t, s0 + k * UNIT, min(UNIT, n - k * UNIT), u);
  }
  for (int t = tid; t <= T; t += PLAN_THREADS) tile_start[t] = ts[t];
  if (tid == 0) *n_units = split_total + warp_tot[1][PLAN_THREADS / 32 - 1];
}

// A triangle row's strip test, the parts that do not depend on the pixel
// row y: float64, as ops/raster_kernel.py::_rows_outside_strips computes
// them, step for step (tile coordinates are positive, so x1 is the
// largest |x| of the row).
struct RowTest {
  double hx1, mx1, a1, hx2, mx2, b1, lxs, s1;
};

__device__ __forceinline__ RowTest row_test(float l1x, float l1y, float l1c, float l2x,
                                            float l2y, float l2c, double x0) {
  const double x1 = x0 + (double)(TILE - 1);
  const double a0 = l1x, a1 = l1y, a2 = l1c, b0 = l2x, b1 = l2y, b2 = l2c;
  const double s0 = a0 + b0, s1 = a1 + b1, s2 = a2 + b2;
  return RowTest{a2 + fmax(a0 * x0, a0 * x1), fabs(a0) * x1 + fabs(a2), a1,
                 b2 + fmax(b0 * x0, b0 * x1), fabs(b0) * x1 + fabs(b2), b1,
                 s2 + fmin(s0 * x0, s0 * x1), s1};
}

// True when no pixel of the row's strip at y can pass l1 >= 0, l2 >= 0,
// l1 + l2 <= 1: the 1e-5 relative margin is far beyond the rounding of
// the f32 evaluation.
__device__ __forceinline__ bool strip_outside(const RowTest& q, double y) {
  const double m1 = q.mx1 + fabs(q.a1) * y, m2 = q.mx2 + fabs(q.b1) * y;
  return (q.hx1 + q.a1 * y < -1e-5 * m1) || (q.hx2 + q.b1 * y < -1e-5 * m2) ||
         (q.lxs + q.s1 * y > (1.0 + 1e-5 * (m1 + m2)) + 1e-6);
}

template <bool kK1, bool kIds>
__device__ __forceinline__ void write_pixel(const Args& a, int t, int p, float xl, float yl,
                                            float oxf, float oyf, float z, unsigned item_row) {
  int vid = -1;
  if (item_row != NONE)
    vid = __ldg(a.work_slot + item_row / ROWS) * ROWS + (int)(item_row % ROWS);
  a.depth[(size_t)t * PIX + p] = z;
  a.visid[(size_t)t * PIX + p] = kIds ? vid : -1;
  if (!kK1) return;
  float* out = a.attrs + (size_t)t * ATTR_ROWS * PIX + p;
  if (vid < 0) {
#pragma unroll
    for (int k = 0; k < ATTR_ROWS; ++k) out[k * PIX] = 0.0f;
    return;
  }
  const float4* rec = reinterpret_cast<const float4*>(a.records + (size_t)vid * LANES + 16);
  const float pxg = __fadd_rn(xl, oxf);
  const float pyg = __fadd_rn(yl, oyf);
  float vals[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 X = __ldg(rec + q), Y = __ldg(rec + 4 + q), C = __ldg(rec + 8 + q);
    const float xs[4] = {X.x, X.y, X.z, X.w}, ys[4] = {Y.x, Y.y, Y.z, Y.w},
                cs[4] = {C.x, C.y, C.z, C.w};
#pragma unroll
    for (int m = 0; m < 4; ++m)
      vals[4 * q + m] = __fadd_rn(__fadd_rn(__fmul_rn(xs[m], pxg), __fmul_rn(ys[m], pyg)), cs[m]);
  }
  const float inv_w = 1.0f / fmaxf(vals[11], 1e-12f);
#pragma unroll
  for (int k = 0; k < 11; ++k) out[k * PIX] = __fmul_rn(vals[k], inv_w);
#pragma unroll
  for (int k = 12; k < 16; ++k) out[(k - 1) * PIX] = vals[k];
  out[15 * PIX] = 0.0f;
}

template <bool kK1, bool kIds>
__global__ void __launch_bounds__(THREADS, 4) raster_units_kernel(Args a) {
  __shared__ float4 stage4[UNIT * ROWS * (SROW / 4)];   // a unit's staged rows
  float* stage = reinterpret_cast<float*>(stage4);
  __shared__ int s_unit, s_last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float xl = (float)lane;

  // ---- the empty tiles (no unit): cleared outputs -------------------------
  for (int t = blockIdx.x; t < a.T; t += gridDim.x) {
    if (a.tile_start[t + 1] != a.tile_start[t]) continue;
    for (int p = threadIdx.x; p < PIX; p += THREADS) {
      a.depth[(size_t)t * PIX + p] = 0.0f;
      a.visid[(size_t)t * PIX + p] = -1;
      if (kK1) {
#pragma unroll
        for (int k = 0; k < ATTR_ROWS; ++k) a.attrs[((size_t)t * ATTR_ROWS + k) * PIX + p] = 0.0f;
      }
    }
  }

  // ---- units from the queue ----------------------------------------------
  const int n_units = __ldg(a.n_units);
  if (threadIdx.x == 0) s_unit = atomicAdd(a.queue, 1);
  __syncthreads();
  for (int e = s_unit; e < n_units;) {
    const int4 u = __ldg(a.units + e);          // tile, first item, items, tile's units
    const int t = u.x, j0 = u.y, n = u.z;
    for (int idx = threadIdx.x; idx < n * ROWS * 3; idx += THREADS) {
      const int i = idx / (ROWS * 3), rem = idx % (ROWS * 3);
      const float4* src = reinterpret_cast<const float4*>(
          a.records + ((size_t)__ldg(a.work_slot + j0 + i) * ROWS + rem / 3) * a.lanes) + rem % 3;
      stage4[(i * ROWS + rem / 3) * (SROW / 4) + rem % 3] = __ldg(src);
    }
    __syncthreads();
    // each staged row [l1x l1y l1c l2x | l2y l2c zx zy | zc . . .]: lanes
    // 9..11 (padding in the records) take the planes' constants re-centred
    // on the tile origin, c = A0*ox + A1*oy + A2 rounded per step
    const float oxf = (float)((t % a.tx) * TILE) + 0.5f;
    const float oyf = (float)((t / a.tx) * TILE) + 0.5f;
    for (int idx = threadIdx.x; idx < n * ROWS; idx += THREADS) {
      float* R = stage + idx * SROW;
      R[9] = __fadd_rn(__fadd_rn(__fmul_rn(R[0], oxf), __fmul_rn(R[1], oyf)), R[2]);
      R[10] = __fadd_rn(__fadd_rn(__fmul_rn(R[3], oxf), __fmul_rn(R[4], oyf)), R[5]);
      R[11] = __fadd_rn(__fadd_rn(__fmul_rn(R[6], oxf), __fmul_rn(R[7], oyf)), R[8]);
    }
    __syncthreads();
    int ahead = 0;
    if (threadIdx.x == 0) ahead = atomicAdd(a.queue, 1);    // the next unit, stored below

    // ---- the unit's items over the warp's pixel rows: max depth, item-row --
    float best_z[PER_WARP];
    unsigned best_i[PER_WARP];
#pragma unroll
    for (int s = 0; s < PER_WARP; ++s) {
      best_z[s] = 0.0f;
      best_i[s] = NONE;
    }
    for (int i = 0; i < n; ++i) {
      const float4* P = stage4 + i * ROWS * (SROW / 4);
      unsigned mask[PER_WARP];
      const float4 own0 = P[lane * 3], own1 = P[lane * 3 + 1];    // row `lane`
      const RowTest q = row_test(own0.x, own0.y, own0.z, own0.w, own1.x, own1.y, (double)oxf);
#pragma unroll
      for (int s = 0; s < PER_WARP; ++s)
        mask[s] = __ballot_sync(FULL, !strip_outside(
                                          q, (double)__fadd_rn(oyf, (float)(warp + WARPS * s))));
      const unsigned base = (unsigned)(j0 + i) * ROWS;
#pragma unroll
      for (int s = 0; s < PER_WARP; ++s) {
        const float yl = (float)(warp + WARPS * s);
        unsigned m = mask[s];
        while (m) {
          const int r = __ffs(m) - 1;
          m &= m - 1;
          const float4 A = P[r * 3], B = P[r * 3 + 1], C = P[r * 3 + 2];
          const float l1 = __fadd_rn(__fadd_rn(__fmul_rn(A.x, xl), __fmul_rn(A.y, yl)), C.y);
          const float l2 = __fadd_rn(__fadd_rn(__fmul_rn(A.w, xl), __fmul_rn(B.x, yl)), C.z);
          const float z = __fadd_rn(__fadd_rn(__fmul_rn(B.z, xl), __fmul_rn(B.w, yl)), C.w);
          const bool inside = (l1 >= 0.0f) && (l2 >= 0.0f) && (__fadd_rn(l1, l2) <= 1.0f);
          if (inside && z > best_z[s]) {   // strict: earlier items, lower rows keep ties
            best_z[s] = z;
            best_i[s] = base + r;
          }
        }
      }
    }

    // ---- merge: a tile of one unit writes; a split tile's last unit does --
    bool write = true;
    if (u.w > 1) {
#pragma unroll
      for (int s = 0; s < PER_WARP; ++s)
        if (best_i[s] != NONE)
          atomicMax(a.keys + (size_t)t * PIX + (warp + WARPS * s) * TILE + lane,
                    ((unsigned long long)__float_as_uint(best_z[s]) << 32) |
                        (unsigned long long)(NONE - best_i[s]));
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) {
        s_last = atomicAdd(a.done + t, 1) == u.w - 1;
        if (s_last) atomicExch(a.done + t, 0);
      }
      __syncthreads();
      write = s_last;
      if (write) {
        __threadfence();
#pragma unroll
        for (int s = 0; s < PER_WARP; ++s) {
          const unsigned long long key =
              atomicExch(a.keys + (size_t)t * PIX + (warp + WARPS * s) * TILE + lane, 0ull);
          best_z[s] = key ? __uint_as_float((unsigned)(key >> 32)) : 0.0f;
          best_i[s] = key ? NONE - (unsigned)key : NONE;
        }
      }
    }
    if (write) {
#pragma unroll
      for (int s = 0; s < PER_WARP; ++s) {
        const int y = warp + WARPS * s;
        write_pixel<kK1, kIds>(a, t, y * TILE + lane, xl, (float)y, oxf, oyf, best_z[s],
                               best_i[s]);
      }
    }
    if (threadIdx.x == 0) s_unit = ahead;
    __syncthreads();                            // the stage consumed; the next unit known
    e = s_unit;
  }
  // every fetch of this CTA has returned; the last CTA out resets the queue
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(a.queue + 1, 1) == (int)gridDim.x - 1) {
      atomicExch(a.queue, 0);
      atomicExch(a.queue + 1, 0);
    }
  }
}

template <bool kK1, bool kIds>
cudaError_t launch(const Args& a, int grid, cudaStream_t s) {
  raster_units_kernel<kK1, kIds><<<grid, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

template <bool kK1, bool kIds>
int resident() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, raster_units_kernel<kK1, kIds>, THREADS,
                                                    0) != cudaSuccess)
    return -1;
  return n;
}

Args make_args(const void* records, int lanes, const void* work_slot, const void* tile_start,
               const void* units, const void* n_units, int T, int tx, void* depth, void* visid,
               void* attrs, void* keys, void* done, void* queue) {
  Args a;
  a.records = (const float*)records;
  a.lanes = lanes;
  a.tile_start = (const int*)tile_start;
  a.work_slot = (const int*)work_slot;
  a.units = (const int4*)units;
  a.n_units = (const int*)n_units;
  a.T = T;
  a.tx = tx;
  a.depth = (float*)depth;
  a.visid = (int*)visid;
  a.attrs = (float*)attrs;
  a.keys = (unsigned long long*)keys;
  a.done = (int*)done;
  a.queue = (int*)queue;
  return a;
}

cudaError_t plan(const void* work_tile, int wcap, int T, void* tile_start, void* units,
                 void* n_units, cudaStream_t s) {
  const size_t smem = (size_t)(T + 1) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  plan_kernel<<<1, PLAN_THREADS, smem, s>>>((const int*)work_tile, wcap, T, (int*)tile_start,
                                            (int4*)units, (int*)n_units);
  return cudaGetLastError();
}

}  // namespace

// Resident CTAs an SM holds of the raster (the fewest of its variants) -> *out.
extern "C" int hr_raster_ctas_per_sm(void* out) {
  int n = resident<true, true>();
  const int n1 = resident<false, true>(), n2 = resident<false, false>();
  n = n < n1 ? n : n1;
  n = n < n2 ? n : n2;
  *(int*)out = n;
  return n < 0 ? (int)cudaErrorInvalidValue : (int)cudaGetLastError();
}

// The plan alone (tile_start (T+1,) i32, units (max_units, 4) i32, n_units
// (1,) i32), for holding it against ops/raster_kernel.py::split_units.
extern "C" int hr_raster_plan(const void* work_tile, int wcap, int T, void* tile_start,
                              void* units, void* n_units, void* stream) {
  if (T <= 0) return (int)cudaErrorInvalidValue;
  return (int)plan(work_tile, wcap, T, tile_start, units, n_units, (cudaStream_t)stream);
}

extern "C" int hr_raster_resolve_tiles(const void* records, const void* work_tile,
                                       const void* work_slot, int wcap, void* tile_start,
                                       void* units, void* n_units, void* depth, void* visid,
                                       void* attrs, void* keys, void* done, void* queue, int T,
                                       int tx, int grid, void* stream) {
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  if (T <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = plan(work_tile, wcap, T, tile_start, units, n_units, s);
  if (err != cudaSuccess) return (int)err;
  const Args a = make_args(records, LANES, work_slot, tile_start, units, n_units, T, tx, depth,
                           visid, attrs, keys, done, queue);
  return (int)launch<true, true>(a, grid, s);
}

extern "C" int hr_raster_tiles(const void* records, const void* work_tile,
                               const void* work_slot, int wcap, void* tile_start, void* units,
                               void* n_units, void* depth, void* visid, void* keys, void* done,
                               void* queue, int T, int tx, int lanes, int depth_only, int grid,
                               void* stream) {
  if (grid <= 0 || lanes < 12 || lanes % 4 != 0) return (int)cudaErrorInvalidValue;
  if (T <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = plan(work_tile, wcap, T, tile_start, units, n_units, s);
  if (err != cudaSuccess) return (int)err;
  const Args a = make_args(records, lanes, work_slot, tile_start, units, n_units, T, tx, depth,
                           visid, nullptr, keys, done, queue);
  return (int)(depth_only ? launch<false, false>(a, grid, s) : launch<false, true>(a, grid, s));
}
