// 16-wide BVH walk, closest or any hit (kernel K3 of the port).
//
// Replaces: hobbyrenderer_tpu/ops/wtrace.py::_wtrace_kernel / wtrace_phase
// (the Pallas TPU walk; its callers wtrace_closest_hit / wtrace_any_hit).
// The rules are those of hobbyrenderer_tpu/ops/bvh16.py::_step16 (the walk
// the XLA bvh16 branch runs), so the node visits and the step count of each
// ray equal the JAX walk's, capped or not. Inputs and outputs:
//   table (I+L, 128) f32  row-major 16-ary implicit heap (children of q are
//                         16q+1..16q+16): interior rows lanes 0:96 = 16 child
//                         boxes lo3|hi3; leaf rows lanes 0:120 = 12 records
//                         [v0 e1 e2 tid], tid < 0 = padding
//   o, d  (R, 3) f32, tmax (R,) f32 (best_t starts there)
//   best_t (R,) f32, best_tri (R,) i32 (-1 = none), steps (R,) i32
//
// What bounds it on the H100: each step of a ray is one dependent 512 B row
// load; a ray takes ~6-30 steps. The stress scene's table (69,905 rows,
// 36 MB) fits the 50 MB L2, so the loads are L2 latency plus the divergence
// of the 32 rays of a warp (they walk different paths and finish at
// different steps) — not FLOPs and not DRAM bandwidth.
//
// Design: the TPU ran the walk as a lockstep wavefront over SoA ray blocks
// with the trail in vector registers and bulk-DMA'd rows, because per-lane
// gathers are slow there. On Hopper one thread walks one ray: the row is read
// through the read-only cache, the pending-children trail is a few 16-bit
// masks per level in the thread's local array, and the thread exits when its
// ray is done instead of idling in lockstep. The arithmetic is the plain
// version's, operation for operation; the library is compiled with
// -fmad=false so no product is fused into a sum (the plain PyTorch ops round
// every step), and '/' is IEEE division — so the kernel and the plain version
// agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int W = 128;
constexpr int K = 12;          // records per leaf row
constexpr int MAXM = 6;        // deepest trail the kernel keeps (16^6 leaves)
constexpr float INF = 3.0e38f;

__device__ __forceinline__ float inv_dir(float d) {
  return fabsf(d) > 1e-12f ? 1.0f / d : (d >= 0.0f ? 1e12f : -1e12f);
}

__global__ void bvh16_walk_kernel(const float* __restrict__ table,
                                  const float* __restrict__ o,
                                  const float* __restrict__ d,
                                  const float* __restrict__ tmax,
                                  float* __restrict__ out_t, int* __restrict__ out_tri,
                                  int* __restrict__ out_steps, int R, int I, int M,
                                  int any_hit, int max_steps, float t_min) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  float best_t = tmax[r];
  int best_tri = -1;
  int mask[MAXM];
#pragma unroll
  for (int k = 0; k < MAXM; ++k) mask[k] = 0;
  int cur = 0;
  int steps = 0;
  bool live = true;
  while (live && steps < max_steps) {
    ++steps;
    int lvl = 0;
    for (int k = 0, th = 1; k < M; ++k, th = th * 16 + 1) lvl += (cur >= th);
    const float* row = table + (size_t)cur * W;
    bool need_pop;
    if (cur >= I) {
      // leaf: K Möller-Trumbore tests, the first minimum t wins
      float tmin_leaf = INF;
      int kbest_tid = -1;
      for (int k = 0; k < K; ++k) {
        const float* rec = row + 10 * k;
        const float tid = __ldg(rec + 9);
        if (!(tid >= 0.0f)) continue;
        const float v0x = __ldg(rec), v0y = __ldg(rec + 1), v0z = __ldg(rec + 2);
        const float e1x = __ldg(rec + 3), e1y = __ldg(rec + 4), e1z = __ldg(rec + 5);
        const float e2x = __ldg(rec + 6), e2y = __ldg(rec + 7), e2z = __ldg(rec + 8);
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool ok = fabsf(det) > 1e-12f;
        const float inv_det = ok ? 1.0f / det : 0.0f;
        const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
        const float uu = (sx * px + sy * py + sz * pz) * inv_det;
        const float qx = sy * e1z - sz * e1y;
        const float qy = sz * e1x - sx * e1z;
        const float qz = sx * e1y - sy * e1x;
        const float vv = (dx * qx + dy * qy + dz * qz) * inv_det;
        const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const bool thit = ok && uu >= -1e-7f && vv >= -1e-7f
            && (uu + vv) <= 1.00000012f && tt > t_min && tt < best_t;
        if (thit && tt < tmin_leaf) { tmin_leaf = tt; kbest_tid = (int)tid; }
      }
      if (tmin_leaf < best_t) { best_t = tmin_leaf; best_tri = kbest_tid; }
      need_pop = true;
    } else {
      // interior: 16 slab tests; nearest (closest hit) or lowest (any hit)
      int bits = 0;
      int near = 0;
      float tnear = INF;
      for (int c = 0; c < 16; ++c) {
        const float* b = row + 6 * c;
        const float lox = __ldg(b), loy = __ldg(b + 1), loz = __ldg(b + 2);
        const float hix = __ldg(b + 3), hiy = __ldg(b + 4), hiz = __ldg(b + 5);
        const float t0x = (lox - ox) * ix, t1x = (hix - ox) * ix;
        const float t0y = (loy - oy) * iy, t1y = (hiy - oy) * iy;
        const float t0z = (loz - oz) * iz, t1z = (hiz - oz) * iz;
        const float t_en = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
        const float t_ex = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
        const bool bhit = (t_en <= t_ex * 1.00000024f) && (t_ex > 0.0f) && (t_en < best_t)
            && (lox <= hix);
        if (bhit) {
          bits |= 1 << c;
          const float tc = fmaxf(t_en, 0.0f);
          if (tc < tnear) { tnear = tc; near = c; }
        }
      }
      bool has_int;
      if (any_hit) {
        has_int = bits != 0;
        near = has_int ? __ffs(bits) - 1 : 0;
      } else {
        has_int = tnear < INF;
      }
      if (has_int) {
        mask[lvl] = bits & ~(1 << near);     // the nearest child descends now
        cur = 16 * cur + 1 + near;
        need_pop = false;
      } else {
        need_pop = true;
      }
    }
    if (need_pop) {
      int kstar = -1;
      for (int k = M - 1; k >= 0; --k) {
        if (mask[k] != 0) { kstar = k; break; }
      }
      if (kstar < 0) {
        live = false;
        cur = -1;
      } else {
        int a = cur;
        for (int s = lvl - kstar; s > 0; --s) a = (a - 1) >> 4;
        const int m = mask[kstar];
        const int lsb = m & -m;
        mask[kstar] = m & ~lsb;
        cur = 16 * a + 1 + (__ffs(lsb) - 1);
      }
    }
    if (any_hit && best_tri >= 0) live = false;
  }
  out_t[r] = best_t;
  out_tri[r] = best_tri;
  out_steps[r] = steps;
}

}  // namespace

extern "C" int hr_bvh16_walk(const void* table, const void* o, const void* d,
                             const void* tmax, void* out_t, void* out_tri, void* out_steps,
                             int R, int I, int M, int any_hit, int max_steps, float t_min,
                             void* stream) {
  if (M > MAXM) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    const int threads = 128;
    const int blocks = (R + threads - 1) / threads;
    bvh16_walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)table, (const float*)o, (const float*)d, (const float*)tmax,
        (float*)out_t, (int*)out_tri, (int*)out_steps, R, I, M, any_hit, max_steps, t_min);
  }
  return (int)cudaGetLastError();
}
