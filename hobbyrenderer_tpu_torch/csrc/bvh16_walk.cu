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
//   o, d  (R, 3) f32, tmax (R,) f32 (best_t starts there), t_min >= 0
//   best_t (R,) f32, best_tri (R,) i32 (-1 = none), steps (R,) i32
//   queue (2,) i32       the ray queue's head and the CTAs done; zero before
//                        the launch, and the last CTA to finish zeroes both
//                        again, so the caller keeps one queue a stream
//
// What bounds it on the H100: each step of a ray is one dependent row read
// (384 B of an interior row, 480 B of a leaf row) and 16 slab tests or 12
// triangle tests; a ray takes ~6-30 steps. The stress scene's table (69,905
// rows, 36 MB) fits the 50 MB L2. One thread a ray (the first port) made a
// step ~100 scalar loads, each to another row in each lane of a warp when the
// rays diverge, and a warp ran as long as its longest ray. Here a step costs
// a few coalesced loads, and the limit becomes the instructions a step
// issues and its chain of ballots, reductions and shuffles: staging the
// heap's top levels in shared memory was measured and lost on every walk
// (a row from shared memory does not shorten a step), so every row comes
// through the read-only cache.
//
// Design: the TPU ran all lanes of a 2,048-ray block in lockstep, the 16
// box tests of a node side by side on data held in VMEM. Here a half-warp
// walks one ray, and the node's tests run side by side across it:
//   - interior row: lane c reads child c's six floats as three 8-byte loads
//     (the half-warp reads the row's 384 contiguous bytes in one coalesced
//     pass) and runs its slab test; __ballot_sync gives the hit bits, and the
//     nearest child is the first minimum of max(t_en, 0): a redux.sync min
//     over the bits of t (non-negative floats order as their bit patterns;
//     -0 is made +0 first, so a tie between them is a tie), then the lowest
//     lane that holds it (a ballot). Any hit takes the lowest hit bit.
//   - leaf row: lane k < 12 tests record k (five 8-byte loads) against the
//     best_t from before the leaf; the first minimum t wins, found the same
//     way (t > t_min >= 0, so t is positive).
//   - the trail of pending children: lane k holds level k's 16-bit mask; the
//     pop is a ballot (deepest level with a pending child) and a shuffle.
//   Every lane of a half-warp holds the same ray state, so nothing else is
//   sent between lanes.
// Persistent CTAs of 256 threads: the launch holds about as many CTAs as
// the card keeps resident; a half-warp whose ray is done takes the next ray
// index from the queue (one atomicAdd, issued while the current ray walks),
// so no lane waits for a long ray of another. A ray's result depends only
// on its own inputs, so the outputs are the same bits whichever half-warp
// walks it.
// The arithmetic is the plain version's, operation for operation; the
// library is compiled with -fmad=false so no product is fused into a sum
// (the plain PyTorch ops round every step), and '/' is IEEE division — so
// the kernel and the plain version agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int W = 128;         // floats a table row
constexpr int K = 12;          // records per leaf row
constexpr int MAXM = 6;        // deepest trail the kernel keeps (16^6 leaves)
constexpr int THREADS = 256;   // a CTA: 16 half-warps, 16 rays at a time
constexpr float INF = 3.0e38f;

__device__ __forceinline__ float inv_dir(float d) {
  return fabsf(d) > 1e-12f ? 1.0f / d : (d >= 0.0f ? 1e12f : -1e12f);
}

template <bool ANY>
__global__ void __launch_bounds__(THREADS)
bvh16_walk_kernel(const float* __restrict__ table, const float* __restrict__ o,
                  const float* __restrict__ d, const float* __restrict__ tmax,
                  float* __restrict__ out_t, int* __restrict__ out_tri,
                  int* __restrict__ out_steps, int* __restrict__ queue, int R, int I,
                  int max_steps, float t_min) {
  int* next_ray = queue;
  const float2* table2 = reinterpret_cast<const float2*>(table);

  const int lane = threadIdx.x & 31;
  const int g = lane & 15;                   // this lane's child / record / trail level
  const int g0 = lane & 16;                  // the half-warp's first lane
  const unsigned gmask = 0xFFFFu << g0;
  const unsigned KEY_INF = __float_as_uint(INF);

  int r = 0;
  if (g == 0) r = atomicAdd(next_ray, 1);
  r = __shfl_sync(gmask, r, g0);
  while (r < R) {
    int ahead = 0;
    if (g == 0) ahead = atomicAdd(next_ray, 1);     // the next ray, fetched now
    const float ox = __ldg(o + 3 * r), oy = __ldg(o + 3 * r + 1), oz = __ldg(o + 3 * r + 2);
    const float dx = __ldg(d + 3 * r), dy = __ldg(d + 3 * r + 1), dz = __ldg(d + 3 * r + 2);
    const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
    float best_t = __ldg(tmax + r);
    int best_tri = -1;
    unsigned trail = 0u;                     // lane k < M: level k's pending children
    int cur = 0, lvl = 0, steps = 0;
    bool live = true;
    while (live && steps < max_steps) {
      ++steps;
      bool need_pop = true;
      if (cur >= I) {
        // leaf: lane k < 12 tests record k; the first minimum t wins
        unsigned key = KEY_INF;
        float tt = INF;
        int tid = -1;
        if (g < K) {
          const float2* rec = table2 + (size_t)cur * (W / 2) + 5 * g;
          const float2 r0 = __ldg(rec), r1 = __ldg(rec + 1), r2 = __ldg(rec + 2);
          const float2 r3 = __ldg(rec + 3), r4 = __ldg(rec + 4);
          const float v0x = r0.x, v0y = r0.y, v0z = r1.x;
          const float e1x = r1.y, e1y = r2.x, e1z = r2.y;
          const float e2x = r3.x, e2y = r3.y, e2z = r4.x;
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
          tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          tid = (int)r4.y;
          const bool thit = r4.y >= 0.0f && ok && uu >= -1e-7f && vv >= -1e-7f
              && (uu + vv) <= 1.00000012f && tt > t_min && tt < best_t;
          if (thit) key = min(__float_as_uint(tt), KEY_INF);
        }
        const unsigned m = __reduce_min_sync(gmask, key);
        if (m < KEY_INF) {
          const int src = g0 + __ffs((__ballot_sync(gmask, key == m) >> g0) & 0xFFFFu) - 1;
          const float t_leaf = __shfl_sync(gmask, tt, src);
          const int tid_leaf = __shfl_sync(gmask, tid, src);
          if (t_leaf < best_t) { best_t = t_leaf; best_tri = tid_leaf; }
        } else if (INF < best_t) {     // no hit below INF: best_t comes down to INF
          best_t = INF;
          best_tri = -1;
        }
      } else {
        // interior: lane c tests child c
        const float2* box = table2 + (size_t)cur * (W / 2) + 3 * g;
        const float2 b0 = __ldg(box), b1 = __ldg(box + 1), b2 = __ldg(box + 2);
        const float lox = b0.x, loy = b0.y, loz = b1.x;
        const float hix = b1.y, hiy = b2.x, hiz = b2.y;
        const float t0x = (lox - ox) * ix, t1x = (hix - ox) * ix;
        const float t0y = (loy - oy) * iy, t1y = (hiy - oy) * iy;
        const float t0z = (loz - oz) * iz, t1z = (hiz - oz) * iz;
        const float t_en = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
        const float t_ex = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
        const bool bhit = (t_en <= t_ex * 1.00000024f) && (t_ex > 0.0f) && (t_en < best_t)
            && (lox <= hix);
        const unsigned bits = (__ballot_sync(gmask, bhit) >> g0) & 0xFFFFu;
        int near = -1;
        if (ANY) {
          if (bits) near = __ffs(bits) - 1;
        } else {
          const unsigned key = bhit ? min(__float_as_uint(fmaxf(t_en, 0.0f) + 0.0f), KEY_INF)
                                    : KEY_INF;
          const unsigned m = __reduce_min_sync(gmask, key);
          if (m < KEY_INF) near = __ffs((__ballot_sync(gmask, key == m) >> g0) & 0xFFFFu) - 1;
        }
        if (near >= 0) {
          if (g == lvl) trail = bits & ~(1u << near);   // the nearest child descends now
          cur = 16 * cur + 1 + near;
          ++lvl;
          need_pop = false;
        }
      }
      if (need_pop) {
        // the deepest level with a pending child, its lowest child
        const unsigned pend = (__ballot_sync(gmask, trail != 0u) >> g0) & 0xFFFFu;
        if (pend == 0u) {
          live = false;
        } else {
          const int kstar = 31 - __clz(pend);
          const unsigned m = __shfl_sync(gmask, trail, g0 + kstar);
          for (int s = lvl - kstar; s > 0; --s) cur = (cur - 1) >> 4;
          const unsigned lsb = m & (0u - m);
          if (g == kstar) trail = m & ~lsb;
          cur = 16 * cur + 1 + (__ffs(lsb) - 1);
          lvl = kstar + 1;
        }
      }
      if (ANY && best_tri >= 0) live = false;
    }
    if (g == 0) {
      out_t[r] = best_t;
      out_tri[r] = best_tri;
      out_steps[r] = steps;
    }
    r = __shfl_sync(gmask, ahead, g0);
  }
  // every fetch of this CTA has returned; the last CTA out resets the queue
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(queue + 1, 1) == (int)gridDim.x - 1) {
      atomicExch(queue, 0);
      atomicExch(queue + 1, 0);
    }
  }
}

}  // namespace

// Resident CTAs an SM holds of the walk (the fewer of its two variants) -> *out.
extern "C" int hr_bvh16_walk_ctas_per_sm(void* out) {
  int n_closest = 0, n_any = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n_closest, bvh16_walk_kernel<false>, THREADS, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n_any, bvh16_walk_kernel<true>,
                                                        THREADS, 0);
  *(int*)out = n_closest < n_any ? n_closest : n_any;
  return (int)err;
}

extern "C" int hr_bvh16_walk(const void* table, const void* o, const void* d,
                             const void* tmax, void* out_t, void* out_tri, void* out_steps,
                             void* queue, int R, int I, int M, int any_hit, int max_steps,
                             float t_min, int grid, void* stream) {
  if (M > MAXM || !(t_min >= 0.0f) || grid <= 0) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (any_hit)
      bvh16_walk_kernel<true><<<grid, THREADS, 0, s>>>(
          (const float*)table, (const float*)o, (const float*)d, (const float*)tmax,
          (float*)out_t, (int*)out_tri, (int*)out_steps, (int*)queue, R, I, max_steps, t_min);
    else
      bvh16_walk_kernel<false><<<grid, THREADS, 0, s>>>(
          (const float*)table, (const float*)o, (const float*)d, (const float*)tmax,
          (float*)out_t, (int*)out_tri, (int*)out_steps, (int*)queue, R, I, max_steps, t_min);
  }
  return (int)cudaGetLastError();
}
