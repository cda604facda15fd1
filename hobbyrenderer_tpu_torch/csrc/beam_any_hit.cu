// Any-hit occlusion for ray tiles (kernel K4 of the port).
//
// Replaces: hobbyrenderer_tpu/ops/beam.py::_beam_kernel / beam_any_hit_tiles
// (the Pallas TPU kernel). Same inputs and outputs:
//   rays  (T, 8, 1024) f32  rows [ox oy oz dx dy dz tmax act] per 32x32 tile
//   table (N, 128) f32      beam_table() of the 4-wide implicit-heap BVH:
//                           interior rows lanes 0:24 = 4 child boxes (lo3|hi3),
//                           leaf rows 4 x 16-lane [v0 e1 e2 tid pad6],
//                           lane 127 = leaf marker; children of q: 4q+1..4q+4;
//                           rows >= I (the wrapper's _leaf_start) are leaves
//   occ   (T, 1024) f32     1 = occluded, 0 = free or not live
//   ovf   (T,) f32          always 0: a lane's stack holds every entry a
//                           table the wrapper accepts can need (check_stack),
//                           so there is no frontier to overflow
//
// What bounds it on the H100: latency. A lane's walk is a chain of
// dependent row loads (a step costs ~1,000-3,000 cycles on the stress
// frame's calls), the longest lane's chain sets a sparse call's time, and
// its bytes and FLOPs are 26-86x below its time (bench_k2k4.k4_bound).
//
// Design (two launches). The TPU kernel walks the tree once per 32x32 tile
// with an interval bound of the whole beam; the first port ran a thread per
// lane over every lane, live or not. Here a first launch compacts each tile's
// live lanes (act > 0.5 and tmax > 1e-4) by ballot and prefix, in 8x4 pixel
// blocks (ops/beam.py::packet_order), into one list for the call; a second
// launch of as many CTAs as the card keeps resident cuts the list into
// packets (32 lanes, or fewer when there are fewer live lanes than resident
// warps can take 32 at a time), which the CTAs take in chunks of 4 from an
// atomic queue that the last CTA resets. A lane walks its own ray depth
// first with a stack in local memory and the next row in a register; the
// packet's lanes step in one warp-uniform loop (a per-lane loop let the
// lanes of a warp drift apart and ran up to 3x slower). At an interior row a
// lane reads the 4 boxes with six 16-byte loads and runs the padded
// (conservative) slab test; at a leaf the rounded Möller-Trumbore test of
// beam.py:193-204 (|det| > 1e-12, u, v >= -1e-7, u + v <= 1 + 1e-7,
// 1e-4 < t < tmax; __fmul_rn/__fadd_rn in the plain version's order); a hit
// ends the lane. A walk that shares one stack among a packet's lanes (their
// union of rows) was tried and lost on every call (PERF.md section 6).
// Exactness: any hit does not depend on the order of the walk, so with the
// conservative box test the result is the brute-force plain version's, and
// ops/beam.py::beam_walk replays this walk lane for lane.

#include <cuda_runtime.h>

namespace {

constexpr int PIX = 1024;
constexpr int W = 128;
constexpr int STACK = 64;                  // ops/beam.py::STACK
constexpr int NW = 4;                      // warps a CTA
constexpr float ONE_EPS = 1.00000012f;     // f32(1 + 1e-7)

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// record k of a leaf row: floats 0..11 of its 16 as three 16-byte loads
__device__ __forceinline__ bool tri_hit(const float4* rec, float ox, float oy, float oz,
                                        float dx, float dy, float dz, float tmax) {
  const float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 2);
  if (!(c.y >= 0.0f)) return false;          // padded slot (tid < 0)
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float px = sub(mul(dy, e2z), mul(dz, e2y));
  const float py = sub(mul(dz, e2x), mul(dx, e2z));
  const float pz = sub(mul(dx, e2y), mul(dy, e2x));
  const float det = add(add(mul(e1x, px), mul(e1y, py)), mul(e1z, pz));
  if (!(fabsf(det) > 1e-12f)) return false;
  const float inv_det = 1.0f / det;
  const float sx = sub(ox, v0x), sy = sub(oy, v0y), sz = sub(oz, v0z);
  const float u = mul(add(add(mul(sx, px), mul(sy, py)), mul(sz, pz)), inv_det);
  const float qx = sub(mul(sy, e1z), mul(sz, e1y));
  const float qy = sub(mul(sz, e1x), mul(sx, e1z));
  const float qz = sub(mul(sx, e1y), mul(sy, e1x));
  const float v = mul(add(add(mul(dx, qx), mul(dy, qy)), mul(dz, qz)), inv_det);
  const float t = mul(add(add(mul(e2x, qx), mul(e2y, qy)), mul(e2z, qz)), inv_det);
  return (u >= -1e-7f) && (v >= -1e-7f) && (add(u, v) <= ONE_EPS)
      && (t > 1e-4f) && (t < tmax);
}

__device__ __forceinline__ float inv_dir(float d) {
  return fabsf(d) > 1e-12f ? 1.0f / d : (d >= 0.0f ? 1e12f : -1e12f);
}

// Padded slab test: conservative, so a box the exact hit test could reach
// through its fuzzy edges is never skipped.
__device__ __forceinline__ bool box_hit(const float* b, const float* o, const float* inv,
                                        float tmax) {
  float tn = 0.0f, tf = tmax;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo = b[a], hi = b[3 + a];
    if (!(lo <= hi)) return false;           // inverted box = empty subtree
    const float pad = 1e-5f * fmaxf(fmaxf(fabsf(lo), fabsf(hi)), 1.0f);
    const float t0 = (lo - pad - o[a]) * inv[a];
    const float t1 = (hi + pad - o[a]) * inv[a];
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  return tn <= tf;
}

// the tile lane at position j of the packet order: 8x4 blocks, row by row
__device__ __forceinline__ int packet_lane(int j) {
  const int b = j >> 5, i = j & 31;
  return ((b >> 2) * 4 + (i >> 3)) * 32 + (b & 3) * 8 + (i & 7);
}

// One step of a lane's depth-first walk at row q. An interior row's last
// child that the ray meets is the next row (q), its other such children go
// to the lane's stack: the order of a plain stack that pushes children
// 0..3 and pops the top (child 3 first). Returns true on a hit.
__device__ __forceinline__ bool step(const float* __restrict__ table, int N, int I, int& q,
                                     int* stack, int& sp, const float* o, const float* inv,
                                     float dx, float dy, float dz, float tmax) {
  const float4* row = reinterpret_cast<const float4*>(table + (size_t)q * W);
  if (q >= I) {
    bool hit = false;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      hit = hit || tri_hit(row + 4 * k, o[0], o[1], o[2], dx, dy, dz, tmax);
    q = -1;
    return hit;
  }
  float f[24];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float4 v = __ldg(row + k);
    f[4 * k] = v.x; f[4 * k + 1] = v.y; f[4 * k + 2] = v.z; f[4 * k + 3] = v.w;
  }
  int next = -1;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    const int c = 4 * q + 1 + ch;
    if (c < N && box_hit(f + 6 * ch, o, inv, tmax)) {
      if (next >= 0) {
        if (sp >= STACK) __trap();           // check_stack rules this out
        stack[sp++] = next;
      }
      next = c;
    }
  }
  q = next;
  return false;
}

// Launch 1, a CTA a tile: its live lanes, compacted by ballot and prefix in
// the packet order, go to one list for the call (each tile takes a range of
// it with one atomicAdd, so tiles land in any order, each tile's lanes in
// order); not-live lanes are written 0.
__global__ void __launch_bounds__(NW * 32)
beam_compact_kernel(const float* __restrict__ rays, float* __restrict__ occ,
                    float* __restrict__ ovf, int* __restrict__ list, int* __restrict__ counters) {
  __shared__ unsigned live_mask[32];
  __shared__ int base[33];
  __shared__ int at;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x;
  const float* R = rays + (size_t)tile * 8 * PIX;
  for (int k = warp; k < 32; k += NW) {
    const int p = packet_lane(k * 32 + lane);
    const bool live = R[7 * PIX + p] > 0.5f && R[6 * PIX + p] > 1e-4f;
    const unsigned m = __ballot_sync(~0u, live);
    if (!live) occ[(size_t)tile * PIX + p] = 0.0f;
    if (lane == 0) live_mask[k] = m;
  }
  __syncthreads();
  if (warp == 0) {                           // exclusive prefix of the 32 counts
    int s = __popc(live_mask[lane]);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(~0u, s, o);
      if (lane >= o) s += v;
    }
    base[lane + 1] = s;
    if (lane == 0) {
      base[0] = 0;
      ovf[tile] = 0.0f;
    }
    if (lane == 31) at = atomicAdd(counters, s);
  }
  __syncthreads();
  for (int k = warp; k < 32; k += NW) {
    const unsigned m = live_mask[k];
    if ((m >> lane) & 1u)
      list[at + base[k] + __popc(m & ((1u << lane) - 1u))] =
          tile * PIX + packet_lane(k * 32 + lane);
  }
}

// The next packet of a warp (lane 0): the CTA takes chunks of NW
// neighbouring packets from the call's queue (counters[1]), and its warps
// share the chunk through one 64-bit word in shared memory (the chunk's
// first packet << 32 | packets handed out of it): the warp that finds the
// chunk spent fetches the next, the others wait until it is there.
__device__ __forceinline__ int next_packet(int* counters, unsigned long long* chunk) {
  for (;;) {
    const unsigned long long w = atomicAdd(chunk, 1ull);
    const int first = (int)(w >> 32), t = (int)(unsigned)w;
    if (t < NW) return first + t;
    if (t == NW) {
      const int nb = atomicAdd(counters + 1, NW);
      atomicExch(chunk, ((unsigned long long)(unsigned)nb << 32) | 1ull);
      return nb;
    }
    while ((int)(*(volatile unsigned long long*)chunk >> 32) == first) {
    }
  }
}

// Launch 2, as many CTAs as the card keeps resident. A packet is `width`
// consecutive lanes of the list: 32, or fewer when the list's L lanes would
// leave resident warps idle (width = ceil(L / warps), at least 1). A sparse
// call's time is its longest lane's chain of dependent rows, and a step
// takes longer the more lanes of a warp fetch different rows, so its few
// rays are spread thin; a dense call fills its warps. Chunks of NW
// neighbouring packets keep a CTA's warps on one patch of the frame (the
// rows they read stay in the SM's L1) while the queue balances the SMs. The
// lanes of a packet walk their own rays in one warp-uniform loop, so they
// meet again after every step.
__global__ void __launch_bounds__(NW * 32)
beam_walk_kernel(const float* __restrict__ rays, const float* __restrict__ table,
                 float* __restrict__ occ, const int* __restrict__ list,
                 int* __restrict__ counters, int N, int I) {
  __shared__ unsigned long long chunk;
  const int lane = threadIdx.x & 31;
  const int L = counters[0];
  const int warps = (int)gridDim.x * NW;
  const int width = min(32, max(1, (L + warps - 1) / warps));
  const int packets = (L + width - 1) / width;
  if (threadIdx.x == 0) chunk = (0xffffffffull << 32) | NW;   // spent: the first warp fetches
  __syncthreads();
  int stack[STACK];
  for (;;) {
    int pk = 0;
    if (lane == 0) pk = next_packet(counters, &chunk);
    pk = __shfl_sync(~0u, pk, 0);
    if (pk >= packets) break;
    const int i = pk * width + lane;
    const bool has = lane < width && i < L;
    const int g = has ? list[i] : 0;
    const float* R = rays + (size_t)(g / PIX) * 8 * PIX + g % PIX;
    float o[3] = {0.0f, 0.0f, 0.0f}, dx = 0.0f, dy = 0.0f, dz = 0.0f, tmax = 0.0f;
    if (has) {
      o[0] = R[0]; o[1] = R[PIX]; o[2] = R[2 * PIX];
      dx = R[3 * PIX]; dy = R[4 * PIX]; dz = R[5 * PIX];
      tmax = R[6 * PIX];
    }
    const float inv[3] = {inv_dir(dx), inv_dir(dy), inv_dir(dz)};
    bool walking = has, hit = false;
    int q = 0, sp = 0;
    while (__any_sync(~0u, walking)) {
      if (walking && q < 0) {
        if (sp == 0) walking = false;
        else q = stack[--sp];
      }
      if (walking && step(table, N, I, q, stack, sp, o, inv, dx, dy, dz, tmax)) {
        hit = true;
        walking = false;
      }
    }
    if (has) occ[g] = hit ? 1.0f : 0.0f;
  }
  // every fetch of this CTA has returned; the last CTA out resets the counters
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(counters + 2, 1) == (int)gridDim.x - 1) {
      atomicExch(counters, 0);
      atomicExch(counters + 1, 0);
      atomicExch(counters + 2, 0);
    }
  }
}

}  // namespace

// list: T * 1024 i32 scratch; counters (3,) i32: live lanes, packet queue,
// CTAs done; zero before a launch, and the launch leaves them at zero, so
// the caller keeps one a stream.
extern "C" int hr_beam_any_hit_tiles(const void* rays, const void* table, void* occ,
                                     void* ovf, void* list, void* counters, int T, int N,
                                     int I, void* stream) {
  static int resident[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, beam_walk_kernel, NW * 32, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = per_sm * sms;
  }
  if (T > 0) {
    beam_compact_kernel<<<T, NW * 32, 0, (cudaStream_t)stream>>>(
        (const float*)rays, (float*)occ, (float*)ovf, (int*)list, (int*)counters);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    beam_walk_kernel<<<resident[dev], NW * 32, 0, (cudaStream_t)stream>>>(
        (const float*)rays, (const float*)table, (float*)occ, (const int*)list,
        (int*)counters, N, I);
  }
  return (int)cudaGetLastError();
}
