// Closest hit of sorted 1024-ray blocks (kernel K6 of the port).
//
// Replaces: hobbyrenderer_tpu/ops/trace.py::_closest_kernel / closest_hit_blocks
// (the Pallas TPU kernel). Same inputs and outputs:
//   rays  (T, 8, 1024) f32  rows [ox oy oz dx dy dz tmax act], one block of
//                           coherence-sorted rays each (ops/trace.py)
//   table (N, 128) f32      beam_table() of the 4-wide implicit-heap BVH:
//                           interior rows lanes 0:24 = 4 child boxes (lo3|hi3),
//                           leaf rows 4 x 16-lane [v0 e1 e2 tid pad6],
//                           lane 127 = leaf marker; children of q: 4q+1..4q+4
//   t, tri, u, v, front (T, 1024) f32  per lane: best t (tmax on a miss),
//                           triangle id (-1 on a miss), barycentrics, 1 if det > 0
//   ovf   (T,) f32          1 if a level's frontier dropped children (hits
//                           of that block may be missed)
//
// What it computes is ops/trace_kernel.py's plain version, step for step:
// a beam BFS of the tree per block (origin box x direction box of the
// block's active lanes, interval child-box tests), levels in order, each
// level in groups of 8 node rows, the cull bound cur_hi (max best t over the
// active lanes) read once per group before the group's leaf updates,
// children appended in (row, child) order up to FCAP - 1 = 4,095 a level,
// and per record slot the smallest t over the group's leaf rows with tri,
// u, v, front each the largest over the rows that tie at it. Every product
// and sum is rounded on its own (__fmul_rn / __fadd_rn, IEEE division), so
// the kernel equals the plain version bit for bit.
//
// What bounds it on the H100: each block walks its rows one group after
// another, with three block-wide barriers per group, and the leaf work is
// 1,024 lanes x 4 records per leaf row; the node rows it reads (512 B each)
// and the Möller-Trumbore operations give the bound, the serial group walk
// and the barriers the time. Wide direction cones (cosine bounce rays) reach
// much of the tree and fill the frontier.
//
// Design: one CTA of 1,024 threads per block, one ray per thread; the two
// frontier levels (2 x 4,096 int32 = 32 KB) and the group's 8 rows (4 KB)
// in shared memory; the block's beam bounds from one block-wide min/max.
// Warp 0 runs the 32 (row, child) box tests, one per lane, and appends the
// hits with a ballot and a prefix popcount, which keeps the (row, child)
// order; all warps then fold the leaf rows into their lanes.

#include <cuda_runtime.h>

namespace {

constexpr int PIX = 1024;
constexpr int W = 128;
constexpr int GW = 8;
constexpr int FCAP = 4096;
constexpr float BIG = 3.0e37f;
constexpr float EPS = 1e-8f;
constexpr float ONE_EPS = 1.00000012f;     // f32(1 + 1e-7)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, s));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, s));
  return v;
}

__global__ void __launch_bounds__(1024, 1)
closest_blocks_kernel(const float* __restrict__ rays, const float* __restrict__ table,
                      float* __restrict__ out_t, float* __restrict__ out_tri,
                      float* __restrict__ out_u, float* __restrict__ out_v,
                      float* __restrict__ out_f, float* __restrict__ ovf, float t_min) {
  __shared__ int frontier[2][FCAP];
  __shared__ float rows[GW][W];
  __shared__ float red[12][32];
  __shared__ float bounds[12];
  __shared__ int s_cnt_nxt;
  __shared__ int s_ovf;

  const int b = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float* ray = rays + (size_t)b * 8 * PIX + p;
  const float ox = ray[0], oy = ray[PIX], oz = ray[2 * PIX];
  const float dx = ray[3 * PIX], dy = ray[4 * PIX], dz = ray[5 * PIX];
  const float tmax = ray[6 * PIX];
  const bool act = ray[7 * PIX] > 0.5f;
  float bt = tmax, btri = -1.0f, bu = 0.0f, bv = 0.0f, bf = 0.0f;

  // ---- the block's beam bounds over its active lanes ----
  {
    const float v[6] = {ox, oy, oz, dx, dy, dz};
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float lo = warp_min(act ? v[j] : BIG);
      const float hi = warp_max(act ? v[j] : -BIG);
      if (lane == 0) { red[j][warp] = lo; red[6 + j][warp] = hi; }
    }
  }
  const bool any_act = __syncthreads_or(act);
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const float x = red[j][lane];
      const float r = j < 6 ? warp_min(x) : warp_max(x);
      if (lane == 0) bounds[j] = r;
    }
  }
  if (p == 0) { frontier[0][0] = 0; s_ovf = 0; }
  __syncthreads();

  if (any_act) {
    float olo[3], ohi[3], dlo[3], dhi[3], ilo[3], ihi[3];
    bool ivalid[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      olo[a] = bounds[a];
      dlo[a] = bounds[3 + a];
      ohi[a] = bounds[6 + a];
      dhi[a] = bounds[9 + a];
      const bool pos = dlo[a] > EPS;
      const bool neg = dhi[a] < -EPS;
      ivalid[a] = pos || neg;
      ilo[a] = pos ? 1.0f / fmaxf(dhi[a], EPS) : 1.0f / fminf(dlo[a], -EPS);
      ihi[a] = pos ? 1.0f / fmaxf(dlo[a], EPS) : 1.0f / fminf(dhi[a], -EPS);
    }
    int cur = 0, cnt = 1;
    while (cnt > 0) {
      const int nxt = 1 - cur;
      if (p == 0) s_cnt_nxt = 0;
      const int n_groups = (cnt + GW - 1) / GW;
      for (int g = 0; g < n_groups; ++g) {
        const int rem = min(cnt - g * GW, GW);
        __syncthreads();     // last group's rows read; s_cnt_nxt visible
        {
          const int r = p >> 7, l = p & (W - 1);
          rows[r][l] = r < rem ? table[(size_t)frontier[cur][g * GW + r] * W + l] : 0.0f;
        }
        {
          const float c = warp_max(act ? bt : 0.0f);
          if (lane == 0) red[0][warp] = c;
        }
        __syncthreads();
        if (warp == 0) {
          const float cur_hi = warp_max(red[0][lane]);
          const int r = lane >> 2, ch = lane & 3;
          const bool rowok = r < rem;
          bool hit = false;
          int nid = 0;
          if (rowok && !(rows[r][127] > 0.5f)) {
            nid = frontier[cur][g * GW + r];
            const float* box = &rows[r][6 * ch];
            float t_en = 0.0f, t_ex = cur_hi;
            bool ok = true;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              const float blo = box[a], bhi = box[3 + a];
              ok = ok && (blo <= bhi);
              const float p_lo = sub(blo, ohi[a]);
              const float p_hi = sub(bhi, olo[a]);
              const float c1 = mul(p_lo, ilo[a]), c2 = mul(p_lo, ihi[a]);
              const float c3 = mul(p_hi, ilo[a]), c4 = mul(p_hi, ihi[a]);
              const float lo4 = fminf(fminf(c1, c2), fminf(c3, c4));
              const float hi4 = fmaxf(fmaxf(c1, c2), fmaxf(c3, c4));
              if (ivalid[a]) {
                t_en = fmaxf(t_en, lo4);
                t_ex = fminf(t_ex, hi4);
              }
              const float reach_lo = add(olo[a], mul(fminf(dlo[a], 0.0f), cur_hi));
              const float reach_hi = add(ohi[a], mul(fmaxf(dhi[a], 0.0f), cur_hi));
              ok = ok && (ivalid[a] || ((reach_hi >= blo) && (reach_lo <= bhi)));
            }
            hit = ok && (t_en <= t_ex) && (t_ex > 0.0f);
          }
          const unsigned mask = __ballot_sync(FULL, hit);
          const int base = s_cnt_nxt;
          const int pos = base + __popc(mask & ((1u << lane) - 1u));
          if (hit && pos < FCAP - 1) frontier[nxt][pos] = 4 * nid + 1 + ch;
          const bool dropped = __any_sync(FULL, hit && pos >= FCAP - 1);
          __syncwarp();
          if (lane == 0) {
            s_cnt_nxt = min(base + __popc(mask), FCAP - 1);
            if (dropped) s_ovf = 1;
          }
        }
        // fold the group's leaf rows into this lane's best hit
        if (act) {
#pragma unroll 1
          for (int k = 0; k < 4; ++k) {
            float m = BIG, at = 0.0f, au = 0.0f, av = 0.0f, af = 0.0f;
            bool any = false;
#pragma unroll 1
            for (int r = 0; r < rem; ++r) {
              if (!(rows[r][127] > 0.5f)) continue;
              const float* rec = &rows[r][16 * k];
              const float tid = rec[9];
              const float v0x = rec[0], v0y = rec[1], v0z = rec[2];
              const float e1x = rec[3], e1y = rec[4], e1z = rec[5];
              const float e2x = rec[6], e2y = rec[7], e2z = rec[8];
              const float px = sub(mul(dy, e2z), mul(dz, e2y));
              const float py = sub(mul(dz, e2x), mul(dx, e2z));
              const float pz = sub(mul(dx, e2y), mul(dy, e2x));
              const float det = add(add(mul(e1x, px), mul(e1y, py)), mul(e1z, pz));
              const bool okd = fabsf(det) > 1e-12f;
              const float inv_det = okd ? 1.0f / det : 0.0f;
              const float sx = sub(ox, v0x), sy = sub(oy, v0y), sz = sub(oz, v0z);
              const float u = mul(add(add(mul(sx, px), mul(sy, py)), mul(sz, pz)), inv_det);
              const float qx = sub(mul(sy, e1z), mul(sz, e1y));
              const float qy = sub(mul(sz, e1x), mul(sx, e1z));
              const float qz = sub(mul(sx, e1y), mul(sy, e1x));
              const float vv = mul(add(add(mul(dx, qx), mul(dy, qy)), mul(dz, qz)), inv_det);
              const float t = mul(add(add(mul(e2x, qx), mul(e2y, qy)), mul(e2z, qz)), inv_det);
              const bool h = okd && (u >= -1e-7f) && (vv >= -1e-7f) && (add(u, vv) <= ONE_EPS)
                  && (t > t_min) && (t < tmax) && (t < bt) && (tid >= 0.0f);
              if (!h) continue;
              const float fr = det > 0.0f ? 1.0f : 0.0f;
              if (!any || t < m) {
                m = t; at = tid; au = u; av = vv; af = fr;
                any = true;
              } else if (t == m) {
                at = fmaxf(at, tid); au = fmaxf(au, u); av = fmaxf(av, vv); af = fmaxf(af, fr);
              }
            }
            if (any) { bt = m; btri = at; bu = au; bv = av; bf = af; }
          }
        }
      }
      __syncthreads();
      cnt = s_cnt_nxt;
      cur = nxt;
      __syncthreads();       // every thread read s_cnt_nxt before it is reset
    }
  }
  const size_t o = (size_t)b * PIX + p;
  out_t[o] = bt;
  out_tri[o] = btri;
  out_u[o] = bu;
  out_v[o] = bv;
  out_f[o] = bf;
  if (p == 0) ovf[b] = s_ovf ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int hr_closest_hit_blocks(const void* rays, const void* table, void* t, void* tri,
                                     void* u, void* v, void* front, void* ovf, int T, int N,
                                     float t_min, void* stream) {
  (void)N;
  if (T > 0) {
    closest_blocks_kernel<<<T, PIX, 0, (cudaStream_t)stream>>>(
        (const float*)rays, (const float*)table, (float*)t, (float*)tri, (float*)u,
        (float*)v, (float*)front, (float*)ovf, t_min);
  }
  return (int)cudaGetLastError();
}
