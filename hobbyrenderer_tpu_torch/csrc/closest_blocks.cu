// Closest hit of sorted 1024-ray blocks (kernel K6 of the port).
//
// Replaces: hobbyrenderer_tpu/ops/trace.py::_closest_kernel / closest_hit_blocks
// (the Pallas TPU kernel). Same inputs and outputs:
//   rays  (T, 8, 1024) f32  rows [ox oy oz dx dy dz tmax act], one block of
//                           coherence-sorted rays each (ops/trace.py)
//   table (N, 128) f32      beam_table() of the 4-wide implicit-heap BVH:
//                           interior rows lanes 0:24 = 4 child boxes (lo3|hi3),
//                           leaf rows 4 x 16-lane [v0 e1 e2 tid pad6],
//                           lane 127 = leaf marker (rows >= I, the leaf start);
//                           children of q: 4q+1..4q+4
//   t, tri, u, v, front (T, 1024) f32  per lane: best t (tmax on a miss),
//                           triangle id (-1 on a miss), barycentrics, 1 if det > 0
//   ovf   (T,) f32          1 if a level's frontier dropped children (hits
//                           of that block may be missed)
//
// What it computes is ops/trace_kernel.py's plain version: a beam BFS of the
// tree per block (origin box x direction box of the block's active lanes,
// interval child-box tests), levels in order, each level in groups of 8 node
// rows, the cull bound cur_hi (max best t over the active lanes) read before
// each group, children appended in (row, child) order up to FCAP - 1 = 4,095
// a level, and per record slot the smallest t over the group's leaf rows with
// tri, u, v, front each the largest over the rows that tie at it. Every
// product and sum is rounded on its own (__fmul_rn / __fadd_rn, IEEE
// division), so the kernel equals the plain version bit for bit.
//
// The order it runs in. A level's frontier ascends (children 4q+1..4q+4 are
// appended in row order and a cut keeps a prefix) and leaves are the rows
// id >= I, so in every level the interior rows come before the leaf rows,
// and only leaf folds move cur_hi: every box test of a level sees the cur_hi
// of the level's start. So the kernel reads cur_hi once a level, runs all
// of the level's box tests at once and appends their hits with a block-wide
// exclusive scan (the first FCAP - 1 in (row, child) order are kept, as the
// serial append kept them), then folds the level's leaf rows group by group
// in the plain version's order. tests/test_torch_k6_order.py emulates this
// order in plain PyTorch and holds it to the plain version.
//
// What bounds it on the H100: the fold. Every active lane tests the 4
// records of every leaf row its block's beam reaches (up to 4,095 rows a
// block, ~3e8 leaf-lane-rows on a 1080p GI bounce), each test a chain of
// separately rounded products and an IEEE division, ~116 SASS
// instructions; the rows read are a few hundred MB at most. So it is held
// by issue: by how many record tests it runs, how many instructions each
// takes, and how evenly the issue spreads over the 132 SMs.
//
// Design.
// - A block's 1,024 lanes are spread over a thread-block cluster of
//   CLUSTER = 4 CTAs of 256 threads (a lane a thread), so that a call of 64
//   or 127 blocks reaches every SM (clusters of 8 ran 4-40% slower). The
//   beam bounds and each level's cur_hi are cluster-wide reductions: each
//   CTA puts its partial in its shared memory, one cluster barrier, then
//   every CTA reads all 4 partials over distributed shared memory (min /
//   max, order-free).
// - Rank 0 runs a level's box tests, a row a thread (the row's 96-byte box
//   lanes), and appends the hits with a warp scan and a scan over the
//   warps into its frontier (2 x 4,096 ids in shared memory); after a
//   cluster barrier the other CTAs copy the next frontier from it over
//   distributed shared memory (2.5% faster on the GI bounce than every CTA
//   building it). A last cluster barrier keeps every CTA's shared memory
//   alive until its peers' reads are done.
// - The leaf rows (their 4 records, the first 240 B of the row) are staged
//   in shared memory in chunks of 32 rows (4 groups) by cp.async.bulk
//   copies that complete on an mbarrier, double-buffered: the next chunk's
//   copies are in flight while the lanes fold this one; one CTA barrier a
//   chunk frees its buffer.
// - The fold tests fewer records, exactly: a warp whose directions lie
//   within SPREAD_MAX of each other first bounds, for each record of the
//   group (a record a lane), the values its lanes would compute for det
//   and for u's, v's and t's numerators (record_may_hit: interval bounds
//   that hold for round-to-nearest), and skips the records that cannot
//   pass h on any of its lanes; a lane stops a record test once u's or v's
//   numerator shows h false, before the division (fold_group).
// - __launch_bounds__(NT, 3): up to 85 registers, 3 CTAs (24 warps) an
//   SM. At 64 registers (32 warps an SM) the fold's state spilled and the
//   GI bounce call ran 16% slower (PERF.md §6, K6).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int PIX = 1024;
constexpr int W = 128;
constexpr int GW = 8;
constexpr int FCAP = 4096;
constexpr int CLUSTER = 4;           // CTAs a block (ops/trace_kernel.py: CLUSTER)
constexpr int NT = PIX / CLUSTER;    // a CTA's lanes, a lane a thread
constexpr int NWARPS = NT / 32;
constexpr int REC = 60;              // staged floats of a leaf row: 4 records at 16k
constexpr int REC_BYTES = REC * 4;   // 240, a multiple of 16 as cp.async.bulk needs
constexpr int CH = 32;               // leaf rows a stage: 4 groups
constexpr float BIG = 3.0e37f;
constexpr float EPS = 1e-8f;
constexpr float ONE_EPS = 1.00000012f;     // f32(1 + 1e-7)
constexpr float SPREAD_MAX = 0.2f;   // direction spread of a warp that culls records
constexpr unsigned FULL = 0xffffffffu;

struct Shared {
  float stage[2][CH * REC];          // 2 x 7,680 B (16-B aligned: first member)
  int frontier[2][FCAP];             // 32 KB
  unsigned long long bar[2];         // the stages' mbarriers
  float red[13][NWARPS];             // per-warp partials of the bounds
  float xch[2][16];                  // this CTA's partials, read by the cluster
  float bounds[21];                  // olo dlo ohi dhi (12), ilo ihi (6), ivalid (3)
  int wsum[2][NWARPS];               // scan over warps, double-buffered by pass
  int cnt_x[2];                      // rank 0's hit count a level, read by the cluster
  float wbox[NWARPS][16];            // a warp's ray box: lo of o d (6), hi (6), max |.|
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// -inf: the neutral element of max
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also announces `bytes` of copies to come.
__device__ __forceinline__ void bar_expect(unsigned long long* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1], %2, [%3];"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Stage chunk `c` of the level's leaf rows (frontier positions
// [pos0, pos0 + CH) within [lo, hi)) into `buf`: lane j of warp 0 copies
// the row at pos0 + j; lane 0 first announces the bytes.
__device__ __forceinline__ void issue_chunk(Shared& sm, const float* __restrict__ table,
                                            const int* ids, int pos0, int lo, int hi,
                                            int buf, int lane) {
  const int first = max(pos0, lo), last = min(pos0 + CH, hi);
  if (lane == 0) bar_expect(&sm.bar[buf], (uint32_t)((last - first) * REC_BYTES));
  __syncwarp();
  const int pos = pos0 + lane;
  if (pos >= first && pos < last) {
    bulk_copy(&sm.stage[buf][lane * REC], table + (size_t)ids[pos] * W, REC_BYTES,
              &sm.bar[buf]);
  }
}

// The 4 child-box interval tests of interior row `id`: bit ch set on a hit.
__device__ __forceinline__ unsigned box_hits(const float* __restrict__ table, int id,
                                             const float* bnd, float cur_hi) {
  const float4* row = reinterpret_cast<const float4*>(table + (size_t)id * W);
  float box[24];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float4 q = __ldg(row + i);
    box[4 * i] = q.x;
    box[4 * i + 1] = q.y;
    box[4 * i + 2] = q.z;
    box[4 * i + 3] = q.w;
  }
  unsigned bits = 0;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    float t_en = 0.0f, t_ex = cur_hi;
    bool ok = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float olo = bnd[a], dlo = bnd[3 + a], ohi = bnd[6 + a], dhi = bnd[9 + a];
      const float ilo = bnd[12 + a], ihi = bnd[15 + a];
      const bool ivalid = bnd[18 + a] > 0.5f;
      const float blo = box[6 * ch + a], bhi = box[6 * ch + 3 + a];
      ok = ok && (blo <= bhi);
      const float p_lo = sub(blo, ohi);
      const float p_hi = sub(bhi, olo);
      const float c1 = mul(p_lo, ilo), c2 = mul(p_lo, ihi);
      const float c3 = mul(p_hi, ilo), c4 = mul(p_hi, ihi);
      const float lo4 = fminf(fminf(c1, c2), fminf(c3, c4));
      const float hi4 = fmaxf(fmaxf(c1, c2), fmaxf(c3, c4));
      if (ivalid) {
        t_en = fmaxf(t_en, lo4);
        t_ex = fminf(t_ex, hi4);
      }
      const float reach_lo = add(olo, mul(fminf(dlo, 0.0f), cur_hi));
      const float reach_hi = add(ohi, mul(fmaxf(dhi, 0.0f), cur_hi));
      ok = ok && (ivalid || ((reach_hi >= blo) && (reach_lo <= bhi)));
    }
    if (ok && (t_en <= t_ex) && (t_ex > 0.0f)) bits |= 1u << ch;
  }
  return bits;
}

// Interval bounds of a lane's computed values over the lanes of a warp.
// Round-to-nearest is monotone, so where a lane computes fl(a op b) from a
// in [al, ah] and b in [bl, bh], the result lies between the rounded
// results at the interval's corners: the bounds below are of the values the
// lanes compute, roundings included, not of the exact ones.
struct Iv { float lo, hi; };
__device__ __forceinline__ Iv iv_mul(Iv a, float c) {
  const float x = mul(a.lo, c), y = mul(a.hi, c);
  return {fminf(x, y), fmaxf(x, y)};
}
__device__ __forceinline__ Iv iv_mul(Iv a, Iv b) {
  const float w = mul(a.lo, b.lo), x = mul(a.lo, b.hi), y = mul(a.hi, b.lo), z = mul(a.hi, b.hi);
  return {fminf(fminf(w, x), fminf(y, z)), fmaxf(fmaxf(w, x), fmaxf(y, z))};
}
__device__ __forceinline__ Iv iv_add(Iv a, Iv b) { return {add(a.lo, b.lo), add(a.hi, b.hi)}; }
__device__ __forceinline__ Iv iv_sub(Iv a, Iv b) { return {sub(a.lo, b.hi), sub(a.hi, b.lo)}; }
__device__ __forceinline__ Iv iv_sub(Iv a, float c) { return {sub(a.lo, c), sub(a.hi, c)}; }

// True where a numerator n = u's or v's (over d = det, of one sign, |d| >
// 1e-12 on every lane) makes h false on every lane: n / d < -1e-7 or > 1 +
// 1e-7 whatever the other barycentric (the margins of the lane's own
// pre-test in fold_group).
__device__ __forceinline__ bool iv_bary_out(Iv n, Iv d, bool pos) {
  const float amax = pos ? d.hi : -d.lo;                    // the largest |det|
  const bool n_pos = n.lo > 0.0f, n_neg = n.hi < 0.0f;
  const bool opp = pos ? n_neg : n_pos, same = pos ? n_pos : n_neg;
  const float amin_n = n_pos ? n.lo : -n.hi;                // the smallest |n|
  return (opp && amin_n > mul(4e-7f, amax)) || (same && amin_n > mul(1.000001f, amax));
}

// Whether some active lane of the warp (its rays in the box `wb`: lo of ox
// oy oz dx dy dz, then hi) may find h true on record `rec`: false only where
// bounds of the lane's own computed det, u's and v's numerators and t's
// numerator prove h false on every lane (tid < 0; |det| <= 1e-12; u or v out
// of range; t <= 0 <= t_min). Inputs of 1e9 or more in magnitude are never
// culled, so that no bound overflows.
__device__ __forceinline__ bool record_may_hit(const float* rec, const float* wb, bool t_pos) {
  const float4 a0 = *reinterpret_cast<const float4*>(rec);
  const float4 a1 = *reinterpret_cast<const float4*>(rec + 4);
  const float2 a2 = *reinterpret_cast<const float2*>(rec + 8);
  const float v0x = a0.x, v0y = a0.y, v0z = a0.z;
  const float e1x = a0.w, e1y = a1.x, e1z = a1.y;
  const float e2x = a1.z, e2y = a1.w, e2z = a2.x;
  if (!(a2.y >= 0.0f)) return false;                       // h needs tid >= 0
  float big = fmaxf(fmaxf(fabsf(v0x), fabsf(v0y)), fabsf(v0z));
  big = fmaxf(big, fmaxf(fmaxf(fabsf(e1x), fabsf(e1y)), fabsf(e1z)));
  big = fmaxf(big, fmaxf(fmaxf(fabsf(e2x), fabsf(e2y)), fabsf(e2z)));
  if (!(big < 1e9f) || !(wb[12] < 1e9f)) return true;
  const Iv ox = {wb[0], wb[6]}, oy = {wb[1], wb[7]}, oz = {wb[2], wb[8]};
  const Iv dx = {wb[3], wb[9]}, dy = {wb[4], wb[10]}, dz = {wb[5], wb[11]};
  const Iv px = iv_sub(iv_mul(dy, e2z), iv_mul(dz, e2y));
  const Iv py = iv_sub(iv_mul(dz, e2x), iv_mul(dx, e2z));
  const Iv pz = iv_sub(iv_mul(dx, e2y), iv_mul(dy, e2x));
  const Iv det = iv_add(iv_add(iv_mul(px, e1x), iv_mul(py, e1y)), iv_mul(pz, e1z));
  if (det.lo >= -1e-12f && det.hi <= 1e-12f) return false;  // |det| <= 1e-12: okd false
  const bool pos = det.lo > 1e-12f;
  if (!pos && !(det.hi < -1e-12f)) return true;             // det's sign or okd unknown
  const Iv sx = iv_sub(ox, v0x), sy = iv_sub(oy, v0y), sz = iv_sub(oz, v0z);
  const Iv un = iv_add(iv_add(iv_mul(sx, px), iv_mul(sy, py)), iv_mul(sz, pz));
  if (iv_bary_out(un, det, pos)) return false;
  const Iv qx = iv_sub(iv_mul(sy, e1z), iv_mul(sz, e1y));
  const Iv qy = iv_sub(iv_mul(sz, e1x), iv_mul(sx, e1z));
  const Iv qz = iv_sub(iv_mul(sx, e1y), iv_mul(sy, e1x));
  const Iv vn = iv_add(iv_add(iv_mul(dx, qx), iv_mul(dy, qy)), iv_mul(dz, qz));
  if (iv_bary_out(vn, det, pos)) return false;
  if (t_pos) {                  // t = tn * (1/det) <= 0 where tn's sign opposes det's
    const Iv tn = iv_add(iv_add(iv_mul(qx, e2x), iv_mul(qy, e2y)), iv_mul(qz, e2z));
    if (pos ? tn.hi <= 0.0f : tn.lo >= 0.0f) return false;
  }
  return true;
}

// Fold the staged leaf rows r_lo <= r < r_hi of one group (rows at `rows`,
// REC floats apart) into the lane's best hit, record slot by record slot,
// the rows of slot k in ascending order, skipping those whose bit 8k + r is
// clear in `mask` (records that cannot pass h on any lane of the warp).
// The test computes the plain version's values in another order and stops
// where h is already certain to be false: after det and u's numerator
// (un = s . p; u = un * (1/det) has the sign of un * det, and |u| exceeds
// 4e-7 where |un| > 4e-7 |det| even after the three roundings, or 1 + 6e-7
// where |un| > 1.000001 |det|: then u < -1e-7, or u + v > 1 + 1e-7 for any
// v >= -1e-7; each rounding is within 2^-24 relative, 1/det's within 5e-7
// where it is subnormal), and after v's numerator (vn = d . q, the same
// bounds); only then comes the division.
__device__ __forceinline__ void fold_group(const float* rows, int r_lo, int r_hi,
                                           unsigned mask, float ox, float oy, float oz,
                                           float dx, float dy, float dz, float tmax,
                                           float t_min, float& bt, float& btri, float& bu,
                                           float& bv, float& bf) {
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    float m = BIG, at = 0.0f, au = 0.0f, av = 0.0f, af = 0.0f;
    bool any = false;
    const float tlim = fminf(tmax, bt);     // t < tmax && t < bt  <=>  t < tlim
    const unsigned keep = mask >> (8 * k);
#pragma unroll 1
    for (int r = r_lo; r < r_hi; ++r) {
      if (!((keep >> r) & 1u)) continue;
      const float4* rec4 = reinterpret_cast<const float4*>(rows + r * REC + 16 * k);
      const float4 a0 = rec4[0], a1 = rec4[1];
      const float2 a2 = *reinterpret_cast<const float2*>(rec4 + 2);
      const float v0x = a0.x, v0y = a0.y, v0z = a0.z;
      const float e1x = a0.w, e1y = a1.x, e1z = a1.y;
      const float e2x = a1.z, e2y = a1.w, e2z = a2.x;
      const float tid = a2.y;
      const float px = sub(mul(dy, e2z), mul(dz, e2y));
      const float py = sub(mul(dz, e2x), mul(dx, e2z));
      const float pz = sub(mul(dx, e2y), mul(dy, e2x));
      const float det = add(add(mul(e1x, px), mul(e1y, py)), mul(e1z, pz));
      const bool okd = fabsf(det) > 1e-12f;
      const float sx = sub(ox, v0x), sy = sub(oy, v0y), sz = sub(oz, v0z);
      const float un = add(add(mul(sx, px), mul(sy, py)), mul(sz, pz));
      {
        const float ad = fabsf(det);
        const bool opp = (un < 0.0f) != (det < 0.0f);
        if (!okd || fabsf(un) > mul(opp ? 4e-7f : 1.000001f, ad)) continue;
      }
      const float qx = sub(mul(sy, e1z), mul(sz, e1y));
      const float qy = sub(mul(sz, e1x), mul(sx, e1z));
      const float qz = sub(mul(sx, e1y), mul(sy, e1x));
      const float vn = add(add(mul(dx, qx), mul(dy, qy)), mul(dz, qz));
      {
        const bool opp = (vn < 0.0f) != (det < 0.0f);
        if (fabsf(vn) > mul(opp ? 4e-7f : 1.000001f, fabsf(det))) continue;
      }
      const float inv_det = okd ? 1.0f / det : 0.0f;
      const float u = mul(un, inv_det);
      const float vv = mul(vn, inv_det);
      const float t = mul(add(add(mul(e2x, qx), mul(e2y, qy)), mul(e2z, qz)), inv_det);
      const bool h = okd && (u >= -1e-7f) && (vv >= -1e-7f) && (add(u, vv) <= ONE_EPS)
          && (t > t_min) && (t < tlim) && (tid >= 0.0f);
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

__global__ void __launch_bounds__(NT, 3)
closest_blocks_kernel(const float* __restrict__ rays, const float* __restrict__ table,
                      float* __restrict__ out_t, float* __restrict__ out_tri,
                      float* __restrict__ out_u, float* __restrict__ out_v,
                      float* __restrict__ out_f, float* __restrict__ ovf, int I,
                      float t_min, unsigned long long* __restrict__ work) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Shared& sm = *reinterpret_cast<Shared*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / CLUSTER;
  const int p = rank * NT + tid;          // the lane in the ray block
  const float* ray = rays + (size_t)b * 8 * PIX + p;
  const float ox = ray[0], oy = ray[PIX], oz = ray[2 * PIX];
  const float dx = ray[3 * PIX], dy = ray[4 * PIX], dz = ray[5 * PIX];
  const float tmax = ray[6 * PIX];
  const bool act = ray[7 * PIX] > 0.5f;
  float bt = tmax, btri = -1.0f, bu = 0.0f, bv = 0.0f, bf = 0.0f;

  if (tid == 0) {
    bar_init(&sm.bar[0]);
    bar_init(&sm.bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  bool warp_cull;
  // ---- the block's beam bounds over its active lanes: this CTA's, then
  // the cluster's (exchange round 0) ----
  {
    const float v[6] = {ox, oy, oz, dx, dy, dz};
    float mag = 0.0f, spread = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float lo = warp_min(act ? v[j] : BIG);
      const float hi = warp_max(act ? v[j] : -BIG);
      mag = fmaxf(mag, fmaxf(fabsf(lo), fabsf(hi)));
      if (j >= 3) spread = fmaxf(spread, hi - lo);
      if (lane == 0) {
        sm.red[j][warp] = lo;
        sm.red[6 + j][warp] = hi;
        sm.wbox[warp][j] = lo;
        sm.wbox[warp][6 + j] = hi;
      }
    }
    if (lane == 0) sm.wbox[warp][12] = mag;
    // the warp tests records against its ray box only where its directions
    // are close enough for the bounds to cull (a wide cone culls nothing)
    warp_cull = spread <= SPREAD_MAX;
    const unsigned any_w = __ballot_sync(FULL, act);
    if (lane == 0) sm.red[12][warp] = any_w ? 1.0f : 0.0f;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < 13; ++j) {
      const float x = lane < NWARPS ? sm.red[j][lane] : (j < 6 ? BIG : neg_inf());
      const float r = j < 6 ? warp_min(x) : warp_max(x);
      if (lane == 0) sm.xch[0][j] = r;
    }
  }
  cluster.sync();
  float bnd[13];
#pragma unroll
  for (int j = 0; j < 13; ++j) bnd[j] = j < 6 ? BIG : neg_inf();
  for (int q = 0; q < CLUSTER; ++q) {
    const float* peer = cluster.map_shared_rank(&sm.xch[0][0], q);
#pragma unroll
    for (int j = 0; j < 13; ++j) bnd[j] = j < 6 ? fminf(bnd[j], peer[j]) : fmaxf(bnd[j], peer[j]);
  }
  const bool any_act = bnd[12] > 0.5f;
  const int warp_lanes = __popc(__ballot_sync(FULL, act));   // the warp's active lanes
  const bool warp_act = warp_lanes > 0;            // whether the warp folds at all
  if (tid == 0) {
    // [olo dlo ohi dhi] as the bounds' order: olo = 0..2, dlo = 3..5,
    // ohi = 6..8, dhi = 9..11; then ilo, ihi, ivalid
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float dlo = bnd[3 + a], dhi = bnd[9 + a];
      const bool pos = dlo > EPS;
      const bool neg = dhi < -EPS;
      sm.bounds[a] = bnd[a];
      sm.bounds[3 + a] = dlo;
      sm.bounds[6 + a] = bnd[6 + a];
      sm.bounds[9 + a] = dhi;
      sm.bounds[12 + a] = pos ? 1.0f / fmaxf(dhi, EPS) : 1.0f / fminf(dlo, -EPS);
      sm.bounds[15 + a] = pos ? 1.0f / fmaxf(dlo, EPS) : 1.0f / fminf(dhi, -EPS);
      sm.bounds[18 + a] = (pos || neg) ? 1.0f : 0.0f;
    }
    sm.frontier[0][0] = 0;
  }
  __syncthreads();

  int round = 1;                 // the next exchange round (its xch buffer: round & 1)
  bool dropped = false;
  if (any_act) {
    int cur = 0, cnt = 1;
    uint32_t uses[2] = {0u, 0u};   // completed phases of each stage's mbarrier
    while (cnt > 0) {
      const int nxt = 1 - cur;
      const int* ids = sm.frontier[cur];
      // interior rows are the prefix of ids below I (the frontier ascends)
      int n_int = 0;
      {
        int lo = 0, hi = cnt;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (ids[mid] < I) lo = mid + 1; else hi = mid;
        }
        n_int = lo;
      }
      int cnt_nxt = 0;
      if (n_int > 0) {
        // cur_hi over the cluster's active lanes, once a level
        const float c = warp_max(act ? bt : 0.0f);
        if (lane == 0) sm.red[0][warp] = c;
        __syncthreads();
        if (warp == 0) {
          const float r = warp_max(lane < NWARPS ? sm.red[0][lane] : neg_inf());
          if (lane == 0) sm.xch[round & 1][0] = r;
        }
        cluster.sync();
        float cur_hi = neg_inf();
        for (int q = 0; q < CLUSTER; ++q)
          cur_hi = fmaxf(cur_hi, *cluster.map_shared_rank(&sm.xch[round & 1][0], q));
        ++round;
        // the level's box tests in rank 0, a row a thread; hits appended in
        // (row, child) order by an exclusive scan over the CTA
        int running = 0;
        for (int base = 0, pass = 0; base < (rank == 0 ? n_int : 0); base += NT, ++pass) {
          const int i = base + tid;
          const int id = i < n_int ? ids[i] : 0;
          const unsigned bits = i < n_int ? box_hits(table, id, sm.bounds, cur_hi) : 0u;
          const int n = __popc(bits);
          int x = n;
#pragma unroll
          for (int s = 1; s < 32; s <<= 1) {
            const int y = __shfl_up_sync(FULL, x, s);
            if (lane >= s) x += y;
          }
          int* ws = sm.wsum[pass & 1];
          if (lane == 31) ws[warp] = x;
          __syncthreads();
          if (warp == 0) {
            int v = lane < NWARPS ? ws[lane] : 0;
#pragma unroll
            for (int s = 1; s < 32; s <<= 1) {
              const int y = __shfl_up_sync(FULL, v, s);
              if (lane >= s) v += y;
            }
            if (lane < NWARPS) ws[lane] = v;
          }
          __syncthreads();
          int pos = running + (warp > 0 ? ws[warp - 1] : 0) + x - n;
#pragma unroll
          for (int ch = 0; ch < 4; ++ch) {
            if (bits & (1u << ch)) {
              if (pos < FCAP - 1) sm.frontier[nxt][pos] = 4 * id + 1 + ch;
              ++pos;
            }
          }
          running += ws[NWARPS - 1];
        }
        // the other CTAs copy rank 0's next frontier over DSMEM (rank 0
        // writes that buffer again two levels on, after they passed the
        // next level's barriers)
        if (rank == 0 && tid == 0) sm.cnt_x[round & 1] = running;
        cluster.sync();
        if (rank != 0) {
          running = *cluster.map_shared_rank(&sm.cnt_x[round & 1], 0);
          const int n4 = (min(running, FCAP - 1) + 3) / 4;
          const int4* src =
              reinterpret_cast<const int4*>(cluster.map_shared_rank(&sm.frontier[nxt][0], 0));
          int4* dst = reinterpret_cast<int4*>(sm.frontier[nxt]);
          for (int i = tid; i < n4; i += NT) dst[i] = src[i];
        }
        dropped = dropped || running > FCAP - 1;
        cnt_nxt = min(running, FCAP - 1);
      }
      if (cnt > n_int) {
        // the leaf rows [n_int, cnt), in groups of 8 frontier positions,
        // staged 4 groups at a time
        const int g0 = n_int / GW;
        const int n_chunks = ((cnt - 1) / GW - g0) / (CH / GW) + 1;
        if (warp == 0) issue_chunk(sm, table, ids, g0 * GW, n_int, cnt, 0, lane);
        for (int c = 0; c < n_chunks; ++c) {
          const int buf = c & 1;
          const int pos0 = (g0 + c * (CH / GW)) * GW;
          if (c + 1 < n_chunks && warp == 0)
            issue_chunk(sm, table, ids, pos0 + CH, n_int, cnt, 1 - buf, lane);
          bar_wait(&sm.bar[buf], uses[buf] & 1u);
          ++uses[buf];
          if (warp_act) {
#pragma unroll 1
            for (int gg = 0; gg < CH / GW; ++gg) {
              const int gp = pos0 + gg * GW;
              const int r_lo = max(n_int - gp, 0), r_hi = min(cnt - gp, GW);
              if (r_hi <= 0) break;
              const float* grp = &sm.stage[buf][gg * GW * REC];
              unsigned mask = FULL;
              if (warp_cull) {       // lane 8k + r asks whether record (r, k) may hit
                const int r = lane & 7, k = lane >> 3;
                mask = __ballot_sync(FULL, r >= r_lo && r < r_hi &&
                                     record_may_hit(grp + r * REC + 16 * k, sm.wbox[warp],
                                                    t_min >= 0.0f));
              }
              if (work != nullptr && lane == 0) {     // the work counts, when asked for
                const unsigned rows = ((1u << r_hi) - 1u) & ~((1u << r_lo) - 1u);
                const unsigned kept = __popc(mask & rows * 0x01010101u), all = 4 * __popc(rows);
                atomicAdd(&work[0], (unsigned long long)kept * warp_lanes);
                atomicAdd(&work[1], (unsigned long long)(all - kept) * warp_lanes);
                if (warp_cull) atomicAdd(&work[2], (unsigned long long)all);
              }
              if (act && mask)
                fold_group(grp, r_lo, r_hi, mask, ox, oy, oz, dx, dy, dz, tmax, t_min, bt, btri,
                           bu, bv, bf);
            }
          }
          __syncthreads();       // this buffer's rows read before it is refilled
        }
      }
      __syncthreads();           // the next frontier written, this one read
      cnt = cnt_nxt;
      cur = nxt;
    }
  }
  const size_t o = (size_t)b * PIX + p;
  out_t[o] = bt;
  out_tri[o] = btri;
  out_u[o] = bu;
  out_v[o] = bv;
  out_f[o] = bf;
  if (rank == 0 && tid == 0) ovf[b] = dropped ? 1.0f : 0.0f;
  cluster.sync();                // the peers' reads of this CTA's xch are done
}

// The launch: T * CLUSTER CTAs of NT threads, clusters of CLUSTER, the
// shared block in dynamic shared memory (its limit raised on first use).
cudaError_t closest_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int T,
                           cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        closest_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Shared));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(T * CLUSTER));
  cfg.blockDim = dim3((unsigned)NT);
  cfg.dynamicSmemBytes = sizeof(Shared);
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

cudaError_t closest_max_clusters(int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t e = closest_config(cfg, attr, 1, 0);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(n, (const void*)closest_blocks_kernel, &cfg);
}

}  // namespace

extern "C" {

// rays (T, 8, 1024), table (N, 128), t / tri / u / v / front (T, 1024),
// ovf (T,), all f32; I the table's first leaf row; work null, or (3,) u64
// zeroed, to which the kernel adds the lane record tests it runs, those
// the warp cull skips, and the warp cull's record bounds
int hr_closest_hit_blocks(const void* rays, const void* table, void* t, void* tri, void* u,
                          void* v, void* front, void* ovf, void* work, int T, int N, int I,
                          float t_min, void* stream) {
  (void)N;
  if (T <= 0) return (int)cudaGetLastError();
  static bool placed = false;  // a cluster was found placeable
  if (!placed) {
    int n = 0;
    const cudaError_t e = closest_max_clusters(&n);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;   // no SM group can hold one
    placed = true;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = closest_config(cfg, attr, T, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, closest_blocks_kernel, (const float*)rays, (const float*)table,
                         (float*)t, (float*)tri, (float*)u, (float*)v, (float*)front,
                         (float*)ovf, I, t_min, (unsigned long long*)work);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of the kernel the card holds at once, into *n
int hr_closest_hit_blocks_max_clusters(void* n) {
  return (int)closest_max_clusters((int*)n);
}

}  // extern "C"
