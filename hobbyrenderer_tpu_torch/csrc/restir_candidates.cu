// ReSTIR DI initial candidates (kernel K2 of the port).
//
// Replaces: hobbyrenderer_tpu/ops/restir_pallas.py::_kernel /
// restir_candidates (the fused Pallas TPU kernel). Same inputs and outputs:
//   flat3  (T, 18, 128) f32  presample tiles, channel-major slots: packed
//                            light row (16), inv_pdf, light id (as f32)
//   tsel   (Hp, nseg) i32    tile of each (scanline, 128-px segment)
//   planes (12, Hp, Wp) f32  px py pz nx ny nz albedo_rgb rough metal valid
//   cam    (3,) f32          camera position (read on the device)
//   y, u, v, w_sum (Hp, Wp) f32 and row (Hp, 16, Wp) f32: the reservoir
//                            after N streaming-RIS candidates
// Candidate c of the pixel at segment rank p reads slot (p + 17c) % 128 of
// its scanline's tile; the counter RNG is pcg3d(gy * w_log + gx, frame,
// 100 + c) with gy the global row and w_log the logical width, and bits turn
// into [0, 1) as the top 24 bits times 2^-24 (the TPU kernel's _u01).
//
// What bounds it on the H100: instruction issue. Its bytes (12 G-buffer
// floats in, 20 out a pixel, ~0.08 ms at 3.35 TB/s) are far below the
// ~440 SASS instructions a candidate issues (bench_k2k4.sass_counts): the
// IEEE divides and square roots (the library is built with -fmad=false and
// IEEE '/' and sqrtf, so that it stays bit-exact with the plain version)
// and the products of the light and the GGX terms.
//
// Design: a block of 128 threads takes one scanline segment, a thread a
// pixel. The block copies its tile (18 x 128 f32) into shared memory and
// adds 7 channels a slot that depend on the light slot alone (the emissive
// triangle's normal, its 1/|n| and area, max(range, 1e-4) and the spot
// denominator), computed once a slot instead of once a (pixel, candidate)
// and with the same operations in the same order. Every candidate then
// reads its slot from shared memory, conflict-free since neighbouring
// threads read neighbouring slots, and evaluates only its slot's kind of
// light (emissive triangle or analytic) before the GGX p-hat. All N
// candidates run in registers and the reservoir keeps only the winner's
// slot; the winner's 16-channel row is copied from shared memory once, at
// the end. The arithmetic is the plain version's, operation for operation,
// with rsqrt written as 1/sqrt, so the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG = 128;
constexpr int CH = 18;
constexpr float MIN_ROUGH = 0.03f;
constexpr float F0 = 0.04f;
constexpr float LUM0 = 0.2126f, LUM1 = 0.7152f, LUM2 = 0.0722f;
constexpr float PI_ = 3.14159265f;
constexpr float INV_PI = (float)(1.0 / 3.14159265);

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float rsq(float x) { return 1.0f / sqrtf(x); }

__device__ __forceinline__ void pcg3d(uint32_t& x, uint32_t& y, uint32_t& z) {
  x = x * 1664525u + 1013904223u;
  y = y * 1664525u + 1013904223u;
  z = z * 1664525u + 1013904223u;
  x += y * z; y += z * x; z += x * y;
  x ^= x >> 16; y ^= y >> 16; z ^= z >> 16;
  x += y * z; y += z * x; z += x * y;
}

__device__ __forceinline__ float u01(uint32_t b) {
  return (float)(int)(b >> 8) * 5.960464477539063e-08f;
}

__device__ __forceinline__ float shade(float f0c, float dc, float radc, float fr5,
                                       float DV, float ndl) {
  const float F = f0c + (1.0f - f0c) * fr5;
  return (((1.0f - F) * dc * INV_PI + DV * F) * ndl) * radc;
}

constexpr int XCH = 7;                          // per-slot channels after the CH
constexpr int CHS = CH + XCH;

// What a pixel brings to every candidate (the per-pixel set-up).
struct Pixel {
  float px, py, pz, nx, ny, nz, vx, vy, vz, ndv, a2, dr, dg, db, f0r, f0g, f0b, smith_v, valid;
};

// p-hat of one candidate: the slot's channels ch (stride SEG, with the
// per-slot terms), only the slot's kind of light, then the GGX BRDF *
// NdotL; the plain version's operations in its order (it evaluates both
// kinds and selects, which gives the same bits).
__device__ __forceinline__ float phat(const float* ch, const Pixel& q, float u_u, float u_v) {
#define CHN(k) ch[(k) * SEG]
  const bool is_em = CHN(13) > 0.5f;
  float Lx, Ly, Lz, rr, rg2, rb;
  if (is_em) {
    const bool over = (u_u + u_v) > 1.0f;
    const float uu = over ? 1.0f - u_u : u_u;
    const float vv = over ? 1.0f - u_v : u_v;
    const float plx = CHN(1) + uu * CHN(4) + vv * CHN(7) - q.px;
    const float ply = CHN(2) + uu * CHN(5) + vv * CHN(8) - q.py;
    const float plz = CHN(3) + uu * CHN(6) + vv * CHN(9) - q.pz;
    const float d2e = fmaxf(plx * plx + ply * ply + plz * plz, 1e-8f);
    const float inv_de = rsq(d2e);
    Lx = plx * inv_de; Ly = ply * inv_de; Lz = plz * inv_de;
    const float cos_l = fabsf((CHN(CH) * Lx + CHN(CH + 1) * Ly + CHN(CH + 2) * Lz) * CHN(CH + 3));
    const float ge = cos_l * CHN(CH + 4) / d2e;
    rr = CHN(10) * ge; rg2 = CHN(11) * ge; rb = CHN(12) * ge;
  } else {
    const bool is_dir = CHN(0) < 0.5f;
    const bool is_spot = CHN(0) > 1.5f;
    const float tlx = is_dir ? -CHN(4) : CHN(1) - q.px;
    const float tly = is_dir ? -CHN(5) : CHN(2) - q.py;
    const float tlz = is_dir ? -CHN(6) : CHN(3) - q.pz;
    const float d2a = fmaxf(tlx * tlx + tly * tly + tlz * tlz, 1e-16f);
    const float inv_da = rsq(d2a);
    Lx = tlx * inv_da; Ly = tly * inv_da; Lz = tlz * inv_da;
    const float dist_a = d2a * inv_da;
    const float xr = clip(dist_a / CHN(CH + 5), 0.0f, 1.0f);
    float fall = 1.0f - xr * xr * xr * xr;
    fall = clip(fall * fall, 0.0f, 1.0f);
    float atten = is_dir ? 1.0f : fall / fmaxf(d2a, 1e-4f);
    const float cd = -(Lx * CHN(4) + Ly * CHN(5) + Lz * CHN(6));
    const float spot = clip((cd - CHN(12)) / CHN(CH + 6), 0.0f, 1.0f);
    if (is_spot) atten = atten * spot * spot;
    rr = CHN(7) * atten; rg2 = CHN(8) * atten; rb = CHN(9) * atten;
  }
  float hx = q.vx + Lx, hy = q.vy + Ly, hz = q.vz + Lz;
  const float hn = rsq(fmaxf(hx * hx + hy * hy + hz * hz, 1e-12f));
  hx = hx * hn; hy = hy * hn; hz = hz * hn;
  const float ndl = fmaxf(q.nx * Lx + q.ny * Ly + q.nz * Lz, 0.0f);
  const float ndh = fmaxf(q.nx * hx + q.ny * hy + q.nz * hz, 0.0f);
  const float vdh = fmaxf(q.vx * hx + q.vy * hy + q.vz * hz, 0.0f);
  const float dterm = ndh * ndh * (q.a2 - 1.0f) + 1.0f;
  const float D = q.a2 / fmaxf(PI_ * dterm * dterm, 1e-8f);
  const float gv = ndl * q.smith_v;
  const float gl = q.ndv * sqrtf(fmaxf(ndl * ndl * (1.0f - q.a2) + q.a2, 1e-8f));
  const float Vis = 0.5f / fmaxf(gv + gl, 1e-8f);
  float fr5 = clip(1.0f - vdh, 0.0f, 1.0f);
  fr5 = fr5 * fr5 * fr5 * fr5 * fr5;
  const float DV = D * Vis;
  float ph = LUM0 * shade(q.f0r, q.dr, rr, fr5, DV, ndl)
      + LUM1 * shade(q.f0g, q.dg, rg2, fr5, DV, ndl) + LUM2 * shade(q.f0b, q.db, rb, fr5, DV, ndl);
  if (!(q.valid > 0.5f && CHN(17) >= 0.0f)) ph = 0.0f;
  return ph;
#undef CHN
}

__global__ void __launch_bounds__(SEG)
restir_candidates_kernel(const float* __restrict__ flat3, const int* __restrict__ tsel,
                         const float* __restrict__ planes, const float* __restrict__ cam,
                         float* __restrict__ out_y, float* __restrict__ out_u,
                         float* __restrict__ out_v, float* __restrict__ out_w,
                         float* __restrict__ out_row, int Hp, int Wp, int T,
                         int num_candidates, uint32_t frame, int y0, int w_log) {
  __shared__ float tb[CHS * SEG];
  const int p = threadIdx.x;                    // segment rank
  const int j = blockIdx.x;                     // segment
  const int gyl = blockIdx.y;                   // local row
  const int gx = j * SEG + p;
  int tid = tsel[gyl * (Wp / SEG) + j];
  tid = min(max(tid, 0), T - 1);
  const float* src = flat3 + (size_t)tid * CH * SEG;
  for (int k = 0; k < CH; ++k) tb[k * SEG + p] = src[k * SEG + p];
  {
    const float* sc = tb + p;
#define CHN(k) sc[(k) * SEG]
    const float cxn = CHN(5) * CHN(9) - CHN(6) * CHN(8);
    const float cyn = CHN(6) * CHN(7) - CHN(4) * CHN(9);
    const float czn = CHN(8) * CHN(4) - CHN(5) * CHN(7);
    const float n2 = cxn * cxn + cyn * cyn + czn * czn;
    const float inv_n = rsq(fmaxf(n2, 1e-24f));
    tb[(CH + 0) * SEG + p] = cxn;
    tb[(CH + 1) * SEG + p] = cyn;
    tb[(CH + 2) * SEG + p] = czn;
    tb[(CH + 3) * SEG + p] = inv_n;
    tb[(CH + 4) * SEG + p] = 0.5f * n2 * inv_n;
    tb[(CH + 5) * SEG + p] = fmaxf(CHN(10), 1e-4f);
    tb[(CH + 6) * SEG + p] = fmaxf(CHN(11) - CHN(12), 1e-4f);
#undef CHN
  }
  __syncthreads();

  const size_t HW = (size_t)Hp * Wp;
  const size_t at = (size_t)gyl * Wp + gx;
  const float px = planes[at], py = planes[HW + at], pz = planes[2 * HW + at];
  const float nx = planes[3 * HW + at], ny = planes[4 * HW + at], nz = planes[5 * HW + at];
  const float ar = planes[6 * HW + at], ag = planes[7 * HW + at], ab = planes[8 * HW + at];
  const float rough = clip(planes[9 * HW + at], MIN_ROUGH, 1.0f);
  const float metal = planes[10 * HW + at];
  const float cx = cam[0], cy = cam[1], cz = cam[2];
  const float tvx = cx - px, tvy = cy - py, tvz = cz - pz;
  const float vn = rsq(fmaxf(tvx * tvx + tvy * tvy + tvz * tvz, 1e-12f));
  const float vx = tvx * vn, vy = tvy * vn, vz = tvz * vn;
  const float ndv = fmaxf(nx * vx + ny * vy + nz * vz, 1e-5f);
  const float alpha = rough * rough;
  const float a2 = alpha * alpha;
  const float inv_m = 1.0f - metal;
  const Pixel q = {px, py, pz, nx, ny, nz, vx, vy, vz, ndv, a2, ar * inv_m, ag * inv_m,
                   ab * inv_m, F0 * inv_m + ar * metal, F0 * inv_m + ag * metal,
                   F0 * inv_m + ab * metal, sqrtf(fmaxf(ndv * ndv * (1.0f - a2) + a2, 1e-8f)),
                   planes[11 * HW + at] > 0.5f ? 1.0f : 0.0f};
  const uint32_t pix = (uint32_t)((gyl + y0) * w_log + gx);

  float ry = -1.0f, ru = 0.0f, rv = 0.0f, w_sum = 0.0f;
  int win = -1;                                  // winner's slot
  for (int c = 0; c < num_candidates; ++c) {
    const int s = (p + 17 * c) % SEG;
    uint32_t b0 = pix, b1 = frame, b2 = (uint32_t)(100 + c);
    pcg3d(b0, b1, b2);
    const float u_r = u01(b0), u_u = u01(b1), u_v = u01(b2);
    // streaming RIS update
    const float w_c = phat(tb + s, q, u_u, u_v) * tb[16 * SEG + s];
    w_sum = w_sum + w_c;
    if ((u_r * fmaxf(w_sum, 1e-20f)) < w_c) {
      ry = tb[17 * SEG + s]; ru = u_u; rv = u_v; win = s;
    }
  }
  out_y[at] = ry;
  out_u[at] = ru;
  out_v[at] = rv;
  out_w[at] = w_sum;
  float* orow = out_row + (size_t)gyl * 16 * Wp + gx;
  for (int k = 0; k < 16; ++k) orow[(size_t)k * Wp] = win >= 0 ? tb[k * SEG + win] : 0.0f;
}

}  // namespace

extern "C" int hr_restir_candidates(const void* flat3, const void* tsel, const void* planes,
                                    const void* cam, void* y, void* u, void* v, void* w_sum,
                                    void* row, int Hp, int Wp, int T, int num_candidates,
                                    int frame, int y0, int w_log, void* stream) {
  if (Hp > 0 && Wp > 0)
    restir_candidates_kernel<<<dim3(Wp / SEG, Hp), SEG, 0, (cudaStream_t)stream>>>(
        (const float*)flat3, (const int*)tsel, (const float*)planes, (const float*)cam,
        (float*)y, (float*)u, (float*)v, (float*)w_sum, (float*)row, Hp, Wp, T,
        num_candidates, (uint32_t)frame, y0, w_log);
  return (int)cudaGetLastError();
}
