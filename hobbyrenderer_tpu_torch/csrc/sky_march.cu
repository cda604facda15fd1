// Sky radiance of the Bruneton-class atmosphere: the 32-step in-scatter
// march, one thread a lane (a kernel of the port alone).
//
// Replaces no TPU kernel: the JAX package marches the sky as XLA ops
// (hobbyrenderer_tpu/ops/atmosphere.py::sky_radiance_lut). The port's plain
// version, ops/atmosphere.py::sky_radiance_lut_reference, is ~270 PyTorch
// ops over (lanes, 32) and (lanes, 32, 3) tensors, ~40 KB of device memory
// traffic a lane for a direction in and a radiance out. Inputs and outputs:
//   d    (N, 3) f32   view directions (normalised here, as the plain version does)
//   mask (N,) u8      lanes to march, or null for all; a lane outside it reads 0
//   sun  (3,) f32     the direction sunlight travels (read on the device)
//   ms   (32, 32, 3) f32  the multiple-scattering table
//   out  (N, 3) f32   radiance
// The host scalars (observer radius, the table row of the observer, the
// sun's colour times intensity, the disk's cos and 1 / solid angle) come
// rounded to f32 as the plain version's ops round them.
//
// What bounds it on the H100: arithmetic. 25 bytes a lane in and out
// (~0.06 ms at 3.35 TB/s for 8.3M lanes) against 32 steps of 8 expf, an
// acosf, a powf, a sqrtf and a divide a lane, all at full precision.
//
// Design: a thread a lane, the march's state (the running optical depth of
// the three channels and four partial sums of the in-scatter a channel) in
// registers; nothing but the direction and the radiance touches device
// memory. The order of operations is the plain version's on the card, op
// for op, so the two agree bit for bit:
//   - a division by a Python scalar is PyTorch's product with the f32
//     reciprocal, and `scalar / tensor` its reciprocal times the scalar;
//   - a sum over the 3 components is PyTorch's reduction over two threads,
//     (x0 + x2) + x1; the running optical depth is cumsum's sequential sum;
//     the sum over the 32 steps is PyTorch's four interleaved partial sums
//     (steps k = j mod 4 into sum j), added as ((s0 + s1) + s2) + s3;
//   - every constant is the f32 that PyTorch rounds the Python double to;
//   - expf, acosf, powf and sqrtf are the full-precision functions PyTorch's
//     kernels call, and the library is built with -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int STEPS = 32;                    // MARCH_STEPS
constexpr int MS_RES = 32;
constexpr double PI = 3.14159265358979323846;

constexpr float RB = (float)6360.0;
constexpr float RB2 = (float)(6360.0 * 6360.0);
constexpr float RT2 = (float)(6460.0 * 6460.0);
constexpr float BR0 = (float)5.802e-3, BR1 = (float)13.558e-3, BR2 = (float)33.1e-3;
constexpr float BO0 = (float)0.650e-3, BO1 = (float)1.881e-3, BO2 = (float)0.085e-3;
constexpr float BMS = (float)3.996e-3;                 // BETA_M_SCAT
constexpr float KME = (float)(3.996e-3 + 4.4e-3);      // BETA_M_SCAT + BETA_M_ABS
constexpr float HR = (float)8.0, HM = (float)1.2;
constexpr float INV_HR = 1.0f / HR, INV_HM = 1.0f / HM;
constexpr float INV_S = 1.0f / (float)STEPS;
constexpr float INV_15 = 1.0f / (float)15.0, INV_30 = 1.0f / (float)30.0;
constexpr float RAD2DEG = (float)57.295779513082320876798154814105170332405472466564;
constexpr float AM_A = (float)0.50572, AM_B = (float)96.07995, AM_P = (float)-1.6364;
constexpr float PR = (float)(3.0 / (16.0 * PI));       // Rayleigh phase
constexpr float PM_A = (float)(1 + 0.8 * 0.8);         // Mie: 1 + g^2, 2g, 1 - g^2, 4 pi
constexpr float PM_B = (float)(2 * 0.8);
constexpr float PM_C = (float)(1 - 0.8 * 0.8);
constexpr float PM_D = (float)(4 * PI);
constexpr float GROUND = (float)(0.3 / PI);
constexpr float EPS_N = (float)1e-20, EPS_R = (float)1e-3, EPS_M = (float)1e-4;

// torch.clamp: NaN passes through
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// torch.sum over a last dim of 3
__device__ __forceinline__ float sum3(float x0, float x1, float x2) { return (x0 + x2) + x1; }

// Kasten-Young relative air mass (atmosphere.py::_airmass)
__device__ __forceinline__ float airmass(float mu) {
  const float mu_c = clampf(mu, 0.0f, 1.0f);
  const float chi = acosf(mu_c) * RAD2DEG;
  const float m = (1.0f / (mu_c + AM_A * powf(AM_B - chi, AM_P))) * 1.0f;
  const float below = clampf(-mu, 0.0f, 1.0f);
  return m * (1.0f + below * 200.0f);
}

// ozone column above h (atmosphere.py::_ozone_column_above)
__device__ __forceinline__ float ozone_column(float h) {
  h = clampf(h, 0.0f, 40.0f);
  const float a = 40.0f - h;
  const float falling = (a * a) * INV_30;
  const float b = h - 10.0f;
  const float rising = 15.0f - (b * b) * INV_30;
  return h >= 25.0f ? falling : (h >= 10.0f ? rising : 15.0f);
}

// per-species vertical optical depth at h, from exp(-h / H_R) and
// exp(-h / H_M) (atmosphere.py::sun_transmittance_analytic before the air mass)
__device__ __forceinline__ void vertical_depth(float h, float rho_r, float rho_m, float v[3]) {
  const float r = HR * rho_r, m = KME * (HM * rho_m), o = ozone_column(h);
  v[0] = (BR0 * r + m) + BO0 * o;
  v[1] = (BR1 * r + m) + BO1 * o;
  v[2] = (BR2 * r + m) + BO2 * o;
}

__device__ __forceinline__ void vertical_depth_at(float h, float v[3]) {
  vertical_depth(h, expf(-h * INV_HR), expf(-h * INV_HM), v);
}

__global__ void __launch_bounds__(THREADS)
sky_march_kernel(const float* __restrict__ d, const uint8_t* __restrict__ mask,
                 const float* __restrict__ sun, const float* __restrict__ ms,
                 float* __restrict__ out, int n, int with_disk, int ms_y0, int ms_y1,
                 float ms_fy, float ms_1mfy, float r0, float r0sq, float h_obs, float e0,
                 float e1, float e2, float cos_disk, float inv_omega) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float* o = out + 3 * (size_t)i;
  if (mask != nullptr && !mask[i]) {
    o[0] = 0.0f;
    o[1] = 0.0f;
    o[2] = 0.0f;
    return;
  }
  const float E[3] = {e0, e1, e2};
  const float BR[3] = {BR0, BR1, BR2};
  const float BO[3] = {BO0, BO1, BO2};

  // to_sun = -normalize(sun_dir); d = normalize(d)
  const float s0 = sun[0], s1 = sun[1], s2 = sun[2];
  const float sn = clamp_min(sqrtf(sum3(s0 * s0, s1 * s1, s2 * s2)), EPS_N);
  const float ts0 = -(s0 / sn), ts1 = -(s1 / sn), ts2 = -(s2 / sn);
  const float a0 = d[3 * (size_t)i], a1 = d[3 * (size_t)i + 1], a2 = d[3 * (size_t)i + 2];
  const float an = clamp_min(sqrtf(sum3(a0 * a0, a1 * a1, a2 * a2)), EPS_N);
  const float d0 = a0 / an, d1 = a1 / an, d2 = a2 / an;
  const float mu = d1, mu_s = ts1;
  const float cos_g = clampf(sum3(d0 * ts0, d1 * ts1, d2 * ts2), -1.0f, 1.0f);

  // the ground and the top of the atmosphere along d
  const float q = r0sq * (mu * mu - 1.0f);
  const float disc_g = q + RB2;
  const bool hits_ground = (disc_g >= 0.0f) && (mu < 0.0f);
  const float d_ground = (-r0) * mu - sqrtf(clamp_min(disc_g, 0.0f));
  const float disc_t = q + RT2;
  const float d_top = (-r0) * mu + sqrtf(clamp_min(disc_t, 0.0f));
  const float d_max = hits_ground ? d_ground : d_top;
  const float dt = d_max * INV_S;

  // the multiple-scattering tap at (observer, sun): _sample_ms
  float psi[3];
  {
    const float x = clampf((mu_s * 0.5f + 0.5f) * (float)MS_RES - 0.5f, 0.0f,
                           (float)(MS_RES - 1));
    const float xf = floorf(x);
    const int x0 = (int)xf;
    const int x1 = min(x0 + 1, MS_RES - 1);
    const float fx = x - xf, gx = 1.0f - fx;
    const float* r0p = ms + 3 * MS_RES * ms_y0;
    const float* r1p = ms + 3 * MS_RES * ms_y1;
    for (int c = 0; c < 3; ++c)
      psi[c] = (r0p[3 * x0 + c] * gx + r0p[3 * x1 + c] * fx) * ms_1mfy
               + (r1p[3 * x0 + c] * gx + r1p[3 * x1 + c] * fx) * ms_fy;
  }
  // phase functions of the scattering angle
  const float p_r = PR * (1.0f + cos_g * cos_g);
  const float p_m = (1.0f / (PM_D * powf(clamp_min(PM_A - PM_B * cos_g, EPS_M), 1.5f)))
                    * PM_C;
  const float r0_mu_s = r0 * mu_s;
  const float two_r0 = 2.0f * r0;

  float tau[3] = {0.0f, 0.0f, 0.0f};
  float acc[4][3];
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = 0.0f;

  for (int k4 = 0; k4 < STEPS; k4 += 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float t = ((float)(k4 + j) + 0.5f) * INV_S;
      const float tt = d_max * t;
      const float rr = sqrtf((r0sq + tt * tt) + (two_r0 * tt) * mu);
      const float h = clamp_min(rr - RB, 0.0f);
      const float rho_r = expf(-h * INV_HR);
      const float rho_m = expf(-h * INV_HM);
      const float rho_o = clamp_min(1.0f - fabsf(h - 25.0f) * INV_15, 0.0f);
      const float scat_m = BMS * rho_m;
      const float mu_s_loc = clampf((r0_mu_s + tt * cos_g) / clamp_min(rr, EPS_R), -1.0f,
                                    1.0f);
      const float am = airmass(mu_s_loc);
      float vod[3];
      vertical_depth(h, rho_r, rho_m, vod);
      const float km = KME * rho_m;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float scat_r = BR[c] * rho_r;
        const float ext = (scat_r + km) + BO[c] * rho_o;
        tau[c] = tau[c] + ext * dt;
        const float tr_view = expf(-(tau[c] - (0.5f * ext) * dt));
        const float ts = expf(-vod[c] * am);
        const float w = tr_view * (ts * (scat_r * p_r + scat_m * p_m)
                                   + psi[c] * (scat_r + scat_m)) * dt;
        acc[j][c] = acc[j][c] + w;   // step k into partial sum k mod 4
      }
    }
  }

  // the sun's transmittance at the ground (h = 0) and at the observer
  float vg[3], vobs[3];
  vertical_depth_at(0.0f, vg);
  const float am_s = airmass(mu_s);
  const float mu_s_pos = clamp_min(mu_s, 0.0f);
  const bool disk = with_disk && (cos_g >= cos_disk) && !hits_ground;
  float am_v = 0.0f;
  if (disk) {
    vertical_depth_at(h_obs, vobs);
    am_v = airmass(mu);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float inscat = ((acc[0][c] + acc[1][c]) + acc[2][c]) + acc[3][c];
    float L = inscat * E[c];
    const float t_path = expf(-tau[c]);
    const float l_ground = ((GROUND * expf(-vg[c] * am_s)) * mu_s_pos) * E[c];
    L = L + (hits_ground ? t_path * l_ground : 0.0f);
    if (disk) L = (E[c] * inv_omega) * expf(-vobs[c] * am_v);
    o[c] = L;
  }
}

}  // namespace

// The sky radiance of n directions d into out; mask (n bytes) or null.
extern "C" int hr_sky_march(const void* d, const void* mask, const void* sun, const void* ms,
                            void* out, int n, int with_disk, int ms_y0, int ms_y1, float ms_fy,
                            float ms_1mfy, float r0, float r0sq, float h_obs, float e0, float e1,
                            float e2, float cos_disk, float inv_omega, void* stream) {
  if (n < 0 || ms_y0 < 0 || ms_y1 < 0 || ms_y0 >= MS_RES || ms_y1 >= MS_RES)
    return (int)cudaErrorInvalidValue;
  if (n > 0)
    sky_march_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)d, (const uint8_t*)mask, (const float*)sun, (const float*)ms,
        (float*)out, n, with_disk, ms_y0, ms_y1, ms_fy, ms_1mfy, r0, r0sq, h_obs, e0, e1, e2,
        cos_disk, inv_omega);
  return (int)cudaGetLastError();
}
