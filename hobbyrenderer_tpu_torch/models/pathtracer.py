"""ReferencePathTracer mode: unbiased progressive Monte Carlo path tracer
(counterpart of hobbyrenderer_tpu/models/pathtracer.py: camera_rays,
trace_paths and PathTracerRenderer; the scene snapshot is
models/scene_rt.py).

A wavefront over all pixels: every bounce is one closest-hit walk of the
whole ray population on the bvh16 walk (K3), then shading, NEE with one
any-hit shadow walk (K3) and sampling of the next direction, all as tensor
ops over the lanes. The RNG is a pure function of (pixel, accumulation
frame, dimension), dimension 1 + bounce*8 + k as the reference draws it,
so frame N is reproducible. From bounce COMPACT_START on, wide wavefronts
compact their live paths into shrinking static capacities (the reference's
TPU wavefront compaction, ported as it is): the capacities follow from the
lane count on the host, the live counts stay on the device, and nothing in
a bounce waits for the device.

Not ported (the renderer refuses them, each naming its slice): env maps and
env-as-lights, texture streaming, animated scenes (refit_scene_rt). The
SceneRT must carry the light pool and its emissive index (build_scene_rt
with the uploaded scene does); the reference's pool-less NEE branch is not
ported."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hobbyrenderer_tpu_torch.models.scene_rt import SceneRT, fetch_hit_attrs
from hobbyrenderer_tpu_torch.ops import atmosphere as atm
from hobbyrenderer_tpu_torch.ops import lights as lightops
from hobbyrenderer_tpu_torch.ops import post as postops
from hobbyrenderer_tpu_torch.ops import sampling as smp
from hobbyrenderer_tpu_torch.ops import shading as shadeops
from hobbyrenderer_tpu_torch.ops import sky as skyops
from hobbyrenderer_tpu_torch.ops import texture as texops
from hobbyrenderer_tpu_torch.ops import trace as traceops
from hobbyrenderer_tpu_torch.ops.intersect import offset_ray_origin, retarget_shadow_ray
from hobbyrenderer_tpu_torch.scene.gpu import (MAT_ALPHA_CUTOFF, MAT_ATTEN_COLOR,
                                               MAT_ATTEN_DIST, MAT_BASE_COLOR, MAT_EMISSIVE,
                                               MAT_IOR, MAT_METALLIC, MAT_ROUGHNESS,
                                               MAT_TEX_BASE_HI, MAT_TEX_BASE_LO, MAT_TEX_SIZE,
                                               MAT_TRANSMISSION, MAT_UV_SCALE)
from hobbyrenderer_tpu_torch.scene.scene import LIGHT_DIRECTIONAL
from hobbyrenderer_tpu_torch.utils import tmath as tm
from hobbyrenderer_tpu_torch.utils.rng import as_u32, pcg3d, uniform_from_bits

# per-bounce wavefront-compaction schedule (pathtracer.py:274-277): bounces
# 0..COMPACT_START-1 run full width; from COMPACT_START the live paths
# compact into static capacities CAP_FRACS[b - COMPACT_START] * RS (floor
# COMPACT_MIN_CAP). Wavefronts under COMPACT_MIN_LANES stay on the scan path.
COMPACT_START = 3
CAP_FRACS = (0.625, 0.375, 0.25, 0.125, 0.125)
COMPACT_MIN_LANES = 32768
COMPACT_MIN_CAP = 4096


def camera_rays(vc, height: int, width: int, jitter_uv):
    """Primary rays through jittered pixel positions; jitter_uv (H, W, 2)
    sub-pixel offsets in [0, 1). Returns o, d (H*W, 3)."""
    inv = vc["inv_view_proj"]
    dev = inv.device
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    px = torch.stack([xs, ys], -1) + jitter_uv
    ndc_x = (px[..., 0] + 0.0) / width * 2.0 - 1.0
    ndc_y = 1.0 - (px[..., 1] + 0.0) / height * 2.0
    p = torch.stack([ndc_x, ndc_y, torch.full_like(ndc_x, 0.5)], -1)
    w = torch.einsum("j,hwj->hw", inv[3, :3], p) + inv[3, 3]
    world = (torch.einsum("ij,hwj->hwi", inv[:3, :3], p) + inv[:3, 3]) / w[..., None]
    o = torch.broadcast_to(vc["camera_pos"], world.shape)
    d = tm.normalize(world - o)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def _fresnel_dielectric(cos_i, eta):
    """Exact unpolarized dielectric Fresnel; cos_i >= 0, eta = n_t / n_i."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = (1.0 / (eta * eta)) * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    rs = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-8)
    rp = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-8)
    return torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))


def _refract(d, n, eta_rel):
    """Snell refraction of d about n (n opposes d), eta_rel = n_in / n_out;
    mirror reflection on total internal reflection. Returns (dir, tir)."""
    cos_i = -torch.sum(d * n, -1, keepdim=True)
    sin2_t = eta_rel * eta_rel * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    refr = eta_rel * d + (eta_rel * cos_i - cos_t) * n
    refl = d + 2.0 * cos_i * n
    return torch.where(tir, refl, refr), tir[..., 0]


def _sun_index(gpu):
    """Index of the first live directional light (0 without one), a device
    scalar: jnp.argmax of a bool takes the first maximum, so the bool is
    cast to int before torch.argmax."""
    lt = gpu.light_type
    is_dir = (lt == LIGHT_DIRECTIONAL) & (torch.arange(lt.shape[0], device=lt.device)
                                          < gpu.meta["light_count"])
    return torch.argmax(is_dir.to(torch.int32))


class _Paths(NamedTuple):
    """The wavefront's per-lane state (the reference's scan carry)."""
    o: torch.Tensor
    d: torch.Tensor
    radiance: torch.Tensor
    throughput: torch.Tensor
    active: torch.Tensor
    inside: torch.Tensor
    sigma_t: torch.Tensor
    prev_pdf: torch.Tensor
    pix: torch.Tensor      # uint32 words in int64
    frame: torch.Tensor    # uint32 words in int64


def _rand3(pix, frame, dim: int):
    bits = pcg3d(torch.stack([pix, frame, torch.full_like(pix, dim)], -1))
    return (uniform_from_bits(bits[..., 0]), uniform_from_bits(bits[..., 1]),
            uniform_from_bits(bits[..., 2]))


def _add(stats, key, value):
    stats[key] = stats[key] + value if key in stats else value


def _bounce(gpu, rt: SceneRT, vc, settings, height: int, p: _Paths, bounce: int, sun_dir,
            rr_start: int, sky_fn, stats) -> _Paths:
    """One bounce of every lane (the reference's bounce_body)."""
    o, d, radiance, throughput, active, inside, sigma_t, prev_pdf, pix, frame = p
    dim = 1 + bounce * 8

    def rand2(k):
        a, b, _ = _rand3(pix, frame, k)
        return a, b

    hit, capped = traceops.closest_hit_auto(rt, o, d, active=active, return_capped=True)
    _add(stats, "rt_k3_lanes_pt", active.sum())
    _add(stats, "rt_k3_capped_pt", (capped & active).sum())
    miss = (hit.tri < 0) & active
    # Beer-Lambert through the current medium (a miss's t is the finite INF)
    seg_t = torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    throughput = throughput * torch.where(inside[..., None],
                                          torch.exp(-sigma_t * seg_t[..., None]), 1.0)
    # sky on a miss; the sun disk on the primary ray only (NEE covers it later)
    if sky_fn is not None:
        sky = sky_fn(d, bounce)
    else:
        sky = skyops.sky_radiance(d, sun_dir, settings, with_sun_disk=bounce == 0)
    radiance = radiance + torch.where(miss[..., None], throughput * sky, 0.0)
    active = active & (hit.tri >= 0)

    pos, n, gn, uv, mat, inst = fetch_hit_attrs(gpu, rt, hit, o, d)
    mf = gpu.mat_f[mat]
    albedo = mf[:, MAT_BASE_COLOR:MAT_BASE_COLOR + 3]
    metallic = mf[:, MAT_METALLIC]
    rough = torch.clamp(mf[:, MAT_ROUGHNESS], shadeops.MIN_ROUGHNESS, 1.0)
    emissive = mf[:, MAT_EMISSIVE:MAT_EMISSIVE + 3]
    trans = mf[:, MAT_TRANSMISSION]
    alpha_v = mf[:, MAT_BASE_COLOR + 3]

    # texturing at the hit, LOD from a ray-cone footprint
    if gpu.tex_table.shape[0] > gpu.mat_f.shape[0]:
        tex_size = mf[:, MAT_TEX_SIZE]
        tex_base = (torch.round(mf[:, MAT_TEX_BASE_HI]).to(torch.int64) * 4096
                    + torch.round(mf[:, MAT_TEX_BASE_LO]).to(torch.int64))
        uv_s = uv * torch.clamp(mf[:, MAT_UV_SCALE:MAT_UV_SCALE + 1], min=1e-6)
        spread = 2.0 / (vc["proj11"] * height)       # pixel angular footprint
        foot = torch.where(torch.isfinite(hit.t), hit.t, 1.0) * spread
        lod = torch.log2(torch.clamp(tex_size * foot, min=1e-6))
        bits = pcg3d(torch.stack([pix, frame, torch.full_like(pix, dim + 5)], -1))
        ts = texops.sample_material(gpu, tex_size, tex_base, uv_s, lod, bits)
        albedo = albedo * ts.albedo
        alpha_v = alpha_v * ts.alpha
        rough = torch.clamp(rough * ts.roughness, shadeops.MIN_ROUGHNESS, 1.0)
        metallic = metallic * ts.metallic
        emissive = emissive * ts.emissive

    # alpha test (MASK materials), then stochastic BLEND coverage: a failed
    # hit passes straight through (one bounce)
    alpha_fail = active & (alpha_v < mf[:, MAT_ALPHA_CUTOFF])
    u_cov, _ = rand2(dim + 6)
    blend = gpu.inst_alpha_mode[inst] == 2
    cov = torch.maximum(alpha_v, trans)
    alpha_fail = alpha_fail | (active & blend & (u_cov >= cov))
    shade_ok = active & ~alpha_fail

    v = -d
    ior = torch.clamp(mf[:, MAT_IOR], min=1.01)
    atten_c = torch.clamp(mf[:, MAT_ATTEN_COLOR:MAT_ATTEN_COLOR + 3], 1e-4, 1.0)
    atten_d = torch.clamp(mf[:, MAT_ATTEN_DIST], min=1e-3)
    cos_i = torch.clamp(torch.sum(v * n, -1), min=0.0)
    eta_tr = torch.where(inside, 1.0 / ior, ior)           # n_transmitted / n_incident
    F_d = _fresnel_dielectric(cos_i, eta_tr)
    p_transmit = torch.clamp(trans * (1.0 - F_d), 0.0, 0.98)
    diffuse_c, f0, alpha = shadeops.brdf_params(albedo, metallic, rough)
    diffuse_c = diffuse_c * (1.0 - trans)[..., None]
    w_spec = tm.luminance(f0) + 1e-4
    w_diff = tm.luminance(diffuse_c) + 1e-4
    p_spec = w_spec / (w_spec + w_diff)
    v_loc = smp.to_local(n, v)
    v_loc = torch.cat([v_loc[..., :2], torch.clamp(v_loc[..., 2:3], min=1e-4)], -1)

    # emitted light at the hit, MIS-weighted against NEE for pooled emitters
    # (prev_pdf <= 0 marks transports NEE cannot produce)
    pool = rt.lights
    A_n = pool.power_pdf.shape[0] - pool.em_v0.shape[0]
    e_idx = rt.em_index[rt.split_to_orig[torch.clamp(hit.tri, min=0).to(torch.int64)]]
    in_pool = shade_ok & (e_idx >= 0) & (prev_pdf > 0.0)
    e_c = torch.clamp(e_idx, min=0)
    nx2 = tm.cross(pool.em_e1[e_c], pool.em_e2[e_c])
    area_h = 0.5 * torch.linalg.vector_norm(nx2, dim=-1)
    n_eh = nx2 / torch.clamp(2.0 * area_h, min=1e-12)[..., None]
    cos_lh = torch.abs(torch.sum(n_eh * (-d), -1))
    d2h = torch.clamp(hit.t * hit.t, min=1e-8)
    pdf_light_h = pool.power_pdf[A_n + e_c] * d2h / torch.clamp(area_h * cos_lh, min=1e-8)
    w_hit = smp.power_heuristic(prev_pdf, pdf_light_h)
    em_out = torch.where(in_pool[..., None], pool.em_rad[e_c] * w_hit[..., None], emissive)
    radiance = radiance + torch.where(shade_ok[..., None], throughput * em_out, 0.0)

    # NEE over the pool (power-proportional selection), MIS against the BRDF
    # sampler for emissive triangles; analytic lights are delta
    u_l, u1, u2 = _rand3(pix, frame, dim + 0)
    n_src = pool.power_pdf.shape[0]
    s = torch.clamp(torch.searchsorted(pool.power_cdf, u_l), 0, n_src - 1)
    pdf_sel = torch.clamp(pool.power_pdf[s], min=1e-12)
    L, rad, dist, (is_em_s, area_s, cos_ls, d2s) = lightops.pool_light_incident(
        pool, s, torch.stack([u1, u2], -1), pos)
    la = torch.clamp(s, 0, gpu.light_type.shape[0] - 1)
    is_sun = ~is_em_s & (gpu.light_type[la] == LIGHT_DIRECTIONAL)
    cos_max = float(np.cos(np.float32(settings.sun_angular_radius)))
    L = torch.where(is_sun[..., None], smp.sample_cone(L, cos_max, u1, u2), L)
    pdf_light_sol = pdf_sel * d2s / torch.clamp(area_s * cos_ls, min=1e-8)
    pdf_b = (1.0 - p_transmit) * smp.brdf_mix_pdf(v_loc, smp.to_local(n, L), alpha, p_spec)
    w_nee = torch.where(is_em_s, smp.power_heuristic(pdf_light_sol, pdf_b), 1.0)
    inv_sel = w_nee / pdf_sel
    # transmissive energy is carried by the transmission lobe, not NEE
    f = shadeops.eval_brdf(n, v, L, albedo * (1.0 - trans)[..., None], metallic, rough)
    ndl_ok = (torch.sum(L * gn, -1) > 0) & (torch.sum(L * n, -1) > 0)
    nee_active = shade_ok & ndl_ok & (torch.amax(rad, -1) > 0)
    so = offset_ray_origin(pos, gn, L)
    L_v, tmax_t = retarget_shadow_ray(pos, so, L, dist)
    occluded, capped = traceops.any_hit_auto(rt, so, L_v,
                                             t_max=torch.where(nee_active, tmax_t, 1e-4),
                                             active=nee_active, return_capped=True)
    _add(stats, "rt_k3_lanes_pt_nee", nee_active.sum())
    _add(stats, "rt_k3_capped_pt_nee", (capped & nee_active).sum())
    contrib = throughput * f * rad * inv_sel[..., None]
    radiance = radiance + torch.where((nee_active & ~occluded)[..., None], contrib, 0.0)

    # Russian roulette
    u_rr, _ = rand2(dim + 1)
    if bounce >= rr_start:
        p_cont = torch.clamp(torch.amax(throughput, -1), 0.05, 0.95)
    else:
        p_cont = torch.ones_like(u_rr)
    active = active & (u_rr < p_cont)
    throughput = throughput / p_cont[..., None]

    # transmission lobe (dielectric Fresnel + refraction); weight = tint
    u_t, _ = rand2(dim + 4)
    do_transmit = shade_ok & (u_t < p_transmit)
    eta_rel = torch.where(inside, ior, 1.0 / ior)[..., None]   # n_i / n_t
    d_refr, tir = _refract(d, n, eta_rel)
    new_inside = torch.where(do_transmit & ~tir, ~inside, inside)
    sigma_new = -torch.log(atten_c) / atten_d[..., None]
    sigma_t = torch.where((do_transmit & new_inside & ~inside)[..., None], sigma_new, sigma_t)
    inside = new_inside

    # BRDF sampling: diffuse (cosine) or specular (GGX-VNDF)
    u_sel, us1 = rand2(dim + 2)
    ud1, ud2 = rand2(dim + 3)
    h_loc = smp.sample_ggx_vndf(v_loc, alpha, us1, ud2)
    l_spec_loc = tm.normalize(2.0 * torch.sum(v_loc * h_loc, -1, keepdim=True) * h_loc - v_loc)
    l_diff_loc = smp.cosine_sample_hemisphere(ud1, ud2)
    choose_spec = u_sel < p_spec
    l_loc = torch.where(choose_spec[..., None], l_spec_loc, l_diff_loc)
    l_world = smp.to_world(n, l_loc)
    ndl = l_loc[..., 2]
    ndv = v_loc[..., 2]
    vdh = torch.clamp(torch.sum(v_loc * h_loc, -1), min=0.0)
    F = shadeops.fresnel_schlick(vdh[..., None], f0)
    w_s = F * smp.smith_g2_over_g1(ndv, torch.clamp(ndl, min=1e-5), alpha)[..., None]
    weight = torch.where(choose_spec[..., None],
                         w_s / torch.clamp(p_spec, min=1e-4)[..., None],
                         diffuse_c / torch.clamp(1 - p_spec, min=1e-4)[..., None])
    weight = weight / torch.clamp(1.0 - p_transmit, min=0.02)[..., None]
    ok = (ndl > 1e-5) | do_transmit | alpha_fail
    active = active & ok
    weight = torch.where(do_transmit[..., None], albedo, weight)
    weight = torch.where(alpha_fail[..., None], 1.0, weight)
    throughput = throughput * torch.where(ok[..., None], weight, 0.0)
    throughput = torch.clamp(throughput, max=64.0)            # firefly clamp

    d_new = torch.where(do_transmit[..., None], d_refr, l_world)
    d_new = torch.where(alpha_fail[..., None], d, d_new)
    # alpha pass-through continues behind the surface (offset along -gn)
    o = torch.where(alpha_fail[..., None], offset_ray_origin(pos, -gn, d_new),
                    offset_ray_origin(pos, gn, d_new))
    # solid-angle pdf of the sampled direction for next bounce's hit-emission
    # MIS; 0 marks transports NEE cannot produce
    pdf_bounce = (1.0 - p_transmit) * smp.brdf_mix_pdf(v_loc, smp.to_local(n, d_new), alpha,
                                                        p_spec)
    prev_pdf = torch.where(do_transmit | alpha_fail | ~shade_ok, 0.0, pdf_bounce)
    return _Paths(o, d_new, radiance, throughput, active, inside, sigma_t, prev_pdf, pix, frame)


def _compact(p: _Paths, b: int, cap: int, stats):
    """Capacity Russian roulette (p_keep = 0.8 cap / live lanes, throughput /
    p_keep: unbiased), then the kept lanes in order into ``cap`` slots by one
    packed row gather; live lanes past cap are dropped and counted. Returns
    the new wavefront, each slot's source lane and the empty slots."""
    cur = p.active.shape[0]
    dev = p.active.device
    dim_c = 1 + (b - 1) * 8 + 7                   # the unused slot of bounce b-1
    u_c, _, _ = _rand3(p.pix, p.frame, dim_c)
    n_act = p.active.sum()
    p_keep = torch.clamp(0.8 * cap / torch.clamp(n_act.to(torch.float32), min=1.0), max=1.0)
    keep = p.active & (u_c < p_keep)
    _add(stats, "pt_dropped_lanes", torch.clamp(keep.sum() - cap, min=0))
    throughput = p.throughput / p_keep
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    slot = torch.where(keep & (rank < cap), rank, cap)      # row cap: dropped
    sel = torch.full((cap + 1,), cur, dtype=torch.int64, device=dev).scatter_(
        0, slot, torch.arange(cur, dtype=torch.int64, device=dev))[:cap]
    pad = sel >= cur
    selc = torch.clamp(sel, max=cur - 1)
    # one packed row gather; pix and frame ride as f32 (exact below 2^24)
    packed = torch.cat([p.o, p.d, throughput, p.sigma_t, p.prev_pdf[:, None],
                        p.inside.to(torch.float32)[:, None],
                        p.pix.to(torch.float32)[:, None], p.frame.to(torch.float32)[:, None]], -1)
    pk = torch.where(pad[:, None], 0.0, packed[selc])
    return _Paths(o=pk[:, 0:3], d=pk[:, 3:6], radiance=torch.zeros((cap, 3), device=dev),
                  throughput=pk[:, 6:9], active=keep[selc] & ~pad, inside=pk[:, 13] > 0.5,
                  sigma_t=pk[:, 9:12], prev_pdf=pk[:, 12], pix=pk[:, 14].to(torch.int64),
                  frame=pk[:, 15].to(torch.int64)), selc, pad


def trace_paths(gpu, rt: SceneRT, vc, settings, height: int, width: int, accum_index: int,
                max_bounces: int = 8, rr_start: int = 2, sky_fn=None, spp: int = 1,
                with_stats: bool = False):
    """spp samples per pixel in one wavefront -> (H*W, 3) mean radiance;
    with ``with_stats`` also {"pt_dropped_lanes", "rt_k3_lanes_pt",
    "rt_k3_capped_pt", "rt_k3_lanes_pt_nee", "rt_k3_capped_pt_nee"} as
    device scalars (the closest-hit and NEE lanes that walked K3 and those
    that spent its whole step budget).

    Sample s of accumulation frame a draws the RNG stream of frame a*spp+s,
    so an spp=N frame is the mean of N consecutive spp=1 frames. Per-lane
    radiance is kept per (sample, pixel) lane and summed over the samples in
    a fixed order at the end, so the result does not depend on the order of
    the device's scatter adds."""
    R = height * width
    RS = R * spp
    dev = gpu.mat_f.device
    lane = torch.arange(RS, dtype=torch.int64, device=dev)
    pix = lane % R
    frame = as_u32(accum_index * spp + lane // R)
    ju, jv, _ = _rand3(pix, frame, 0)
    rays = [camera_rays(vc, height, width, torch.stack(
        [ju[s * R:(s + 1) * R].reshape(height, width),
         jv[s * R:(s + 1) * R].reshape(height, width)], -1)) for s in range(spp)]
    o = torch.cat([r[0] for r in rays]) if spp > 1 else rays[0][0]
    d = torch.cat([r[1] for r in rays]) if spp > 1 else rays[0][1]
    sun_dir = gpu.light_dir.index_select(0, _sun_index(gpu).reshape(1))[0]   # no host read
    z3 = torch.zeros((RS, 3), dtype=torch.float32, device=dev)
    p = _Paths(o.contiguous(), d.contiguous(), z3, torch.ones_like(z3),
               torch.ones((RS,), dtype=torch.bool, device=dev),
               torch.zeros((RS,), dtype=torch.bool, device=dev), z3,
               torch.zeros((RS,), dtype=torch.float32, device=dev), pix, frame)
    stats = {"pt_dropped_lanes": torch.zeros((), dtype=torch.int64, device=dev)}

    def bounce(p, b):
        # named ranges: profile_frame.py splits each bounce's kernel time
        with torch.profiler.record_function(f"PT bounce {b}"):
            return _bounce(gpu, rt, vc, settings, height, p, b, sun_dir, rr_start, sky_fn,
                           stats)

    use_compact = RS >= COMPACT_MIN_LANES and max_bounces > COMPACT_START
    if not use_compact:
        for b in range(max_bounces):
            p = bounce(p, b)
        rad = p.radiance.reshape(spp, R, 3).mean(0) if spp > 1 else p.radiance
        return (rad, stats) if with_stats else rad

    for b in range(COMPACT_START):
        p = bounce(p, b)
    # per-lane accumulator (lane s*R + pix of sample s): every slot of a
    # compacted wavefront maps back to a distinct lane, empty slots to row RS
    rad_lane = torch.cat([p.radiance, torch.zeros((1, 3), device=dev)])
    origin = lane
    for b in range(COMPACT_START, max_bounces):
        fi = min(b - COMPACT_START, len(CAP_FRACS) - 1)
        cur = int(p.active.shape[0])
        cap = min(max((int(RS * CAP_FRACS[fi]) // 1024) * 1024, COMPACT_MIN_CAP), cur)
        if cap < cur:
            with torch.profiler.record_function(f"PT compact {b}"):
                p, selc, pad = _compact(p, b, cap, stats)
            origin = torch.where(pad, RS, origin[selc])
        else:
            p = p._replace(radiance=torch.zeros((cur, 3), device=dev))
        p = bounce(p, b)
        rad_lane.index_add_(0, origin, p.radiance)
    rad = rad_lane[:RS].reshape(spp, R, 3).sum(0)
    rad = rad / spp if spp > 1 else rad
    return (rad, stats) if with_stats else rad


class PathTracerRenderer:
    """The progressive path-tracer frame (pathtracer.py:701-760): a running
    average of the frames since the camera last moved, auto-exposure and
    the tonemap."""

    graph = None          # no pass graph: the frame is one trace_paths call

    def __init__(self, gpu, width: int, height: int, config, rt: SceneRT):
        self.width, self.height = width, height
        self.rt = rt
        dev = gpu.mat_f.device
        self.accum = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
        self.num_accum = 0
        self.exposure = torch.ones((), dtype=torch.float32, device=dev)
        self._prev_view = None
        self.max_bounces = config.settings.max_bounces
        self.rr_start = config.settings.rr_start_bounce
        # samples per rendered frame, batched into one wavefront (--pt-spp)
        self.spp = max(int(config.pt_spp), 1)
        self.last_stats = {}
        atm.device_tables(dev)       # the sky's constant tables, uploaded here once

    def render(self, gpu, vc, settings, dt: float, view_proj):
        """One accumulated frame -> LDR (H, W, 3) uint8. ``view_proj`` is the
        host copy of vc["view_proj_no_jitter"], compared on the host for the
        camera-move reset."""
        vm = np.asarray(view_proj)
        if self._prev_view is None or not np.array_equal(vm, self._prev_view):
            self.num_accum = 0
            self.accum.zero_()
            self._prev_view = vm
        # num_accum counts samples; the RNG frame index is the spp-frame ordinal
        sample, stats = trace_paths(gpu, self.rt, vc, settings, self.height, self.width,
                                    self.num_accum // self.spp, self.max_bounces,
                                    self.rr_start, spp=self.spp, with_stats=True)
        sample = sample.reshape(self.height, self.width, 3)
        w = np.float32(self.spp) / (np.float32(self.num_accum) + np.float32(self.spp))
        self.accum = self.accum * float(np.float32(1.0) - w) + sample * float(w)
        hist = postops.luminance_histogram(self.accum)
        self.exposure = postops.exposure_adapt(hist, self.exposure, dt, settings)
        self.last_stats = stats
        self.num_accum += self.spp
        return postops.tonemap_to_output(self.accum, self.exposure)
