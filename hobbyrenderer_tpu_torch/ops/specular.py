"""Traced specular indirect: GGX-VNDF reflection rays for glossy pixels
(counterpart of hobbyrenderer_tpu/ops/specular.py).

At half resolution, one VNDF half-vector sample per glossy pixel (roughness
below ``rough_max``) and frame; mirror-like pixels (roughness below
DELTA_ROUGHNESS) reflect about the normal with a Fresnel-only weight. The
active lanes compact into a fixed capacity (no host sync), take one closest
hit each through ``closest_hit_auto`` (the bvh16 walk K3 under a 512-step
4-ary budget), shade the hit as the GI bounce does (emission, one NEE
sample, sky exitance, and with ``sharc_cache`` the SHARC cache's value at
the hit's cell), and read the environment on a miss (``env_fn``, the
environment map, else the sky; nothing with ``include_env_miss`` off); lanes
past the capacity read it too. The
demodulated signal goes through the RELAX temporal pass and a short
roughness-aware A-trous, is upsampled, remodulated, and returned weighted by
the blend that hands over to the split-sum ambient at higher roughness.
On a rank's row band (``shard``) the spec grid is banded with it: global
RNG keys and checkerboard parity, halo'd denoise and upsample, and the
band's own capacity."""

from __future__ import annotations

import torch

from hobbyrenderer_tpu_torch.ops import sampling as smp
from hobbyrenderer_tpu_torch.ops import sharc as sharcops
from hobbyrenderer_tpu_torch.ops import sky as skyops
from hobbyrenderer_tpu_torch.ops import trace as traceops
from hobbyrenderer_tpu_torch.ops.denoise import (DenoiseState, atrous_filter, denoise_init,
                                                 temporal_accumulate)
from hobbyrenderer_tpu_torch.ops.intersect import offset_ray_origin
from hobbyrenderer_tpu_torch.ops.restir import _compact
from hobbyrenderer_tpu_torch.ops.restir_gi import _hit_radiance
from hobbyrenderer_tpu_torch.ops.shading import brdf_params, fresnel_schlick
from hobbyrenderer_tpu_torch.ops.shard_utils import global_y0, sub_shard
from hobbyrenderer_tpu_torch.ops.upsample import joint_bilateral_upsample
from hobbyrenderer_tpu_torch.utils import tmath as tm
from hobbyrenderer_tpu_torch.utils.rng import pcg3d, uniform_from_bits

DELTA_ROUGHNESS = 0.03      # below: mirror path
ROUGH_MAX = 0.50            # above: split-sum ambient only
FADE_BAND = 0.12            # smoothstep handoff width in roughness
MAX_RADIANCE = 10.0         # firefly clamp
TRACE_STEPS = 512           # 4-ary budget of the reflection rays
PIX_SALT = 0x53EC           # offsets the NEE sample ids from the GI bounce's


class _SubGB:
    """The four G-buffer fields the denoiser reads, at the spec grid."""

    def __init__(self, motion, depth, normal, valid):
        self.motion, self.depth = motion, depth
        self.normal, self.valid = normal, valid


def spec_state_init(height: int, width: int, device, scale: int = 2) -> DenoiseState:
    return denoise_init(height // scale, width // scale, device)


def spec_blend_weight(roughness, rough_max: float = ROUGH_MAX):
    """(H, W) in [0, 1]: 1 = traced specular, 0 = split-sum ambient."""
    t = torch.clamp((rough_max - roughness) / FADE_BAND, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def specular_indirect(gpu, rt, gb, vc, settings, state: DenoiseState, frame_index: int, *,
                      scale: int = 2, rough_max: float = ROUGH_MAX, env_fn=None,
                      sun_dir=None, sharc_cache=None, shard=None,
                      skip_pool_emissive: bool = False, include_env_miss: bool = True,
                      sky_sh=None, ibl_scale=1.0, half_rate: bool = False,
                      stats_out: dict = None):
    """One traced-specular frame. Returns (spec (H, W, 3) full-res, already
    weighted by the blend, weight (H, W), new DenoiseState (half-res)).

    ``skip_pool_emissive``: glossy (non-mirror) lanes drop the emission of
    pooled emitters, which ReSTIR DI resolves at the receiver; mirror lanes
    keep it. ``stats_out`` gets device scalars: ``lanes`` / ``capped`` (the
    reflection walk's K3 lanes and those that spent its budget),
    ``nee_lanes`` / ``nee_capped``, and ``past_cap`` (active lanes past the
    capacity). ``shard``: a rank's row band (shard_h % scale == 0)."""
    H, W = gb.depth.shape
    Hs, Ws = H // scale, W // scale
    R = Hs * Ws
    dev = gb.depth.device
    frame = int(frame_index)
    gshard = sub_shard(shard, scale, Hs)

    def sub(img):
        return img[::scale, ::scale][:Hs, :Ws]

    pos = sub(gb.world_pos).reshape(R, 3)
    n = sub(gb.normal).reshape(R, 3)
    gn = sub(gb.geo_normal).reshape(R, 3)
    valid = sub(gb.valid).reshape(R)
    rough = sub(gb.orm[..., 1]).reshape(R)
    metal = sub(gb.orm[..., 2]).reshape(R)
    albedo = sub(gb.albedo).reshape(R, 3)
    lanes = torch.arange(R, dtype=torch.int64, device=dev)
    ly, gx = lanes // Ws + global_y0(gshard), lanes % Ws     # global spec-grid rows
    pix = ly * Ws + gx

    v = tm.normalize(vc["camera_pos"][None, :] - pos)
    nov = torch.sum(n * v, -1)

    # ---- GGX-VNDF half-vector sample ----
    _, f0, alpha = brdf_params(albedo, metal, rough)
    bits = pcg3d(torch.stack([pix, torch.full_like(pix, frame), torch.full_like(pix, 610)], -1))
    u1 = uniform_from_bits(bits[..., 0])
    u2 = uniform_from_bits(bits[..., 1])
    h_loc = smp.sample_ggx_vndf(smp.to_local(n, v), alpha, u1, u2)
    delta = rough < DELTA_ROUGHNESS
    h = torch.where(delta[..., None], n, smp.to_world(n, h_loc))
    d = tm.normalize(tm.reflect(-v, h))

    # estimator weight F * G2/G1 (mirror lanes: F)
    hov = torch.clamp(torch.sum(h * v, -1), min=0.0)
    ndl = torch.sum(n * d, -1)
    F = fresnel_schlick(hov[..., None], f0)
    g2g1 = smp.smith_g2_over_g1(torch.clamp(nov, min=1e-4), torch.clamp(ndl, min=1e-4), alpha)
    weight = torch.where(delta[..., None], F, F * g2g1[..., None])

    active = (valid & (rough < rough_max) & (nov > 1e-4)
              & (torch.sum(gn * d, -1) > 0.0) & (ndl > 0.0))
    parity = None
    if half_rate:
        parity = ((ly + gx + frame) & 1) == 0
        active = active & parity
    o = offset_ray_origin(pos, gn, d)

    # ---- compact the active lanes to a fixed capacity ----
    CAP = max(R // 8 if half_rate else R // 4, 1024)
    sel, _rank = _compact(active, CAP)
    pad = sel >= R
    sel_c = torch.clamp(sel, max=R - 1)

    def take(a):
        return torch.where(pad.reshape((-1,) + (1,) * (a.ndim - 1)),
                           torch.zeros((), dtype=a.dtype, device=dev), a[sel_c])
    o_c, d_c, pix_c, delta_c = take(o), take(d), take(pix), take(delta)

    hit, so = traceops.closest_hit_counted(rt, o_c, d_c, ~pad, max_steps=TRACE_STEPS)

    # ---- shade the secondary surface ----
    skip_mask = ~delta_c if skip_pool_emissive else torch.zeros_like(delta_c)
    nee = {}
    hpos, hnrm, hrad = _hit_radiance(gpu, rt, rt.lights, hit, o_c, d_c, pix_c + PIX_SALT,
                                     frame, stats_out=nee, skip_pool_emissive=skip_mask,
                                     sky_sh=sky_sh, ibl_scale=ibl_scale)
    if sharc_cache is not None:
        # the radiance cache's multi-bounce tail at the hit's cell
        fb, fb_ok = sharcops.sharc_query(sharc_cache, hpos, hnrm, vc["camera_pos"])
        hrad = hrad + torch.where((fb_ok & (hit.tri >= 0))[..., None], fb, 0.0)
    so.update(nee_lanes=nee["k3_lanes"], nee_capped=nee["k3_capped"],
              past_cap=torch.clamp(active.sum() - CAP, min=0))
    # a miss reads the environment; not when it rides the light pool
    # (``include_env_miss`` False), whose specular ReSTIR DI resolves
    if not include_env_miss:
        env_r = torch.zeros((R, 3), device=dev)
    elif env_fn is not None:
        env_r = env_fn(d)
    else:
        env_r = skyops.sky_radiance_fast(d, sun_dir, settings, with_sun_disk=True)
    hit_ok_c = (hit.tri >= 0) & ~pad
    # scatter back to the spec grid; padding lanes (sel = R) land in a spare row
    hit_rad = torch.zeros((R + 1, 3), device=dev).index_put_(
        (sel,), torch.where(hit_ok_c[:, None], hrad, 0.0))[:R]
    hit_ok = torch.zeros((R + 1,), dtype=torch.bool, device=dev).index_put_(
        (sel,), hit_ok_c)[:R]
    radiance = torch.where(hit_ok[..., None], hit_rad, env_r)
    lum = tm.luminance(radiance)
    radiance = radiance * (torch.clamp(lum, max=MAX_RADIANCE) / torch.clamp(lum, min=1e-6))[
        ..., None]
    spec = torch.where(active[..., None], weight * radiance, 0.0)
    # demodulate by F0 (+0.02) before the filter chain
    spec = (spec / (f0 + 0.02)).reshape(Hs, Ws, 3)

    # ---- denoise at the spec grid (RELAX temporal + short A-trous) ----
    sgb = _SubGB(motion=sub(gb.motion) / float(scale), depth=sub(gb.depth),
                 normal=sub(gb.normal), valid=sub(gb.valid))
    sv = parity.reshape(Hs, Ws) if half_rate else None
    color, var, new_state = temporal_accumulate(spec, sgb, state, max_history=8.0,
                                                sample_valid=sv, shard=gshard)
    r_px = (4.0 * torch.clamp(sub(gb.orm[..., 1]) / rough_max, 0.05, 1.0)
            * 8.0 / (1.0 + new_state.history))
    color = atrous_filter(color, var, sgb, iterations=2, radius_px=torch.clamp(r_px, min=0.5),
                          shard=gshard)

    full = joint_bilateral_upsample(color, sgb.depth, sgb.normal, sgb.valid, gb.depth,
                                    gb.normal, scale, shard=shard)
    _, f0_full, _ = brdf_params(gb.albedo, gb.orm[..., 2], gb.orm[..., 1])
    full = full * (f0_full + 0.02)
    w_blend = spec_blend_weight(gb.orm[..., 1], rough_max) * gb.valid.to(torch.float32)
    if stats_out is not None:
        stats_out.update(so)
    return full * w_blend[..., None], w_blend, new_state
