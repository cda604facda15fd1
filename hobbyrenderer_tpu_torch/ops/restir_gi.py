"""ReSTIR GI: reservoir-resampled one-bounce indirect light, and the
bounce-hit shading it shares with DDGI and the traced specular pass
(counterpart of hobbyrenderer_tpu/ops/restir_gi.py).

Per GI pixel (a 1/scale grid) and frame: one cosine bounce ray through
``closest_hit_auto`` (the bvh16 walk K3) gives a sample point whose outgoing
radiance is its emission plus one next-event light sample
(``_hit_radiance``). Reservoirs
carry the whole sample; temporal reuse (nearest-texel reprojection) and
spatial reuse (frame-wide tap offsets, reconnection Jacobian) merge
neighbours; a final receiver-side visibility ray through the any-hit kernel
K4 kills occluded samples; the demodulated grid is upsampled with depth and
normal guidance and remodulated by the albedo.

``half_rate`` traces new bounce rays on even frames only; the frame index is
a host number, so the branch costs no sync. No step of the chain reads a
device value back to the host. On a rank's row band (``shard``) the GI grid
is banded with it: global GI-pixel RNG keys, halo'd reuse and upsample."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from hobbyrenderer_tpu_torch.models.scene_rt import fetch_hit_attrs
from hobbyrenderer_tpu_torch.ops import beam as beamops
from hobbyrenderer_tpu_torch.ops import lights as lightops
from hobbyrenderer_tpu_torch.ops import sampling as smp
from hobbyrenderer_tpu_torch.ops import shading as shadeops
from hobbyrenderer_tpu_torch.ops import trace as traceops
from hobbyrenderer_tpu_torch.ops.ibl import sample_irradiance
from hobbyrenderer_tpu_torch.ops.intersect import offset_ray_origin, retarget_shadow_ray
from hobbyrenderer_tpu_torch.ops.restir import _rand, _tap_offsets
from hobbyrenderer_tpu_torch.ops.shard_utils import full_height, global_y0, sub_shard
from hobbyrenderer_tpu_torch.ops.upsample import joint_bilateral_upsample
from hobbyrenderer_tpu_torch.ops.warp import pad_edges, warp_image
from hobbyrenderer_tpu_torch.scene.gpu import (MAT_BASE_COLOR, MAT_EMISSIVE, MAT_METALLIC,
                                               MAT_ROUGHNESS)
from hobbyrenderer_tpu_torch.utils import tmath as tm
from hobbyrenderer_tpu_torch.utils.rng import pcg3d

NEE_TILES = 16
NEE_TILE_SIZE = 64
NEE_MAX_STEPS = 256      # 4-ary-walk budget of the NEE shadow ray (ops/trace.py)
GI_M_CLAMP = 12.0
GI_SPATIAL_TAPS = 4
GI_SPATIAL_RADIUS = 12.0    # GI-grid pixels
GI_HALO = 16                # GI-grid halo (>= the spatial radius)
GI_TAP_SALT = 0x61AB1E


class GIReservoir(NamedTuple):
    """Per-GI-pixel path-sample reservoir."""

    pos: torch.Tensor     # (H, W, 3) sample (hit) position
    nrm: torch.Tensor     # (H, W, 3) sample surface normal
    rad: torch.Tensor     # (H, W, 3) outgoing radiance at the sample toward the receiver
    w_sum: torch.Tensor   # (H, W)
    M: torch.Tensor       # (H, W)
    W: torch.Tensor       # (H, W)


def gi_reservoir_init(h: int, w: int, device) -> GIReservoir:
    z3 = lambda: torch.zeros((h, w, 3), device=device)      # noqa: E731
    z1 = lambda: torch.zeros((h, w), device=device)         # noqa: E731
    return GIReservoir(pos=z3(), nrm=z3(), rad=z3(), w_sum=z1(), M=z1(), W=z1())


def _hit_radiance(gpu, rt, pool, hit, o, d, pix, frame: int, stats_out: dict = None,
                  skip_pool_emissive=False, sky_sh=None, ibl_scale=1.0):
    """(hit position, shading normal, outgoing radiance toward -d) of
    closest hits ``hit`` of rays o, d (R, 3); ``pix`` (R,) int64 lane ids and
    ``frame`` seed the samples. Misses get zero radiance.

    ``skip_pool_emissive`` (a bool or an (R,) bool mask) drops the emission
    of hit triangles that are in the light pool (ReSTIR DI already samples
    them at the receiver); ``sky_sh`` (9, 3) adds the diffuse sky exitance
    at the hit, times ``ibl_scale``. ``stats_out`` gets the NEE rays
    (``k3_lanes``) and those that spent the walk's whole step budget
    without a hit (``k3_capped``), as device scalars."""
    p, n_s, _gn, _uv, hmat, _hi = fetch_hit_attrs(gpu, rt, hit, o, d)
    mf = gpu.mat_f[hmat]
    albedo = mf[:, MAT_BASE_COLOR:MAT_BASE_COLOR + 3]
    emissive = mf[:, MAT_EMISSIVE:MAT_EMISSIVE + 3]
    rough = mf[:, MAT_ROUGHNESS]
    metal = mf[:, MAT_METALLIC]

    u1, u2, u3 = _rand(pix, frame, 520)
    tile_ids, tile_inv = lightops.presample_lights(pool, frame, n_tiles=NEE_TILES,
                                                   tile_size=NEE_TILE_SIZE)
    T, S = tile_ids.shape
    tile = pcg3d(torch.stack([pix, torch.full_like(pix, frame),
                              torch.full_like(pix, 9)], -1))[..., 0] % T
    slot = torch.clamp((u1 * S).to(torch.int64), max=S - 1)
    li = tile_ids[tile, slot]
    inv_pdf = tile_inv[tile, slot]
    L, rad_l, dist = lightops.pool_light_incident_packed(pool, li, torch.stack([u2, u3], -1), p)
    f = shadeops.eval_brdf(n_s, -d, L, albedo, metal, rough)
    direct = f * rad_l * inv_pdf[..., None]
    # NEE shadow ray, re-aimed from the offset origin at the light sample
    so = offset_ray_origin(p, n_s, L)
    shoot = (hit.tri >= 0) & (li >= 0) & (tm.luminance(direct) > 0)
    L_v, tmax_t = retarget_shadow_ray(p, so, L, dist)
    occ, capped = traceops.any_hit_auto(rt, so, L_v, t_max=torch.where(shoot, tmax_t, 1e-4),
                                        active=shoot, max_steps=NEE_MAX_STEPS,
                                        return_capped=True)
    if stats_out is not None:
        stats_out["k3_lanes"] = shoot.sum()
        stats_out["k3_capped"] = (capped & shoot).sum()
    direct = torch.where((occ | ~shoot)[..., None], 0.0, direct)
    skip_any = skip_pool_emissive if isinstance(skip_pool_emissive, bool) else True
    if skip_any and getattr(rt, "em_index", None) is not None:
        e_idx = rt.em_index[rt.split_to_orig[torch.clamp(hit.tri, min=0).to(torch.int64)]]
        emissive = torch.where(((e_idx >= 0) & skip_pool_emissive)[..., None], 0.0, emissive)
    rad_out = emissive + direct
    if sky_sh is not None:
        amb = (albedo * (1.0 - metal)[..., None]
               * torch.clamp(sample_irradiance(sky_sh, n_s), min=0.0) * ibl_scale)
        rad_out = rad_out + amb
    return p, n_s, torch.where((hit.tri >= 0)[..., None], rad_out, 0.0)


def _jacobian(recv_pos, s_pos, s_nrm, src_pos):
    """Solid-angle Jacobian of reconnecting sample s (seen from the source
    surface) to the receiver, clamped to [0, 10]."""
    to_r = s_pos - recv_pos
    to_s = s_pos - src_pos
    d2_r = torch.clamp(torch.sum(to_r * to_r, -1), min=1e-6)
    d2_s = torch.clamp(torch.sum(to_s * to_s, -1), min=1e-6)
    cos_r = torch.abs(torch.sum(s_nrm * to_r, -1)) / torch.sqrt(d2_r)
    cos_s = torch.abs(torch.sum(s_nrm * to_s, -1)) / torch.sqrt(d2_s)
    J = (cos_r / torch.clamp(cos_s, min=1e-4)) * (d2_s / d2_r)
    return torch.clamp(J, 0.0, 10.0)


def _merge(state, c_pos, c_nrm, c_rad, c_w, c_M, u):
    y_pos, y_nrm, y_rad, w_sum, M = state
    w_new = w_sum + c_w
    take = ((u * torch.clamp(w_new, min=1e-20)) < c_w)[..., None]
    return (torch.where(take, c_pos, y_pos), torch.where(take, c_nrm, y_nrm),
            torch.where(take, c_rad, y_rad), w_new, M + c_M)


def restir_gi(gpu, rt, gb, vc, settings, prev: GIReservoir, frame_index: int,
              scale: int = 4, pool=None, shard=None, half_rate: bool = False,
              trace_max_steps: int = None, skip_pool_emissive: bool = False,
              stats_out: dict = None, sky_sh=None, ibl_scale=1.0,
              spatial_taps: int = GI_SPATIAL_TAPS, m_clamp: float = GI_M_CLAMP):
    """One ReSTIR GI frame at 1/scale resolution. Returns (indirect (H, W, 3)
    full-res diffuse indirect, new GIReservoir (Hg, Wg)).

    ``trace_max_steps``: the bounce rays' 4-ary step budget (K3 runs
    max(24, steps // 4)); None walks uncapped. ``stats_out`` gets device
    scalars: ``overflow`` (K4 tiles whose frontier overflowed: 0, the port's
    K4 walks per ray), ``traced`` (1 if this frame traced, host int),
    ``bounce_lanes`` / ``bounce_capped`` (K3 lanes of the bounce walk and
    those that spent its whole budget), ``nee_lanes`` / ``nee_capped`` (the
    NEE walk's). ``shard``: gb and prev are a rank's row band (the
    full-res band; shard_h % scale == 0)."""
    H, W = gb.depth.shape
    Hg, Wg = H // scale, W // scale
    R = Hg * Wg
    dev = gb.depth.device
    frame = int(frame_index)
    gshard = sub_shard(shard, scale, Hg)
    gy0 = global_y0(gshard)
    # RNG key: the global GI-pixel id gy * Wg + x
    pix = torch.arange(R, dtype=torch.int64, device=dev) + gy0 * Wg
    if pool is None:
        pool = getattr(rt, "lights", None)
    assert pool is not None, "ReSTIR GI needs rt.lights"

    def sub(img):
        return img[::scale, ::scale][:Hg, :Wg]

    pos = sub(gb.world_pos).reshape(R, 3)
    n = sub(gb.normal).reshape(R, 3)
    gn = sub(gb.geo_normal).reshape(R, 3)
    valid = sub(gb.valid).reshape(R)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    so = {"overflow": zero, "traced": 0, "bounce_lanes": zero, "bounce_capped": zero,
          "nee_lanes": zero, "nee_capped": zero}

    # ---- initial sample: one cosine bounce ray (even frames only at half rate) ----
    u1, u2, _ = _rand(pix, frame, 500)
    d = smp.to_world(n, smp.cosine_sample_hemisphere(u1, u2))
    o = offset_ray_origin(pos, gn, d)
    traced = not half_rate or frame % 2 == 0
    if traced:
        hit, walk = traceops.closest_hit_counted(rt, o, d, valid, max_steps=trace_max_steps)
        so.update(bounce_lanes=walk["lanes"], bounce_capped=walk["capped"])
        nee = {}
        s_pos, s_nrm, s_rad = _hit_radiance(gpu, rt, pool, hit, o, d, pix, frame,
                                            stats_out=nee,
                                            skip_pool_emissive=skip_pool_emissive,
                                            sky_sh=sky_sh, ibl_scale=ibl_scale)
        so.update(traced=1, nee_lanes=nee["k3_lanes"], nee_capped=nee["k3_capped"])
        ok0 = valid & (hit.tri >= 0)
    else:
        s_pos = s_nrm = s_rad = torch.zeros((R, 3), device=dev)
        ok0 = torch.zeros((R,), dtype=torch.bool, device=dev)
    cos0 = torch.clamp(torch.sum(d * n, -1), min=0.0)
    pdf0 = torch.clamp(cos0 / math.pi, min=1e-4)
    ph0 = torch.where(ok0, tm.luminance(s_rad), 0.0)
    w0 = torch.where(ok0, ph0 / pdf0, 0.0)
    # an untraced (playback) frame drew no candidate: M = 0
    state = (s_pos, s_nrm, s_rad, w0, torch.full((R,), 1.0 if traced else 0.0, device=dev))

    # ---- temporal reuse with the reconnection Jacobian ----
    motion = sub(gb.motion) / float(scale)
    xs = torch.arange(Wg, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(Hg, dtype=torch.float32, device=dev) + gy0 + 0.5
    prev_x = xs[None, :] + motion[..., 0]
    prev_y = ys[:, None] + motion[..., 1]
    on_s = ((prev_x >= 0) & (prev_x < Wg) & (prev_y >= 0)
            & (prev_y < full_height(gshard, Hg))).reshape(R)
    packed = torch.cat([prev.pos, prev.nrm, prev.rad, prev.W[..., None], prev.M[..., None]], -1)
    pw = warp_image(packed, motion, halo=GI_HALO, radius=4, col_pad=32, bilinear=False,
                    shard=gshard)
    t_pos = pw[..., 0:3].reshape(R, 3)
    t_nrm = pw[..., 3:6].reshape(R, 3)
    t_rad = pw[..., 6:9].reshape(R, 3)
    t_W = pw[..., 9].reshape(R)
    t_M = torch.clamp(pw[..., 10].reshape(R), max=m_clamp)
    t_ok = on_s & valid & (t_M > 0)
    t_ok = t_ok & (torch.sum((t_pos - pos) * n, -1) > 1e-4)   # in front of the receiver
    ph_t = torch.where(t_ok, tm.luminance(t_rad), 0.0)
    w_t = ph_t * t_W * t_M
    u_t, _, _ = _rand(pix, frame, 540)
    state = _merge(state, t_pos, t_nrm, t_rad, torch.where(t_ok, w_t, 0.0),
                   torch.where(t_ok, t_M, 0.0), u_t)

    # ---- spatial reuse at frame-wide tap offsets ----
    y_pos, y_nrm, y_rad, w_sum, M = state
    d2v = sub(gb.depth)
    snap = torch.cat([y_pos.reshape(Hg, Wg, 3), y_nrm.reshape(Hg, Wg, 3),
                      y_rad.reshape(Hg, Wg, 3), w_sum.reshape(Hg, Wg)[..., None],
                      M.reshape(Hg, Wg)[..., None], n.reshape(Hg, Wg, 3), d2v[..., None],
                      pos.reshape(Hg, Wg, 3)], -1)
    hl = GI_HALO
    snap_e = pad_edges(snap, hl, gshard)
    d_c = d2v.reshape(R)
    for k, (dx, dy) in enumerate(_tap_offsets(spatial_taps, frame, salt=GI_TAP_SALT,
                                              radius=GI_SPATIAL_RADIUS)):
        nb = snap_e[hl + dy:hl + dy + Hg, hl + dx:hl + dx + Wg]
        c_pos = nb[..., 0:3].reshape(R, 3)
        c_nrm = nb[..., 3:6].reshape(R, 3)
        c_rad = nb[..., 6:9].reshape(R, 3)
        c_ws = nb[..., 9].reshape(R)
        c_M_raw = nb[..., 10].reshape(R)
        c_M = torch.clamp(c_M_raw, max=m_clamp)
        n_n = nb[..., 11:14].reshape(R, 3)
        d_n = nb[..., 14].reshape(R)
        sim = ((torch.sum(n_n * n, -1) > 0.85)
               & (torch.abs(d_n - d_c) < 0.1 * torch.clamp(d_c, min=1e-3)) & valid)
        ph_n = tm.luminance(c_rad)
        W_n = torch.where(ph_n > 0, c_ws / torch.clamp(c_M_raw * ph_n, min=1e-20), 0.0)
        J = _jacobian(pos, c_pos, c_nrm, nb[..., 15:18].reshape(R, 3))
        ok_n = sim & (torch.sum((c_pos - pos) * n, -1) > 1e-4) & (ph_n > 0)
        _, _, u_c = _rand(pix, frame, 560 + k)
        w_n = torch.where(ok_n, ph_n * W_n * c_M * J, 0.0)
        state = _merge(state, c_pos, c_nrm, c_rad, w_n, torch.where(ok_n, c_M, 0.0), u_c)
    y_pos, y_nrm, y_rad, w_sum, M = state

    # ---- finalize + one receiver-side visibility ray (K4) ----
    ph_y = tm.luminance(y_rad)
    Wgt = torch.where(ph_y > 0, w_sum / torch.clamp(M * ph_y, min=1e-20), 0.0)
    to_s = y_pos - pos
    dist = torch.linalg.vector_norm(to_s, dim=-1)
    L = to_s / torch.clamp(dist, min=1e-6)[..., None]
    o_v = offset_ray_origin(pos, gn, L)
    shoot = valid & (Wgt > 0) & (dist > 1e-4)
    L, tmax_t = retarget_shadow_ray(pos, o_v, L, dist)
    tmax_v = torch.where(shoot, tmax_t, 1e-4)
    occ, n_ovf = beamops.beam_any_hit(rt.btable, o_v.reshape(Hg, Wg, 3), L.reshape(Hg, Wg, 3),
                                      tmax_v.reshape(Hg, Wg), shoot.reshape(Hg, Wg), Hg, Wg)
    so["overflow"] = n_ovf
    Wgt = torch.where(occ.reshape(R), 0.0, Wgt)

    cos_r = torch.clamp(torch.sum(L * n, -1), min=0.0)
    # demodulated: the grid carries irradiance / pi, the albedo is applied at
    # full resolution
    irr = y_rad * (cos_r * Wgt / math.pi)[..., None]
    irr = torch.where(valid[..., None], irr, 0.0)
    new_res = GIReservoir(pos=y_pos.reshape(Hg, Wg, 3), nrm=y_nrm.reshape(Hg, Wg, 3),
                          rad=y_rad.reshape(Hg, Wg, 3), w_sum=w_sum.reshape(Hg, Wg),
                          M=M.reshape(Hg, Wg), W=Wgt.reshape(Hg, Wg))
    full_irr = joint_bilateral_upsample(irr.reshape(Hg, Wg, 3), d2v, n.reshape(Hg, Wg, 3),
                                        valid.reshape(Hg, Wg), gb.depth, gb.normal, scale,
                                        shard=shard)
    full = torch.where(gb.valid[..., None], gb.albedo * full_irr, 0.0)
    if stats_out is not None:
        stats_out.update(so)
    return full, new_res
