"""Bounce-hit shading shared by the traced indirect passes (counterpart of
hobbyrenderer_tpu/ops/restir_gi.py::_hit_radiance, whose ``_rand`` is
ops/restir.py's; DDGI's probe rays use it now, the ReSTIR GI chain of that
module later).

The outgoing radiance at a closest hit toward the ray's origin is its
emission plus one next-event sample: a light drawn from 16 presampled
power tiles of 64 lights, shaded with the GGX BRDF and tested with one
any-hit shadow ray through the 16-wide walk (K3) under a 256-step budget."""

from __future__ import annotations

import torch

from hobbyrenderer_tpu_torch.models.scene_rt import fetch_hit_attrs
from hobbyrenderer_tpu_torch.ops import lights as lightops
from hobbyrenderer_tpu_torch.ops import shading as shadeops
from hobbyrenderer_tpu_torch.ops import trace as traceops
from hobbyrenderer_tpu_torch.ops.intersect import offset_ray_origin, retarget_shadow_ray
from hobbyrenderer_tpu_torch.ops.restir import _rand
from hobbyrenderer_tpu_torch.scene.gpu import (MAT_BASE_COLOR, MAT_EMISSIVE, MAT_METALLIC,
                                               MAT_ROUGHNESS)
from hobbyrenderer_tpu_torch.utils import tmath as tm
from hobbyrenderer_tpu_torch.utils.rng import pcg3d

NEE_TILES = 16
NEE_TILE_SIZE = 64
NEE_MAX_STEPS = 256      # 4-ary-walk budget of the NEE shadow ray (ops/trace.py)


def _hit_radiance(gpu, rt, pool, hit, o, d, pix, frame: int, stats_out: dict = None):
    """(hit position, shading normal, outgoing radiance toward -d) of
    closest hits ``hit`` of rays o, d (R, 3); ``pix`` (R,) int64 lane ids and
    ``frame`` (uint32) seed the samples. Misses get zero radiance.

    The JAX function's options for the ReSTIR GI and specular passes
    (skip_pool_emissive, sky_sh) come with those passes. ``stats_out`` gets
    the NEE rays (``k3_lanes``) and those that spent the walk's whole step
    budget without a hit (``k3_capped``), as device scalars."""
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
    return p, n_s, torch.where((hit.tri >= 0)[..., None], emissive + direct, 0.0)
