"""PBR shading: GGX BRDF + punctual/directional lights (counterpart of
hobbyrenderer_tpu/ops/shading.py)."""

from __future__ import annotations

import math

import torch

from hobbyrenderer_tpu_torch.scene.scene import LIGHT_DIRECTIONAL, LIGHT_SPOT
from hobbyrenderer_tpu_torch.utils import tmath as tm

MIN_ROUGHNESS = 0.03
DIELECTRIC_F0 = 0.04


def ggx_d(n_dot_h, alpha):
    a2 = alpha * alpha
    d = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * d * d, min=1e-8)


def smith_v(n_dot_v, n_dot_l, alpha):
    a2 = alpha * alpha
    gv = n_dot_l * torch.sqrt(torch.clamp(n_dot_v * n_dot_v * (1 - a2) + a2, min=1e-8))
    gl = n_dot_v * torch.sqrt(torch.clamp(n_dot_l * n_dot_l * (1 - a2) + a2, min=1e-8))
    return 0.5 / torch.clamp(gv + gl, min=1e-8)


def fresnel_schlick(v_dot_h, f0, f90=1.0):
    return f0 + (f90 - f0) * torch.pow(torch.clamp(1.0 - v_dot_h, 0.0, 1.0), 5.0)


def brdf_params(albedo, metallic, roughness):
    rough = torch.clamp(roughness, MIN_ROUGHNESS, 1.0)
    alpha = rough * rough
    diffuse = albedo * (1.0 - metallic[..., None])
    f0 = DIELECTRIC_F0 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    return diffuse, f0, alpha


def eval_brdf(n, v, l, albedo, metallic, roughness):
    """Full BRDF * NdotL."""
    diffuse, f0, alpha = brdf_params(albedo, metallic, roughness)
    h = tm.normalize(v + l)
    ndl = torch.clamp(torch.sum(n * l, -1), min=0.0)
    ndv = torch.clamp(torch.sum(n * v, -1), min=1e-5)
    ndh = torch.clamp(torch.sum(n * h, -1), min=0.0)
    vdh = torch.clamp(torch.sum(v * h, -1), min=0.0)
    F = fresnel_schlick(vdh[..., None], f0)
    spec = (ggx_d(ndh, alpha) * smith_v(ndv, ndl, alpha))[..., None] * F
    return ((1.0 - F) * diffuse / math.pi + spec) * ndl[..., None]


def _range_falloff(dist, rng):
    x = torch.clamp(dist / torch.clamp(rng, min=1e-4), 0.0, 1.0)
    f = 1.0 - x * x * x * x
    return torch.clamp(f * f, 0.0, 1.0)


def light_incident(ltype: int, light_pos, light_dir, light_color, light_range,
                   light_cone, shade_pos):
    """One light (``ltype`` a host int, params 0-d/1-d device tensors) at
    shaded points -> (L unit dir to light, radiance, dist)."""
    is_dir = ltype == LIGHT_DIRECTIONAL
    if is_dir:
        to_l = (-light_dir).expand_as(shade_pos)
    else:
        to_l = light_pos - shade_pos
    dist = torch.linalg.vector_norm(to_l, dim=-1, keepdim=True)
    L = to_l / torch.clamp(dist, min=1e-8)
    dist = dist[..., 0]
    if is_dir:
        atten = torch.ones_like(dist)
    else:
        atten = _range_falloff(dist, light_range) / torch.clamp(dist * dist, min=1e-4)
    if ltype == LIGHT_SPOT:
        cd = torch.sum(-L * light_dir, -1)
        spot = torch.clamp((cd - light_cone[1]) /
                           torch.clamp(light_cone[0] - light_cone[1], min=1e-4), 0.0, 1.0)
        spot = spot * spot
        atten = atten * spot
    radiance = light_color * atten[..., None]
    if is_dir:
        dist = torch.full_like(dist, 1e9)
    return L, radiance, dist


def shade_all_lights(gpu, pos, n, v, albedo, metallic, roughness, shadow_fn=None):
    """Direct lighting summed over the scene's lights (count known on the
    host). shadow_fn(light_idx, L, dist) -> visibility or None."""
    types = gpu.meta["light_types"]
    total = torch.zeros_like(albedo)
    for i in range(gpu.meta["light_count"]):
        L, rad, dist = light_incident(types[i], gpu.light_pos[i], gpu.light_dir[i],
                                      gpu.light_color[i], gpu.light_range[i],
                                      gpu.light_cone[i], pos)
        contrib = eval_brdf(n, v, L, albedo, metallic, roughness) * rad
        if shadow_fn is not None:
            vis = shadow_fn(i, L, dist)
            if vis is not None:
                contrib = contrib * vis[..., None]
        total = total + contrib
    return total
