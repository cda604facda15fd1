"""Ray helpers (counterpart of hobbyrenderer_tpu/ops/intersect.py: the parts
this slice uses)."""

from __future__ import annotations

import torch


def safe_inv_dir(d):
    return torch.where(torch.abs(d) > 1e-12, 1.0 / d,
                       torch.where(d >= 0, 1e12, -1e12))


def offset_ray_origin(p, n, d):
    """Robust origin offset along the geometric normal."""
    side = torch.where(torch.sum(n * d, -1, keepdim=True) >= 0, 1.0, -1.0)
    scale = torch.clamp(torch.amax(torch.abs(p), dim=-1, keepdim=True), min=1.0)
    return p + n * side * (4e-4 * scale)


def retarget_shadow_ray(p, o, L, dist):
    """Re-aim a shadow ray from the offset origin o at the sample point
    p + L * dist: returns (L_o, t_max) so the ray passes exactly through the
    sample and stops an epsilon short of it (intersect.py:59)."""
    # masked lanes carry inf distances; 0 * inf would make NaNs
    dist_c = torch.where(torch.isfinite(dist), dist, 1.0)
    to_t = p + L * dist_c[..., None] - o
    dist_o = torch.sqrt(torch.sum(to_t * to_t, -1))
    L_o = to_t / torch.clamp(dist_o, min=1e-8)[..., None]
    L_o = torch.where(torch.isfinite(L_o), L_o, 0.0)
    scale = torch.clamp(torch.amax(torch.abs(p), dim=-1), min=1.0)
    eps = torch.clamp(1.6e-3 * scale, min=2e-3)
    return L_o, torch.where(torch.isfinite(dist), dist_o - eps, dist)
