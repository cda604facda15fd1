"""Monte Carlo sampling helpers (counterpart of hobbyrenderer_tpu/ops/
sampling.py: the parts this slice uses)."""

from __future__ import annotations

import math

import torch


def orthonormal_basis(n):
    """Branchless ONB (Duff et al. 2017). n (..., 3) unit -> (t, b)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], -1)
    bt = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    return t, bt


def to_world(n, v_local):
    t, b = orthonormal_basis(n)
    return t * v_local[..., 0:1] + b * v_local[..., 1:2] + n * v_local[..., 2:3]


def sample_cone(axis, cos_theta_max, u1, u2):
    """Uniform direction in a cone around axis (soft sun)."""
    cos_t = 1.0 - u1 * (1.0 - cos_theta_max)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = (2.0 * math.pi) * u2
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], -1)
    return to_world(axis, local)


def cosine_sample_hemisphere(u1, u2):
    """Local-space cosine-weighted direction, pdf = cos / pi."""
    r = torch.sqrt(u1)
    phi = (2.0 * math.pi) * u2
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
