"""Monte Carlo sampling helpers (counterpart of hobbyrenderer_tpu/ops/
sampling.py: ONB, cone and cosine sampling, GGX-VNDF half-vectors and the
Smith masking terms of the traced specular pass, and the path tracer's MIS
helpers)."""

from __future__ import annotations

import math

import torch

from hobbyrenderer_tpu_torch.utils import tmath as tm


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


def to_local(n, v_world):
    t, b = orthonormal_basis(n)
    return torch.stack([torch.sum(v_world * t, -1), torch.sum(v_world * b, -1),
                        torch.sum(v_world * n, -1)], -1)


def sample_ggx_vndf(v_local, alpha, u1, u2):
    """Heitz 2018 visible-NDF sample of the GGX half-vector (local space,
    n = +z)."""
    vh = tm.normalize(torch.stack([alpha * v_local[..., 0], alpha * v_local[..., 1],
                                   v_local[..., 2]], -1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-12))
    zero = torch.zeros_like(inv)
    t1 = torch.where(lensq[..., None] > 1e-9,
                     torch.stack([-vh[..., 1], vh[..., 0], zero], -1) * inv[..., None],
                     torch.stack([zero + 1.0, zero, zero], -1))
    t2 = torch.linalg.cross(vh, t1, dim=-1)
    r = torch.sqrt(u1)
    phi = (2.0 * math.pi) * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    return tm.normalize(torch.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                                     torch.clamp(nh[..., 2], min=0.0)], -1))


def smith_g1(n_dot_x, alpha):
    a2 = alpha * alpha
    return 2.0 * n_dot_x / torch.clamp(
        n_dot_x + torch.sqrt(a2 + (1.0 - a2) * n_dot_x * n_dot_x), min=1e-8)


def smith_g2_over_g1(n_dot_v, n_dot_l, alpha):
    """G2/G1 for the VNDF estimator weight (separable Smith)."""
    g1v = smith_g1(n_dot_v, alpha)
    g1l = smith_g1(n_dot_l, alpha)
    return g1l * g1v / torch.clamp(g1v + g1l - g1v * g1l, min=1e-8)


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


def power_heuristic(pdf_a, pdf_b):
    a2 = pdf_a * pdf_a
    return a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-12)


def ggx_ndf(n_dot_h, alpha):
    a2 = alpha * alpha
    d = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * d * d, min=1e-12)


def brdf_mix_pdf(v_loc, l_loc, alpha, p_spec):
    """Solid-angle pdf of the diffuse (cosine) / specular (GGX-VNDF) mixture
    sampler at direction l (local space, n = +z): the BSDF side of the MIS
    weights for emissive-triangle NEE."""
    ndl = torch.clamp(l_loc[..., 2], min=0.0)
    ndv = torch.clamp(v_loc[..., 2], min=1e-5)
    h = tm.normalize(v_loc + l_loc)
    ndh = torch.clamp(h[..., 2], min=0.0)
    pdf_s = smith_g1(ndv, alpha) * ggx_ndf(ndh, alpha) / (4.0 * ndv)
    pdf_d = ndl / math.pi
    return p_spec * pdf_s + (1.0 - p_spec) * pdf_d
