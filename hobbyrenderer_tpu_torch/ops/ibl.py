"""Image-based lighting from the procedural sky: SH irradiance rebuilt each
frame + split-sum specular ambient (counterpart of hobbyrenderer_tpu/ops/
ibl.py; no authored env map or BRDF LUT in this slice)."""

from __future__ import annotations

import math

import numpy as np
import torch

from hobbyrenderer_tpu_torch.ops import atmosphere as atm
from hobbyrenderer_tpu_torch.ops import sky as skyops
from hobbyrenderer_tpu_torch.ops.shading import brdf_params
from hobbyrenderer_tpu_torch.utils import tmath as tm

SH_SAMPLES = 256


def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    y = 1.0 - 2.0 * i / n
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    return np.stack([r * np.cos(phi), y, r * np.sin(phi)], -1).astype(np.float32)


def sh_basis(d):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack([
        0.282095 * torch.ones_like(x),
        0.488603 * y, 0.488603 * z, 0.488603 * x,
        1.092548 * x * y, 1.092548 * y * z,
        0.315392 * (3.0 * z * z - 1.0),
        1.092548 * x * z,
        0.546274 * (x * x - y * y)], -1)


_BAND = np.asarray([1.0, 2.0 / 3.0, 2.0 / 3.0, 2.0 / 3.0,
                    0.25, 0.25, 0.25, 0.25, 0.25], np.float32)


def build_sky_irradiance(sun_dir, settings):
    """(9, 3) SH projection of the sky radiance (no sun disk)."""
    d = torch.as_tensor(_fibonacci_sphere(SH_SAMPLES), device=sun_dir.device)
    L = atm.sky_radiance_lut(d, sun_dir, settings, with_sun_disk=False)
    return (4.0 * math.pi / SH_SAMPLES) * torch.einsum("nc,nk->kc", L, sh_basis(d))


def sample_irradiance(sh, n):
    # the bands' cosine-lobe weights go in as scalars: a constant tensor
    # made here would be a host-to-device copy, which waits for the device
    Y = sh_basis(n)
    Y = torch.cat([Y[..., :1] * float(_BAND[0]), Y[..., 1:4] * float(_BAND[1]),
                   Y[..., 4:] * float(_BAND[4])], -1)
    return torch.einsum("...k,kc->...c", Y, sh)


_EB_COEF_A = np.asarray([
    +8.64160800e-01, +6.05938479e+00, -1.13059703e+01, -1.21605450e+01,
    +2.81192555e+01, +1.45689758e+01, -2.38945324e+01, -8.39611313e+00,
    +7.49742039e+00, +1.82001859e+00, -9.44084111e-01, +2.91281397e+01,
    -1.00710299e+02, +8.89154378e+01, -2.05478079e+01, -3.72447428e+01,
    +1.25275893e+02, -1.02986921e+02, +2.02384430e+01, +1.07391214e+01,
    -4.30995281e+01, +2.65484573e+01, +1.64573813e+00, +7.70076959e-01,
    +5.98947753e+00, -1.46560458e+00, -1.56936868e+01, +1.18442740e+01,
    -6.77300008e+00, -1.72224537e+00, +6.13946086e+00, -4.97843579e+00],
    np.float32)
_EB_COEF_B = np.asarray([
    +6.83118269e-01, -7.40111549e+00, +5.04895549e+00, +1.33250468e+01,
    -1.68744769e+01, -1.29349701e+01, +1.71230931e+01, +5.76245963e+00,
    -7.01602635e+00, -8.25181951e-01, +1.14345396e+00, -1.67922285e+00,
    +4.24880504e+01, -4.66825102e+01, +1.19120559e+01, -3.71888365e+00,
    -4.30482209e+01, +4.41703229e+01, -8.04377834e+00, +1.21951704e+01,
    +8.83175995e+00, -1.15271430e+01, -6.12835147e+00, +2.89664271e+00,
    -3.51737449e+00, +1.14596284e+00, +9.55386687e+00, -7.32075062e+00,
    +3.74456670e+00, +1.38560075e+00, -5.52281933e+00, +4.43446563e+00],
    np.float32)


def _env_brdf_basis(x, y):
    feats = [torch.ones_like(x)]
    for p in range(1, 6):
        feats.append(x ** p)
        feats.append(y ** p)
    for p in range(1, 5):
        for q in range(1, 5):
            if p + q <= 6:
                feats.append((x ** p) * (y ** q))
    g = torch.exp2(-9.28 * x)
    sx = torch.sqrt(x)
    feats += [g, g * y, g * y * y, g * y ** 3, g * (1 - y) ** 2,
              sx, sx * y, sx * y * y]
    return torch.stack(feats, -1)


def env_brdf(ndv, rough):
    """Split-sum environment BRDF (scale, bias): the polynomial fit."""
    F = _env_brdf_basis(torch.clamp(ndv, 0.0, 1.0), torch.clamp(rough, 0.0, 1.0))
    A = torch.einsum("...k,k->...", F, torch.as_tensor(_EB_COEF_A, device=F.device))
    B = torch.einsum("...k,k->...", F, torch.as_tensor(_EB_COEF_B, device=F.device))
    return torch.clamp(A, 0.0, 1.0), torch.clamp(B, 0.0, 1.0)


def ibl_ambient(sh, n, v, albedo, metallic, roughness, sun_dir, settings,
                intensity=1.0, spec_suppress=None):
    """Diffuse SH irradiance + roughness-aware specular ambient.
    ``spec_suppress`` (H, W) in [0, 1], optional: the share of the specular
    term that traced specular indirect (ops/specular.py) replaces."""
    diffuse_c, f0, _alpha = brdf_params(albedo, metallic, roughness)
    diffuse = diffuse_c * torch.clamp(sample_irradiance(sh, n), min=0.0)
    r = tm.reflect(-v, n)
    env_r = skyops.sky_radiance_fast(r, sun_dir, settings, with_sun_disk=False)
    rough = torch.clamp(roughness, 0.0, 1.0)[..., None]
    spec_env = env_r * (1 - rough) + torch.clamp(sample_irradiance(sh, r), min=0.0) * rough
    ndv = torch.clamp(torch.sum(n * v, -1, keepdim=True), min=1e-4)
    scale, bias = env_brdf(ndv, rough)
    spec = spec_env * (f0 * scale + bias)
    if spec_suppress is not None:
        spec = spec * (1.0 - spec_suppress)[..., None]
    return (diffuse + spec) * intensity
