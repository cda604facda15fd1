"""Sky radiance (counterpart of hobbyrenderer_tpu/ops/sky.py, the default
"bruneton" model): ``sky_radiance`` is the LUT atmosphere per direction (the
DDGI probe rays' misses read it); ``sky_radiance_fast`` marches it on a
strided grid, bilinearly upsampled, with a full-resolution analytic sun
disk."""

from __future__ import annotations

import numpy as np
import torch

from hobbyrenderer_tpu_torch.ops import atmosphere as atm
from hobbyrenderer_tpu_torch.ops.resize import resize_bilinear
from hobbyrenderer_tpu_torch.utils import tmath as tm

SKY_FAST_SCALE = 4


def sky_radiance(d, sun_dir, settings, with_sun_disk: bool = True, mask=None):
    """Sky radiance for directions d (..., 3); sun_dir is the direction the
    sunlight travels. Lanes outside ``mask`` (d.shape[:-1] bool) read 0."""
    return atm.sky_radiance_lut(d, sun_dir, settings, with_sun_disk=with_sun_disk, mask=mask)


def sky_radiance_fast(d, sun_dir, settings, with_sun_disk: bool = True):
    """(H, W, 3) direction images: march on a 1/SKY_FAST_SCALE grid +
    upsample + full resolution sun disk. Flat (R, 3) directions get the full
    march."""
    scale = SKY_FAST_SCALE
    if d.ndim != 3:
        return sky_radiance(d, sun_dir, settings, with_sun_disk=with_sun_disk)
    H, W = d.shape[0], d.shape[1]
    sh, sw = H // scale, W // scale
    L = atm.sky_radiance_lut(d[::scale, ::scale][:sh, :sw], sun_dir, settings,
                             with_sun_disk=False)
    L = resize_bilinear(L, H, W)
    if with_sun_disk:
        to_sun = -tm.normalize(sun_dir)
        cos_g = torch.sum(tm.normalize(d) * to_sun, -1)
        cos_r, omega = atm.sun_disk_cos_omega(settings.sun_angular_radius)
        dip = -float(np.sqrt(2.0 * 0.2 / 6360.0))
        disk = (cos_g >= cos_r) & (d[..., 1] > dip)
        E_sun = torch.tensor(settings.sun_color, dtype=torch.float32,
                             device=d.device) * settings.sun_intensity
        T = atm.sun_transmittance_analytic(
            torch.tensor(0.2, dtype=torch.float32, device=d.device), d[..., 1])
        L = torch.where(disk[..., None], E_sun / omega * T, L)
    return L


def view_dirs_from_pixels(vc, height: int, width: int, y0: int = 0,
                          full_height: int = None):
    """Per-pixel world-space view direction through each pixel centre. A row
    band passes ``y0`` and ``full_height``: its rows are frame rows
    [y0, y0 + height) of a full_height-tall frame."""
    fh = height if full_height is None else full_height
    dev = vc["inv_view_proj"].device
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=dev) + y0 + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    ndc_x = px / width * 2.0 - 1.0
    ndc_y = 1.0 - py / fh * 2.0
    inv = vc["inv_view_proj"]
    p = torch.stack([ndc_x, ndc_y, torch.full_like(ndc_x, 0.5)], -1)
    w = p @ inv[3, :3] + inv[3, 3]
    world = (p @ inv[:3, :3].T + inv[:3, 3]) / w[..., None]
    return tm.normalize(world - vc["camera_pos"][None, None, :])
