"""Screen-space contact shadows (counterpart of hobbyrenderer_tpu/ops/sss.py):
a short march toward the sun at exponentially spaced distances, projected
against the reversed-Z depth buffer, at quarter resolution, bilinearly
upsampled. Every step is tested (occlusion is the max over steps), as in
the JAX package."""

from __future__ import annotations

import torch

from hobbyrenderer_tpu_torch.ops.resize import resize_bilinear

STEPS = 24
MAX_DISTANCE = 0.6      # world units of the contact march
MIN_STEP = 0.006        # world units: first (finest) step
THICKNESS = 0.02        # relative depth window counted as an occluder
DEPTH_BIAS = 0.002      # min relative depth delta before a sample occludes


def _step_distances(device):
    """Exponentially spaced march distances in (0, MAX_DISTANCE]."""
    r = (MAX_DISTANCE / MIN_STEP) ** (1.0 / (STEPS - 1))
    t = MIN_STEP * r ** torch.arange(STEPS, dtype=torch.float32, device=device)
    return torch.clamp(t, max=MAX_DISTANCE)


def screen_space_shadows(gb, vc, sun_dir):
    """(H, W) visibility in [0, 1] from a march toward the sun at quarter
    resolution."""
    H, W = gb.depth.shape
    VP = vc["view_proj_no_jitter"]
    to_sun = -sun_dir

    def project(p):
        w = torch.clamp(p @ VP[3, :3] + VP[3, 3], min=1e-6)
        clip = p @ VP[:3, :3].T + VP[:3, 3]
        ndc = clip / w[..., None]
        return (ndc[..., 0] * 0.5 + 0.5) * W, (0.5 - ndc[..., 1] * 0.5) * H, ndc[..., 2]

    sh, sw = H // 4, W // 4
    pos = gb.world_pos[::4, ::4][:sh, :sw]
    valid_s = gb.valid[::4, ::4][:sh, :sw]
    t = _step_distances(pos.device)
    p = pos[None] + to_sun * t[:, None, None, None]            # (K, sh, sw, 3)
    x, y, z = project(p.reshape(-1, 3))
    on = (x >= 0) & (x < W) & (y >= 0) & (y < H) & (z > 0)
    xi = torch.clamp(x.to(torch.int64), 0, W - 1)
    yi = torch.clamp(y.to(torch.int64), 0, H - 1)
    zbuf = gb.depth.reshape(-1)[yi * W + xi]
    hit = on & (zbuf > z * (1.0 + DEPTH_BIAS)) & (zbuf < z * (1.0 + THICKNESS))
    occ = torch.amax(hit.reshape(t.shape[0], sh, sw).to(torch.float32), dim=0)
    vis = resize_bilinear(torch.where(valid_s, 1.0 - occ, 1.0), H, W)
    return torch.where(gb.valid, vis, 1.0)
