"""Screen-space global illumination, the NormalBasic SSGI pass's signal
(counterpart of hobbyrenderer_tpu/ops/ssgi.py).

One cosine-sampled march per half-res pixel and frame, with blue-noise
jitter animated per frame: MARCH_STEPS fixed world-space steps projected
against the reversed-Z depth buffer; the first hit fetches bounce radiance
from the previous frame's lit HDR (the TAA history), a miss adds nothing
(the IBL ambient term carries the sky). The half-res irradiance comes back
to full res through the joint bilateral upsample and is remodulated with
the full-res albedo. On a rank's row band the march projects anywhere on
the screen: it taps the gathered whole-frame depth and previous frame
(``depth_full``, ``prev_hdr_full``), and the blue noise is rolled to the
band's global half-res row, so a band draws the whole frame's rays."""

from __future__ import annotations

import torch

from hobbyrenderer_tpu_torch.ops import sampling as smp
from hobbyrenderer_tpu_torch.ops.shard_utils import global_y0
from hobbyrenderer_tpu_torch.ops.upsample import joint_bilateral_upsample
from hobbyrenderer_tpu_torch.utils import bluenoise as bn

MARCH_STEPS = 8
MARCH_DISTANCE = 4.0      # world units
THICKNESS = 0.35          # relative depth-gap acceptance


def ssgi_half_res(gb, vc, prev_hdr, frame_index: int, debug_out: dict = None, irr=None,
                  shard=None, depth_full=None, prev_hdr_full=None):
    """(H, W, 3) indirect radiance from a march at half resolution.
    ``debug_out``: a dict that receives the march's intermediates for the
    ssgi_* debug views (ops/debugview.py): the half-res irradiance, hit
    mask, hit distance over the march length, the radiance read at the hit,
    and the sky irradiance (SH ``irr``, (9, 3)) along each march direction.
    ``shard``: gb is a rank's row band, and the march taps ``depth_full``
    and ``prev_hdr_full`` (prev_hdr is then unused)."""
    depth_tap = gb.depth if depth_full is None else depth_full
    hdr_tap = prev_hdr if prev_hdr_full is None else prev_hdr_full
    H, W = depth_tap.shape
    hb = gb.depth.shape[0]                    # band rows (H on one device)
    y0 = global_y0(shard)
    dev = gb.depth.device
    sh, sw = hb // 2, W // 2

    def sub(img):
        return img[::2, ::2][:sh, :sw]
    pos = sub(gb.world_pos).reshape(-1, 3)
    nrm = sub(gb.normal).reshape(-1, 3)
    valid = sub(gb.valid).reshape(-1)
    R = pos.shape[0]
    frame = frame_index & 0xFFFFFFFF

    def noise(seed):
        tex = bn.blue_noise_tensor(seed, dev)
        if y0:      # the band's global half-res row
            tex = torch.roll(tex, -(y0 // 2) % tex.shape[0], 0)
        return bn.tile_for(tex, sh, sw)

    u1 = bn.animate(noise(0), frame).reshape(R)
    u2 = bn.animate(noise(1), (frame * 7 + 3) & 0xFFFFFFFF).reshape(R)
    d = smp.to_world(nrm, smp.cosine_sample_hemisphere(u1, u2))
    VP = vc["view_proj_no_jitter"]

    def project(p):
        w = torch.clamp(p @ VP[3, :3] + VP[3, 3], min=1e-6)
        clip = p @ VP[:3, :3].T + VP[:3, 3]
        ndc = clip / w[..., None]
        return (ndc[..., 0] * 0.5 + 0.5) * W, (0.5 - ndc[..., 1] * 0.5) * H, ndc[..., 2]

    hit_col = torch.zeros((R, 3), device=dev)
    found = torch.zeros(R, dtype=torch.bool, device=dev)
    hit_t = torch.zeros(R, device=dev)
    # geometric step schedule biased toward the origin
    for k in range(MARCH_STEPS):
        t = MARCH_DISTANCE * ((k + 1) / MARCH_STEPS) ** 2 + 0.05
        x, y, z = project(pos + d * t)
        on = (x >= 0) & (x < W) & (y >= 0) & (y < H) & (z > 0)
        xi = torch.clamp(x.to(torch.int64), 0, W - 1)
        yi = torch.clamp(y.to(torch.int64), 0, H - 1)
        zbuf = depth_tap[yi, xi]
        # reversed-Z: a buffer nearer than the ray point may occlude it
        hit = on & (zbuf > z) & (zbuf < z * (1.0 + THICKNESS)) & ~found
        hit_col = torch.where(hit[..., None], hdr_tap[yi, xi], hit_col)
        if debug_out is not None:
            hit_t = torch.where(hit, t, hit_t)
        found = found | hit
    radiance = torch.where(found[..., None], hit_col, 0.0)
    # demodulated: the grid carries irradiance / pi (the cos / pi pdf cancels)
    irr_img = torch.where(valid[..., None], radiance, 0.0).reshape(sh, sw, 3)
    if debug_out is not None:
        from hobbyrenderer_tpu_torch.ops.ibl import sample_irradiance
        debug_out["irr_half"] = irr_img
        debug_out["hit"] = found.reshape(sh, sw).to(torch.float32)
        debug_out["ray_t"] = (hit_t / MARCH_DISTANCE).reshape(sh, sw)
        debug_out["direct"] = hit_col.reshape(sh, sw, 3)
        # the sky a missed march would read (that energy is the IBL
        # ambient's): the SH irradiance along the march direction
        debug_out["sky_eval"] = torch.where(valid[..., None], sample_irradiance(irr, d),
                                            0.0).reshape(sh, sw, 3)
    irr = joint_bilateral_upsample(irr_img, sub(gb.depth), sub(gb.normal), sub(gb.valid),
                                   gb.depth, gb.normal, 2, shard=shard)
    return torch.where(gb.valid[..., None], gb.albedo * irr, 0.0)
