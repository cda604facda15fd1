"""RELAX-class denoiser for the stochastic direct-light signal (counterpart
of hobbyrenderer_tpu/ops/denoise.py, single device): temporal accumulation
(reprojection, geometry-validated history, luminance moments -> variance)
then a variance-guided A-trous wavelet filter with normal, depth and
luminance edge stops. Profiles: 'relax' (fixed footprint) and 'reblur'
(the kernel radius shrinks as the history grows). All taps are
edge-clamped shifted slices; under a row band (``shard``, ops/shard_utils)
the rows past the band's edges come from the neighbouring ranks."""

from __future__ import annotations

from typing import NamedTuple

import torch

from hobbyrenderer_tpu_torch.ops.shading import brdf_params
from hobbyrenderer_tpu_torch.ops.shard_utils import full_height, global_y0
from hobbyrenderer_tpu_torch.ops.warp import pad_edges, warp_image
from hobbyrenderer_tpu_torch.utils import tmath as tm

REPROJECT_HALO = 32
ATROUS_PAD = 8          # max A-trous tap offset (2 * step, step <= 4)
_KERNEL = [1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16]


class DenoiseState(NamedTuple):
    color: torch.Tensor      # (H, W, 3) accumulated signal
    moments: torch.Tensor    # (H, W, 2) first/second luminance moments
    history: torch.Tensor    # (H, W) accumulated frame count
    depth: torch.Tensor      # (H, W) previous depth (validation)
    normal: torch.Tensor     # (H, W, 3) previous normal (validation)


def denoise_init(h: int, w: int, device) -> DenoiseState:
    return DenoiseState(color=torch.zeros((h, w, 3), device=device),
                        moments=torch.zeros((h, w, 2), device=device),
                        history=torch.zeros((h, w), device=device),
                        depth=torch.zeros((h, w), device=device),
                        normal=torch.zeros((h, w, 3), device=device))


def temporal_accumulate(signal, gb, state: DenoiseState, max_history: float = 32.0,
                        sample_valid=None, shard=None):
    """Reproject, validate by depth + normal, blend with 1/(history+1),
    accumulate luminance moments. Returns (color, variance, new state).

    ``sample_valid`` (H, W) bool, optional: the lanes that traced a fresh
    sample this frame (half-rate checkerboard tracing). The others carry
    the reprojected history unchanged; where they have no history either,
    the signal is rebuilt from the horizontal neighbours (which traced, the
    parity alternating along x) and the history is set to 0, "no data"."""
    H, W = signal.shape[0], signal.shape[1]
    dev = signal.device
    xs = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(H, dtype=torch.float32, device=dev) + global_y0(shard) + 0.5
    prev_x = xs[None, :] + gb.motion[..., 0]
    prev_y = ys[:, None] + gb.motion[..., 1]
    on = (prev_x >= 0) & (prev_x < W) & (prev_y >= 0) & (prev_y < full_height(shard, H))
    packed = torch.cat([state.color, state.moments, state.history[..., None],
                        state.depth[..., None], state.normal], -1)
    pw = warp_image(packed, gb.motion, halo=REPROJECT_HALO, shard=shard)
    pc, pm = pw[..., 0:3], pw[..., 3:5]
    ph, pd, pn = pw[..., 5], pw[..., 6], pw[..., 7:10]

    dep_ok = torch.abs(pd - gb.depth) < 0.1 * torch.clamp(gb.depth, min=1e-3)
    nrm_ok = torch.sum(tm.normalize(pn) * gb.normal, -1) > 0.8
    valid = on & dep_ok & nrm_ok & gb.valid & (ph > 0)

    hist = torch.where(valid, torch.clamp(ph + 1.0, max=max_history), 1.0)
    a = (1.0 / hist)[..., None]
    color = torch.where(valid[..., None], pc + (signal - pc) * a, signal)
    lum = tm.luminance(signal)
    mom_new = torch.stack([lum, lum * lum], -1)
    moments = torch.where(valid[..., None], pm + (mom_new - pm) * a, mom_new)
    if sample_valid is not None:
        keep = valid & ~sample_valid           # history-only lanes
        color = torch.where(keep[..., None], pc, color)
        moments = torch.where(keep[..., None], pm, moments)
        hole = ~valid & ~sample_valid
        left = torch.cat([signal[:, :1], signal[:, :-1]], 1)
        right = torch.cat([signal[:, 1:], signal[:, -1:]], 1)
        recon = 0.5 * (left + right)
        color = torch.where(hole[..., None], recon, color)
        lum_r = tm.luminance(recon)
        moments = torch.where(hole[..., None], torch.stack([lum_r, lum_r * lum_r], -1), moments)
        hist = torch.where(keep, ph, torch.where(sample_valid, hist, 0.0))
    new_state = DenoiseState(color=color, moments=moments, history=hist,
                             depth=gb.depth, normal=gb.normal)
    var = torch.clamp(moments[..., 1] - moments[..., 0] ** 2, min=0.0)
    var = var * (1.0 + 4.0 / torch.clamp(hist, min=1.0))   # young history blurs more
    return color, var, new_state


def atrous_filter(color, var, gb, iterations: int = 3, sigma_z: float = 1.0,
                  sigma_n: float = 64.0, sigma_l: float = 4.0, radius_px=None, shard=None):
    """Edge-aware A-trous wavelet chain; ``radius_px`` (H, W), optional,
    fades out taps farther than a per-pixel radius (the REBLUR profile).
    The planes a step reads are extended together (one halo exchange a
    step under a shard)."""
    H, W = color.shape[0], color.shape[1]
    pad = ATROUS_PAD
    nd_e = pad_edges(torch.cat([gb.normal, gb.depth[..., None]], -1), pad, shard)
    n_e, d_e = nd_e[..., 0:3], nd_e[..., 3]

    def tap(x_e, dy, dx):
        return x_e[pad + dy:pad + dy + H, pad + dx:pad + dx + W]

    for it in range(iterations):
        step = 1 << it
        lum_c = tm.luminance(color)
        cvl_e = pad_edges(torch.cat([color, var[..., None], lum_c[..., None]], -1), pad, shard)
        c_e, v_e, l_e = cvl_e[..., 0:3], cvl_e[..., 3], cvl_e[..., 4]
        k0 = _KERNEL[2] * _KERNEL[2]
        acc = color * k0
        acc_w = torch.full((H, W), k0, device=color.device)
        acc_v = var * k0 ** 2
        std = torch.sqrt(torch.clamp(var, min=0.0)) + 1e-4
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                if dx == 0 and dy == 0:
                    continue
                k = _KERNEL[dy + 2] * _KERNEL[dx + 2]
                sy, sx = dy * step, dx * step
                sn, sd = tap(n_e, sy, sx), tap(d_e, sy, sx)
                w_n = torch.pow(torch.clamp(torch.sum(sn * gb.normal, -1), min=0.0), sigma_n)
                w_z = torch.exp(-torch.abs(sd - gb.depth)
                                / (sigma_z * 0.05 * torch.clamp(gb.depth, min=1e-3) * step
                                   + 1e-6))
                w_l = torch.exp(-torch.abs(tap(l_e, sy, sx) - lum_c) / (sigma_l * std + 1e-4))
                w = k * w_n * w_z * w_l
                if radius_px is not None:
                    r_tap = step * float((dx * dx + dy * dy) ** 0.5)
                    w = w * torch.clamp(2.0 * (radius_px / r_tap - 0.5), 0.0, 1.0)
                acc = acc + tap(c_e, sy, sx) * w[..., None]
                acc_w = acc_w + w
                acc_v = acc_v + tap(v_e, sy, sx) * w * w
        color = acc / torch.clamp(acc_w[..., None], min=1e-6)
        var = acc_v / torch.clamp(acc_w * acc_w, min=1e-6)
    return color


def demodulation_factor(gb):
    """Reflectance estimate divided out before denoising and re-applied
    after (the NRD demodulation convention); floored for near-black."""
    diff, f0, _ = brdf_params(gb.albedo, gb.orm[..., 2], gb.orm[..., 1])
    return torch.clamp(diff + f0, min=0.03)


def denoise(signal, gb, state: DenoiseState, profile: str = "relax", debug_out: dict = None,
            shard=None):
    """Full chain: demodulate, temporal accumulation, A-trous, remodulate.
    Returns (denoised, new state). ``debug_out``: a dict that receives the
    remodulated temporal and denoised signals and the history length (the
    ssgi_* debug views)."""
    if profile not in ("relax", "reblur"):
        raise ValueError(f"unknown denoiser profile '{profile}'")
    mod = demodulation_factor(gb)
    color, var, new_state = temporal_accumulate(signal / mod, gb, state, shard=shard)
    radius = None
    if profile == "reblur":
        # 8 px with no history -> near-identity as the accumulation converges
        radius = torch.clamp(8.0 / (1.0 + 0.5 * new_state.history), min=0.7)
    out = atrous_filter(color, var, gb, radius_px=radius, shard=shard) * mod
    if debug_out is not None:
        debug_out.update(temporal=color * mod, denoised=out, age=new_state.history)
    return out, new_state
