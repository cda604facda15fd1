"""Depth/normal-guided (joint bilateral) upsampling of low-res lighting grids
(counterpart of hobbyrenderer_tpu/ops/upsample.py on one device, where its
row halos are no-ops).

The grid is sampled at full pixels (i*s, j*s) (top-left aligned). A full
pixel y interpolates grid rows y//s and y//s + 1 (edge-clamped) with weight
(y % s)/s; each of the four bilinear candidates is weighted by its depth
and normal similarity to the full-res pixel. Where every candidate dies,
the plain bilinear blend is used instead."""

from __future__ import annotations

import torch

__all__ = ["joint_bilateral_upsample"]

DEPTH_REL = 0.1     # depth weight falloff, relative to the full-res depth
NORMAL_POW = 8.0    # normal weight: max(n_q . n, 0) ** NORMAL_POW


def _axis_pair(q, scale: int, axis: int):
    """lo[y] = q[y // s], hi[y] = q[min(y // s + 1, n - 1)] along ``axis``."""
    n = q.shape[axis]
    q_hi = torch.cat([q.narrow(axis, 1, n - 1), q.narrow(axis, n - 1, 1)], dim=axis)
    return (torch.repeat_interleave(q, scale, dim=axis),
            torch.repeat_interleave(q_hi, scale, dim=axis))


def _frac(n: int, scale: int, device):
    """f[y] = (y % s) / s for y in [0, n*s)."""
    return (torch.arange(scale, dtype=torch.float32, device=device) / scale).repeat(n)


def _fit(x, H: int, W: int):
    """Edge-extend an (Hs, Ws, ...) map to (H, W, ...) when H % s != 0."""
    if x.shape[0] < H:
        x = torch.cat([x, x[-1:].expand((H - x.shape[0],) + x.shape[1:])], 0)
    if x.shape[1] < W:
        x = torch.cat([x, x[:, -1:].expand((x.shape[0], W - x.shape[1]) + x.shape[2:])], 1)
    return x[:H, :W]


def joint_bilateral_upsample(q, q_depth, q_nrm, q_valid, f_depth, f_nrm, scale: int):
    """Upsample a (Hg, Wg, C) grid to full (H, W, C) with geometry guidance.

    q_depth / q_nrm / q_valid are the G-buffer at the grid's pixels
    (``[::scale]``); f_depth / f_nrm the full-res guides, whose shape sets
    the output's."""
    Hg, Wg = q.shape[:2]
    H, W = f_depth.shape[:2]
    C = q.shape[-1]
    pack = torch.cat([q, q_depth[..., None], q_nrm, q_valid[..., None].to(q.dtype)], -1)
    lo, hi = _axis_pair(pack, scale, 0)
    p00, p01 = _axis_pair(lo, scale, 1)
    p10, p11 = _axis_pair(hi, scale, 1)
    fy = _frac(Hg, scale, q.device)[:, None]
    fx = _frac(Wg, scale, q.device)[None, :]
    b = ((1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx)
    fd = _fit(f_depth[..., None], H, W)[..., 0]
    fn = _fit(f_nrm, H, W)
    num = torch.zeros((H, W, C), dtype=q.dtype, device=q.device)
    den = torch.zeros((H, W), dtype=q.dtype, device=q.device)
    num_b = torch.zeros_like(num)
    den_b = torch.zeros_like(den)
    for cand, bw in zip((p00, p01, p10, p11), b):
        cand = _fit(cand, H, W)
        val = cand[..., :C]
        zq = cand[..., C]
        nq = cand[..., C + 1:C + 4]
        okq = cand[..., C + 4]
        gz = torch.exp(-torch.abs(zq - fd) / (DEPTH_REL * torch.clamp(torch.abs(fd), min=1e-3)))
        gn = torch.clamp(torch.sum(nq * fn, -1), min=0.0) ** NORMAL_POW
        w = bw * okq * gz * gn
        num = num + val * w[..., None]
        den = den + w
        wb = bw * okq
        num_b = num_b + val * wb[..., None]
        den_b = den_b + wb
    guided = num / torch.clamp(den, min=1e-8)[..., None]
    plain = num_b / torch.clamp(den_b, min=1e-8)[..., None]
    out = torch.where((den > 1e-6)[..., None], guided, plain)
    return torch.where((den_b > 1e-6)[..., None], out, 0.0)
