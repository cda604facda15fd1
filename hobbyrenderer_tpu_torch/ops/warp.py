"""Screen-space reprojection (counterpart of hobbyrenderer_tpu/ops/warp.py,
single device): a global integer shift plus a per-pixel residual over
2R+1 shifted slices per axis, separable, edge-clamped. The same arithmetic as
the JAX version, so TAA history fetches agree with it."""

from __future__ import annotations

import torch
import torch.nn.functional as F

WARP_RADIUS = 8
WARP_COL_PAD = 96


def extend_rows(x, halo: int):
    """(h, w, ...) -> (h + 2*halo, w, ...) with edge-replicated rows."""
    if halo == 0:
        return x
    return torch.cat([x[:1].expand(halo, *x.shape[1:]), x,
                      x[-1:].expand(halo, *x.shape[1:])], 0)


def pad_edges(x, pad: int):
    """(h, w, ...) -> (h + 2*pad, w + 2*pad, ...), edge-replicated."""
    x = extend_rows(x, pad)
    return torch.cat([x[:, :1].expand(-1, pad, *x.shape[2:]), x,
                      x[:, -1:].expand(-1, pad, *x.shape[2:])], 1)


def warp_image(img, motion, halo: int = 32, radius: int = WARP_RADIUS,
               col_pad: int = WARP_COL_PAD, bilinear: bool = True):
    """img (H, W, C) sampled at pixel_center + motion (H, W, 2), bilinearly
    or (``bilinear=False``) at the nearest texel; integer data rides as f32
    with bilinear=False (one-hot weights move values exactly). ``radius`` is
    the per-pixel residual reach after the global shift, ``col_pad`` bounds
    the global column shift."""
    H, W, Cc = img.shape
    R = radius
    assert halo - R >= 1, "halo must exceed the residual radius"
    dev = img.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    if bilinear:
        sx = torch.clamp(xs[None, :] + motion[..., 0], 0.0, W - 1.0)
        sy_l = torch.clamp(ys[:, None] + motion[..., 1], 0.0, H - 1.0)
    else:
        # nearest: floor(pixel_center + motion) = round-to-texel
        sx = torch.clamp(torch.floor(xs[None, :] + 0.5 + motion[..., 0]), 0.0, W - 1.0)
        sy_l = torch.clamp(torch.floor(ys[:, None] + 0.5 + motion[..., 1]), 0.0, H - 1.0)
    # global integer shift; the window is gathered by index so no value is
    # read back to the host
    gy = torch.clamp(torch.round(torch.mean(sy_l - ys[:, None])).to(torch.int64),
                     -(halo - R), halo - R - 1)
    gx = torch.clamp(torch.round(torch.mean(sx - xs[None, :])).to(torch.int64),
                     -(col_pad - R), col_pad - R - 1)
    ext = extend_rows(img, halo)
    pad = F.pad(ext.permute(2, 0, 1)[None], (col_pad, col_pad, 0, 0),
                mode="replicate")[0].permute(1, 2, 0)
    rows = halo + gy - R + torch.arange(H + 2 * R + 1, device=dev)
    cols = col_pad + gx - R + torch.arange(W + 2 * R + 1, device=dev)
    win = pad.index_select(0, rows).index_select(1, cols)

    my = sy_l - ys[:, None]
    my_p = torch.cat([my[:, :1].expand(H, R), my, my[:, -1:].expand(H, R + 1)], 1)
    iy = torch.floor(my_p)
    fy = my_p - iy
    ry = torch.clamp(iy.to(torch.int64) - gy, -R, R - 1)
    t = torch.zeros((H, W + 2 * R + 1, Cc), dtype=img.dtype, device=dev)
    for d in range(-R, R + 1):
        w = torch.where(ry == d, 1.0 - fy, 0.0) + torch.where(ry == d - 1, fy, 0.0)
        t = t + w[..., None] * win[R + d:R + d + H]

    rxf = sx - xs[None, :]
    ix = torch.floor(rxf)
    fx = rxf - ix
    rx = torch.clamp(ix.to(torch.int64) - gx, -R, R - 1)
    out = torch.zeros((H, W, Cc), dtype=img.dtype, device=dev)
    for e in range(-R, R + 1):
        w = torch.where(rx == e, 1.0 - fx, 0.0) + torch.where(rx == e - 1, fx, 0.0)
        out = out + w[..., None] * t[:, R + e:R + e + W]
    return out
