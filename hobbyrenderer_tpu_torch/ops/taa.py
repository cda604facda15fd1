"""Temporal anti-aliasing at native resolution and TAA upscaling
(counterpart of hobbyrenderer_tpu/ops/taa.py: taa_resolve and
taau_resolve, single device)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from hobbyrenderer_tpu_torch.ops.warp import extend_rows, warp_image

HISTORY_HALO = 32


def _chw(x):
    return x.permute(2, 0, 1)[None]


def _hwc(x):
    return x[0].permute(1, 2, 0)


def _neighborhood_minmax(c_e, H):
    """3x3 min/max per channel over the 1-row-extended domain (columns see
    the window truncated at the edge, like reduce_window's -inf padding)."""
    mx = _hwc(F.max_pool2d(_chw(c_e), 3, 1, padding=1))[1:1 + H]
    mn = -_hwc(F.max_pool2d(_chw(-c_e), 3, 1, padding=1))[1:1 + H]
    return mn, mx


def taa_resolve(hdr, history, motion, valid_history: bool, settings):
    """One TAA step; returns the resolved frame (also the new history)."""
    H, W = hdr.shape[0], hdr.shape[1]
    dev = hdr.device
    ys = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    prev_x = px + motion[..., 0]
    prev_y = py + motion[..., 1]
    hist = warp_image(history, motion, halo=HISTORY_HALO)
    mn, mx = _neighborhood_minmax(extend_rows(hdr, 1), H)
    hist = torch.minimum(torch.maximum(hist, mn), mx)
    on_screen = (prev_x >= 0) & (prev_x < W) & (prev_y >= 0) & (prev_y < H)
    if valid_history:
        alpha = torch.where(on_screen[..., None], settings.taa_blend, 1.0)
    else:
        alpha = torch.ones_like(hdr[..., :1])
    return _sharpen(hist + (hdr - hist) * alpha, settings)


def _sharpen(out, settings):
    """out + (out - 3x3 box) * sharpness, clamped at 0; the box has
    zero-padded columns over the row-extended frame."""
    blur = _hwc(F.avg_pool2d(_chw(extend_rows(out, 1)), 3, 1, padding=1,
                             count_include_pad=True))[1:1 + out.shape[0]]
    return torch.clamp(out + (out - blur) * settings.sharpness, min=0.0)


def _linear_taps(in_size: int, out_size: int, scale: float, trans: float, device):
    """jax.image.scale_and_translate's "linear" weights for one axis as
    taps: [(index (out,), weight (out,))], the input samples each output
    reads, with the triangle filter (widened by 1/scale when shrinking)
    normalised over the in-range taps, and zero weight where the sample
    point falls outside the input. Index 0 stands in where a weight is 0."""
    inv = np.float32(1.0) / np.float32(scale)
    ks = float(max(inv, np.float32(1.0)))
    sf = ((torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * float(inv)
          - float(np.float32(trans) * inv) - 0.5)
    base = torch.floor(sf).to(torch.int64)
    reach = math.ceil(ks)
    idx, wts = [], []
    for off in range(1 - reach, reach + 1):
        i = base + off
        w = torch.clamp(1.0 - torch.abs(sf - i) / ks, min=0.0)
        ok = (i >= 0) & (i < in_size)
        idx.append(torch.where(ok, i, 0))
        wts.append(torch.where(ok, w, 0.0))
    total = wts[0]
    for w in wts[1:]:
        total = total + w
    live = (torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)) \
        & (sf >= -0.5) & (sf <= in_size - 0.5)
    norm = torch.where(total != 0, total, 1.0)
    return [(i, torch.where(live, w / norm, 0.0)) for i, w in zip(idx, wts)]


def _resample(x, taps_y, taps_x):
    """(h, w, C) -> (out_h, out_w, C): rows, then columns, from their taps."""
    rows = None
    for i, w in taps_y:
        t = x.index_select(0, i) * w[:, None, None]
        rows = t if rows is None else rows + t
    out = None
    for i, w in taps_x:
        t = rows.index_select(1, i) * w[None, :, None]
        out = t if out is None else out + t
    return out


def taau_resolve(hdr_lr, history, motion_lr, valid_history: bool, settings, jitter,
                 out_h: int, out_w: int):
    """One TAA upscaling step: the jittered (h, w, 3) render resampled to
    the (out_h, out_w) output (linear, translated by the jitter), blended
    into the output-size history by a per-pixel confidence (the distance
    from the output pixel centre to the nearest jittered render sample).
    ``motion_lr`` (h, w, 2) is prev - cur in render pixels, ``jitter``
    (jx, jy) this frame's sub-pixel offset in render pixels, as host floats.
    Returns the resolved output frame (also the new history)."""
    h, w = hdr_lr.shape[:2]
    dev = hdr_lr.device
    sx, sy = out_w / w, out_h / h
    jx, jy = float(jitter[0]), float(jitter[1])
    # render sample i sits at (i + 0.5 + j) render px = (i + 0.5 + j) * s
    # output px: a translation of s * j
    tx = float(np.float32(sx) * np.float32(jx))
    ty = float(np.float32(sy) * np.float32(jy))
    taps_y = _linear_taps(h, out_h, sy, ty, dev)
    taps_x = _linear_taps(w, out_w, sx, tx, dev)
    cur = _resample(hdr_lr, taps_y, taps_x)
    mot = _resample(motion_lr, taps_y, taps_x)
    mot = torch.stack([mot[..., 0] * sx, mot[..., 1] * sy], -1)   # render -> output px

    hist = warp_image(history, mot, halo=HISTORY_HALO)
    mn, mx = _neighborhood_minmax(extend_rows(cur, 1), out_h)
    hist = torch.minimum(torch.maximum(hist, mn), mx)

    xo = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) / sx
    yo = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) / sy
    dx = xo - (torch.floor(xo - 0.5 - jx) + 0.5 + jx)
    dx = torch.minimum(torch.abs(dx), torch.abs(dx - 1.0))
    dy = yo - (torch.floor(yo - 0.5 - jy) + 0.5 + jy)
    dy = torch.minimum(torch.abs(dy), torch.abs(dy - 1.0))
    conf = torch.exp(-4.0 * (dy[:, None] ** 2 + dx[None, :] ** 2))

    py, px = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5,
                            torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5,
                            indexing="ij")
    prev_x, prev_y = px + mot[..., 0], py + mot[..., 1]
    on_screen = (prev_x >= 0) & (prev_x < out_w) & (prev_y >= 0) & (prev_y < out_h)
    if valid_history:
        alpha = torch.where(on_screen[..., None],
                            settings.taa_blend * (0.25 + 0.75 * conf)[..., None], 1.0)
    else:
        alpha = torch.ones_like(cur[..., :1])
    return _sharpen(hist + (cur - hist) * alpha, settings)
