"""Hierarchical Z-buffer (counterpart of hobbyrenderer_tpu/ops/hzb.py).

Reversed-Z min pyramid as a padded (levels, h0, w0) stack; level 0 is a
fixed-stride conservative min fold of the full-res depth."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hobbyrenderer_tpu_torch.utils.math import prev_pow2


def hzb_sizes(width: int, height: int):
    w0 = prev_pow2(width)
    h0 = prev_pow2(height)
    levels = max(min(w0, h0).bit_length() - 1, 1)
    return h0, w0, int(min(levels, 12))


def hzb_effective_size(width: int, height: int):
    h0, w0, _ = hzb_sizes(width, height)
    fy = -(-height // h0)
    fx = -(-width // w0)
    return height / fy, width / fx


def _min_pool(x, kh, kw):
    return -F.max_pool2d(-x[None, None], (kh, kw), (kh, kw))[0, 0]


def build_hzb(depth: torch.Tensor, levels: int, h0: int, w0: int) -> torch.Tensor:
    """depth (H, W) reversed-Z -> (levels, h0, w0) min-pyramid stack."""
    H, W = depth.shape
    fy = -(-H // h0)
    fx = -(-W // w0)
    padded = F.pad(depth, (0, fx * w0 - W, 0, fy * h0 - H), value=0.0)
    lvl = _min_pool(padded, fy, fx)
    out = torch.zeros((levels, h0, w0), dtype=torch.float32, device=depth.device)
    out[0, :h0, :w0] = lvl
    h, w = h0, w0
    for li in range(1, levels):
        h, w = max(h // 2, 1), max(w // 2, 1)
        lvl = _min_pool(lvl, 2, 2)
        out[li, :h, :w] = lvl
    return out
