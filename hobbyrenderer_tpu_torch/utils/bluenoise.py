"""Blue-noise texture (void-and-cluster, Ulichney 1993): the numpy generator
of hobbyrenderer_tpu/utils/bluenoise.py, copied so the port's texture is
byte for byte the JAX package's, and torch versions of its per-frame
animation and screen tiling. Generated at first use (about a second for a
64x64 tile) and cached in-process."""

from __future__ import annotations

import functools

import numpy as np
import torch

GOLDEN = 0.6180339887498949
SIZE = 64           # texels per side
SIGMA = 1.9         # texels: the energy kernel's gaussian width


@functools.lru_cache(maxsize=4)
def blue_noise(seed: int) -> np.ndarray:
    """(SIZE, SIZE) f32 blue-noise ranks in [0, 1) — each texel a unique rank."""
    rng = np.random.default_rng(seed)
    n, sigma = SIZE, SIGMA
    N = n * n

    # wrap-around gaussian energy kernel in Fourier space
    x = np.arange(n)
    d = np.minimum(x, n - x).astype(np.float64)
    d2 = d[:, None] ** 2 + d[None, :] ** 2
    kern = np.exp(-d2 / (2.0 * sigma * sigma))
    Fk = np.fft.rfft2(kern)

    def energy(mask):
        return np.fft.irfft2(np.fft.rfft2(mask) * Fk, s=(n, n))

    # initial pattern: 10% ones, relaxed so no tight clusters remain
    m = np.zeros(N, bool)
    m[rng.choice(N, N // 10, replace=False)] = True
    m = m.reshape(n, n)
    for _ in range(4 * N):
        e = energy(m.astype(np.float64))
        cluster = np.argmax(np.where(m, e, -np.inf))
        m.flat[cluster] = False
        e = energy(m.astype(np.float64))
        void = np.argmin(np.where(m, np.inf, e))
        if void == cluster:
            m.flat[cluster] = True
            break
        m.flat[void] = True

    rank = np.zeros((n, n), np.int64)
    # phase 1: remove ones tightest-cluster-first -> ranks count-1 .. 0
    work = m.copy()
    for r in range(int(m.sum()) - 1, -1, -1):
        e = energy(work.astype(np.float64))
        i = np.argmax(np.where(work, e, -np.inf))
        work.flat[i] = False
        rank.flat[i] = r
    # phase 2: fill zeros largest-void-first -> ranks count .. N-1
    work = m.copy()
    for r in range(int(m.sum()), N):
        e = energy(work.astype(np.float64))
        i = np.argmin(np.where(work, np.inf, e))
        work.flat[i] = True
        rank.flat[i] = r
    return ((rank.astype(np.float64) + 0.5) / N).astype(np.float32)


def animate(bn: torch.Tensor, frame: int) -> torch.Tensor:
    """Cranley-Patterson rotation by the golden ratio; ``frame`` is a uint32
    value (a python int in [0, 2^32)), converted to f32 as the JAX package
    converts its uint32."""
    f = torch.full((), frame & 0xFFFFFFFF, dtype=torch.float32, device=bn.device)
    return torch.remainder(bn + f * GOLDEN, 1.0)


@functools.lru_cache(maxsize=8)
def blue_noise_tensor(seed: int, device) -> torch.Tensor:
    """``blue_noise(seed)`` on ``device``, uploaded once."""
    return torch.as_tensor(blue_noise(seed), device=device)


def tile_for(bn: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Tile the blue-noise texture over an (height, width) screen."""
    n = bn.shape[0]
    return bn.tile((-(-height // n), -(-width // n)))[:height, :width]
