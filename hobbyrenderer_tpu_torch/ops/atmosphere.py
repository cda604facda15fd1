"""Bruneton-class precomputed atmosphere (counterpart of
hobbyrenderer_tpu/ops/atmosphere.py).

The transmittance and multiple-scattering LUTs are the same host numpy
precompute; sky radiance is the same 32-step in-scatter march, in torch.
The constant tables go to a device once (``device_tables``) and the
per-call constants are filled on the device, so a sky evaluation uploads
nothing (an upload from host memory waits for the stream)."""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from hobbyrenderer_tpu_torch.utils import tmath as tm

RB = 6360.0
RT = 6460.0
H_ATM = RT - RB
BETA_R = np.asarray([5.802e-3, 13.558e-3, 33.1e-3], np.float32)
H_R = 8.0
BETA_M_SCAT = 3.996e-3
BETA_M_ABS = 4.4e-3
H_M = 1.2
BETA_O = np.asarray([0.650e-3, 1.881e-3, 0.085e-3], np.float32)
MIE_G = 0.8
T_MU = 256
T_R = 64
MS_RES = 32
MARCH_STEPS = 32


class AtmosphereLUTs(NamedTuple):
    transmittance: np.ndarray   # (T_R, T_MU, 3)
    multiscatter: np.ndarray    # (MS_RES, MS_RES, 3)


def _densities(h):
    h = np.maximum(h, 0.0)
    return np.exp(-h / H_R), np.exp(-h / H_M), np.maximum(0.0, 1.0 - np.abs(h - 25.0) / 15.0)


def _extinction(h):
    rho_r, rho_m, rho_o = _densities(h)
    return (BETA_R[None, :] * rho_r[..., None]
            + (BETA_M_SCAT + BETA_M_ABS) * rho_m[..., None]
            + BETA_O[None, :] * rho_o[..., None])


def _dist_to_top(r, mu):
    disc = r * r * (mu * mu - 1.0) + RT * RT
    return np.maximum(-r * mu + np.sqrt(np.maximum(disc, 0.0)), 0.0)


def _transmittance_integral(r, mu, steps=48):
    d = _dist_to_top(r, mu)
    t = (np.arange(steps, dtype=np.float32) + 0.5) / steps
    tt = d[..., None] * t
    rr = np.sqrt(r[..., None] ** 2 + tt ** 2 + 2.0 * r[..., None] * tt * mu[..., None])
    tau = _extinction(rr - RB).sum(-2) * (d / steps)[..., None]
    return np.exp(-tau).astype(np.float32)


def _tlut_uv_to_rmu(u, v):
    H = np.sqrt(RT * RT - RB * RB)
    rho = v * H
    r = np.sqrt(rho * rho + RB * RB)
    d_min = RT - r
    d_max = rho + H
    d = d_min + u * (d_max - d_min)
    mu = np.where(d <= 0, 1.0, (H * H - rho * rho - d * d) / (2.0 * r * np.maximum(d, 1e-6)))
    return r, np.clip(mu, -1.0, 1.0)


@functools.lru_cache(maxsize=1)
def build_luts() -> AtmosphereLUTs:
    """Host-side precompute (same numbers as the JAX package's)."""
    uu, vv = np.meshgrid((np.arange(T_MU) + 0.5) / T_MU,
                         (np.arange(T_R) + 0.5) / T_R, indexing="xy")
    r, mu = _tlut_uv_to_rmu(uu, vv)
    T = _transmittance_integral(r, mu)
    rs = RB + ((np.arange(MS_RES) + 0.5) / MS_RES) * H_ATM
    mus = (np.arange(MS_RES) + 0.5) / MS_RES * 2.0 - 1.0
    r_g, mus_g = np.meshgrid(rs, mus, indexing="ij")
    golden = np.pi * (3.0 - np.sqrt(5.0))
    i = np.arange(64, dtype=np.float32) + 0.5
    dz = 1.0 - 2.0 * i / 64
    dr = np.sqrt(np.maximum(1.0 - dz * dz, 0.0))
    sph = np.stack([dr * np.cos(golden * i), dz, dr * np.sin(golden * i)], -1)
    L2 = np.zeros((MS_RES, MS_RES, 3), np.float32)
    fms = np.zeros((MS_RES, MS_RES, 3), np.float32)
    steps = 20
    for k in range(64):
        mu_d = sph[k, 1]
        d_top = _dist_to_top(r_g, np.full_like(r_g, mu_d))
        t = (np.arange(steps, dtype=np.float32) + 0.5) / steps
        tt = d_top[..., None] * t
        rr = np.sqrt(r_g[..., None] ** 2 + tt ** 2 + 2.0 * r_g[..., None] * tt * mu_d)
        h = rr - RB
        rho_r, rho_m, _ = _densities(h)
        scat = (BETA_R[None, None, None, :] * rho_r[..., None]
                + BETA_M_SCAT * rho_m[..., None])
        ext = _extinction(h)
        dt = (d_top / steps)[..., None, None]
        tau = np.cumsum(ext * dt, axis=-2)
        Tr = np.exp(-(tau - 0.5 * ext * dt))
        mu_s_loc = np.clip(mus_g[..., None], -1.0, 1.0)
        Ts = _transmittance_integral(
            rr.reshape(-1), np.broadcast_to(mu_s_loc, rr.shape).reshape(-1),
            steps=16).reshape(rr.shape + (3,))
        iso = 1.0 / (4.0 * np.pi)
        L2 += (Tr * scat * Ts * iso * dt).sum(-2) / 64.0 * 4.0 * np.pi * iso
        fms += (Tr * scat * dt).sum(-2) / 64.0
    psi = L2 / np.maximum(1.0 - fms, 1e-3)
    return AtmosphereLUTs(transmittance=T, multiscatter=psi.astype(np.float32))


@functools.lru_cache(maxsize=None)
def device_tables(device: torch.device) -> dict:
    """BETA_R, BETA_O and the multiple-scattering LUT on ``device`` (a
    device with its index), uploaded once per process."""
    return {"beta_r": torch.as_tensor(BETA_R, device=device),
            "beta_o": torch.as_tensor(BETA_O, device=device),
            "multiscatter": torch.as_tensor(build_luts().multiscatter, device=device)}


def _filled(values, device) -> torch.Tensor:
    """A small f32 vector of host floats, filled on the device (no upload)."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32, device=device)
                        for v in values])


def _sample_ms(r: float, mu_s, device):
    """Multiple-scattering factor at (observer radius r, sun cosine mu_s)."""
    x = torch.clamp((mu_s * 0.5 + 0.5) * MS_RES - 0.5, 0.0, MS_RES - 1.0)
    # the observer's row: a host constant, rounded to f32 like the x side
    y = min(max(np.float32((r - RB) / H_ATM * MS_RES - 0.5), np.float32(0.0)),
            np.float32(MS_RES - 1.0))
    x0 = torch.floor(x).to(torch.int64)
    y0 = int(np.floor(y))
    x1 = torch.clamp(x0 + 1, max=MS_RES - 1)
    y1 = min(y0 + 1, MS_RES - 1)
    fx = (x - x0)[..., None]
    fy = float(np.float32(y - np.float32(y0)))
    m = device_tables(device)["multiscatter"]

    def tap(row: int, col):
        # index_select: a 0-d index tensor would be read back to the host
        return m[row].index_select(0, col.reshape(-1)).reshape(col.shape + (3,))
    return ((tap(y0, x0) * (1 - fx) + tap(y0, x1) * fx) * (1 - fy)
            + (tap(y1, x0) * (1 - fx) + tap(y1, x1) * fx) * fy)


def _ozone_column_above(h):
    h = torch.clamp(h, 0.0, 40.0)
    falling = (40.0 - h) ** 2 / 30.0
    rising = 15.0 - (h - 10.0) ** 2 / 30.0
    return torch.where(h >= 25.0, falling, torch.where(h >= 10.0, rising, 15.0))


def _airmass(mu):
    """Kasten-Young 1989 relative air mass."""
    mu_c = torch.clamp(mu, 0.0, 1.0)
    chi = torch.rad2deg(torch.arccos(mu_c))
    m = 1.0 / (mu_c + 0.50572 * (96.07995 - chi) ** -1.6364)
    below = torch.clamp(-mu, 0.0, 1.0)
    return m * (1.0 + below * 200.0)


def sun_transmittance_analytic(h, mu_s):
    """T_sun(h, mu_s): per-species vertical optical depth x air mass."""
    tabs = device_tables(mu_s.device)
    beta_r, beta_o = tabs["beta_r"], tabs["beta_o"]
    vod = (beta_r * (H_R * torch.exp(-h / H_R))[..., None]
           + (BETA_M_SCAT + BETA_M_ABS) * (H_M * torch.exp(-h / H_M))[..., None]
           + beta_o * _ozone_column_above(h)[..., None])
    return torch.exp(-vod * _airmass(mu_s)[..., None])


def sun_disk_cos_omega(radius):
    """cos of the sun's angular radius and the disk's solid angle, rounded
    in float32 like the JAX package (1 - cos cancels: double precision would
    change the disk radiance by ~1%)."""
    cos_r = np.cos(np.float32(radius))
    omega = np.float32(2 * np.pi) * (np.float32(1.0) - cos_r)
    return float(cos_r), float(omega)


def _phase_rayleigh(c):
    return 3.0 / (16.0 * math.pi) * (1.0 + c * c)


def _phase_mie(c, g=MIE_G):
    return (1 - g * g) / (4 * math.pi * torch.pow(
        torch.clamp(1 + g * g - 2 * g * c, min=1e-4), 1.5))


def sky_radiance_lut(d, sun_dir, settings, observer_h_km: float = 0.2,
                     with_sun_disk: bool = True):
    """Sky radiance for unit view dirs d (..., 3); sun_dir (3,) tensor is the
    travel direction of sunlight."""
    dev = d.device
    d = tm.normalize(d)
    to_sun = -tm.normalize(sun_dir)
    r0 = RB + observer_h_km
    mu = d[..., 1]
    mu_s = to_sun[1]
    cos_g = torch.clamp(torch.sum(d * to_sun, -1), -1.0, 1.0)

    disc_g = r0 * r0 * (mu * mu - 1.0) + RB * RB
    hits_ground = (disc_g >= 0.0) & (mu < 0.0)
    d_ground = -r0 * mu - torch.sqrt(torch.clamp(disc_g, min=0.0))
    disc_t = r0 * r0 * (mu * mu - 1.0) + RT * RT
    d_top = -r0 * mu + torch.sqrt(torch.clamp(disc_t, min=0.0))
    d_max = torch.where(hits_ground, d_ground, d_top)

    S = MARCH_STEPS
    t = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) / S
    tt = d_max[..., None] * t
    rr = torch.sqrt(r0 * r0 + tt * tt + 2.0 * r0 * tt * mu[..., None])
    h = torch.clamp(rr - RB, min=0.0)
    rho_r = torch.exp(-h / H_R)
    rho_m = torch.exp(-h / H_M)
    rho_o = torch.clamp(1.0 - torch.abs(h - 25.0) / 15.0, min=0.0)
    tabs = device_tables(dev)
    scat_r = tabs["beta_r"] * rho_r[..., None]
    scat_m = BETA_M_SCAT * rho_m[..., None]
    ext = (scat_r + (BETA_M_SCAT + BETA_M_ABS) * rho_m[..., None]
           + tabs["beta_o"] * rho_o[..., None])
    dt = (d_max / S)[..., None, None]
    tau = torch.cumsum(ext * dt, dim=-2)
    Tr_view = torch.exp(-(tau - 0.5 * ext * dt))

    mu_s_loc = torch.clamp((r0 * mu_s + tt * cos_g[..., None])
                           / torch.clamp(rr, min=1e-3), -1.0, 1.0)
    Ts = sun_transmittance_analytic(h, mu_s_loc)

    p_r = _phase_rayleigh(cos_g)[..., None, None]
    p_m = _phase_mie(cos_g)[..., None, None]
    psi = _sample_ms(r0, mu_s, dev)
    inscat = (Tr_view * (Ts * (scat_r * p_r + scat_m * p_m)
                         + psi * (scat_r + scat_m)) * dt).sum(-2)

    E_sun = _filled(settings.sun_color, dev) * settings.sun_intensity
    L = inscat * E_sun
    T_path = torch.exp(-tau[..., -1, :])
    Tg_sun = sun_transmittance_analytic(torch.zeros((), device=dev), mu_s)
    L_ground = (0.3 / math.pi) * Tg_sun * torch.clamp(mu_s, min=0.0) * E_sun
    L = L + torch.where(hits_ground[..., None], T_path * L_ground, 0.0)

    if with_sun_disk:
        cos_r_d, omega = sun_disk_cos_omega(settings.sun_angular_radius)
        disk = (cos_g >= cos_r_d) & ~hits_ground
        T_sun = sun_transmittance_analytic(
            torch.full((), observer_h_km, dtype=torch.float32, device=dev), mu)
        L = torch.where(disk[..., None], E_sun / max(omega, 1e-6) * T_sun, L)
    return L
