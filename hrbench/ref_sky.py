"""The plain reference's sky: the Bruneton-class precomputed atmosphere
that the path tracer reads on a miss (HobbyRenderer's default "bruneton"
sky), written out again in NumPy (the two host tables) and PyTorch (the
32-step in-scatter march and the sun disk).

Sunlight travels along ``sun_dir``; the sun's colour, intensity and
angular radius are the configuration's ``settings``."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

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
MS_RES = 32
MARCH_STEPS = 32
OBSERVER_H_KM = 0.2


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


def _transmittance_integral(r, mu, steps):
    d = _dist_to_top(r, mu)
    t = (np.arange(steps, dtype=np.float32) + 0.5) / steps
    tt = d[..., None] * t
    rr = np.sqrt(r[..., None] ** 2 + tt ** 2 + 2.0 * r[..., None] * tt * mu[..., None])
    tau = _extinction(rr - RB).sum(-2) * (d / steps)[..., None]
    return np.exp(-tau).astype(np.float32)


@functools.lru_cache(maxsize=1)
def multiscatter_lut() -> np.ndarray:
    """(MS_RES, MS_RES, 3) second-order multiple scattering over (observer
    radius, sun cosine): 64 golden-spiral directions, 20 steps each."""
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
    return (L2 / np.maximum(1.0 - fms, 1e-3)).astype(np.float32)


def _sample_ms(r: float, mu_s, ms):
    """Bilinear tap of the multiple-scattering table at (r, mu_s)."""
    x = torch.clamp((mu_s * 0.5 + 0.5) * MS_RES - 0.5, 0.0, MS_RES - 1.0)
    y = min(max(np.float32((r - RB) / H_ATM * MS_RES - 0.5), np.float32(0.0)),
            np.float32(MS_RES - 1.0))
    x0 = torch.floor(x).to(torch.int64)
    y0 = int(np.floor(y))
    x1 = torch.clamp(x0 + 1, max=MS_RES - 1)
    y1 = min(y0 + 1, MS_RES - 1)
    fx = (x - x0)[..., None]
    fy = float(np.float32(y - np.float32(y0)))
    return ((ms[y0][x0] * (1 - fx) + ms[y0][x1] * fx) * (1 - fy)
            + (ms[y1][x0] * (1 - fx) + ms[y1][x1] * fx) * fy)


def _ozone_column_above(h):
    h = torch.clamp(h, 0.0, 40.0)
    falling = (40.0 - h) ** 2 / 30.0
    rising = 15.0 - (h - 10.0) ** 2 / 30.0
    return torch.where(h >= 25.0, falling, torch.where(h >= 10.0, rising, 15.0))


def _airmass(mu):
    """Kasten-Young 1989 relative air mass (x201 below the horizon)."""
    mu_c = torch.clamp(mu, 0.0, 1.0)
    chi = torch.rad2deg(torch.arccos(mu_c))
    m = 1.0 / (mu_c + 0.50572 * (96.07995 - chi) ** -1.6364)
    return m * (1.0 + torch.clamp(-mu, 0.0, 1.0) * 200.0)


def _sun_transmittance(h, mu_s, beta_r, beta_o):
    vod = (beta_r * (H_R * torch.exp(-h / H_R))[..., None]
           + (BETA_M_SCAT + BETA_M_ABS) * (H_M * torch.exp(-h / H_M))[..., None]
           + beta_o * _ozone_column_above(h)[..., None])
    return torch.exp(-vod * _airmass(mu_s)[..., None])


def _normalize(v):
    return v / torch.clamp(torch.sqrt(torch.sum(v * v, -1, keepdim=True)), min=1e-20)


def sky_radiance(d, sun_dir, settings: dict, with_sun_disk: bool):
    """Radiance (..., 3) of the sky in unit directions d (..., 3), in d's
    dtype; ``sun_dir`` (3,) the direction sunlight travels."""
    dev, dt_ = d.device, d.dtype
    beta_r = torch.as_tensor(BETA_R, device=dev).to(dt_)
    beta_o = torch.as_tensor(BETA_O, device=dev).to(dt_)
    ms = torch.as_tensor(multiscatter_lut(), device=dev).to(dt_)
    d = _normalize(d)
    to_sun = -_normalize(sun_dir.to(dt_))
    r0 = RB + OBSERVER_H_KM
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
    t = ((torch.arange(S, dtype=torch.float32, device=dev) + 0.5) / S).to(dt_)
    tt = d_max[..., None] * t
    rr = torch.sqrt(r0 * r0 + tt * tt + 2.0 * r0 * tt * mu[..., None])
    h = torch.clamp(rr - RB, min=0.0)
    rho_r = torch.exp(-h / H_R)
    rho_m = torch.exp(-h / H_M)
    rho_o = torch.clamp(1.0 - torch.abs(h - 25.0) / 15.0, min=0.0)
    scat_r = beta_r * rho_r[..., None]
    scat_m = BETA_M_SCAT * rho_m[..., None]
    ext = scat_r + (BETA_M_SCAT + BETA_M_ABS) * rho_m[..., None] + beta_o * rho_o[..., None]
    dt = (d_max / S)[..., None, None]
    tau = torch.cumsum(ext * dt, dim=-2)
    Tr_view = torch.exp(-(tau - 0.5 * ext * dt))

    mu_s_loc = torch.clamp((r0 * mu_s + tt * cos_g[..., None]) / torch.clamp(rr, min=1e-3),
                           -1.0, 1.0)
    Ts = _sun_transmittance(h, mu_s_loc, beta_r, beta_o)
    p_r = (3.0 / (16.0 * math.pi) * (1.0 + cos_g * cos_g))[..., None, None]
    g = MIE_G
    p_m = ((1 - g * g) / (4 * math.pi * torch.pow(
        torch.clamp(1 + g * g - 2 * g * cos_g, min=1e-4), 1.5)))[..., None, None]
    psi = _sample_ms(r0, mu_s, ms)
    inscat = (Tr_view * (Ts * (scat_r * p_r + scat_m * p_m) + psi * (scat_r + scat_m))
              * dt).sum(-2)

    E_sun = torch.as_tensor(np.asarray(settings["sun_color"], np.float32),
                            device=dev).to(dt_) * float(settings["sun_intensity"])
    L = inscat * E_sun
    T_path = torch.exp(-tau[..., -1, :])
    Tg_sun = _sun_transmittance(torch.zeros((), device=dev, dtype=dt_), mu_s, beta_r, beta_o)
    L_ground = (0.3 / math.pi) * Tg_sun * torch.clamp(mu_s, min=0.0) * E_sun
    L = L + torch.where(hits_ground[..., None], T_path * L_ground, 0.0)
    if with_sun_disk:
        cos_r = np.cos(np.float32(settings["sun_angular_radius"]))
        omega = float(np.float32(2 * np.pi) * (np.float32(1.0) - cos_r))
        disk = (cos_g >= float(cos_r)) & ~hits_ground
        T_sun = _sun_transmittance(torch.full((), OBSERVER_H_KM, device=dev, dtype=dt_), mu,
                                   beta_r, beta_o)
        L = torch.where(disk[..., None], E_sun / max(omega, 1e-6) * T_sun, L)
    return L
