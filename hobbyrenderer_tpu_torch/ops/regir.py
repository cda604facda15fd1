"""ReGIR: a world-space reservoir grid for localized light presampling
(counterpart of hobbyrenderer_tpu/ops/regir.py).

The grid is a presample-tile table: each cell holds one (S=128, 18) tile
of packed light rows [row (16), W, id], the format ReSTIR DI's candidate
stage (ops/restir.py, kernel K2) reads, where W is the cell reservoir's
reciprocal-pdf estimate (w_sum / (K * p_hat of the selected light)) in
place of the global tiles' 1/power_pdf. A cell's slots are K-round
streaming RIS over power-CDF draws with the target p-hat evaluated at the
cell's representative point (unshadowed luminance). Each 128-pixel segment
then reads the cell covering its centre pixel instead of a random tile.

Two layouts: ``onion`` (camera-centred shells, linear detail layers then
geometric coverage layers out to the scene radius, times azimuth and
elevation cells; the default) and ``grid`` (a uniform grid over the scene's
bounds). Everything here is plain PyTorch on the pool's device. The grid's
scalars (radii, origin, cell size) are f32 values kept on the host and
passed to the device as operation arguments: building and reading a grid
copies nothing between host and device and reads nothing back."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from hobbyrenderer_tpu_torch.ops import lights as lightops
from hobbyrenderer_tpu_torch.utils import tmath as tm
from hobbyrenderer_tpu_torch.utils.rng import pcg3d, uniform_from_bits

ONION_DIMS = (5, 10, 12, 6)     # (detail layers, coverage layers, azimuth, elevation)
GRID_DIMS = (12, 6, 12)


class RegirGrid(NamedTuple):
    rows: torch.Tensor           # (C, S, 18) f32 presample-tile-format cell tables
    lo: tuple                    # (3,) f32 grid origin (grid mode), host floats
    inv_cell: tuple              # (3,) f32 1 / cell size (grid mode), host floats
    dims: tuple                  # (nx, ny, nz) (grid mode)
    mode: str = "grid"           # "grid" | "onion"
    cam: torch.Tensor = None     # (3,) onion centre (the camera position)
    onion_dims: tuple = None     # (n_detail, n_coverage, n_az, n_el)
    r_detail: float = None       # f32 outer radius of the detail layers
    r_max: float = None          # f32 outer radius of the last layer


def _f32(x) -> float:
    """A host number rounded to f32 (the reference computes these on the
    device in f32)."""
    return float(np.float32(x))


def _layer_ratio(r_detail: float, r_max: float, n_cov: int) -> float:
    """The coverage layers' geometric ratio, in f32."""
    return _f32(np.float32(r_max / max(r_detail, _f32(1e-3))) ** np.float32(1.0 / n_cov))


def _onion_centers(cam, r_detail: float, r_max: float, onion_dims):
    """(C, 3) representative points of the onion cells: each shell's
    mid-radius along its angular cell's central direction."""
    n_det, n_cov, n_az, n_el = onion_dims
    C = (n_det + n_cov) * n_az * n_el
    ci = torch.arange(C, device=cam.device)
    az = ci % n_az
    el = (ci // n_az) % n_el
    layer = ci // (n_az * n_el)
    # detail: linear spacing in [0, r_detail); coverage: geometric to r_max
    g = _layer_ratio(r_detail, r_max, n_cov)
    lf = layer.to(torch.float32)
    r_mid = torch.where(layer < n_det, r_detail * (lf + 0.5) / n_det,
                        r_detail * torch.pow(g, lf - n_det + 0.5))
    az_c = (az.to(torch.float32) + 0.5) / n_az * (2.0 * math.pi) - math.pi
    el_c = (el.to(torch.float32) + 0.5) / n_el * math.pi - 0.5 * math.pi
    d = torch.stack([torch.cos(el_c) * torch.cos(az_c), torch.sin(el_c),
                     torch.cos(el_c) * torch.sin(az_c)], -1)
    return cam[None, :] + d * r_mid[..., None]


def build_regir_onion(pool: lightops.LightPool, cam, scene_radius: float, frame: int,
                      onion_dims=ONION_DIMS, tile_size: int = 128,
                      rounds: int = 4) -> RegirGrid:
    """Onion-mode cells around the camera ``cam`` (3,) out to the scene
    radius: (5 + 10) shells x 12 azimuth x 6 elevation = 1,080 cells."""
    cam = cam.to(torch.float32)
    r_max = max(_f32(scene_radius), 1.0)
    r_detail = _f32(np.float32(0.15) * np.float32(r_max))
    centers = _onion_centers(cam, r_detail, r_max, onion_dims)
    rows = _build_cells(pool, centers, frame, tile_size, rounds)
    return RegirGrid(rows=rows, lo=(0.0, 0.0, 0.0), inv_cell=(1.0, 1.0, 1.0), dims=(0, 0, 0),
                     mode="onion", cam=cam, onion_dims=tuple(onion_dims), r_detail=r_detail,
                     r_max=r_max)


def build_regir_grid(pool: lightops.LightPool, lo, hi, frame: int, dims=GRID_DIMS,
                     tile_size: int = 128, rounds: int = 4) -> RegirGrid:
    """Uniform cells over the scene's bounds [lo, hi]: 12 x 6 x 12 = 864
    cells, re-drawn every frame."""
    nx, ny, nz = dims
    C = nx * ny * nz
    dev = pool.power_cdf.device
    lo = np.asarray(lo, np.float32)
    cell_sz = (np.maximum(np.asarray(hi, np.float32) - lo, np.float32(1e-3))
               / np.asarray(dims, np.float32))
    ci = torch.arange(C, device=dev)
    cxyz = (ci % nx, (ci // nx) % ny, ci // (nx * ny))
    centers = torch.stack([float(lo[a]) + (cxyz[a].to(torch.float32) + 0.5) * float(cell_sz[a])
                           for a in range(3)], -1)
    rows = _build_cells(pool, centers, frame, tile_size, rounds)
    return RegirGrid(rows=rows, lo=tuple(float(x) for x in lo),
                     inv_cell=tuple(float(x) for x in np.float32(1.0) / cell_sz),
                     dims=tuple(dims))


def _build_cells(pool: lightops.LightPool, centers, frame: int, tile_size: int, rounds: int):
    """K-round streaming RIS over power-CDF draws on every (cell, slot)
    lane, p-hat the unshadowed luminance at the cell's point. Returns the
    (C, S, 18) tile table."""
    C = centers.shape[0]
    S = tile_size
    dev = centers.device
    slot = torch.arange(C * S, dtype=torch.int64, device=dev)
    frb = torch.full_like(slot, int(frame))
    pos = torch.repeat_interleave(centers, S, dim=0)          # (C*S, 3)
    N = pool.packed.shape[0]
    y_rows = torch.zeros((C * S, 16), device=dev)
    y_id = torch.full((C * S,), -1.0, device=dev)
    w_sum = torch.zeros((C * S,), device=dev)
    ph_y = torch.zeros((C * S,), device=dev)
    for k in range(rounds):
        bits = pcg3d(torch.stack([slot, frb, torch.full_like(slot, 900 + k)], -1))
        u_sel = uniform_from_bits(bits[..., 0])
        u_uv = torch.stack([uniform_from_bits(bits[..., 1]), uniform_from_bits(bits[..., 2])],
                           -1)
        ids = torch.clamp(torch.searchsorted(pool.power_cdf, u_sel), 0,
                          pool.power_pdf.shape[0] - 1)
        inv_pdf = 1.0 / torch.clamp(pool.power_pdf[ids], min=1e-20)
        rows = pool.packed[torch.clamp(ids, 0, N - 1)]
        _, rad, _ = lightops.light_incident_rows(rows, u_uv, pos)
        ph = tm.luminance(torch.clamp(rad, min=0.0))
        w = ph * inv_pdf if pool.n_total > 0 else torch.zeros_like(ph)
        w_sum = w_sum + w
        # streaming accept (counter RNG, one more channel)
        u_acc = uniform_from_bits(pcg3d(torch.stack(
            [slot, frb, torch.full_like(slot, 950 + k)], -1))[..., 0])
        accept = (w > 0) & (u_acc * torch.clamp(w_sum, min=1e-20) < w)
        y_rows = torch.where(accept[..., None], rows, y_rows)
        y_id = torch.where(accept, ids.to(torch.float32), y_id)
        ph_y = torch.where(accept, ph, ph_y)
    W = torch.where((y_id >= 0) & (ph_y > 0),
                    w_sum / torch.clamp(rounds * ph_y, min=1e-20), 0.0)
    return torch.cat([y_rows, W[..., None], y_id[..., None]], -1).reshape(C, S, 18)


def cells_of_positions(grid: RegirGrid, pos, valid):
    """World positions (..., 3) -> flat cell ids (...,) int32; positions
    outside the grid clamp to the nearest cell, invalid ones read cell 0."""
    if grid.mode == "onion":
        n_det, n_cov, n_az, n_el = grid.onion_dims
        L = n_det + n_cov
        rel = pos - grid.cam
        r = torch.sqrt(torch.sum(rel * rel, -1))
        log_g = _f32(np.log(np.float32(_layer_ratio(grid.r_detail, grid.r_max, n_cov))))
        # inverse of _onion_centers' layer spacing
        rd = max(grid.r_detail, _f32(1e-6))
        lay_det = torch.floor(r / rd * n_det)
        lay_cov = n_det + torch.floor(torch.log(torch.clamp(r / rd, min=1.0)) / log_g)
        layer = torch.clamp(torch.where(r < grid.r_detail, lay_det, lay_cov), 0,
                            L - 1).to(torch.int32)
        rn = torch.clamp(r, min=1e-6)
        az = torch.clamp(((torch.atan2(rel[..., 2], rel[..., 0]) + math.pi)
                          / (2.0 * math.pi) * n_az).to(torch.int32), 0, n_az - 1)
        el = torch.clamp(((torch.asin(torch.clamp(rel[..., 1] / rn, -1.0, 1.0))
                           + 0.5 * math.pi) / math.pi * n_el).to(torch.int32), 0, n_el - 1)
        cid = (layer * n_el + el) * n_az + az
        return torch.where(valid, cid, 0).to(torch.int32)
    qi = [torch.clamp(((pos[..., a] - grid.lo[a]) * grid.inv_cell[a]).to(torch.int32), 0,
                      grid.dims[a] - 1) for a in range(3)]
    nx, ny, _ = grid.dims
    cid = qi[0] + nx * (qi[1] + ny * qi[2])
    return torch.where(valid, cid, 0).to(torch.int32)
