"""ReSTIR DI initial candidates: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of hobbyrenderer_tpu/ops/restir_pallas.py (K2,
restir_candidates). The kernel source is csrc/restir_candidates.cu.
``restir_candidates`` launches the kernel for CUDA tensors and runs
``restir_candidates_reference`` for CPU tensors; nothing else chooses.

Both follow the TPU kernel, not the JAX package's XLA candidate loop: bits
become uniforms as the top 24 bits times 2^-24 (``_u01``), which differs from
utils/rng.uniform_from_bits by less than 2^-24, and rsqrt is computed as
1/sqrt."""

from __future__ import annotations

import torch

from hobbyrenderer_tpu_torch import kernels
from hobbyrenderer_tpu_torch.utils.rng import pcg3d

ROWS = 8          # planes are padded to whole 8-scanline blocks (the TPU's)
SEG = 128         # pixels per segment == presample tile slots
CH = 18           # packed light row channels: row(16) + inv_pdf + id
N_PLANES = 12     # px py pz nx ny nz ar ag ab rough metal valid

_LUM = (0.2126, 0.7152, 0.0722)
_MIN_ROUGH = 0.03
_F0 = 0.04

launches = 0      # kernel launches (CPU reference calls are not counted)


def _u01(bits):
    return (bits >> 8).to(torch.float32) * 5.960464477539063e-08


def _rsqrt(x):
    return 1.0 / torch.sqrt(x)


def restir_candidates(flat3, tsel, planes, cam, frame: int, y0: int,
                      num_candidates: int = 8, w_log: int = None):
    """flat3 (T, 18, 128) f32 presample tiles (channel-major slots); tsel
    (Hp, nseg) int32 tile per (scanline, segment); planes (12, Hp, Wp) f32;
    cam (3,) f32; frame, y0 host ints; w_log the logical render width used
    for pixel ids. Hp % 8 == 0, Wp % 128 == 0.

    Returns (y f32 (Hp, Wp) selected id (-1 none), u, v, w_sum (Hp, Wp),
    row (Hp, 16, Wp))."""
    if not (w_log and w_log > 0):
        raise ValueError("w_log (the logical width) is required: pixel ids are gy*w_log+gx")
    _, Hp, Wp = planes.shape
    if Hp % ROWS or Wp % SEG:
        raise ValueError(f"planes must be padded to ({ROWS}, {SEG}) multiples, got {(Hp, Wp)}")
    if planes.device.type == "cpu":
        return restir_candidates_reference(flat3, tsel, planes, cam, frame, y0,
                                           num_candidates, w_log)
    return _restir_candidates_cuda(flat3, tsel, planes, cam, frame, y0, num_candidates, w_log)


def _restir_candidates_cuda(flat3, tsel, planes, cam, frame, y0, num_candidates, w_log):
    global launches
    _, Hp, Wp = planes.shape
    T = flat3.shape[0]
    kernels.require(flat3, "flat3", torch.float32, (T, CH, SEG))
    kernels.require(tsel, "tsel", torch.int32, (Hp, Wp // SEG))
    kernels.require(planes, "planes", torch.float32, (N_PLANES, Hp, Wp))
    kernels.require(cam, "cam", torch.float32, (3,))
    if not (flat3.device == tsel.device == planes.device == cam.device):
        raise ValueError("restir_candidates: all inputs must be on one device")
    lib = kernels.library()
    dev = planes.device
    y, u, v, w = (torch.empty((Hp, Wp), dtype=torch.float32, device=dev) for _ in range(4))
    row = torch.empty((Hp, 16, Wp), dtype=torch.float32, device=dev)
    err = lib.hr_restir_candidates(flat3.data_ptr(), tsel.data_ptr(), planes.data_ptr(),
                                   cam.data_ptr(), y.data_ptr(), u.data_ptr(), v.data_ptr(),
                                   w.data_ptr(), row.data_ptr(), Hp, Wp, T,
                                   int(num_candidates), int(frame), int(y0), int(w_log),
                                   kernels.stream_handle(dev))
    kernels.check(err, "hr_restir_candidates")
    launches += 1
    return y, u, v, w, row


def restir_candidates_reference(flat3, tsel, planes, cam, frame: int, y0: int,
                                num_candidates: int = 8, w_log: int = None):
    """Plain PyTorch version of the candidate kernel: the same arithmetic,
    one full-frame op per kernel statement."""
    _, Hp, Wp = planes.shape
    dev = planes.device
    T = flat3.shape[0]
    tiles = flat3[torch.clamp(tsel.to(torch.int64), 0, T - 1)]   # (Hp, nseg, CH, SEG)
    cx, cy, cz = cam[0], cam[1], cam[2]
    px, py, pz, nx, ny, nz, ar, ag, ab, rg, metal, va = planes
    rough = torch.clamp(rg, _MIN_ROUGH, 1.0)
    valid = va > 0.5

    tvx, tvy, tvz = cx - px, cy - py, cz - pz
    vn = _rsqrt(torch.clamp(tvx * tvx + tvy * tvy + tvz * tvz, min=1e-12))
    vx, vy, vz = tvx * vn, tvy * vn, tvz * vn
    ndv = torch.clamp(nx * vx + ny * vy + nz * vz, min=1e-5)
    alpha = rough * rough
    a2 = alpha * alpha
    inv_m = 1.0 - metal
    dr, dg, db = ar * inv_m, ag * inv_m, ab * inv_m
    f0r = _F0 * inv_m + ar * metal
    f0g = _F0 * inv_m + ag * metal
    f0b = _F0 * inv_m + ab * metal

    gy = torch.arange(Hp, dtype=torch.int64, device=dev)[:, None] + y0
    gx = torch.arange(Wp, dtype=torch.int64, device=dev)[None, :]
    pix = (gy * w_log + gx).expand(Hp, Wp)

    ry = torch.full((Hp, Wp), -1.0, device=dev)
    ru = torch.zeros((Hp, Wp), device=dev)
    rv = torch.zeros((Hp, Wp), device=dev)
    w_sum = torch.zeros((Hp, Wp), device=dev)
    rrow = torch.zeros((16, Hp, Wp), device=dev)
    INV_PI = 1.0 / 3.14159265

    for c in range(num_candidates):
        sh = (17 * c) % SEG
        rolled = torch.roll(tiles, -sh, dims=-1) if sh else tiles
        ch = rolled.permute(2, 0, 1, 3).reshape(CH, Hp, Wp)
        bits = pcg3d(torch.stack([pix, torch.full_like(pix, frame),
                                  torch.full_like(pix, 100 + c)], -1))
        u_r, u_u, u_v = _u01(bits[..., 0]), _u01(bits[..., 1]), _u01(bits[..., 2])

        lid, inv_pdf = ch[17], ch[16]
        is_em = ch[13] > 0.5
        is_dir = (ch[0] < 0.5) & ~is_em
        is_spot = (ch[0] > 1.5) & ~is_em

        # analytic light
        tlx = torch.where(is_dir, -ch[4], ch[1] - px)
        tly = torch.where(is_dir, -ch[5], ch[2] - py)
        tlz = torch.where(is_dir, -ch[6], ch[3] - pz)
        d2a = torch.clamp(tlx * tlx + tly * tly + tlz * tlz, min=1e-16)
        inv_da = _rsqrt(d2a)
        lax_, lay, laz = tlx * inv_da, tly * inv_da, tlz * inv_da
        dist_a = d2a * inv_da
        xr = torch.clamp(dist_a / torch.clamp(ch[10], min=1e-4), 0.0, 1.0)
        fall = 1.0 - xr * xr * xr * xr
        fall = torch.clamp(fall * fall, 0.0, 1.0)
        atten = torch.where(is_dir, 1.0, fall / torch.clamp(d2a, min=1e-4))
        cd = -(lax_ * ch[4] + lay * ch[5] + laz * ch[6])
        spot = torch.clamp((cd - ch[12]) / torch.clamp(ch[11] - ch[12], min=1e-4), 0.0, 1.0)
        atten = torch.where(is_spot, atten * spot * spot, atten)
        rra, rga, rba = ch[7] * atten, ch[8] * atten, ch[9] * atten

        # emissive triangle
        over = (u_u + u_v) > 1.0
        uu = torch.where(over, 1.0 - u_u, u_u)
        vv = torch.where(over, 1.0 - u_v, u_v)
        plx = ch[1] + uu * ch[4] + vv * ch[7] - px
        ply = ch[2] + uu * ch[5] + vv * ch[8] - py
        plz = ch[3] + uu * ch[6] + vv * ch[9] - pz
        d2e = torch.clamp(plx * plx + ply * ply + plz * plz, min=1e-8)
        inv_de = _rsqrt(d2e)
        lex, ley, lez = plx * inv_de, ply * inv_de, plz * inv_de
        cxn = ch[5] * ch[9] - ch[6] * ch[8]
        cyn = ch[6] * ch[7] - ch[4] * ch[9]
        czn = ch[8] * ch[4] - ch[5] * ch[7]
        n2 = cxn * cxn + cyn * cyn + czn * czn
        inv_n = _rsqrt(torch.clamp(n2, min=1e-24))
        area = 0.5 * n2 * inv_n
        cos_l = torch.abs((cxn * lex + cyn * ley + czn * lez) * inv_n)
        ge = cos_l * area / d2e
        rre, rge, rbe = ch[10] * ge, ch[11] * ge, ch[12] * ge

        Lx = torch.where(is_em, lex, lax_)
        Ly = torch.where(is_em, ley, lay)
        Lz = torch.where(is_em, lez, laz)
        rr = torch.where(is_em, rre, rra)
        rg2 = torch.where(is_em, rge, rga)
        rb = torch.where(is_em, rbe, rba)

        # GGX BRDF * NdotL p-hat
        hx, hy, hz = vx + Lx, vy + Ly, vz + Lz
        hn = _rsqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-12))
        hx, hy, hz = hx * hn, hy * hn, hz * hn
        ndl = torch.clamp(nx * Lx + ny * Ly + nz * Lz, min=0.0)
        ndh = torch.clamp(nx * hx + ny * hy + nz * hz, min=0.0)
        vdh = torch.clamp(vx * hx + vy * hy + vz * hz, min=0.0)
        dterm = ndh * ndh * (a2 - 1.0) + 1.0
        D = a2 / torch.clamp(3.14159265 * dterm * dterm, min=1e-8)
        gv = ndl * torch.sqrt(torch.clamp(ndv * ndv * (1 - a2) + a2, min=1e-8))
        gl = ndv * torch.sqrt(torch.clamp(ndl * ndl * (1 - a2) + a2, min=1e-8))
        Vis = 0.5 / torch.clamp(gv + gl, min=1e-8)
        fr5 = torch.clamp(1.0 - vdh, 0.0, 1.0)
        fr5 = fr5 * fr5 * fr5 * fr5 * fr5
        DV = D * Vis

        def shade(f0c, dc, radc):
            F = f0c + (1.0 - f0c) * fr5
            return ((1.0 - F) * dc * INV_PI + DV * F) * ndl * radc

        ph = (_LUM[0] * shade(f0r, dr, rr) + _LUM[1] * shade(f0g, dg, rg2)
              + _LUM[2] * shade(f0b, db, rb))
        ph = torch.where(valid & (lid >= 0.0), ph, 0.0)

        # streaming RIS update
        w_c = ph * inv_pdf
        w_sum = w_sum + w_c
        take = (u_r * torch.clamp(w_sum, min=1e-20)) < w_c
        ry = torch.where(take, lid, ry)
        ru = torch.where(take, u_u, ru)
        rv = torch.where(take, u_v, rv)
        rrow = torch.where(take[None], ch[:16], rrow)
    return ry, ru, rv, w_sum, rrow.permute(1, 0, 2).contiguous()
