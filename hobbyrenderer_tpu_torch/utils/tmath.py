"""Torch counterparts of the device-side helpers in hobbyrenderer_tpu/utils/math.py.

The JAX package runs these through its ``xp=jnp`` parameter; torch's API
differs enough (dim/keepdim, tensor-only maximum) that they are written out
here. Packed vertex words are int64 tensors holding uint32 values."""

from __future__ import annotations

import torch


def normalize(v, eps=1e-20):
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return v / torch.clamp(n, min=eps)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def luminance(rgb):
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def reflect(d, n):
    return d - 2.0 * torch.sum(d * n, dim=-1, keepdim=True) * n


def affine_points(M, p):
    """Points p (..., 3) through affine matrices M (..., 4, 4), as separate
    products and sums in a fixed order (no fused multiply-add, no matmul
    library), so that the CPU and the GPU give the same bits."""
    return torch.stack([((M[..., i, 0] * p[..., 0] + M[..., i, 1] * p[..., 1])
                         + M[..., i, 2] * p[..., 2]) + M[..., i, 3] for i in range(3)], -1)


def matmul4(a, b):
    """a @ b for (..., 4, 4) stacks, summed over k = 0..3 in order (as
    affine_points: the same bits on the CPU and the GPU)."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, 4):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def oct_encode(n):
    """Unit vector -> octahedral (u, v) in [-1, 1]^2."""
    n = n / torch.clamp(torch.sum(torch.abs(n), dim=-1, keepdim=True), min=1e-20)
    u, v, z = n[..., 0], n[..., 1], n[..., 2]
    pu = (1.0 - torch.abs(v)) * torch.where(u >= 0.0, 1.0, -1.0)
    pv = (1.0 - torch.abs(u)) * torch.where(v >= 0.0, 1.0, -1.0)
    return torch.stack([torch.where(z < 0.0, pu, u), torch.where(z < 0.0, pv, v)], dim=-1)


def oct_decode(e):
    u, v = e[..., 0], e[..., 1]
    z = 1.0 - torch.abs(u) - torch.abs(v)
    t = torch.clamp(-z, min=0.0)
    u = u + torch.where(u >= 0.0, -t, t)
    v = v + torch.where(v >= 0.0, -t, t)
    return normalize(torch.stack([u, v, z], dim=-1))


def _unorm_unpack(q, bits):
    scale = float((1 << bits) - 1)
    return (q.to(torch.float32) / scale) * 2.0 - 1.0


def unpack_normal_oct(p):
    """uint32 -> (normal (..,3), bitangent_sign (..,))."""
    u = _unorm_unpack(p & 0x3FF, 10)
    v = _unorm_unpack((p >> 10) & 0x3FF, 10)
    s = torch.where(((p >> 20) & 1) > 0, 1.0, -1.0).to(torch.float32)
    return oct_decode(torch.stack([u, v], dim=-1)), s


def f16_bits_to_f32(b):
    b = torch.where(b >= 32768, b - 65536, b)
    return b.to(torch.int16).view(torch.float16).to(torch.float32)


def unpack_uv_half2(p):
    return torch.stack([f16_bits_to_f32(p & 0xFFFF),
                        f16_bits_to_f32((p >> 16) & 0xFFFF)], dim=-1)


def sphere_in_frustum(planes, centers, radii):
    """planes (6, 4) inward; centers (..., 3); radii (...). True if visible."""
    d = centers @ planes[:, :3].T + planes[:, 3]
    return torch.all(d >= -radii[..., None], dim=-1)


def sphere_screen_extent(c, radius, proj00, proj11, znear):
    """Conservative NDC AABB of view-space spheres (see utils/math.py)."""
    cz = -c[..., 2]
    valid = cz > radius + znear

    def axis_bounds(cx, cz):
        t2 = torch.clamp(cx * cx + cz * cz - radius * radius, min=1e-12)
        t = torch.sqrt(t2)
        inv = 1.0 / (cx * cx + cz * cz)
        vx = (cx * t - cz * radius) * inv
        vz = (cz * t + cx * radius) * inv
        lo = vx / torch.clamp(vz, min=1e-6)
        vx2 = (cx * t + cz * radius) * inv
        vz2 = (cz * t - cx * radius) * inv
        hi = vx2 / torch.clamp(vz2, min=1e-6)
        return lo, hi

    min_x, max_x = axis_bounds(c[..., 0], cz)
    min_y, max_y = axis_bounds(c[..., 1], cz)
    mn = torch.stack([min_x * proj00, min_y * proj11], dim=-1)
    mx = torch.stack([max_x * proj00, max_y * proj11], dim=-1)
    return mn, mx, valid
