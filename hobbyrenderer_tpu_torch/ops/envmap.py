"""Environment maps: one equirectangular (lat-long) radiance texture
(counterpart of hobbyrenderer_tpu/ops/envmap.py): the Sky pass's background
and the path tracer's miss shader, its SH9 projection for the diffuse IBL
term, a bilinear fetch along the reflection vector for the specular ambient,
and its discretization into directional lights for the light pool.

Conventions: +Y up; u = 0.5 + atan2(x, -z) / 2pi (u = 0.5 faces -z), and
v = acos(y) / pi (v = 0 is straight up). LDR sources are linearized with the
2.2 power; Radiance .hdr files decode to linear directly. Everything but
``sample_equirect`` is host numpy, run once at load."""

from __future__ import annotations

import math
import os

import numpy as np
import torch


def decode_hdr(data: bytes) -> np.ndarray:
    """Radiance RGBE (.hdr) decode -> (H, W, 3) f32 linear. Supports the
    common -Y H +X W orientation with adaptive RLE scanlines."""
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    pos = data.find(b"\n\n")
    if pos < 0:
        raise ValueError("truncated HDR header")
    dims = data[pos + 2:data.find(b"\n", pos + 2)].split()
    if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation {dims}")
    H, W = int(dims[1]), int(dims[3])
    p = data.find(b"\n", pos + 2) + 1
    buf = np.frombuffer(data, np.uint8, offset=p)
    out = np.zeros((H, W, 4), np.uint8)
    i = 0
    for y in range(H):
        if W < 8 or W > 0x7FFF or buf[i] != 2 or buf[i + 1] != 2:
            # flat (non-RLE) scanline
            out[y] = buf[i:i + W * 4].reshape(W, 4)
            i += W * 4
            continue
        if (int(buf[i + 2]) << 8 | int(buf[i + 3])) != W:
            raise ValueError("bad RLE scanline width")
        i += 4
        for c in range(4):
            x = 0
            while x < W:
                n = int(buf[i])
                i += 1
                if n > 128:          # run
                    out[y, x:x + n - 128, c] = buf[i]
                    i += 1
                    x += n - 128
                else:                # literal
                    out[y, x:x + n, c] = buf[i:i + n]
                    i += n
                    x += n
    e = out[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)  # 2^(e-128-8)
    return (out[..., :3].astype(np.float32) + 0.5) * scale[..., None]


def encode_hdr(img: np.ndarray) -> bytes:
    """(H, W, 3) f32 linear -> Radiance RGBE bytes (adaptive-RLE scanlines
    of literal blocks; flat scanlines outside the RLE width range)."""
    img = np.maximum(np.asarray(img, np.float32), 0.0)
    H, W = img.shape[:2]
    m = img.max(-1)
    # the exponent is clamped to RGBE's range [-105, 127] and used for both
    # the mantissa scale and the exponent byte
    e = np.where(m > 1e-32, np.ceil(np.log2(np.maximum(m, 1e-32))) + 1, -128)
    e = np.clip(e, -105.0, 127.0)
    scale = np.where(m > 1e-32, np.exp2(8.0 - e), 0.0)   # 2^113 max: f32-safe
    rgbe = np.zeros((H, W, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(m > 1e-32, e + 128, 0).astype(np.uint8)
    head = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
            + f"-Y {H} +X {W}\n".encode())
    if W < 8 or W > 0x7FFF:
        return head + rgbe.tobytes()
    # literal blocks only: a flat scanline whose first R byte is 2 would be
    # read as RLE by any reader
    out = [head]
    wm = W.to_bytes(2, "big")
    for y in range(H):
        out.append(b"\x02\x02" + wm)
        for c in range(4):
            row = rgbe[y, :, c]
            for x0 in range(0, W, 128):
                n = min(128, W - x0)
                out.append(bytes([n]) + row[x0:x0 + n].tobytes())
    return b"".join(out)


def load_envmap(path: str, max_width: int = 2048) -> np.ndarray:
    """Decode an environment image file -> (H, W, 3) f32 linear radiance,
    halved until it is at most ``max_width`` wide. The decode is cached as
    ``<path>.<max_width>.npy`` next to the source (used while it is not
    older than the source)."""
    cache = path + f".{max_width}.npy"
    try:
        if os.path.getmtime(cache) >= os.path.getmtime(path):
            return np.load(cache)
    except OSError:
        pass
    if path.lower().endswith(".hdr"):
        with open(path, "rb") as f:
            img = decode_hdr(f.read())
    elif path.lower().endswith(".dds"):
        # a BC6H DDS keeps its linear floats
        from hobbyrenderer_tpu_torch.scene.textures import decode_dds
        with open(path, "rb") as f:
            dec = decode_dds(f.read())
        img = (dec[..., :3].astype(np.float32) if dec.dtype != np.uint8
               else (dec[..., :3].astype(np.float32) / 255.0) ** 2.2)
    else:
        from hobbyrenderer_tpu_torch.scene.textures import load_image_file
        img = (load_image_file(path)[..., :3].astype(np.float32) / 255.0) ** 2.2
    while img.shape[1] > max_width:
        h2, w2 = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
        img = img[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2, 3).mean((1, 3))
    img = np.ascontiguousarray(img, np.float32)
    try:
        np.save(cache, img)
    except OSError:
        pass
    return img


def sample_equirect(env: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Bilinear lat-long fetch of env (He, We, 3) at unit directions d
    (..., 3) -> (..., 3): wraps in azimuth, clamps in latitude."""
    He, We = env.shape[:2]
    u = 0.5 + torch.atan2(d[..., 0], -d[..., 2]) / (2.0 * math.pi)
    v = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    x = u * We - 0.5
    y = torch.clamp(v * He - 0.5, 0.0, He - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    flat = env.reshape(He * We, 3)

    def tap(yi, xi):
        return flat[torch.clamp(yi, 0, He - 1) * We + xi % We]

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def _equirect_dirs_dw(He: int, We: int):
    """Texel-centre directions (He*We, 3) and solid-angle weights (He*We,)
    of an equirect grid, in sample_equirect's mapping."""
    v = (np.arange(He) + 0.5) / He
    u = (np.arange(We) + 0.5) / We
    theta = v * np.pi
    phi = (u - 0.5) * 2.0 * np.pi
    st = np.sin(theta)[:, None]
    d = np.stack([np.broadcast_to(st * np.sin(phi)[None, :], (He, We)),
                  np.broadcast_to(np.cos(theta)[:, None], (He, We)),
                  np.broadcast_to(-st * np.cos(phi)[None, :], (He, We))],
                 -1).reshape(-1, 3)
    dw = (st * (np.pi / He) * (2.0 * np.pi / We)).repeat(We, 1).reshape(-1)
    return d, dw


def env_to_directional_lights(env: np.ndarray, n: int = 128):
    """Discretize the envmap into n power-stratified directional lights:
    texels sorted by flux and cut into n groups of equal power, each group
    a light along its flux-weighted mean direction carrying the group's
    flux. Returns (dirs (n', 3) unit toward the light, colors (n', 3)),
    n' <= n (empty groups dropped); sum(colors) is the env's integral of
    radiance dw. The caller drops the env's ambient and miss terms that
    the lights then carry."""
    He, We = env.shape[:2]
    d, dw = _equirect_dirs_dw(He, We)
    power = env.reshape(-1, 3) * dw[:, None]               # per-texel flux
    lum = 0.2126 * power[:, 0] + 0.7152 * power[:, 1] + 0.0722 * power[:, 2]
    order = np.argsort(-lum)                               # bright texels first
    cdf = np.cumsum(lum[order])
    total = max(float(cdf[-1]), 1e-12)
    # equal-power partition: group k = texels in ((k/n)T, ((k+1)/n)T]
    group = np.minimum((cdf / total * n - 1e-9).astype(np.int64), n - 1)
    colors = np.zeros((n, 3), np.float64)
    dsum = np.zeros((n, 3), np.float64)
    np.add.at(colors, group, power[order])
    np.add.at(dsum, group, d[order] * lum[order][:, None])
    nrm = np.linalg.norm(dsum, axis=1, keepdims=True)
    dirs = np.where(nrm > 1e-12, dsum / np.maximum(nrm, 1e-12),
                    np.asarray([[0.0, 1.0, 0.0]]))
    keep = colors.sum(1) > 0
    return dirs[keep].astype(np.float32), colors[keep].astype(np.float32)


def project_sh9(env: np.ndarray, convolved: bool = False) -> np.ndarray:
    """(9, 3) SH projection of the equirect radiance, the quantity
    ops/ibl.py's build_sky_irradiance gives for the procedural sky.
    ``convolved``: the input is a prebaked irradiance map (E / pi), so the
    cosine-lobe band weights that sample_irradiance applies are divided
    out here."""
    from hobbyrenderer_tpu_torch.ops.ibl import _BAND, sh_basis
    He, We = env.shape[:2]
    d, dw = _equirect_dirs_dw(He, We)
    Y = sh_basis(torch.as_tensor(d.astype(np.float32))).numpy()
    sh = np.einsum("nc,nk,n->kc", env.reshape(-1, 3), Y, dw).astype(np.float32)
    if convolved:
        sh = sh / np.asarray(_BAND, np.float32)[:, None]
    return sh
