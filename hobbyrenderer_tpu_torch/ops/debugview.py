"""Named debug visualizations, ``--debug-view NAME`` (counterpart of
hobbyrenderer_tpu/ops/debugview.py): the cascaded-shadow views, the SSGI
pass's intermediates and the SHARC cache's. A view whose signal this
renderer does not have (SSGI's specular chain: specular is the traced pass)
renders black, as in the JAX package.

Every view takes float [0, 1] images and returns a float [0, 1] image; the
DebugView graph pass converts to uint8."""

from __future__ import annotations

import torch

from hobbyrenderer_tpu_torch.ops.csm import CASCADE_COLORS, NUM_CASCADES, SHADOW_RES, CSMData

CSM_VIEWS = (
    "csm_cascade_splits",
    "csm_shadow_map",        # the four depth maps as strips across the bottom quarter
    "csm_shadow_mask",
    "csm_pcf_footprint",     # a shadow-texel-scale checker tinted by cascade
    "csm_alpha_masked",
    "csm_depth_compare",
    "csm_frustum_wire",
    "csm_blend_zone",        # the last 20% of each cascade's depth range
)

SSGI_VIEWS = (
    "ssgi_raw_diffuse",      # the half-res march before the temporal stage
    "ssgi_raw_specular",             # no signal here -> black
    "ssgi_temporal_diffuse",
    "ssgi_temporal_specular",        # black
    "ssgi_denoised_diffuse",
    "ssgi_denoised_specular",        # black
    "ssgi_composed",         # the indirect term alone
    "ssgi_diffuse_age",      # temporal history length heatmap
    "ssgi_specular_age",             # black
    "ssgi_ray_length",       # grey = hit distance, magenta = miss
    "ssgi_hit_mask",         # green = hit, red = miss
    "ssgi_sample_type",      # blue: every ray is diffuse
    "ssgi_sky_fallback",     # sky irradiance along the march direction
    "ssgi_direct_light",     # the lit HDR read at the ray hits
    "ssgi_fresnel",
    "ssgi_validity",         # magenta NaN/Inf, yellow negative, grey finite
    "ssgi_denoiser_delta_diffuse",   # |temporal - denoised|
    "ssgi_denoiser_delta_specular",  # black
)

SHARC_VIEWS = (
    "sharc_voxel_color",     # a hash colour per cache voxel
    "sharc_radiance",        # the cache's radiance before the albedo
    "sharc_heatmap",         # green = cache hit, red = miss
)

ALL_VIEWS = CSM_VIEWS + SSGI_VIEWS + SHARC_VIEWS
_BLACK_SSGI = ("ssgi_raw_specular", "ssgi_temporal_specular", "ssgi_denoised_specular",
               "ssgi_specular_age", "ssgi_denoiser_delta_specular")


def _rgb(c, dev):
    return torch.tensor(c, dtype=torch.float32, device=dev)


def heatmap(t):
    """Scalar ramp black -> blue -> cyan -> green -> yellow -> red."""
    t = torch.clamp(t, 0.0, 1.0)
    stops = torch.tensor([[0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0], [1, 1, 0], [1, 0, 0]],
                         dtype=torch.float32, device=t.device)
    s = t * 5.0
    i = torch.clamp(s.to(torch.int64), 0, 4)
    f = (s - i.to(torch.float32))[..., None]
    return stops[i] * (1 - f) + stops[i + 1] * f


def _cascade_index(csm: CSMData, vc, world_pos):
    V = vc["view"]
    dist = -(torch.einsum("ij,hwj->hwi", V[:3, :3], world_pos) + V[:3, 3])[..., 2]
    cidx = torch.sum((dist[..., None] > csm.splits).to(torch.int64), -1)
    return torch.clamp(cidx, 0, NUM_CASCADES - 1), dist


def csm_view(name: str, ldr_f, gb, csm: CSMData, vc, sun_mask, masked=None):
    """One of CSM_VIEWS -> (H, W, 3). ``masked``: optional (H, W) bool, the
    pixels of MASK-alpha-mode materials (for csm_alpha_masked)."""
    H, W = ldr_f.shape[0], ldr_f.shape[1]
    dev = ldr_f.device
    albedo = gb.albedo
    cidx, dist = _cascade_index(csm, vc, gb.world_pos)
    ccol = torch.tensor(CASCADE_COLORS, dtype=torch.float32, device=dev)[cidx]
    valid3 = gb.valid[..., None]

    if name == "csm_cascade_splits":
        return torch.where(valid3, ccol * 0.5 + albedo * 0.5, ldr_f)
    if name == "csm_shadow_map":
        strip_h = H // 4
        y = torch.arange(H, device=dev)[:, None]
        x = torch.arange(W, device=dev)[None, :]
        in_strip = y >= (H - strip_h)
        ci = torch.clamp(x * 4 // W, 0, 3)
        lu = (x * 4 % W).to(torch.float32) / W
        lv = torch.clamp((y - (H - strip_h)).to(torch.float32) / max(strip_h, 1), 0.0, 1.0)
        sx = torch.clamp((lu * SHADOW_RES).to(torch.int64), 0, SHADOW_RES - 1)
        sy = torch.clamp((lv * SHADOW_RES).to(torch.int64), 0, SHADOW_RES - 1)
        d = csm.depth.reshape(-1)[(ci * (SHADOW_RES * SHADOW_RES) + sy * SHADOW_RES + sx)
                                  .expand(H, W)]
        return torch.where(in_strip[..., None], d[..., None].expand(H, W, 3), albedo)
    if name == "csm_shadow_mask":
        return sun_mask[..., None].expand(H, W, 3)
    if name == "csm_pcf_footprint":
        texel = 1.0 / SHADOW_RES
        x = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
        y = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
        checker = (torch.floor(x * W * texel / 8.0) + torch.floor(y * H * texel / 8.0)) % 2.0
        w = (checker * 0.3)[..., None]
        return torch.where(valid3, albedo * (1 - w) + ccol * w, ldr_f)
    if name == "csm_alpha_masked":
        base = torch.where(valid3, albedo, ldr_f)
        if masked is None:
            return base
        return torch.where((masked & gb.valid)[..., None], _rgb([1.0, 0.5, 0.0], dev), base)
    if name == "csm_depth_compare":
        t = sun_mask[..., None]
        return torch.where(valid3, _rgb([0.8, 0.1, 0.1], dev) * (1 - t)
                           + _rgb([0.1, 0.8, 0.1], dev) * t, ldr_f)
    if name == "csm_frustum_wire":
        # pixels whose light-space |x| or |y| lies within a line width of a
        # cascade's box edge
        out = torch.where(valid3, albedo, ldr_f)
        lw = 0.004
        for c in range(NUM_CASCADES):
            vp = csm.view_proj[c]
            clip = torch.einsum("ij,hwj->hwi", vp[:3, :3], gb.world_pos) + vp[:3, 3]
            ax, ay = torch.abs(clip[..., 0]), torch.abs(clip[..., 1])
            inside = (ax <= 1.0 + lw) & (ay <= 1.0 + lw)
            edge = inside & ((torch.abs(ax - 1.0) < lw) | (torch.abs(ay - 1.0) < lw))
            out = torch.where((edge & gb.valid)[..., None], _rgb(CASCADE_COLORS[c], dev), out)
        return out
    if name == "csm_blend_zone":
        near = torch.where(cidx > 0, csm.splits[torch.clamp(cidx - 1, min=0)], 0.0)
        far = csm.splits[cidx]
        t = torch.clamp((dist - near) / torch.clamp(far - near, min=1e-3), 0.0, 1.0)
        band = torch.clamp((t - 0.8) * 5.0, 0.0, 1.0)
        return torch.where(valid3, albedo * 0.4 + ccol * 0.3 + band[..., None] * 0.3, ldr_f)
    raise ValueError(f"unknown CSM debug view '{name}'")


def _tone(x):
    """A simple display transform for HDR debug signals."""
    return torch.clamp(x / (1.0 + x), 0.0, 1.0)


def resize_nearest(img, H: int, W: int):
    """Nearest resize of (h, w, ...) to (H, W, ...): source index
    floor((i + 0.5) * h / H) in f32, jax.image.resize's rule."""
    if img.shape[0] == H and img.shape[1] == W:
        return img

    def idx(n, m):
        o = (torch.arange(n, dtype=torch.float32, device=img.device) + 0.5) * m / n
        return torch.floor(o).to(torch.int64)
    if img.shape[0] != H:
        img = img[idx(H, img.shape[0])]
    if img.shape[1] != W:
        img = img[:, idx(W, img.shape[1])]
    return img


def ssgi_view(name: str, ldr_f, gb, dv: dict):
    """One of SSGI_VIEWS -> (H, W, 3). ``dv``: the SSGI pass's debug
    intermediates (ops/ssgi.py and ops/denoise.py ``debug_out``)."""
    H, W = ldr_f.shape[0], ldr_f.shape[1]
    dev = ldr_f.device

    def up(img):
        return resize_nearest(img, H, W)

    if name in _BLACK_SSGI:
        return torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    if name == "ssgi_raw_diffuse":
        return _tone(up(dv["irr_half"]))
    if name == "ssgi_temporal_diffuse":
        return _tone(dv["temporal"])
    if name == "ssgi_denoised_diffuse":
        return _tone(dv["denoised"])
    if name == "ssgi_composed":
        return _tone(dv["composed"])
    if name == "ssgi_diffuse_age":
        return heatmap(1.0 - dv["age"] / 32.0)       # red = young
    if name == "ssgi_ray_length":
        grey = torch.clamp(up(dv["ray_t"][..., None]), 0.0, 1.0).expand(H, W, 3)
        return torch.where(up(dv["hit"][..., None]) > 0.5, grey, _rgb([1.0, 0.0, 1.0], dev))
    if name == "ssgi_hit_mask":
        return torch.where(up(dv["hit"][..., None]) > 0.5, _rgb([0.1, 0.9, 0.1], dev),
                           _rgb([0.9, 0.1, 0.1], dev))
    if name == "ssgi_sample_type":
        return _rgb([0.2, 0.2, 1.0], dev).expand(H, W, 3).clone()
    if name == "ssgi_sky_fallback":
        return _tone(up(dv["sky_eval"]))
    if name == "ssgi_direct_light":
        return _tone(up(dv["direct"]))
    if name == "ssgi_fresnel":
        from hobbyrenderer_tpu_torch.ops.shading import brdf_params, fresnel_schlick
        nov = torch.clamp(torch.sum(gb.normal * (-dv["view_dir"]), -1), min=0.0)
        _, f0, _ = brdf_params(gb.albedo, gb.orm[..., 2], gb.orm[..., 1])
        return torch.clamp(fresnel_schlick(nov[..., None], f0), 0.0, 1.0)
    if name == "ssgi_validity":
        x = dv["composed"]
        bad = ~torch.isfinite(x).all(-1)
        neg = (x < 0.0).any(-1) & ~bad
        out = torch.where(bad[..., None], _rgb([1.0, 0.0, 1.0], dev),
                          torch.full((H, W, 3), 0.5, device=dev))
        return torch.where(neg[..., None], _rgb([1.0, 1.0, 0.0], dev), out)
    if name == "ssgi_denoiser_delta_diffuse":
        return heatmap(torch.abs(dv["temporal"] - dv["denoised"]).mean(-1) * 4.0)
    raise ValueError(f"unknown SSGI debug view '{name}'")


def sharc_view(name: str, ldr_f, gb, dv: dict):
    """One of SHARC_VIEWS -> (H, W, 3). ``dv``: the cache's cell key (the
    uint32 key in int64), radiance and hit at each pixel."""
    H, W = ldr_f.shape[0], ldr_f.shape[1]
    dev = ldr_f.device
    if name == "sharc_voxel_color":
        cell = resize_nearest(dv["cell"][..., None], H, W)[..., 0] & 0xFFFFFFFF
        # cell * 2654435761 mod 2^32 in halves (the whole product overflows int64)
        m = 2654435761
        h = ((cell & 0xFFFF) * m + ((((cell >> 16) * m) & 0xFFFF) << 16)) & 0xFFFFFFFF
        col = torch.stack([(h & 0xFF), (h >> 8) & 0xFF, (h >> 16) & 0xFF], -1)
        return torch.where(gb.valid[..., None], col.to(torch.float32) / 255.0, ldr_f)
    if name == "sharc_radiance":
        return _tone(resize_nearest(dv["radiance"], H, W))
    if name == "sharc_heatmap":
        ok = resize_nearest(dv["hit"][..., None], H, W) > 0.5
        return torch.where(gb.valid[..., None],
                           torch.where(ok, _rgb([0.1, 0.9, 0.1], dev),
                                       _rgb([0.9, 0.1, 0.1], dev)), ldr_f)
    raise ValueError(f"unknown SHARC debug view '{name}'")
