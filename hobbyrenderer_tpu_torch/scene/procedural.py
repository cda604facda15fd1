"""Procedural test assets.

Reference: src/ProceduralDefaultCube.{h,cpp} — a quantized unit cube + meshlets, the
scene-free smoke-test fixture (BASELINE.json configs[0]). We add a parameterized
"stress scene" (grid of varied primitives with many instances and materials) standing
in for Sponza-class benchmark content, since the reference ships no glTF assets."""

from __future__ import annotations

import numpy as np

from hobbyrenderer_tpu_torch.scene.cooker import cook_mesh
from hobbyrenderer_tpu_torch.scene.scene import (ALPHA_MASKED, ALPHA_OPAQUE, CameraDesc, Light,
                                           LIGHT_DIRECTIONAL, LIGHT_POINT, Material, Node,
                                           Scene)


def cube_geometry(half: float = 0.5):
    """24-vertex cube with per-face normals + UVs (ref GenerateDefaultCube)."""
    h = half
    faces = [
        ((0, 0, 1), [(-h, -h, h), (h, -h, h), (h, h, h), (-h, h, h)]),
        ((0, 0, -1), [(h, -h, -h), (-h, -h, -h), (-h, h, -h), (h, h, -h)]),
        ((1, 0, 0), [(h, -h, h), (h, -h, -h), (h, h, -h), (h, h, h)]),
        ((-1, 0, 0), [(-h, -h, -h), (-h, -h, h), (-h, h, h), (-h, h, -h)]),
        ((0, 1, 0), [(-h, h, h), (h, h, h), (h, h, -h), (-h, h, -h)]),
        ((0, -1, 0), [(-h, -h, -h), (h, -h, -h), (h, -h, h), (-h, -h, h)]),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for fi, (n, quad) in enumerate(faces):
        base = fi * 4
        pos.extend(quad)
        nrm.extend([n] * 4)
        uv.extend([(0, 0), (1, 0), (1, 1), (0, 1)])
        idx.extend([base, base + 1, base + 2, base, base + 2, base + 3])
    return (np.asarray(pos, np.float32), np.asarray(nrm, np.float32),
            np.asarray(uv, np.float32), np.asarray(idx, np.int32))


def sphere_geometry(radius: float = 0.5, rings: int = 24, segs: int = 32):
    """UV sphere (ref CommonResources unit-sphere mesh)."""
    ring_a = np.linspace(0, np.pi, rings + 1)
    seg_a = np.linspace(0, 2 * np.pi, segs + 1)
    rr, ss = np.meshgrid(ring_a, seg_a, indexing="ij")
    x = np.sin(rr) * np.cos(ss)
    y = np.cos(rr)
    z = np.sin(rr) * np.sin(ss)
    pos = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32) * radius
    nrm = (pos / max(radius, 1e-9)).astype(np.float32)
    uv = np.stack([ss / (2 * np.pi), rr / np.pi], -1).reshape(-1, 2).astype(np.float32)
    idx = []
    for r in range(rings):
        for s in range(segs):
            a = r * (segs + 1) + s
            b = a + segs + 1
            idx.extend([a, b, a + 1, a + 1, b, b + 1])
    return pos, nrm, uv, np.asarray(idx, np.int32)


def plane_geometry(half: float = 10.0, uv_tiles: float = 8.0):
    pos = np.asarray([(-half, 0, -half), (half, 0, -half), (half, 0, half), (-half, 0, half)],
                     np.float32)
    nrm = np.tile(np.asarray([[0, 1, 0]], np.float32), (4, 1))
    uv = np.asarray([(0, 0), (uv_tiles, 0), (uv_tiles, uv_tiles), (0, uv_tiles)], np.float32)
    idx = np.asarray([0, 2, 1, 0, 3, 2], np.int32)
    return pos, nrm, uv, idx


def torus_geometry(R: float = 0.6, r: float = 0.25, nu: int = 32, nv: int = 18):
    u = np.linspace(0, 2 * np.pi, nu + 1)
    v = np.linspace(0, 2 * np.pi, nv + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    cx, cz = np.cos(uu), np.sin(uu)
    x = (R + r * np.cos(vv)) * cx
    z = (R + r * np.cos(vv)) * cz
    y = r * np.sin(vv)
    pos = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    center = np.stack([R * cx, np.zeros_like(y), R * cz], -1).reshape(-1, 3)
    nrm = np.asarray((pos - center) / r, np.float32)
    uv = np.stack([uu / (2 * np.pi) * 4, vv / (2 * np.pi)], -1).reshape(-1, 2).astype(np.float32)
    idx = []
    for i in range(nu):
        for j in range(nv):
            a = i * (nv + 1) + j
            b = a + nv + 1
            idx.extend([a, b, a + 1, a + 1, b, b + 1])
    return pos, nrm, uv, np.asarray(idx, np.int32)


def make_default_cube_scene() -> Scene:
    """The smoke-test scene: a single unit cube + default sun (configs[0])."""
    sc = Scene()
    pos, nrm, uv, idx = cube_geometry()
    prim = sc.add_mesh(cook_mesh(pos, idx, normals=nrm, uvs=uv), material=0)
    sc.add_node(Node(name="cube", mesh_primitives=[prim]))
    sc.cameras.append(camera_looking_at(np.array([1.5, 1.2, 2.2], np.float32),
                                        np.zeros(3, np.float32)))
    sc.finalize()
    return sc


def make_stress_scene(grid: int = 12, seed: int = 7, with_lights: bool = True,
                      lod_rich: bool = True) -> Scene:
    """Sponza-class benchmark stand-in: ground plane + grid of cubes/spheres/tori
    with varied materials (some masked/emissive), several point lights + sun.

    grid=12 -> 145 instances, ~420k triangles at LOD0 (spheres+tori dominate)."""
    rng = np.random.default_rng(seed)
    sc = Scene()
    geos = []
    geos.append(cook_mesh(*_reorder(plane_geometry(grid * 1.2))))
    geos.append(cook_mesh(*_reorder(cube_geometry())))
    if lod_rich:
        geos.append(cook_mesh(*_reorder(sphere_geometry(0.5, 48, 64))))
        geos.append(cook_mesh(*_reorder(torus_geometry(0.55, 0.22, 64, 36))))
    else:
        geos.append(cook_mesh(*_reorder(sphere_geometry(0.5, 16, 24))))
        geos.append(cook_mesh(*_reorder(torus_geometry(0.55, 0.22, 24, 12))))

    mats = []
    # procedural base-color textures on half the materials: Sponza-class
    # content is texture-heavy, so the benchmark must pay the texture-resolve
    # cost (mip-chained table sampling + alpha-tested cutouts), not just flat
    # constants
    sc.images = list(getattr(sc, "images", []))
    trng = np.random.default_rng(seed + 1000)   # own stream: the texture
    #                                 draws must not shift the scene layout
    for i in range(16):
        hue = rng.random(3).astype(np.float32)
        m = Material(name=f"m{i}",
                     base_color=np.append(0.2 + 0.8 * hue, 1.0).astype(np.float32),
                     metallic=float(rng.random() > 0.7) * float(rng.random()),
                     roughness=float(0.15 + 0.8 * rng.random()))
        if i % 5 == 4:
            m.emissive = (hue * 4.0).astype(np.float32)
        if i % 7 == 6:
            m.alpha_mode = ALPHA_MASKED
            m.alpha_cutoff = 0.5
        if i % 11 == 9:
            from hobbyrenderer_tpu_torch.scene.scene import ALPHA_BLEND
            m.alpha_mode = ALPHA_BLEND
            m.base_color[3] = 0.35
            m.transmission = 0.6
            m.attenuation_color = np.clip(m.base_color[:3] * 1.4, 0, 1)
        if i % 2 == 0:
            S = 256
            yy, xx = np.mgrid[0:S, 0:S]
            if i % 4 == 0:   # checker
                c = (((xx // 32) ^ (yy // 32)) & 1).astype(np.float32)
                tex = 0.45 + 0.55 * c
            else:            # band noise
                tex = 0.5 + 0.5 * np.sin(xx * (0.07 + 0.02 * (i % 3))
                                         + np.sin(yy * 0.11) * 3.0)
            img = np.empty((S, S, 4), np.uint8)
            tint = 0.6 + 0.4 * trng.random(3)
            for ch in range(3):
                img[..., ch] = np.clip(tex * tint[ch] * 255, 0, 255)
            # masked materials get a real cutout pattern in alpha
            if m.alpha_mode == ALPHA_MASKED:
                img[..., 3] = np.where(((xx // 24 + yy // 24) & 1) > 0, 255, 0)
            else:
                img[..., 3] = 255
            m.base_color_tex = len(sc.images)
            sc.images.append(img)
        mats.append(sc.add_material(m))

    # register one (geometry, material) primitive per use to mirror glTF primitives
    ground_mat = sc.add_material(Material(name="ground",
                                          base_color=np.array([0.55, 0.55, 0.6, 1], np.float32),
                                          roughness=0.9))
    ground = sc.add_mesh(geos[0], material=ground_mat)
    sc.add_node(Node(name="ground", mesh_primitives=[ground]))

    for i in range(grid):
        for j in range(grid):
            kind = int(rng.integers(1, len(geos)))
            mat = mats[int(rng.integers(0, len(mats)))]
            prim = sc.add_mesh(geos[kind], material=mat)
            x = (i - (grid - 1) / 2) * 2.0
            z = (j - (grid - 1) / 2) * 2.0
            s = float(0.6 + rng.random() * 0.9)
            ang = float(rng.random() * np.pi * 2)
            q = np.array([0, np.sin(ang / 2), 0, np.cos(ang / 2)], np.float32)
            sc.add_node(Node(name=f"obj_{i}_{j}", mesh_primitives=[prim],
                             translation=np.array([x, 0.55 * s, z], np.float32),
                             rotation=q, scale=np.full(3, s, np.float32)))

    if with_lights:
        sc.add_light(Light(type=LIGHT_DIRECTIONAL,
                           direction=np.array([0.35, -0.75, 0.45], np.float32),
                           intensity=6.0, radius=0.004675, name="sun"))
        for k in range(8):
            ang = k / 8 * 2 * np.pi
            sc.add_light(Light(type=LIGHT_POINT,
                               position=np.array([np.cos(ang) * grid * 0.7, 2.0,
                                                  np.sin(ang) * grid * 0.7], np.float32),
                               color=np.abs(rng.random(3)).astype(np.float32),
                               intensity=40.0, radius=0.05, range=30.0, name=f"pt{k}"))
    sc.cameras.append(CameraDesc(position=np.array([0.0, grid * 0.45, grid * 1.05], np.float32),
                                 pitch=-0.35))
    sc.finalize()
    return sc


def camera_looking_at(position: np.ndarray, target: np.ndarray) -> CameraDesc:
    d = np.asarray(target, np.float32) - np.asarray(position, np.float32)
    pitch = float(np.arctan2(d[1], np.linalg.norm(d[[0, 2]])))
    yaw = float(np.arctan2(-d[0], -d[2]))
    return CameraDesc(position=np.asarray(position, np.float32), yaw=yaw, pitch=pitch)


def _reorder(t):
    """(pos, nrm, uv, idx) -> cook_mesh positional order (pos, idx, nrm, uv)."""
    pos, nrm, uv, idx = t
    return pos, idx, nrm, uv
