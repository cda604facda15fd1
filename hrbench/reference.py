"""The plain reference's scene: world-space triangles and their attributes,
worked out from the scene as it was handed to the renderer, and closest
and any hits of rays found by testing every triangle.

Plain PyTorch and NumPy. It imports nothing of the program: no BVH, no
split table, no kernel and no plain kernel version. The scene enters as
``snapshot_scene``'s copy of its raw data, taken before the renderer saw
it: per mesh its positions, LOD0 triangle indices and the vertex normals
and uvs in the scene's storage format (10:10 octahedral normals, half
uvs), per node TRS and parent, per instance its mesh, node, material and
alpha mode, the materials with their base-colour images, the lights and
the authored camera. Node transforms, the triangle soup, its normals and
uvs are worked out here again.

Triangle test: Moller-Trumbore, a hit where u >= 0, v >= 0, u + v <= 1 and
t_min < t < t_max, in the dtype asked for (float32; the control runs it in
bfloat16)."""

from __future__ import annotations

import numpy as np
import torch

# the scene format's enumerations
LIGHT_DIRECTIONAL, LIGHT_POINT, LIGHT_SPOT = 0, 1, 2
ALPHA_OPAQUE, ALPHA_MASKED, ALPHA_BLEND = 0, 1, 2


def snapshot_scene(scene) -> dict:
    """Copies of what the reference needs of a finalized, static Scene."""
    if any(a.channels for a in scene.animations):
        raise ValueError("the reference covers static scenes")
    meshes = {}
    insts = []
    for inst in scene.instances:
        if inst.prim not in meshes:
            m = scene.meshes[inst.prim]
            meshes[inst.prim] = dict(
                pos=np.array(m.positions, np.float64),
                idx=np.array(m.lods[0].indices, np.int64).reshape(-1, 3),
                nrm=np.array(m.normals_packed, np.uint32),
                uv=np.array(m.uvs_packed, np.uint32))
        insts.append(dict(prim=int(inst.prim), node=int(inst.node),
                          material=int(inst.material), alpha_mode=int(inst.alpha_mode)))
    nodes = [dict(t=np.array(n.translation, np.float64), r=np.array(n.rotation, np.float64),
                  s=np.array(n.scale, np.float64), parent=int(n.parent)) for n in scene.nodes]
    images = list(getattr(scene, "images", []) or [])
    mats = []
    for m in scene.materials:
        if max(m.normal_tex, m.orm_tex, m.emissive_tex) >= 0:
            raise ValueError("the reference samples base-colour textures only")
        tex = m.base_color_tex
        mats.append(dict(
            base=np.array(m.base_color, np.float32),
            metallic=float(m.metallic), roughness=float(m.roughness),
            emissive=np.asarray(m.emissive, np.float32) * np.float32(m.emissive_strength),
            alpha_cutoff=float(m.alpha_cutoff) if m.alpha_mode == ALPHA_MASKED else 0.0,
            transmission=float(m.transmission), ior=float(m.ior),
            atten_color=np.array(m.attenuation_color, np.float32),
            atten_dist=min(float(m.attenuation_distance), 1e6), uv_scale=float(m.uv_scale),
            image=np.array(images[tex], np.uint8) if 0 <= tex < len(images) else None))
    lights = [dict(type=int(li.type), pos=np.array(li.position, np.float32),
                   dir=np.array(li.direction, np.float32),
                   color=np.asarray(li.color, np.float32) * np.float32(li.intensity),
                   range=float(li.range), cone=(float(np.cos(li.inner_cone)),
                                                float(np.cos(li.outer_cone))))
              for li in scene.lights]
    cam = scene.cameras[0] if scene.cameras else None
    return dict(meshes=meshes, instances=insts, nodes=nodes, materials=mats, lights=lights,
                fov_y=float(cam.fov_y) if cam else float(np.deg2rad(60.0)))


def _quat_mat(q):
    x, y, z, w = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def node_worlds(snap: dict) -> list:
    """Every node's 4x4 world matrix (float64)."""
    nodes = snap["nodes"]
    worlds = [None] * len(nodes)

    def world(i):
        if worlds[i] is None:
            n = nodes[i]
            m = np.eye(4)
            m[:3, :3] = _quat_mat(n["r"] / np.linalg.norm(n["r"])) * n["s"][None, :]
            m[:3, 3] = n["t"]
            worlds[i] = world(n["parent"]) @ m if n["parent"] >= 0 else m
        return worlds[i]
    return [world(i) for i in range(len(nodes))]


def world_triangles(snap: dict, device) -> torch.Tensor:
    """(T, 3, 3) float32 world-space triangles of every instance, in
    instance order, on ``device``."""
    worlds = node_worlds(snap)
    out = []
    for inst in snap["instances"]:
        m = snap["meshes"][inst["prim"]]
        w = worlds[inst["node"]]
        pw = m["pos"] @ w[:3, :3].T + w[:3, 3]
        out.append(pw[m["idx"]])
    return torch.as_tensor(np.concatenate(out, 0).astype(np.float32), device=device)


def oct_normals(packed: np.ndarray) -> np.ndarray:
    """(V,) uint32 10:10 octahedral normals -> (V, 3) float32 unit vectors."""
    p = packed.astype(np.int64)
    e = np.stack([(p & 0x3FF), ((p >> 10) & 0x3FF)], -1).astype(np.float32) / np.float32(1023.0)
    e = e * np.float32(2.0) - np.float32(1.0)
    u, v = e[:, 0], e[:, 1]
    z = np.float32(1.0) - np.abs(u) - np.abs(v)
    t = np.maximum(-z, np.float32(0.0))
    u = u + np.where(u >= 0, -t, t)
    v = v + np.where(v >= 0, -t, t)
    n = np.stack([u, v, z], -1).astype(np.float32)
    return (n / np.maximum(np.sqrt((n * n).sum(-1, keepdims=True)), 1e-20)).astype(np.float32)


def half_uvs(packed: np.ndarray) -> np.ndarray:
    """(V,) uint32 half2 uvs -> (V, 2) float32."""
    lo = (packed & 0xFFFF).astype(np.uint16).view(np.float16)
    hi = (packed >> 16).astype(np.uint16).view(np.float16)
    return np.stack([lo, hi], -1).astype(np.float32)


def triangle_attributes(snap: dict, device) -> dict:
    """Per world triangle (instance order): ``inst`` (T,), world vertex
    normals ``vn`` (T, 3, 3) (the normal matrix of the instance times the
    stored normal) and ``vuv`` (T, 3, 2)."""
    worlds = node_worlds(snap)
    insts, vns, vuvs = [], [], []
    for i, inst in enumerate(snap["instances"]):
        m = snap["meshes"][inst["prim"]]
        nmat = torch.as_tensor(np.linalg.inv(worlds[inst["node"]][:3, :3]).T.astype(np.float32),
                               device=device)
        n_obj = torch.as_tensor(oct_normals(m["nrm"])[m["idx"]], device=device)   # (t, 3, 3)
        vns.append(torch.einsum("ij,tvj->tvi", nmat, n_obj))
        vuvs.append(torch.as_tensor(half_uvs(m["uv"])[m["idx"]], device=device))
        insts.append(torch.full((m["idx"].shape[0],), i, dtype=torch.int64, device=device))
    return dict(inst=torch.cat(insts), vn=torch.cat(vns), vuv=torch.cat(vuvs))


def _block_hits(tris, o, d, t_min, t_max, any_hit: bool, dtype):
    """(nearest t, its triangle) of rays o, d (B, 3) against every triangle
    (T, 3, 3), t in (t_min, t_max) per ray; any_hit stops at the first
    block where every ray has found one."""
    B = o.shape[0]
    T = tris.shape[0]
    dev = o.device
    o = o.to(dtype)
    d = d.to(dtype)
    tmin = t_min.to(dtype)[:, None]
    tmax = t_max.to(torch.float32)
    best = torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
    best_tri = torch.full((B,), -1, dtype=torch.int64, device=dev)
    # a block of rays x triangles holds about 2^24 pairs a tensor
    step = max(1, (1 << 24) // max(B, 1))
    for s in range(0, T, step):
        tr = tris[s:s + step].to(dtype)
        v0 = tr[:, 0]
        e1 = tr[:, 1] - v0
        e2 = tr[:, 2] - v0
        ox, oy, oz = (o[:, i:i + 1] for i in range(3))
        dx, dy, dz = (d[:, i:i + 1] for i in range(3))
        v0x, v0y, v0z = (v0[None, :, i] for i in range(3))
        e1x, e1y, e1z = (e1[None, :, i] for i in range(3))
        e2x, e2y, e2z = (e2[None, :, i] for i in range(3))
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        ok = det.abs() > 1e-12
        inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
        u = (sx * px + sy * py + sz * pz) * inv
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = (e2x * qx + e2y * qy + e2z * qz) * inv
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > tmin)
        tf = torch.where(hit, t.to(torch.float32), torch.full_like(t, float("inf"),
                                                                   dtype=torch.float32))
        tf = torch.where(tf < tmax[:, None], tf, float("inf"))
        bt, bi = tf.min(1)
        closer = bt < best
        best = torch.where(closer, bt, best)
        best_tri = torch.where(closer, bi + s, best_tri)
        if any_hit and bool(torch.isfinite(best).all()):
            break
    return best, best_tri


def trace(tris, o, d, t_min, t_max, any_hit: bool = False, dtype=torch.float32,
          rays_a_block: int = 256, with_tri: bool = False):
    """Rays o, d (R, 3) with per-ray t_min, t_max (R,) against every
    triangle: t (R,) float32, inf where nothing lies in (t_min, t_max);
    with ``with_tri`` also the triangle (R,) int64, -1 on a miss."""
    ts, tris_hit = [], []
    for s in range(0, o.shape[0], rays_a_block):
        sl = slice(s, s + rays_a_block)
        t, tri = _block_hits(tris, o[sl], d[sl], t_min[sl], t_max[sl], any_hit, dtype)
        ts.append(t)
        tris_hit.append(tri)
    if not ts:
        z = torch.zeros((0,), dtype=torch.float32, device=o.device)
        return (z, z.to(torch.int64)) if with_tri else z
    t = torch.cat(ts)
    return (t, torch.cat(tris_hit)) if with_tri else t


def barycentrics(tris, tri, o, d):
    """(u, v) of rays o, d (R, 3) on their triangles ``tri`` (R,) (0 where
    tri < 0), Moller-Trumbore in float32."""
    tv = tris[torch.clamp(tri, min=0)]
    v0, e1, e2 = tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]
    p = torch.linalg.cross(d, e2, dim=-1)
    det = torch.sum(e1 * p, -1)
    inv = torch.where(det.abs() > 1e-12, 1.0 / torch.where(det.abs() > 1e-12, det, 1.0), 0.0)
    s = o - v0
    q = torch.linalg.cross(s, e1, dim=-1)
    u = torch.sum(s * p, -1) * inv
    v = torch.sum(d * q, -1) * inv
    miss = tri < 0
    return torch.where(miss, 0.0, u), torch.where(miss, 0.0, v)
