"""Ray-tracing scene for the traced passes and the path tracer.

Counterpart of hobbyrenderer_tpu/models/pathtracer.py::_subdivide_large /
build_scene_rt / refit_scene_rt / _fetch_hit_attrs (pathtracer.py:113-190,
203-236), cut down to what those passes need: the LOD0 world-space
triangles (oversized ones subdivided), their 4-wide BVH and beam table (K4),
the split tables, the per-triangle vertex / instance / material tables, the
instances' inverse load-time transforms, and with the uploaded scene the
16-wide BVH (K3), the light pool and the emissive index. ``refit_scene_rt``
moves it all with the instances on the device each frame an instance moved;
``fetch_hit_attrs`` interpolates a hit's attributes."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from hobbyrenderer_tpu_torch.utils import math as hm
from hobbyrenderer_tpu_torch.ops import beam as beamops
from hobbyrenderer_tpu_torch.ops import bvh as bvhops
from hobbyrenderer_tpu_torch.ops import bvh16 as b16ops
from hobbyrenderer_tpu_torch.ops import lights as lightops
from hobbyrenderer_tpu_torch.utils import tmath as tm


class SceneRT(NamedTuple):
    bvh: bvhops.BVH            # the 4-wide tree, its tensors on the device
    btable: torch.Tensor       # (I+L, 128) f32 beam table on the device
    split_to_orig: torch.Tensor  # (Ts,) split tri -> original tri
    split_bary: torch.Tensor   # (Ts, 3, 2) original (u, v) of split verts
    split_world0: torch.Tensor  # (Ts, 3, 3) split verts at load-time world
    bvh16: b16ops.BVH16 = None   # 16-wide BVH over the split triangles
    lights: lightops.LightPool = None
    em_index: torch.Tensor = None  # (T,) original tri -> pool emissive entry (-1 none)
    tri_gv: torch.Tensor = None    # (T, 3) global vertex ids of the original tris
    tri_inst: torch.Tensor = None  # (T,) instance id
    tri_mat: torch.Tensor = None   # (T,) material id
    inst_inv0: torch.Tensor = None  # (N, 4, 4) f32 inverse world transform at load


RT_FIELDS = ("btable", "split_to_orig", "split_bary", "split_world0")
TABLE_FIELDS = ("tri_gv", "tri_inst", "tri_mat")
POOL_FIELDS = ("em_v0", "em_e1", "em_e2", "em_rad", "em_orig", "em_scale",
               "power_cdf", "power_pdf", "packed")


def _subdivide_large(tri_verts: np.ndarray, max_rounds: int = 4,
                     rel_threshold: float = 1.0 / 24.0):
    """1->4 midpoint subdivision of triangles larger than rel_threshold x the
    scene diagonal. Returns (split_verts, split_to_orig, split_bary)."""
    T = tri_verts.shape[0]
    orig = np.arange(T, dtype=np.int32)
    bary = np.tile(np.asarray([[[0, 0], [1, 0], [0, 1]]], np.float32), (T, 1, 1))
    verts = tri_verts
    lo = tri_verts.reshape(-1, 3).min(0)
    hi = tri_verts.reshape(-1, 3).max(0)
    thresh = float(np.linalg.norm(hi - lo)) * rel_threshold
    for _ in range(max_rounds):
        ext = verts.max(1) - verts.min(1)
        big = np.linalg.norm(ext, axis=1) > thresh
        if not big.any():
            break
        keep_v, keep_o, keep_b = verts[~big], orig[~big], bary[~big]
        bv, bo, bb = verts[big], orig[big], bary[big]
        m01v, m12v, m02v = (0.5 * (bv[:, 0] + bv[:, 1]), 0.5 * (bv[:, 1] + bv[:, 2]),
                            0.5 * (bv[:, 0] + bv[:, 2]))
        m01b, m12b, m02b = (0.5 * (bb[:, 0] + bb[:, 1]), 0.5 * (bb[:, 1] + bb[:, 2]),
                            0.5 * (bb[:, 0] + bb[:, 2]))
        child_v = np.concatenate([
            np.stack([bv[:, 0], m01v, m02v], 1), np.stack([m01v, bv[:, 1], m12v], 1),
            np.stack([m02v, m12v, bv[:, 2]], 1), np.stack([m01v, m12v, m02v], 1)], 0)
        child_b = np.concatenate([
            np.stack([bb[:, 0], m01b, m02b], 1), np.stack([m01b, bb[:, 1], m12b], 1),
            np.stack([m02b, m12b, bb[:, 2]], 1), np.stack([m01b, m12b, m02b], 1)], 0)
        verts = np.concatenate([keep_v, child_v], 0)
        orig = np.concatenate([keep_o, np.tile(bo, 4)], 0)
        bary = np.concatenate([keep_b, child_b], 0)
    return verts.astype(np.float32), orig.astype(np.int32), bary.astype(np.float32)


def build_scene_rt(scene, device, gpu=None) -> SceneRT:
    """Host-side flatten of every instance's LOD0 triangles to world space,
    BVH + beam table and per-triangle tables, upload to ``device``. With
    the uploaded scene ``gpu`` (for RTXDI and DDGI), also the 16-wide BVH,
    the light pool and the emissive index."""
    tris, gvs, insts, mats = [], [], [], []
    voff = np.cumsum([0] + [m.num_vertices for m in scene.meshes])
    for i, I in enumerate(scene.instances):
        mesh = scene.meshes[I.prim]
        idx = mesh.lods[0].indices
        pw = hm.transform_points(scene.nodes[I.node].world, mesh.positions)
        tris.append(pw[idx])
        gvs.append(idx.astype(np.int32) + voff[I.prim])
        insts.append(np.full(idx.shape[0], i, np.int32))
        mats.append(np.full(idx.shape[0], I.material, np.int32))
    tri_verts = np.concatenate(tris, 0).astype(np.float32)
    split_verts, split_to_orig, split_bary = _subdivide_large(tri_verts)
    bvh = bvhops.build_bvh(split_verts)
    host = dict(btable=beamops.beam_table(bvh.table), split_to_orig=split_to_orig,
                split_bary=split_bary, split_world0=split_verts,
                tri_gv=np.concatenate(gvs, 0), tri_inst=np.concatenate(insts, 0),
                tri_mat=np.concatenate(mats, 0),
                inst_inv0=np.stack([np.linalg.inv(scene.nodes[I.node].world)
                                    for I in scene.instances]).astype(np.float32))
    if gpu is None:
        return scene_rt_from_numpy(host, device, bvh=bvh)
    host["bvh16"] = b16ops.build_bvh16_arrays(split_verts)
    rt = scene_rt_from_numpy(host, device, bvh=bvh)
    pool = lightops.build_light_pool(scene, gpu)
    em_index = np.full(tri_verts.shape[0], -1, np.int64)
    orig = pool.em_orig.cpu().numpy()
    live = orig >= 0
    em_index[orig[live]] = np.nonzero(live)[0]
    return rt._replace(lights=pool, em_index=torch.as_tensor(em_index, device=device))


def scene_rt_from_numpy(d: Dict[str, Any], device, bvh=None) -> SceneRT:
    """A SceneRT as numpy (``{name: array}``, the JAX SceneRT's leaves:
    btable, split_to_orig, split_bary, split_world0; optionally tri_gv /
    tri_inst / tri_mat / inst_inv0, bvh_table /
    bvh_order / bvh_root_box; ``bvh16`` as a dict of the JAX BVH16's table
    (transposed (128, I+L) as the JAX package stores it, or row-major),
    order, root_box, recs, slot_of; ``lights`` as a dict of the LightPool's
    fields and ``em_index``) -> the port's SceneRT on ``device``."""
    def t(a):
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            return torch.as_tensor(a.astype(np.int64), device=device)
        return torch.as_tensor(a.astype(np.float32), device=device)

    if bvh is None and "bvh_table" in d:
        bvh = bvhops.BVH(table=np.asarray(d["bvh_table"], np.float32),
                         order=np.asarray(d["bvh_order"], np.int32),
                         root_box=np.asarray(d["bvh_root_box"], np.float32),
                         num_tris=int(np.asarray(d["split_to_orig"]).shape[0]))
    extra = {k: t(d[k]) for k in TABLE_FIELDS + ("inst_inv0",) if d.get(k) is not None}
    if d.get("bvh16") is not None:
        b = dict(d["bvh16"])
        if b["table"].shape[0] == b16ops.ROW_W and b["table"].shape[1] != b16ops.ROW_W:
            b["table"] = b16ops.from_jax_table(b["table"])
        extra["bvh16"] = b16ops.bvh16_from_numpy(
            b, int(np.asarray(d["split_to_orig"]).shape[0]), device)
    if d.get("lights") is not None:
        lp = d["lights"]
        extra["lights"] = lightops.LightPool(
            n_analytic=int(lp["n_analytic"]), n_total=int(lp["n_total"]),
            **{k: t(lp[k]) for k in POOL_FIELDS})
        extra["em_index"] = t(d["em_index"])
    return SceneRT(bvh=None if bvh is None else bvhops.bvh_to_device(bvh, device),
                   **{k: t(d[k]) for k in RT_FIELDS}, **extra)


def refit_scene_rt(rt: SceneRT, inst_transform) -> SceneRT:
    """The per-frame update of moved instances, on the device: every split
    triangle moves by its instance's W_now @ W_load^-1 (inst_transform
    (N, 4, 4): the current world matrices, SceneGPU.inst_transform), then
    the 4-wide tree and its beam table, the 16-wide tree and the light
    pool's emissive triangles are refitted over the moved triangles. The
    transforms are separate products and sums in a fixed order
    (tmath.affine_points), so the CPU and the GPU refit to the same bits."""
    M = tm.matmul4(inst_transform, rt.inst_inv0)
    Mi = M[rt.tri_inst[rt.split_to_orig]]                       # (Ts, 4, 4)
    v = tm.affine_points(Mi[:, None], rt.split_world0)
    bvh = bvhops.refit_bvh(rt.bvh, v)
    rt = rt._replace(bvh=bvh, btable=beamops.beam_table(bvh.table))
    if rt.bvh16 is not None:
        rt = rt._replace(bvh16=b16ops.refit_bvh16(rt.bvh16, v))
    if rt.lights is not None:
        M_tri = M[rt.tri_inst[torch.clamp(rt.lights.em_orig, min=0)]]
        rt = rt._replace(lights=lightops.refit_light_pool(rt.lights, M_tri))
    return rt


def fetch_hit_attrs(gpu, rt: SceneRT, hit, o, d):
    """Attributes at closest hits: world position, shading normal, geometric
    normal, uv, material and instance. A split triangle's hit maps back to
    its original triangle and barycentrics; both normals are flipped toward
    the incoming ray (two-sided shading)."""
    stri = torch.clamp(hit.tri, min=0).to(torch.int64)
    tri = rt.split_to_orig[stri]
    sb = rt.split_bary[stri]                                    # (R, 3, 2)
    uv_orig = (sb[:, 0] * (1.0 - hit.u - hit.v)[:, None]
               + sb[:, 1] * hit.u[:, None] + sb[:, 2] * hit.v[:, None])
    u, v = uv_orig[:, 0], uv_orig[:, 1]
    gv = rt.tri_gv[tri]
    inst = rt.tri_inst[tri]
    mat = rt.tri_mat[tri]
    b = torch.stack([1.0 - u - v, u, v], -1)
    n_obj, _s = tm.unpack_normal_oct(gpu.vnormals[gv])          # (R, 3, 3)
    n_w = torch.einsum("rij,rvj->rvi", gpu.inst_normal_mat[inst], n_obj)
    n = tm.normalize(torch.einsum("rv,rvi->ri", b, n_w))
    W = gpu.inst_transform[inst]
    p_w = torch.einsum("rij,rvj->rvi", W[:, :3, :3], gpu.positions[gv]) + W[:, None, :3, 3]
    gn = tm.normalize(tm.cross(p_w[:, 1] - p_w[:, 0], p_w[:, 2] - p_w[:, 0]))
    pos = o + d * hit.t[..., None]
    uv = torch.einsum("rv,rvi->ri", b, tm.unpack_uv_half2(gpu.vuvs[gv]))
    gn = torch.where(torch.sum(gn * d, -1, keepdim=True) > 0, -gn, gn)
    n = torch.where(torch.sum(n * gn, -1, keepdim=True) < 0, -n, n)
    return pos, n, gn, uv, mat, inst
