"""SceneGPU: the device-resident scene as a dataclass of torch tensors.

Counterpart of hobbyrenderer_tpu/scene/gpu.py. The host flattening is the same
numpy code (without the texture-streaming branch, which this port does not
run yet); the upload goes to an explicit ``device``. An environment map, its
SH projection and an authored BRDF LUT ride along as optional tensors.

Dtypes: float tables are float32; every integer table is int64 (torch indexes
with int64), including the packed uint32 vertex/texel words, which keep their
unsigned values. ``scene_gpu_from_numpy`` converts the JAX package's leaves to
the same layout so both packages render from identical tables."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np
import torch

from hobbyrenderer_tpu_torch.scene.cooker import MAX_LODS, MESHLET_MAX_TRIS, MESHLET_MAX_VERTS
from hobbyrenderer_tpu_torch.scene.scene import ALPHA_MASKED, Scene
from hobbyrenderer_tpu_torch.utils import math as hm

# Material float-layout offsets (same layout as the JAX package)
MAT_BASE_COLOR = 0      # 4
MAT_METALLIC = 4
MAT_ROUGHNESS = 5
MAT_EMISSIVE = 6        # 3
MAT_ALPHA_CUTOFF = 9
MAT_TRANSMISSION = 10
MAT_IOR = 11
MAT_ATTEN_COLOR = 12    # 3
MAT_UV_SCALE = 15
MAT_ATTEN_DIST = 16
MAT_TEX_SIZE = 17
MAT_TEX_BASE_HI = 18
MAT_TEX_BASE_LO = 19
# int layout
MATI_ALPHA_MODE = 0
MATI_DOUBLE_SIDED = 1
MATI_BASE_TEX = 2
MATI_NORMAL_TEX = 3
MATI_ORM_TEX = 4
MATI_EMISSIVE_TEX = 5

@dataclass
class SceneGPU:
    """All device scene data (see the JAX SceneGPU for each table's meaning).

    ``meta`` holds host-side facts derived once at upload (light count,
    raster capacities, alpha-mode presence), so the frame never reads a
    device scalar back to steer Python control flow."""

    positions: Any
    vnormals: Any
    vuvs: Any
    vtangents: Any
    tri_indices: Any
    ml_vertices: Any
    ml_tris: Any
    ml_vert_offset: Any
    ml_vert_count: Any
    ml_tri_offset: Any
    ml_tri_count: Any
    ml_center: Any
    ml_radius: Any
    ml_cone_axis: Any
    ml_cone_cutoff: Any
    ml_pos: Any
    ml_attr: Any
    ml_gv: Any
    ml_ltris: Any
    prim_lod_count: Any
    prim_lod_error: Any
    prim_tri_offset: Any
    prim_tri_count: Any
    prim_center: Any
    prim_radius: Any
    inst_transform: Any
    inst_prev_transform: Any
    inst_normal_mat: Any
    inst_prim: Any
    inst_material: Any
    inst_alpha_mode: Any
    inst_center: Any
    inst_radius: Any
    inst_scale_max: Any
    pair_inst: Any
    pair_meshlet: Any
    pair_lod: Any
    mat_f: Any
    mat_i: Any
    tex_table: Any
    mat_tex_size: Any
    mat_mip_off: Any
    light_type: Any
    light_pos: Any
    light_dir: Any
    light_color: Any
    light_radius: Any
    light_range: Any
    light_cone: Any
    light_count: Any
    meta: Dict[str, Any] = field(default_factory=dict)
    env_map: Any = None       # (He, We, 3) f32 equirect radiance (ops/envmap.py)
    env_sh: Any = None        # (9, 3) f32 irradiance SH of the env map or --irradiance
    brdf_lut: Any = None      # (N, N, 2) f32 authored split-sum LUT (--brdflut)
    tex_stream: Any = None    # scene/streaming.py StreamTables under texture streaming

    def __post_init__(self):
        if not self.meta:
            self.meta = _host_meta(self)

    @property
    def device(self) -> torch.device:
        return self.positions.device

    @property
    def lod0_pair_capacity(self) -> int:
        return self.meta["lod0_pair_capacity"]

    def bucket_pair_capacity(self, modes) -> int:
        return self.meta["bucket_pair_capacity"][tuple(modes)]

    def shadow_pair_capacity(self, biases) -> int:
        """Static bound on (cascade, pair) shadow-raster slots: per cascade c,
        every shadow-casting instance contributes its meshlet count at LOD
        min(biases[c], lod_count - 1)."""
        counts = self.meta["inst_lod_pairs"]
        lc = self.meta["inst_lod_count"]
        casts = self.meta["inst_casts_shadow"]
        n = counts.shape[0]
        total = 0
        for b in biases:
            lod = np.minimum(b, lc - 1)
            total += int(np.sum(counts[np.arange(n), lod] * casts))
        return max(total, 1)


# the environment's optional leaves (None without an environment map / LUT)
ENV_FIELDS = ("env_map", "env_sh", "brdf_lut")
# the JAX SceneGPU leaves every scene has, in dataclass order
FIELDS = tuple(f.name for f in dataclasses.fields(SceneGPU)
               if f.name not in ("meta", "tex_stream") and f.name not in ENV_FIELDS)


def _host_meta(g: SceneGPU) -> Dict[str, Any]:
    pl = g.pair_lod.cpu().numpy()
    pi = g.pair_inst.cpu().numpy()
    am = g.inst_alpha_mode.cpu().numpy()
    lt = g.light_type.cpu().numpy()
    nl = int(g.light_count)
    lod0 = pl == 0
    pam = am[pi]
    caps = {}
    for modes in ((0,), (1,), (2,)):
        caps[modes] = int(np.sum(lod0 & np.isin(pam, modes)))
    is_dir = (lt == 0) & (np.arange(lt.shape[0]) < nl)
    n = g.inst_prim.shape[0]
    inst_lod_pairs = np.zeros((n, int(pl.max()) + 1), np.int64)
    np.add.at(inst_lod_pairs, (pi, pl), 1)
    # scene bounds from the instance spheres and the bounding-sphere radius
    # about their centre (they size the CSM range and the DDGI volume)
    c = g.inst_center.cpu().numpy().reshape(-1, 3)
    r = g.inst_radius.cpu().numpy().reshape(-1)
    if c.size:
        lo, hi = (c - r[:, None]).min(0), (c + r[:, None]).max(0)
        mid = 0.5 * (lo + hi)
        radius = float((np.linalg.norm(c - mid, axis=1) + r).max())
    else:
        lo, hi, radius = np.full(3, -30.0), np.full(3, 30.0), 30.0
    return {"light_count": nl,
            "light_types": lt[:nl].tolist(),
            "lod0_pair_capacity": int(np.sum(lod0)),
            "bucket_pair_capacity": caps,
            "has_masked": bool((am == 1).any()),
            "has_transparent": bool((am == 2).any()),
            "sun_index": int(np.argmax(is_dir)),
            "has_sun": bool(is_dir.any()),
            "inst_lod_pairs": inst_lod_pairs,
            "inst_lod_count": g.prim_lod_count.cpu().numpy()[g.inst_prim.cpu().numpy()],
            "inst_casts_shadow": am < 2,
            "scene_bounds": (lo, hi),
            "scene_radius": radius}


def _to_tensor(v, device) -> torch.Tensor:
    a = np.asarray(v)
    if a.dtype.kind in "iu":
        return torch.as_tensor(a.astype(np.int64), device=device)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a.astype(np.float32), device=device)


def stream_tables_from_numpy(t, device):
    """A JAX StreamTables (its arrays as numpy or jax arrays, or a dict of
    them) -> the port's StreamTables on ``device``: int64 tensors, the
    packed uint32 texel words widened as the dense table's are."""
    from hobbyrenderer_tpu_torch.scene.streaming import StreamTables
    get = t.get if isinstance(t, dict) else (lambda k: getattr(t, k))
    return StreamTables(**{k: (int(get(k)) if k == "pool_base"
                               else torch.as_tensor(np.asarray(get(k)).astype(np.int64),
                                                    device=device))
                           for k in StreamTables._fields})


def scene_gpu_from_numpy(d: Dict[str, np.ndarray], device) -> SceneGPU:
    """The JAX SceneGPU's leaves as numpy (``{name: np.asarray(leaf)}``, the
    streaming tables as they are) -> the port's SceneGPU on ``device``."""
    missing = [k for k in FIELDS if k not in d]
    if missing:
        raise KeyError(f"missing SceneGPU leaves: {missing}")
    stream = d.get("tex_stream")
    return SceneGPU(**{k: _to_tensor(d[k], device) for k in FIELDS},
                    **{k: _to_tensor(d[k], device) for k in ENV_FIELDS
                       if d.get(k) is not None},
                    tex_stream=None if stream is None else stream_tables_from_numpy(stream,
                                                                                    device))


def _texture_arrays(scene: Scene) -> Dict[str, np.ndarray]:
    from hobbyrenderer_tpu_torch.scene.textures import build_texture_table
    t = build_texture_table(scene)
    return dict(tex_table=t["tex_table"], mat_tex_size=t["mat_tex_size"],
                mat_mip_off=t["mat_mip_off"])


def scene_arrays(scene: Scene, max_lights: int = 64, streamer=None) -> Dict[str, np.ndarray]:
    """Flatten the host Scene into numpy tables (same code as the JAX
    build_scene_gpu, minus environment maps). Under texture streaming
    (``streamer``, a scene/streaming.py TextureStreamer) there is no dense
    texel table: the material sizes come from the streamer's layout."""
    vtx_offsets = []
    pos_l, nrm_l, uv_l, tan_l = [], [], [], []
    off = 0
    for mesh in scene.meshes:
        vtx_offsets.append(off)
        pos_l.append(mesh.positions)
        nrm_l.append(mesh.normals_packed)
        uv_l.append(mesh.uvs_packed)
        tan_l.append(mesh.tangents_packed)
        off += mesh.num_vertices
    positions = np.concatenate(pos_l, 0) if pos_l else np.zeros((1, 3), np.float32)
    vnormals = np.concatenate(nrm_l, 0) if nrm_l else np.zeros(1, np.uint32)
    vuvs = np.concatenate(uv_l, 0) if uv_l else np.zeros(1, np.uint32)
    vtangents = np.concatenate(tan_l, 0) if tan_l else np.zeros(1, np.uint32)

    P = len(scene.meshes)
    prim_lod_count = np.zeros(P, np.int32)
    prim_lod_error = np.zeros((P, MAX_LODS), np.float32)
    prim_tri_offset = np.zeros((P, MAX_LODS), np.int32)
    prim_tri_count = np.zeros((P, MAX_LODS), np.int32)
    prim_ml_offset = np.zeros((P, MAX_LODS), np.int32)
    prim_ml_count = np.zeros((P, MAX_LODS), np.int32)
    prim_center = np.zeros((P, 3), np.float32)
    prim_radius = np.zeros(P, np.float32)

    tri_l, mlv_l, mlt_l = [], [], []
    mvo_l, mvc_l, mto_l, mtc_l, mc_l, mr_l, mca_l, mcc_l = [], [], [], [], [], [], [], []
    tri_off = mlv_off = mlt_off = ml_off = 0
    for p, mesh in enumerate(scene.meshes):
        vo = vtx_offsets[p]
        prim_center[p] = mesh.center
        prim_radius[p] = mesh.radius
        prim_lod_count[p] = len(mesh.lods)
        for li, lod in enumerate(mesh.lods):
            prim_lod_error[p, li] = lod.error
            prim_tri_offset[p, li] = tri_off
            prim_tri_count[p, li] = lod.indices.shape[0]
            tri_l.append(lod.indices.astype(np.int32) + vo)
            tri_off += lod.indices.shape[0]
            ms = lod.meshlets
            prim_ml_offset[p, li] = ml_off
            prim_ml_count[p, li] = ms.count
            mvo_l.append(ms.vert_offset + mlv_off)
            mvc_l.append(ms.vert_count)
            mto_l.append(ms.tri_offset + mlt_off)
            mtc_l.append(ms.tri_count)
            mc_l.append(ms.center)
            mr_l.append(ms.radius)
            mca_l.append(ms.cone_axis)
            mcc_l.append(ms.cone_cutoff)
            mlv_l.append(ms.vertices + vo)
            mlt_l.append(ms.tris)
            mlv_off += ms.vertices.shape[0]
            mlt_off += ms.tris.shape[0]
            ml_off += ms.count
        for li in range(len(mesh.lods), MAX_LODS):
            last = len(mesh.lods) - 1
            prim_lod_error[p, li] = np.inf
            prim_tri_offset[p, li] = prim_tri_offset[p, last]
            prim_tri_count[p, li] = prim_tri_count[p, last]
            prim_ml_offset[p, li] = prim_ml_offset[p, last]
            prim_ml_count[p, li] = prim_ml_count[p, last]

    def cat(lst, dtype, cols=None):
        if not lst:
            return np.zeros((1,) if cols is None else (1, cols), dtype)
        return np.concatenate(lst, 0).astype(dtype)

    tri_indices = cat(tri_l, np.int32, 3)
    ml_vertices = cat(mlv_l, np.int32)
    _mvo = cat(mvo_l, np.int32)
    _mvc = cat(mvc_l, np.int32)
    _mto = cat(mto_l, np.int32)
    _mtc = cat(mtc_l, np.int32)
    _mlt = cat(mlt_l, np.int32, 3)
    vlanes = np.arange(MESHLET_MAX_VERTS)[None, :]
    vmask = vlanes < _mvc[:, None]
    vidx = np.minimum(_mvo[:, None] + vlanes, max(ml_vertices.shape[0] - 1, 0))
    ml_gv = np.where(vmask, ml_vertices[vidx], 0).astype(np.int32)
    ml_pos = (positions[ml_gv] * vmask[..., None]).astype(np.float32)
    ml_attr = np.stack([vnormals[ml_gv], vuvs[ml_gv], vtangents[ml_gv]],
                       axis=-1).astype(np.uint32)
    tlanes = np.arange(MESHLET_MAX_TRIS)[None, :]
    tmask = tlanes < _mtc[:, None]
    tidx = np.minimum(_mto[:, None] + tlanes, max(_mlt.shape[0] - 1, 0))
    ml_ltris = np.where(tmask[..., None], _mlt[tidx], 0).astype(np.int32)

    N = max(len(scene.instances), 1)
    inst_transform = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    inst_normal = np.tile(np.eye(3, dtype=np.float32), (N, 1, 1))
    inst_prim = np.zeros(N, np.int32)
    inst_material = np.zeros(N, np.int32)
    inst_alpha = np.zeros(N, np.int32)
    inst_center = np.zeros((N, 3), np.float32)
    inst_radius = np.zeros(N, np.float32)
    inst_scale_max = np.ones(N, np.float32)
    for i, I in enumerate(scene.instances):
        w = scene.nodes[I.node].world
        inst_transform[i] = w
        inst_normal[i] = np.linalg.inv(w[:3, :3]).T
        inst_prim[i] = I.prim
        inst_material[i] = I.material
        inst_alpha[i] = I.alpha_mode
        mesh = scene.meshes[I.prim]
        inst_center[i] = hm.transform_points(w, mesh.center[None])[0]
        s = float(np.max(np.linalg.norm(w[:3, :3], axis=0)))
        inst_radius[i] = mesh.radius * s
        inst_scale_max[i] = s

    pi_l, pm_l, pl_l = [], [], []
    for i, I in enumerate(scene.instances):
        p = I.prim
        for li in range(int(prim_lod_count[p])):
            o, c = int(prim_ml_offset[p, li]), int(prim_ml_count[p, li])
            if c == 0:
                continue
            pm_l.append(np.arange(o, o + c, dtype=np.int32))
            pi_l.append(np.full(c, i, np.int32))
            pl_l.append(np.full(c, li, np.int32))
    pair_inst = cat(pi_l, np.int32)
    pair_meshlet = cat(pm_l, np.int32)
    pair_lod = cat(pl_l, np.int32) if pl_l else np.full((1,), -1, np.int32)

    if streamer is not None:
        tex_arrays = dict(tex_table=np.zeros((1, 4), np.uint32),
                          mat_tex_size=streamer.mat_size.copy(),
                          mat_mip_off=np.zeros((len(scene.materials) or 1,
                                                streamer.tail_off.shape[1]), np.int32))
    else:
        tex_arrays = _texture_arrays(scene)
    Mt = max(len(scene.materials), 1)
    mat_f = np.zeros((Mt, 20), np.float32)
    mat_i = np.full((Mt, 8), -1, np.int32)
    for mi, m in enumerate(scene.materials):
        mat_f[mi, MAT_BASE_COLOR:MAT_BASE_COLOR + 4] = m.base_color
        mat_f[mi, MAT_METALLIC] = m.metallic
        mat_f[mi, MAT_ROUGHNESS] = m.roughness
        mat_f[mi, MAT_EMISSIVE:MAT_EMISSIVE + 3] = np.asarray(m.emissive) * m.emissive_strength
        mat_f[mi, MAT_ALPHA_CUTOFF] = m.alpha_cutoff if m.alpha_mode == ALPHA_MASKED else 0.0
        mat_f[mi, MAT_TRANSMISSION] = m.transmission
        mat_f[mi, MAT_IOR] = m.ior
        mat_f[mi, MAT_ATTEN_COLOR:MAT_ATTEN_COLOR + 3] = m.attenuation_color
        mat_f[mi, MAT_UV_SCALE] = m.uv_scale
        mat_f[mi, MAT_ATTEN_DIST] = min(m.attenuation_distance, 1e6)
        mat_f[mi, MAT_TEX_SIZE] = tex_arrays["mat_tex_size"][mi]
        base = int(tex_arrays["mat_mip_off"][mi, 0])
        mat_f[mi, MAT_TEX_BASE_HI] = base // 4096
        mat_f[mi, MAT_TEX_BASE_LO] = base % 4096
        mat_i[mi, MATI_ALPHA_MODE] = m.alpha_mode
        mat_i[mi, MATI_DOUBLE_SIDED] = 1 if m.double_sided else 0
        mat_i[mi, MATI_BASE_TEX] = m.base_color_tex
        mat_i[mi, MATI_NORMAL_TEX] = m.normal_tex
        mat_i[mi, MATI_ORM_TEX] = m.orm_tex
        mat_i[mi, MATI_EMISSIVE_TEX] = m.emissive_tex

    L = max_lights
    lt = np.zeros(L, np.int32)
    lp = np.zeros((L, 3), np.float32)
    ld = np.tile(np.array([[0, -1, 0]], np.float32), (L, 1))
    lc = np.zeros((L, 3), np.float32)
    lr = np.zeros(L, np.float32)
    lrange = np.full(L, 1e9, np.float32)
    lcone = np.zeros((L, 2), np.float32)
    nl = min(len(scene.lights), L)
    for i in range(nl):
        light = scene.lights[i]
        lt[i] = light.type
        lp[i] = light.position
        ld[i] = np.asarray(hm.normalize(np.asarray(light.direction, np.float32)), np.float32)
        lc[i] = np.asarray(light.color, np.float32) * light.intensity
        lr[i] = light.radius
        lrange[i] = light.range
        lcone[i] = [np.cos(light.inner_cone), np.cos(light.outer_cone)]

    return dict(
        positions=positions, vnormals=vnormals, vuvs=vuvs, vtangents=vtangents,
        tri_indices=tri_indices, ml_vertices=ml_vertices, ml_tris=_mlt,
        ml_vert_offset=_mvo, ml_vert_count=_mvc,
        ml_tri_offset=_mto, ml_tri_count=_mtc,
        ml_center=cat(mc_l, np.float32, 3), ml_radius=cat(mr_l, np.float32),
        ml_cone_axis=cat(mca_l, np.float32, 3),
        ml_cone_cutoff=cat(mcc_l, np.float32),
        ml_pos=ml_pos, ml_attr=ml_attr, ml_gv=ml_gv, ml_ltris=ml_ltris,
        prim_lod_count=prim_lod_count, prim_lod_error=prim_lod_error,
        prim_tri_offset=prim_tri_offset, prim_tri_count=prim_tri_count,
        prim_center=prim_center, prim_radius=prim_radius,
        inst_transform=inst_transform, inst_prev_transform=inst_transform.copy(),
        inst_normal_mat=inst_normal, inst_prim=inst_prim,
        inst_material=inst_material, inst_alpha_mode=inst_alpha,
        inst_center=inst_center, inst_radius=inst_radius,
        inst_scale_max=inst_scale_max,
        pair_inst=pair_inst, pair_meshlet=pair_meshlet, pair_lod=pair_lod,
        mat_f=mat_f, mat_i=mat_i, **tex_arrays,
        light_type=lt, light_pos=lp, light_dir=ld, light_color=lc,
        light_radius=lr, light_range=lrange, light_cone=lcone,
        light_count=np.int32(nl))


def build_scene_gpu(scene: Scene, device, max_lights: int = 64, env_map=None, env_sh=None,
                    brdf_lut=None, streamer=None) -> SceneGPU:
    """Flatten the host Scene and upload it to ``device``. ``env_map``
    (He, We, 3) f32 also sets ``env_sh`` to its SH projection; an explicit
    ``env_sh`` (a prebaked --irradiance map's) overrides it; ``brdf_lut``
    (N, N, 2) replaces the analytic split-sum fit. With ``streamer`` (a
    scene/streaming.py TextureStreamer) the texels live in its paged pool
    (``tex_stream``), the tail resident at first."""
    env = {}
    if env_map is not None:
        from hobbyrenderer_tpu_torch.ops.envmap import project_sh9
        env["env_map"] = env_map
        env["env_sh"] = project_sh9(np.asarray(env_map, np.float32))
    if env_sh is not None:
        env["env_sh"] = env_sh
    if brdf_lut is not None:
        env["brdf_lut"] = brdf_lut
    return SceneGPU(**{k: _to_tensor(v, device)
                       for k, v in scene_arrays(scene, max_lights, streamer).items()},
                    **{k: _to_tensor(v, device) for k, v in env.items()},
                    tex_stream=None if streamer is None else streamer.initial_tables(device))


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A per-frame host array on ``device``: to a GPU through pinned memory
    without waiting (a pageable copy would wait for the device's queue).
    The pinned block outlives the returned tensor's source safely: PyTorch's
    pinned-memory allocator records the copy on the stream and hands the
    block out again only after the copy has finished."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def update_instance_transforms(gpu: SceneGPU, scene: Scene) -> SceneGPU:
    """Upload dirty instance transforms; prev = current every frame (see the
    JAX version for why). Returns a new SceneGPU sharing unchanged tensors."""
    prev = gpu.inst_transform
    if not scene.dirty_instances:
        if gpu.inst_prev_transform is gpu.inst_transform:
            return gpu
        return dataclasses.replace(gpu, inst_prev_transform=prev, meta=gpu.meta)
    idx = sorted(scene.dirty_instances)
    tr, nm, centers, radii, scale_max = [], [], [], [], []
    for i in idx:
        I = scene.instances[i]
        mesh = scene.meshes[I.prim]
        w = scene.nodes[I.node].world
        tr.append(w)
        nm.append(np.linalg.inv(w[:3, :3]).T)
        centers.append(hm.transform_points(w, mesh.center[None])[0])
        smax = float(np.max(np.linalg.norm(w[:3, :3], axis=0)))
        radii.append(mesh.radius * smax)
        scale_max.append(smax)
    dev = gpu.device
    ii = _upload(np.asarray(idx, np.int64), dev)

    def put(t, rows):
        t = t.clone()
        t[ii] = _upload(np.asarray(rows, np.float32), dev)
        return t

    gpu = dataclasses.replace(
        gpu, inst_prev_transform=prev,
        inst_transform=put(gpu.inst_transform, np.stack(tr)),
        inst_normal_mat=put(gpu.inst_normal_mat, np.stack(nm)),
        inst_center=put(gpu.inst_center, np.stack(centers)),
        inst_radius=put(gpu.inst_radius, radii),
        inst_scale_max=put(gpu.inst_scale_max, scale_max),
        meta=gpu.meta)
    scene.dirty_instances.clear()
    return gpu


def update_material_constants(gpu: SceneGPU, scene: Scene) -> SceneGPU:
    """Upload dirty material rows' emissive (emissive x strength, the field
    animations change). Returns a new SceneGPU sharing unchanged tensors."""
    if not scene.dirty_materials:
        return gpu
    idx = sorted(i for i in scene.dirty_materials if i < gpu.mat_f.shape[0])
    if not idx:
        scene.dirty_materials.clear()
        return gpu
    em = np.stack([np.asarray(scene.materials[i].emissive, np.float32)
                   * np.float32(scene.materials[i].emissive_strength) for i in idx])
    mat_f = gpu.mat_f.clone()
    mat_f[_upload(np.asarray(idx, np.int64), gpu.device),
          MAT_EMISSIVE:MAT_EMISSIVE + 3] = _upload(em, gpu.device)
    scene.dirty_materials.clear()
    return dataclasses.replace(gpu, mat_f=mat_f, meta=gpu.meta)
