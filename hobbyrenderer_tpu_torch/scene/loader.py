"""glTF 2.0 scene ingest.

Reference: src/SceneLoader.{h,cpp} (2804 LoC) — glTF via cgltf: meshes (attributes,
indices), materials + KHR extensions (emissive_strength, transmission, ior, volume,
lights_punctual), cameras, nodes/hierarchy, animations; plus the in-memory entry
point LoadGLTFSceneFromMemory (src/SceneLoader.h:39-43) used by test harnesses.

TPU build: pure Python/numpy parser (no cgltf): handles .gltf (JSON + external bin
or data URIs) and .glb containers. Geometry goes through the same cooker
(scene/cooker.py) with the cooked-mesh cache (scene/cache.py). Unlike the
reference we do NOT convert RH->LH — the whole framework is right-handed.

Texture images are registered (indices recorded on materials) but pixel upload is
handled by the texture/streaming layer when present.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Optional, Union

import numpy as np

from hobbyrenderer_tpu_torch.scene.cache import load_or_cook_meshes
from hobbyrenderer_tpu_torch.scene.cooker import cook_mesh
from hobbyrenderer_tpu_torch.utils import math as hm
from hobbyrenderer_tpu_torch.scene.scene import (ALPHA_BLEND, ALPHA_MASKED, ALPHA_OPAQUE,
                                           Animation, AnimationChannel, CameraDesc,
                                           Light, LIGHT_DIRECTIONAL, LIGHT_POINT,
                                           LIGHT_SPOT, Material, Node, Scene)

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}


class GLTFFile:
    """Parsed glTF container: JSON + binary buffers."""

    def __init__(self, doc: dict, buffers: List[bytes], base_dir: str = "."):
        self.doc = doc
        self.buffers = buffers
        self.base_dir = base_dir

    @staticmethod
    def from_path(path: str) -> "GLTFFile":
        base = os.path.dirname(os.path.abspath(path))
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] == b"glTF":
            return GLTFFile._parse_glb(data, base)
        doc = json.loads(data.decode("utf-8"))
        return GLTFFile(doc, GLTFFile._load_buffers(doc, base, None), base)

    @staticmethod
    def from_memory(data: Union[dict, bytes, str]) -> "GLTFFile":
        """In-memory glTF (ref LoadGLTFSceneFromMemory): JSON dict/str/bytes with
        embedded data URIs, or a GLB byte blob."""
        if isinstance(data, bytes) and data[:4] == b"glTF":
            return GLTFFile._parse_glb(data, ".")
        if isinstance(data, (bytes, str)):
            doc = json.loads(data if isinstance(data, str) else data.decode("utf-8"))
        else:
            doc = data
        return GLTFFile(doc, GLTFFile._load_buffers(doc, ".", None), ".")

    @staticmethod
    def _parse_glb(data: bytes, base: str) -> "GLTFFile":
        magic, version, length = struct.unpack_from("<III", data, 0)
        assert version == 2, f"unsupported GLB version {version}"
        off = 12
        doc = None
        bin_chunk = None
        while off < length:
            clen, ctype = struct.unpack_from("<II", data, off)
            payload = data[off + 8:off + 8 + clen]
            if ctype == 0x4E4F534A:      # 'JSON'
                doc = json.loads(payload.decode("utf-8"))
            elif ctype == 0x004E4942:    # 'BIN'
                bin_chunk = payload
            off += 8 + clen
        assert doc is not None, "GLB missing JSON chunk"
        return GLTFFile(doc, GLTFFile._load_buffers(doc, base, bin_chunk), base)

    @staticmethod
    def _load_buffers(doc: dict, base: str, glb_bin: Optional[bytes]) -> List[bytes]:
        out = []
        for i, b in enumerate(doc.get("buffers", [])):
            uri = b.get("uri")
            if uri is None:
                assert glb_bin is not None, "buffer without uri outside GLB"
                out.append(glb_bin)
            elif uri.startswith("data:"):
                out.append(base64.b64decode(uri.split(",", 1)[1]))
            else:
                with open(os.path.join(base, uri), "rb") as f:
                    out.append(f.read())
        return out

    def accessor(self, idx: int) -> np.ndarray:
        """Decode accessor -> (count, comps) array (sparse not supported)."""
        acc = self.doc["accessors"][idx]
        n = acc["count"]
        comps = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize * comps
        if "bufferView" not in acc:
            return np.zeros((n, comps), dtype)
        bv = self.doc["bufferViews"][acc["bufferView"]]
        buf = self.buffers[bv.get("buffer", 0)]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride", itemsize)
        if stride == itemsize:
            arr = np.frombuffer(buf, dtype, count=n * comps, offset=start)
            out = arr.reshape(n, comps)
        else:
            raw = np.frombuffer(buf, np.uint8)
            idxs = start + stride * np.arange(n)[:, None] + np.arange(itemsize)[None, :]
            out = raw[idxs].copy().view(dtype).reshape(n, comps)
        if acc.get("normalized") and dtype != np.float32:
            info = np.iinfo(dtype)
            out = out.astype(np.float32) / float(info.max)
        return np.asarray(out)


def _mat_from_gltf(m: dict, name: str) -> Material:
    pbr = m.get("pbrMetallicRoughness", {})
    mat = Material(name=name)
    mat.base_color = np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)
    mat.metallic = float(pbr.get("metallicFactor", 1.0))
    mat.roughness = float(pbr.get("roughnessFactor", 1.0))
    mat.emissive = np.asarray(m.get("emissiveFactor", [0, 0, 0]), np.float32)
    mat.double_sided = bool(m.get("doubleSided", False))
    am = m.get("alphaMode", "OPAQUE")
    mat.alpha_mode = {"OPAQUE": ALPHA_OPAQUE, "MASK": ALPHA_MASKED,
                      "BLEND": ALPHA_BLEND}.get(am, ALPHA_OPAQUE)
    mat.alpha_cutoff = float(m.get("alphaCutoff", 0.5))
    ext = m.get("extensions", {})
    if "KHR_materials_emissive_strength" in ext:
        mat.emissive_strength = float(
            ext["KHR_materials_emissive_strength"].get("emissiveStrength", 1.0))
    if "KHR_materials_transmission" in ext:
        mat.transmission = float(
            ext["KHR_materials_transmission"].get("transmissionFactor", 0.0))
    if "KHR_materials_ior" in ext:
        mat.ior = float(ext["KHR_materials_ior"].get("ior", 1.5))
    if "KHR_materials_volume" in ext:
        v = ext["KHR_materials_volume"]
        mat.attenuation_color = np.asarray(v.get("attenuationColor", [1, 1, 1]), np.float32)
        mat.attenuation_distance = float(v.get("attenuationDistance", 1e9))
    # texture indices (resolved by the texture layer)
    def tex_index(entry):
        return -1 if entry is None else int(entry.get("index", -1))
    mat.base_color_tex = tex_index(pbr.get("baseColorTexture"))
    mat.orm_tex = tex_index(pbr.get("metallicRoughnessTexture"))
    mat.normal_tex = tex_index(m.get("normalTexture"))
    mat.emissive_tex = tex_index(m.get("emissiveTexture"))
    return mat


def _decompose_matrix(m: np.ndarray):
    t = m[:3, 3].copy()
    sx = np.linalg.norm(m[:3, 0])
    sy = np.linalg.norm(m[:3, 1])
    sz = np.linalg.norm(m[:3, 2])
    if np.linalg.det(m[:3, :3]) < 0:
        sx = -sx
    r = m[:3, :3] / np.asarray([sx, sy, sz])[None, :]
    # rotation matrix -> quaternion (x, y, z, w)
    tr = np.trace(r)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.asarray([(r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                        (r[1, 0] - r[0, 1]) / s, 0.25 * s])
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + r[i, i] - r[j, j] - r[k, k], 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[j] = (r[j, i] + r[i, j]) / s
        q[k] = (r[k, i] + r[i, k]) / s
        q[3] = (r[k, j] - r[j, k]) / s
    return (t.astype(np.float32), q.astype(np.float32),
            np.asarray([sx, sy, sz], np.float32))


def _decode_images(g: GLTFFile) -> list:
    """Decode glTF images (URI file / data URI / bufferView) to u8 RGBA.

    Ref: SceneLoader::LoadTexturesFromImages (src/SceneLoader.cpp:1311-1523) +
    TextureLoader.cpp — here PNG/JPEG via PIL, DDS via scene/textures.py."""
    from hobbyrenderer_tpu_torch.scene.textures import decode_image_bytes
    doc = g.doc
    out = []
    for img in doc.get("images", []):
        try:
            uri = img.get("uri")
            if uri is not None:
                if uri.startswith("data:"):
                    data = base64.b64decode(uri.split(",", 1)[1])
                else:
                    from urllib.parse import unquote
                    with open(os.path.join(g.base_dir, unquote(uri)), "rb") as f:
                        data = f.read()
            else:
                bv = doc["bufferViews"][img["bufferView"]]
                buf = g.buffers[bv.get("buffer", 0)]
                o = bv.get("byteOffset", 0)
                data = bytes(buf[o:o + bv["byteLength"]])
            out.append(decode_image_bytes(data))
        except Exception:
            out.append(None)   # undecodable image -> untextured fallback
    return out


def _build_scene(g: GLTFFile, cache_key: Optional[str], cache_dir: Optional[str]) -> Scene:
    doc = g.doc
    sc = Scene()

    # images + texture -> image mapping (samplers: REPEAT assumed)
    sc.images = _decode_images(g)
    tex_to_img = [t.get("source", -1) for t in doc.get("textures", [])]

    def resolve_tex(ti):
        if ti is None or ti < 0 or ti >= len(tex_to_img):
            return -1
        return tex_to_img[ti]

    # materials (index 0 in Scene is the default; glTF ids shift by +1)
    for i, m in enumerate(doc.get("materials", [])):
        mat = _mat_from_gltf(m, m.get("name", f"material_{i}"))
        mat.base_color_tex = resolve_tex(mat.base_color_tex)
        mat.orm_tex = resolve_tex(mat.orm_tex)
        mat.normal_tex = resolve_tex(mat.normal_tex)
        mat.emissive_tex = resolve_tex(mat.emissive_tex)
        sc.add_material(mat)

    def scene_mat(idx):
        return 0 if idx is None else idx + 1

    # meshes: cook every primitive (cache-aware)
    prim_specs = []            # raw geometry for cooking
    mesh_prim_ids: List[List[int]] = []   # glTF mesh -> list of scene prim ids
    prim_mats: List[int] = []
    for mesh in doc.get("meshes", []):
        ids = []
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:
                continue  # only triangles
            attrs = prim["attributes"]
            pos = g.accessor(attrs["POSITION"]).astype(np.float32)
            if "indices" in prim:
                idx = g.accessor(prim["indices"]).astype(np.int64).reshape(-1)
            else:
                idx = np.arange(pos.shape[0], dtype=np.int64)
            nrm = g.accessor(attrs["NORMAL"]).astype(np.float32) if "NORMAL" in attrs else None
            uv = g.accessor(attrs["TEXCOORD_0"]).astype(np.float32) if "TEXCOORD_0" in attrs else None
            tan = g.accessor(attrs["TANGENT"]).astype(np.float32) if "TANGENT" in attrs else None
            prim_specs.append(dict(positions=pos, indices=idx, normals=nrm,
                                   uvs=uv, tangents=tan))
            ids.append(len(prim_specs) - 1)
            prim_mats.append(scene_mat(prim.get("material")))
        mesh_prim_ids.append(ids)

    cooked = load_or_cook_meshes(prim_specs, cache_key=cache_key, cache_dir=cache_dir)
    spec_to_scene = []
    for ci, cm in enumerate(cooked):
        spec_to_scene.append(sc.add_mesh(cm, material=prim_mats[ci]))

    # lights (KHR_lights_punctual)
    light_defs = (doc.get("extensions", {})
                  .get("KHR_lights_punctual", {}).get("lights", []))

    # nodes
    gltf_nodes = doc.get("nodes", [])
    for i, n in enumerate(gltf_nodes):
        node = Node(name=n.get("name", f"node_{i}"))
        if "matrix" in n:
            m = np.asarray(n["matrix"], np.float32).reshape(4, 4).T  # column-major
            node.translation, node.rotation, node.scale = _decompose_matrix(m)
        else:
            node.translation = np.asarray(n.get("translation", [0, 0, 0]), np.float32)
            node.rotation = np.asarray(n.get("rotation", [0, 0, 0, 1]), np.float32)
            node.scale = np.asarray(n.get("scale", [1, 1, 1]), np.float32)
        if "mesh" in n:
            node.mesh_primitives = [spec_to_scene[p] for p in mesh_prim_ids[n["mesh"]]]
        sc.add_node(node)
    # parents
    for i, n in enumerate(gltf_nodes):
        for c in n.get("children", []):
            sc.nodes[c].parent = i

    # second pass: cameras + lights attached to nodes (need world transforms)
    sc._topo_sort()
    sc.compute_world_transforms()
    for i, n in enumerate(gltf_nodes):
        world = sc.nodes[i].world
        if "camera" in n:
            cam = doc["cameras"][n["camera"]]
            if cam.get("type") == "perspective":
                p = cam.get("perspective", {})
                fwd = -world[:3, 2]
                desc = CameraDesc(name=cam.get("name", "camera"),
                                  position=world[:3, 3].astype(np.float32),
                                  fov_y=float(p.get("yfov", 1.0)),
                                  znear=float(p.get("znear", 0.1)))
                desc.pitch = float(np.arctan2(fwd[1], np.linalg.norm(fwd[[0, 2]])))
                desc.yaw = float(np.arctan2(-fwd[0], -fwd[2]))
                sc.cameras.append(desc)
        lext = n.get("extensions", {}).get("KHR_lights_punctual")
        if lext is not None:
            ld = light_defs[lext["light"]]
            ltype = {"directional": LIGHT_DIRECTIONAL, "point": LIGHT_POINT,
                     "spot": LIGHT_SPOT}.get(ld.get("type"), LIGHT_POINT)
            spot = ld.get("spot", {})
            sc.add_light(Light(
                type=ltype,
                position=world[:3, 3].astype(np.float32),
                direction=(-world[:3, 2]).astype(np.float32),  # -Z convention
                color=np.asarray(ld.get("color", [1, 1, 1]), np.float32),
                intensity=float(ld.get("intensity", 1.0)),
                range=float(ld.get("range", 1e9)),
                inner_cone=float(spot.get("innerConeAngle", 0.0)),
                outer_cone=float(spot.get("outerConeAngle", np.pi / 4)),
                name=ld.get("name", "light")))

    # animations
    for a in doc.get("animations", []):
        anim = Animation(name=a.get("name", "anim"))
        dur = 0.0
        for ch in a.get("channels", []):
            target = ch.get("target", {})
            if target.get("node") is None:
                continue
            samp = a["samplers"][ch["sampler"]]
            times = g.accessor(samp["input"]).reshape(-1).astype(np.float32)
            values = g.accessor(samp["output"]).astype(np.float32)
            anim.channels.append(AnimationChannel(
                target_node=int(target["node"]),
                path=target.get("path", "translation"),
                times=times, values=values,
                interpolation=samp.get("interpolation", "LINEAR")))
            if len(times):
                dur = max(dur, float(times[-1]))
            if target.get("node") is not None:
                sc.nodes[target["node"]].dynamic = True
        anim.duration = dur
        sc.animations.append(anim)

    sc.finalize()
    return sc


def load_gltf_scene(path: str, cache_dir: Optional[str] = ".hr_cache") -> Scene:
    """File entry point (ref SceneLoader::LoadGLTFScene). Dispatches
    `.scene.json` composite scenes to load_scene_json."""
    if path.endswith(".scene.json") or path.endswith(".json"):
        return load_scene_json(path, cache_dir=cache_dir)
    g = GLTFFile.from_path(path)
    key = os.path.abspath(path)
    return _build_scene(g, cache_key=key, cache_dir=cache_dir)


def _merge_scene(dst: Scene, src: Scene, parent_node: int):
    """Append one loaded glTF model under dst node `parent_node` (the model
    re-parenting of LoadJSONScene, ref src/SceneLoader.cpp:355-372).

    Returns (light_ids, camera_ids) of the appended lights/cameras — their
    world-space data was baked in the model's own frame and must be re-derived
    after dst.finalize() via _reframe_world (the reference instead re-reads
    node transforms every frame)."""
    img_off = len(dst.images)
    dst.images.extend(src.images)
    mat_map = {0: 0}
    for i, m in enumerate(src.materials):
        if i == 0:
            continue
        import copy as _copy
        m2 = _copy.deepcopy(m)
        for f in ("base_color_tex", "normal_tex", "orm_tex", "emissive_tex"):
            ti = getattr(m2, f)
            if ti is not None and ti >= 0:
                setattr(m2, f, ti + img_off)
        mat_map[i] = dst.add_material(m2)
    mesh_map = [dst.add_mesh(cm, material=mat_map[src.mesh_materials[ci]])
                for ci, cm in enumerate(src.meshes)]
    node_off = len(dst.nodes)
    for n in src.nodes:
        n2 = Node(name=n.name,
                  parent=(n.parent + node_off if n.parent >= 0 else parent_node),
                  translation=np.asarray(n.translation, np.float32).copy(),
                  rotation=np.asarray(n.rotation, np.float32).copy(),
                  scale=np.asarray(n.scale, np.float32).copy(),
                  mesh_primitives=[mesh_map[p] for p in n.mesh_primitives],
                  dynamic=n.dynamic)
        dst.add_node(n2)
    light_ids = []
    for l in src.lights:
        if l.name == "default_sun":
            continue  # per-model defaults don't compose; dst adds its own
        import copy as _copy
        light_ids.append((dst.add_light(_copy.deepcopy(l)), parent_node))
    cam_ids = []
    for c in src.cameras:
        import copy as _copy
        dst.cameras.append(_copy.deepcopy(c))
        cam_ids.append((len(dst.cameras) - 1, parent_node))
    for a in src.animations:
        a2 = Animation(name=a.name, duration=a.duration)
        for ch in a.channels:
            a2.channels.append(AnimationChannel(
                target_node=ch.target_node + node_off,
                path=ch.path, times=ch.times, values=ch.values,
                interpolation=ch.interpolation))
            if ch.target_node >= 0:
                dst.nodes[ch.target_node + node_off].dynamic = True
        dst.animations.append(a2)
    return light_ids, cam_ids


def _dir_to_quat(d: np.ndarray) -> np.ndarray:
    """Quaternion rotating -Z onto direction d (graph 'direction' keys)."""
    d = np.asarray(hm.normalize(np.asarray(d, np.float32)), np.float32)
    fwd = np.array([0, 0, -1], np.float32)
    c = float(np.dot(fwd, d))
    if c > 1 - 1e-8:
        return np.array([0, 0, 0, 1], np.float32)
    if c < -1 + 1e-8:
        return np.array([0, 1, 0, 0], np.float32)  # 180 deg about Y
    ax = np.cross(fwd, d)
    s = np.sqrt((1 + c) * 2)
    return np.asarray(hm.normalize(np.array(
        [ax[0] / s, ax[1] / s, ax[2] / s, s * 0.5], np.float32)), np.float32)


def load_scene_json(path: str, cache_dir: Optional[str] = ".hr_cache") -> Scene:
    """Composite `.scene.json` scene: multiple glTF models + a transform graph
    + graph-level lights/cameras + JSON animations.

    Ref SceneLoader::LoadJSONScene (src/SceneLoader.cpp:184-560): `models` is
    an array of relative glTF paths; `graph` nodes carry TRS (or scalar
    `scaling`), optional `model` index (re-parents that model's roots),
    `children`, and typed payloads (DirectionalLight irradiance/angularSize,
    SpotLight intensity/cone angles, PerspectiveCamera fov/near/exposure,
    EnvironmentLight path); `animations` hold name-targeted keyframe channels
    (translation | rotation | emissiveIntensity), ref ParseJSONAnimations
    (src/SceneLoader.cpp:709-960). No RH->LH flips: this build keeps glTF
    handedness end to end."""
    import json as _json

    with open(path, "r") as f:
        doc = _json.load(f)
    base = os.path.dirname(os.path.abspath(path))
    sc = Scene()
    model_paths = doc.get("models", [])
    model_scenes = [load_gltf_scene(os.path.join(base, p), cache_dir=cache_dir)
                    for p in model_paths]
    attached = [False] * len(model_scenes)
    fix_lights, fix_cams = [], []

    def parse_graph_node(nd: dict, parent: int):
        node = Node(name=nd.get("name", f"graph_{len(sc.nodes)}"), parent=parent)
        if "translation" in nd:
            node.translation = np.asarray(nd["translation"], np.float32)
        if "rotation" in nd:
            r = nd["rotation"]
            node.rotation = (np.array([0, 0, 0, 1], np.float32)
                             if np.isscalar(r) else np.asarray(r, np.float32))
        if "direction" in nd:
            node.rotation = _dir_to_quat(np.asarray(nd["direction"], np.float32))
        if "scale" in nd:
            node.scale = np.asarray(nd["scale"], np.float32)
        if "scaling" in nd:
            node.scale = np.full(3, float(nd["scaling"]), np.float32)
        ni = sc.add_node(node)
        typ = nd.get("type")
        if typ == "DirectionalLight":
            li = sc.add_light(Light(
                type=LIGHT_DIRECTIONAL,
                color=np.asarray(nd.get("color", [1, 1, 1]), np.float32),
                intensity=float(nd.get("irradiance", 1.0)),
                radius=float(nd.get("angularSize", 0.0)),
                name=node.name))
            fix_lights.append((li, ni))
        elif typ == "SpotLight":
            li = sc.add_light(Light(
                type=LIGHT_SPOT,
                color=np.asarray(nd.get("color", [1, 1, 1]), np.float32),
                intensity=float(nd.get("intensity", 1.0)),
                radius=float(nd.get("radius", 0.0)),
                range=float(nd.get("range", 1e9)),
                inner_cone=np.deg2rad(float(nd.get("innerAngle", 0.0))),
                outer_cone=np.deg2rad(float(nd.get("outerAngle", 45.0))),
                name=node.name))
            fix_lights.append((li, ni))
        elif typ in ("PerspectiveCamera", "PerspectiveCameraEx"):
            fov = float(nd.get("verticalFov", 1.0))
            if fov > 3.15:           # degrees-authored scene files
                fov = np.deg2rad(fov)
            cam = CameraDesc(name=node.name, fov_y=fov,
                             znear=float(nd.get("zNear", 0.1)))
            sc.cameras.append(cam)
            fix_cams.append((len(sc.cameras) - 1, ni))
        elif typ == "EnvironmentLight":
            sc.env_map_path = os.path.join(base, nd.get("path", ""))
        mi = nd.get("model")
        if mi is not None and 0 <= int(mi) < len(model_scenes):
            # every graph reference attaches (a model may be instanced under
            # several transforms; the previous first-reference-only guard
            # silently dropped repeats). Each attach re-merges the model's
            # meshes — duplicated geometry, but correct rendering.
            fl, fc = _merge_scene(sc, model_scenes[int(mi)], ni)
            fix_lights.extend(fl)
            fix_cams.extend(fc)
            attached[int(mi)] = True
        for ch in nd.get("children", []):
            parse_graph_node(ch, ni)

    for root in doc.get("graph", []):
        parse_graph_node(root, -1)
    # models never referenced by the graph attach at the root (a bare
    # {"models": [...]} file is a valid scene)
    for mi, ms in enumerate(model_scenes):
        if not attached[mi]:
            ni = sc.add_node(Node(name=f"model_{mi}"))
            fl, fc = _merge_scene(sc, ms, ni)
            fix_lights.extend(fl)
            fix_cams.extend(fc)
            attached[mi] = True

    # JSON animations: channels target node NAMES (ref ParseJSONAnimations)
    name_to_node = {}
    for i, n in enumerate(sc.nodes):
        name_to_node.setdefault(n.name, i)
    name_to_mat = {}
    for i, m in enumerate(sc.materials):
        name_to_mat.setdefault(m.name, i)
    for a in doc.get("animations", []):
        anim = Animation(name=a.get("name", "anim"))
        dur = 0.0
        for ch in a.get("channels", []):
            targets = ch.get("targets", [ch.get("target")])
            attr = ch.get("attribute", "")
            mode = {"step": "STEP"}.get(ch.get("mode", "linear"), "LINEAR")
            data = ch.get("data", [])
            if not data or not targets or targets[0] is None:
                continue
            if "Cameras" in str(targets[0]):
                continue  # benchmark fly-throughs; the renderer owns its camera
            times = np.asarray([k.get("time", 0.0) for k in data], np.float32)
            vals = [k.get("value", 0.0) for k in data]
            if np.isscalar(vals[0]):
                values = np.asarray(vals, np.float32)[:, None]
            else:
                values = np.asarray(vals, np.float32)
            for tgt in targets:
                if attr == "emissiveIntensity":
                    mi_t = name_to_mat.get(tgt, -1)
                    if mi_t < 0:
                        continue
                    anim.channels.append(AnimationChannel(
                        target_node=-1, target_material=mi_t,
                        path="emissiveIntensity", times=times, values=values,
                        interpolation=mode))
                else:
                    ni_t = name_to_node.get(tgt, -1)
                    if ni_t < 0 or attr not in ("translation", "rotation",
                                                "scale"):
                        continue
                    anim.channels.append(AnimationChannel(
                        target_node=ni_t, path=attr, times=times,
                        values=values, interpolation=mode))
                    sc.nodes[ni_t].dynamic = True
            if len(times):
                dur = max(dur, float(times[-1]))
        anim.duration = dur
        if anim.channels:
            sc.animations.append(anim)

    sc.finalize()
    # re-derive merged/graph light + camera frames from final node worlds
    for li, ni in fix_lights:
        w = sc.nodes[ni].world
        l = sc.lights[li]
        l.position = hm.transform_points(w, l.position[None])[0].astype(np.float32)
        l.direction = np.asarray(hm.normalize(
            w[:3, :3] @ np.asarray(l.direction, np.float32)), np.float32)
    for ci, ni in fix_cams:
        w = sc.nodes[ni].world
        cam = sc.cameras[ci]
        cam.position = hm.transform_points(w, cam.position[None])[0].astype(np.float32)
        fwd = np.asarray(hm.normalize(w[:3, :3] @ np.array([0, 0, -1], np.float32)),
                         np.float32)
        cam.pitch = float(np.arctan2(fwd[1], np.linalg.norm(fwd[[0, 2]])))
        cam.yaw = float(np.arctan2(-fwd[0], -fwd[2]))
    sc.lights_dirty = True
    return sc


def load_gltf_from_memory(data: Union[dict, bytes, str]) -> Scene:
    """In-memory entry point (ref LoadGLTFSceneFromMemory,
    src/SceneLoader.cpp:2572) — the test-harness path; never cached."""
    g = GLTFFile.from_memory(data)
    return _build_scene(g, cache_key=None, cache_dir=None)
