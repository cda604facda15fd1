"""Cooked-mesh binary cache.

Reference: src/SceneCache.{h,cpp} — cooked meshes saved as "<stem>_mesh.bin"
("RLFY" magic, version 1, SceneCache.h:7-33), validated against the source file's
mtime, loaded instead of re-cooking (LoadOrCookMeshData, SceneCache.cpp:148-218).

TPU build: same load-or-cook-and-save contract. Payload is a compressed npz of the
flat cooked arrays plus a small header (magic "HRCK", version, source mtime + a
content key hash). The cook (LOD simplify + meshlet build) is the CPU-bound hot
path (SURVEY.md §3.2), so cache hits matter for load time.
"""

from __future__ import annotations

import hashlib
import io
import os
import struct
from typing import List, Optional

import numpy as np

from hobbyrenderer_tpu_torch.scene.cooker import CookedLOD, CookedMesh, MeshletSet, cook_mesh

MAGIC = b"HRCK"
VERSION = 3


def _cache_path(cache_key: str, cache_dir: str) -> str:
    h = hashlib.sha1(cache_key.encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(cache_key))[0]
    return os.path.join(cache_dir, f"{stem}_{h}_mesh.bin")


def _flatten(meshes: List[CookedMesh]) -> dict:
    out = {"n_meshes": np.int64(len(meshes))}
    for i, m in enumerate(meshes):
        p = f"m{i}_"
        out[p + "positions"] = m.positions
        out[p + "normals"] = m.normals_packed
        out[p + "uvs"] = m.uvs_packed
        out[p + "tangents"] = m.tangents_packed
        out[p + "center"] = m.center
        out[p + "radius"] = np.float32(m.radius)
        out[p + "n_lods"] = np.int64(len(m.lods))
        for li, lod in enumerate(m.lods):
            q = f"{p}l{li}_"
            ms = lod.meshlets
            out[q + "indices"] = lod.indices
            out[q + "error"] = np.float32(lod.error)
            for field in ("vert_offset", "vert_count", "tri_offset", "tri_count",
                          "vertices", "tris", "center", "radius", "cone_axis",
                          "cone_cutoff"):
                out[q + field] = getattr(ms, field)
    return out


def _unflatten(data) -> List[CookedMesh]:
    meshes = []
    for i in range(int(data["n_meshes"])):
        p = f"m{i}_"
        m = CookedMesh(positions=data[p + "positions"],
                       normals_packed=data[p + "normals"],
                       uvs_packed=data[p + "uvs"],
                       tangents_packed=data[p + "tangents"],
                       center=data[p + "center"],
                       radius=float(data[p + "radius"]))
        for li in range(int(data[p + "n_lods"])):
            q = f"{p}l{li}_"
            ms = MeshletSet(*(data[q + f] for f in
                              ("vert_offset", "vert_count", "tri_offset", "tri_count",
                               "vertices", "tris", "center", "radius", "cone_axis",
                               "cone_cutoff")))
            m.lods.append(CookedLOD(indices=data[q + "indices"], meshlets=ms,
                                    error=float(data[q + "error"])))
        meshes.append(m)
    return meshes


def save_cooked_meshes(meshes: List[CookedMesh], cache_key: str, cache_dir: str,
                       source_mtime: float):
    os.makedirs(cache_dir, exist_ok=True)
    path = _cache_path(cache_key, cache_dir)
    payload = io.BytesIO()
    np.savez_compressed(payload, **_flatten(meshes))
    blob = payload.getvalue()
    with open(path, "wb") as f:
        f.write(MAGIC + struct.pack("<Id", VERSION, source_mtime))
        f.write(blob)


def load_cooked_meshes(cache_key: str, cache_dir: str,
                       source_mtime: float) -> Optional[List[CookedMesh]]:
    path = _cache_path(cache_key, cache_dir)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            head = f.read(4 + 4 + 8)
            if head[:4] != MAGIC:
                return None
            version, mtime = struct.unpack("<Id", head[4:])
            if version != VERSION or abs(mtime - source_mtime) > 1e-6:
                return None  # stale (ref: mtime validation)
            data = np.load(io.BytesIO(f.read()), allow_pickle=False)
            return _unflatten(data)
    except Exception:
        return None


def load_or_cook_meshes(prim_specs: List[dict], cache_key: Optional[str],
                        cache_dir: Optional[str]) -> List[CookedMesh]:
    """Ref SceneCache::LoadOrCookMeshData (SceneCache.cpp:148-218)."""
    if cache_key and cache_dir and os.path.exists(cache_key):
        mtime = os.path.getmtime(cache_key)
        cached = load_cooked_meshes(cache_key, cache_dir, mtime)
        if cached is not None and len(cached) == len(prim_specs):
            return cached
    # parallel per-primitive cook (ref ParallelFor, src/SceneLoader.cpp:1784);
    # the heavy stages (numpy vector math, the C++ QEM simplifier + meshlet
    # scan via ctypes) release the GIL, so threads scale on real scenes
    def _cook(s):
        return cook_mesh(s["positions"], s["indices"], normals=s.get("normals"),
                         uvs=s.get("uvs"), tangents=s.get("tangents"))

    if len(prim_specs) > 1:
        import concurrent.futures as _cf
        workers = min(len(prim_specs), os.cpu_count() or 4, 12)
        with _cf.ThreadPoolExecutor(max_workers=workers) as ex:
            cooked = list(ex.map(_cook, prim_specs))
    else:
        cooked = [_cook(s) for s in prim_specs]
    if cache_key and cache_dir and os.path.exists(cache_key):
        save_cooked_meshes(cooked, cache_key, cache_dir,
                           os.path.getmtime(cache_key))
    return cooked
