"""Scene database: meshes, nodes, materials, lights, cameras, animations.

Reference: src/Scene.{h,cpp} — the CPU scene DB with TRS node hierarchy, material
constants as single source of truth (Scene.h:157-190), alpha-mode instance buckets
(opaque/masked/transparent, static-before-dynamic, Scene.cpp:275-333), animation
evaluation (Scene.cpp:409-570) and a default directional light
(Scene::EnsureDefaultDirectionalLight, Scene.cpp:635).

TPU design: plain numpy-backed dataclasses on host. ``finalize()`` computes world
transforms, instance buckets, and the scene bounding sphere; ``update(t)`` evaluates
animations and marks dirty instance ranges, which the renderer uploads as narrow
device updates (mirroring the reference's dirty-range tracking,
src/Renderer.cpp:915-1024).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from hobbyrenderer_tpu_torch.scene.cooker import CookedMesh
from hobbyrenderer_tpu_torch.utils import math as hm

# Alpha modes (instance bucket order: opaque, masked, transparent — ref Scene.cpp:275-333)
ALPHA_OPAQUE = 0
ALPHA_MASKED = 1
ALPHA_BLEND = 2

LIGHT_DIRECTIONAL = 0
LIGHT_POINT = 1
LIGHT_SPOT = 2


@dataclass
class Material:
    """Material constants (ref MaterialConstants embedded in Scene.h:157-190)."""

    name: str = "default"
    base_color: np.ndarray = field(default_factory=lambda: np.ones(4, np.float32))
    metallic: float = 0.0
    roughness: float = 0.8
    emissive: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    emissive_strength: float = 1.0
    alpha_mode: int = ALPHA_OPAQUE
    alpha_cutoff: float = 0.5
    transmission: float = 0.0
    ior: float = 1.5
    attenuation_color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    attenuation_distance: float = 1e9
    double_sided: bool = False
    # bindless texture indices into the scene texture array (-1 = none)
    base_color_tex: int = -1
    normal_tex: int = -1
    orm_tex: int = -1       # occlusion-roughness-metallic
    emissive_tex: int = -1
    uv_scale: float = 1.0


@dataclass
class Light:
    """Punctual/directional light (ref Scene.h:234-248)."""

    type: int = LIGHT_DIRECTIONAL
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    direction: np.ndarray = field(default_factory=lambda: np.array([0.3, -0.8, 0.5], np.float32))
    color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    intensity: float = 1.0
    radius: float = 0.0           # emitter radius (soft shadows / falloff clamp)
    range: float = 1e9
    inner_cone: float = 0.0
    outer_cone: float = np.pi / 4
    name: str = "light"


@dataclass
class CameraDesc:
    """Authored camera (ref Scene.h:220-232 with EV100 exposure params)."""

    name: str = "camera"
    position: np.ndarray = field(default_factory=lambda: np.array([0, 1, 5], np.float32))
    yaw: float = 0.0
    pitch: float = 0.0
    fov_y: float = np.deg2rad(60.0)
    znear: float = 0.1
    aperture_f: float = 16.0
    shutter_s: float = 1.0 / 100.0
    iso: float = 100.0


@dataclass
class AnimationChannel:
    """Sampler + target (ref animation channels incl. material emissive,
    src/SceneLoader.cpp animation ingest)."""

    target_node: int = -1
    target_material: int = -1          # for material channels (emissiveIntensity)
    path: str = "translation"          # translation | rotation | scale |
    #                                    emissiveIntensity (ref JSON animations)
    times: np.ndarray = None           # (K,)
    values: np.ndarray = None          # (K, D)
    interpolation: str = "LINEAR"


@dataclass
class Animation:
    name: str = "anim"
    channels: List[AnimationChannel] = field(default_factory=list)
    duration: float = 0.0


@dataclass
class Node:
    """TRS hierarchy node (ref Scene.h Nodes with dynamic flags)."""

    name: str = "node"
    parent: int = -1
    translation: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = field(default_factory=lambda: np.array([0, 0, 0, 1], np.float32))
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    mesh_primitives: List[int] = field(default_factory=list)   # indices into scene.meshes
    dynamic: bool = False
    world: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))


@dataclass
class Instance:
    """One drawable = (cooked primitive, material, node)."""

    prim: int
    material: int
    node: int
    alpha_mode: int = ALPHA_OPAQUE


class Scene:
    """CPU scene DB + finalize/update (ref src/Scene.{h,cpp})."""

    def __init__(self):
        self.meshes: List[CookedMesh] = []          # cooked primitives
        self.mesh_materials: List[int] = []         # parallel: material per primitive
        self.materials: List[Material] = [Material()]
        self.lights: List[Light] = []
        self.cameras: List[CameraDesc] = []
        self.nodes: List[Node] = []
        self.animations: List[Animation] = []
        self.instances: List[Instance] = []
        self.images: List = []                       # decoded (H, W, 4) u8 RGBA
        self.topo_order: List[int] = []
        self.center = np.zeros(3, np.float32)
        self.radius = 1.0
        self.dirty_instances: set = set()
        self.dirty_materials: set = set()
        self.lights_dirty = True
        self.env_map_path: str = ""       # EnvironmentLight (.scene.json)

    # -- construction helpers ------------------------------------------------

    def add_mesh(self, cooked: CookedMesh, material: int = 0) -> int:
        self.meshes.append(cooked)
        self.mesh_materials.append(material)
        return len(self.meshes) - 1

    def add_node(self, node: Node) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    def add_material(self, mat: Material) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_light(self, light: Light) -> int:
        self.lights.append(light)
        self.lights_dirty = True
        return len(self.lights) - 1

    # -- finalize (ref Scene::FinalizeLoadedScene, Scene.cpp:216-343) --------

    def ensure_default_directional_light(self):
        """Ref Scene::EnsureDefaultDirectionalLight (Scene.cpp:635)."""
        if not any(l.type == LIGHT_DIRECTIONAL for l in self.lights):
            self.add_light(Light(type=LIGHT_DIRECTIONAL,
                                 direction=np.asarray(hm.normalize(
                                     np.array([0.3, -0.8, 0.5], np.float32)), np.float32),
                                 intensity=10.0, name="default_sun"))

    def _topo_sort(self):
        order, state = [], [0] * len(self.nodes)
        children: Dict[int, List[int]] = {}
        roots = []
        for i, n in enumerate(self.nodes):
            if n.parent < 0:
                roots.append(i)
            else:
                children.setdefault(n.parent, []).append(i)
        stack = list(reversed(roots))
        while stack:
            i = stack.pop()
            order.append(i)
            for c in reversed(children.get(i, [])):
                stack.append(c)
        assert len(order) == len(self.nodes), "node hierarchy has a cycle or orphan"
        self.topo_order = order

    def compute_world_transforms(self):
        for i in self.topo_order:
            n = self.nodes[i]
            local = hm.compose_trs(n.translation, n.rotation, n.scale)
            n.world = (self.nodes[n.parent].world @ local) if n.parent >= 0 else local

    def finalize(self):
        """Topo sort, world transforms, alpha buckets (opaque→masked→transparent,
        static before dynamic), scene bounds, default light."""
        self._topo_sort()
        self.compute_world_transforms()
        self.ensure_default_directional_light()
        insts: List[Instance] = []
        for ni, n in enumerate(self.nodes):
            for pi in n.mesh_primitives:
                mat_id = self.mesh_materials[pi]
                mat = self.materials[mat_id]
                insts.append(Instance(prim=pi, material=mat_id, node=ni,
                                      alpha_mode=mat.alpha_mode))
        # bucket order: (alpha_mode, dynamic) — ref Scene.cpp:275-333
        insts.sort(key=lambda I: (I.alpha_mode, 1 if self.nodes[I.node].dynamic else 0))
        self.instances = insts
        # scene bounding sphere over instance world bounds
        if insts:
            centers, radii = [], []
            for I in insts:
                mesh = self.meshes[I.prim]
                w = self.nodes[I.node].world
                c = hm.transform_points(w, mesh.center[None])[0]
                s = float(np.max(np.linalg.norm(w[:3, :3], axis=0)))
                centers.append(c)
                radii.append(mesh.radius * s)
            centers = np.stack(centers)
            radii = np.asarray(radii)
            lo = (centers - radii[:, None]).min(0)
            hi = (centers + radii[:, None]).max(0)
            self.center = (0.5 * (lo + hi)).astype(np.float32)
            self.radius = float(np.linalg.norm(hi - lo) * 0.5)
        self.dirty_instances = set(range(len(self.instances)))
        self.dirty_materials = set(range(len(self.materials)))
        self.lights_dirty = True

    # -- per-frame update (ref Scene::Update, Scene.cpp:409-570) -------------

    def update(self, time_s: float):
        """Evaluate animations, refresh world transforms of dynamic subtrees, and
        mark touched instances dirty."""
        touched_nodes = set()
        for anim in self.animations:
            if anim.duration <= 0:
                continue
            t = np.float32(time_s % anim.duration)
            for ch in anim.channels:
                if ch.times is None or len(ch.times) == 0:
                    continue
                if ch.path == "emissiveIntensity":
                    if ch.target_material >= 0:
                        v = _sample_channel(ch, t)
                        self.materials[ch.target_material].emissive_strength = \
                            float(np.ravel(v)[0])
                        self.dirty_materials.add(ch.target_material)
                    continue
                if ch.target_node < 0:
                    continue
                v = _sample_channel(ch, t)
                node = self.nodes[ch.target_node]
                if ch.path == "translation":
                    node.translation = v
                elif ch.path == "rotation":
                    node.rotation = np.asarray(hm.normalize(v), np.float32)
                elif ch.path == "scale":
                    node.scale = v
                touched_nodes.add(ch.target_node)
        if touched_nodes:
            self.compute_world_transforms()
            for idx, I in enumerate(self.instances):
                # dirty if its node or any ancestor was touched
                ni = I.node
                while ni >= 0:
                    if ni in touched_nodes:
                        self.dirty_instances.add(idx)
                        break
                    ni = self.nodes[ni].parent


def _sample_channel(ch: AnimationChannel, t: np.float32) -> np.ndarray:
    times, vals = ch.times, ch.values
    i = int(np.searchsorted(times, t, side="right")) - 1
    if len(times) == 1 or ch.interpolation == "STEP":
        # STEP holds the LAST keyframe past the channel's end (the linear
        # clamp to len-2 below would return the second-to-last value)
        return np.asarray(vals[max(0, min(i, len(times) - 1))], np.float32)
    i = max(0, min(i, len(times) - 2))
    t0, t1 = times[i], times[i + 1]
    a = 0.0 if t1 <= t0 else float(np.clip((t - t0) / (t1 - t0), 0.0, 1.0))
    v0, v1 = np.asarray(vals[i], np.float32), np.asarray(vals[i + 1], np.float32)
    if ch.path == "rotation":
        # slerp with shortest-path sign flip
        d = float(np.dot(v0, v1))
        if d < 0:
            v1, d = -v1, -d
        if d > 0.9995:
            return np.asarray(hm.normalize(v0 + a * (v1 - v0)), np.float32)
        th = np.arccos(np.clip(d, -1, 1))
        return np.asarray((np.sin((1 - a) * th) * v0 + np.sin(a * th) * v1) / np.sin(th),
                          np.float32)
    return v0 + a * (v1 - v0)
