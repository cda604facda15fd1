"""The port's path-tracer frame (Renderer(mode="path_tracer")) on the CPU:
- against the JAX Renderer, 3 accumulated frames at stress:2 96x64, jitter
  off, dt = 0 (one JAX Renderer compile; the port renders its frames on a
  second thread meanwhile). Gate: >= 99% of LDR pixels within 2/255
  (measured 100.00% on every frame, max |delta| 1);
- the port's own versions of tests/test_render.py's furnace
  (test_furnace_white_sphere) and analytic direct-lighting
  (test_pt_direct_lighting_analytic) tests, with their bounds;
- determinism: two runs bit-identical, another accumulation index not;
- a camera move that resets the accumulation.
trace_paths itself is held against JAX in tests/test_torch_pathtracer.py."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.config import Config as JaxConfig
from hobbyrenderer_tpu.renderer import Renderer as JaxRenderer
from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.models import pathtracer as tpt
from hobbyrenderer_tpu_torch.models.scene_rt import build_scene_rt
from hobbyrenderer_tpu_torch.renderer import Renderer, device_view_constants
from hobbyrenderer_tpu_torch.scene.camera import Camera
from hobbyrenderer_tpu_torch.scene.cooker import cook_mesh
from hobbyrenderer_tpu_torch.scene.gpu import build_scene_gpu
from hobbyrenderer_tpu_torch.scene.procedural import (camera_looking_at, plane_geometry,
                                                      sphere_geometry)
from hobbyrenderer_tpu_torch.scene.scene import LIGHT_DIRECTIONAL, Light, Material, Node, Scene
from tests.torch_parity import same_mesh_cooker

W, H = 96, 64
FRAMES = 3
LDR_WITHIN = 0.99
_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers on one machine: one torch thread
    each keeps the plain versions' many small ops from oversubscribing the
    cores (each op's thread team otherwise waits on descheduled threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _same_mesh_cooker():
    same_mesh_cooker()


def _port_frames(kw):
    torch.set_num_threads(1)      # a thread's own setting: not inherited
    r = Renderer(Config(**kw), device="cpu")
    r.camera.jitter_enabled = False
    ldr = [r.render_frame(dt=0.0).numpy() for _ in range(FRAMES)]
    stats = r.stats()
    r.shutdown()
    return ldr, stats


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    if _CACHE:
        return _CACHE
    kw = dict(scene="stress:2", width=W, height=H, mode="path_tracer",
              cache_dir=str(tmp_path_factory.mktemp("torch_pt_frame")))
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_frames, kw)
        jr = JaxRenderer(JaxConfig(**kw))
        jr.camera.jitter_enabled = False
        ldr_j = [np.asarray(jr.render_frame(dt=0.0)) for _ in range(FRAMES)]
        jr.shutdown()
        ldr_t, stats = port.result()
    _CACHE.update(ldr_j=ldr_j, ldr_t=ldr_t, stats=stats)
    return _CACHE


@pytest.mark.parametrize("frame", range(FRAMES), ids=[f"frame{i + 1}" for i in range(FRAMES)])
def test_pt_frame_matches_jax(frames, frame):
    lj, lt = frames["ldr_j"][frame], frames["ldr_t"][frame]
    assert lt.shape == lj.shape == (H, W, 3) and lt.dtype == np.uint8
    diff = np.abs(lj.astype(np.int32) - lt.astype(np.int32)).max(-1)
    assert np.mean(diff <= 2) >= LDR_WITHIN, np.mean(diff <= 2)


def test_pt_frame_stats(frames):
    s = frames["stats"]
    assert s["pt_dropped_lanes"] == 0
    assert s["rt_k3_lanes_pt"] >= W * H and s["rt_k3_lanes_pt_nee"] > 0
    assert s["rt_k3_capped_pt"] == 0 and s["rt_k3_capped_pt_nee"] == 0


def _furnace_scene(albedo=1.0):
    sc = Scene()
    white = sc.add_material(Material(name="white",
                                     base_color=np.array([albedo] * 3 + [1], np.float32),
                                     metallic=0.0, roughness=1.0))
    pos, nrm, uv, idx = sphere_geometry(0.5, 12, 16)
    prim = sc.add_mesh(cook_mesh(pos, idx, normals=nrm, uvs=uv), material=white)
    sc.add_node(Node(name="s", mesh_primitives=[prim]))
    sc.cameras.append(camera_looking_at(np.array([0, 0, 2.2], np.float32), np.zeros(3)))
    # a zero-intensity sun so NEE samples contribute nothing
    sc.add_light(Light(type=LIGHT_DIRECTIONAL, intensity=0.0))
    sc.finalize()
    return sc


def _setup(sc, w, h):
    gpu = build_scene_gpu(sc, "cpu")
    rt = build_scene_rt(sc, "cpu", gpu=gpu)
    cam = Camera(sc.cameras[0], w, h)
    cam.jitter_enabled = False
    return gpu, rt, device_view_constants(cam.view_constants(0), "cpu")


def test_furnace_white_sphere():
    """Convex albedo-1 Lambertian sphere under a constant sky is invisible
    (energy conservation of the walk, attributes, cosine sampling and RR)."""
    gpu, rt, vc = _setup(_furnace_scene(1.0), 48, 32)
    settings = Config().settings
    Lsky = 0.5

    def sky_fn(d, bounce):
        return torch.full((d.shape[0], 3), Lsky)

    n_s = 6
    img = sum(tpt.trace_paths(gpu, rt, vc, settings, 32, 48, i, max_bounces=12, rr_start=3,
                              sky_fn=sky_fn).reshape(32, 48, 3).numpy()
              for i in range(n_s)) / n_s
    err = np.abs(img - Lsky) / Lsky
    assert err.mean() < 0.05, f"furnace mean err {err.mean():.3f}"
    assert np.median(err) < 0.04


def test_pt_direct_lighting_analytic():
    """White plane, straight-down sun, black sky: pixel = albedo/pi x
    intensity (GGX at roughness 1 adds a little specular: 18% allowed)."""
    sc = Scene()
    a = 0.6
    m = sc.add_material(Material(name="w", base_color=np.array([a, a, a, 1], np.float32),
                                 metallic=0.0, roughness=1.0))
    pos, nrm, uv, idx = plane_geometry(50.0)
    prim = sc.add_mesh(cook_mesh(pos, idx, normals=nrm, uvs=uv), material=m)
    sc.add_node(Node(name="p", mesh_primitives=[prim]))
    I = 3.0
    sc.add_light(Light(type=LIGHT_DIRECTIONAL, direction=np.array([0, -1, 0], np.float32),
                       intensity=I))
    sc.cameras.append(camera_looking_at(np.array([0, 3, 0.1], np.float32), np.zeros(3)))
    sc.finalize()
    gpu, rt, vc = _setup(sc, 32, 24)
    settings = Config().settings
    settings.sun_angular_radius = 1e-4       # near-delta sun

    def sky_fn(d, bounce):
        return torch.zeros((d.shape[0], 3))

    img = tpt.trace_paths(gpu, rt, vc, settings, 24, 32, 0, max_bounces=2,
                          sky_fn=sky_fn).reshape(24, 32, 3).numpy()
    expected = a / np.pi * I
    center = img[12, 16]
    assert abs(center.mean() - expected) / expected < 0.18, (center, expected)


def test_pt_deterministic():
    """Same accumulation index -> bit-identical samples (the golden-image
    property); another index -> another sample."""
    gpu, rt, vc = _setup(_furnace_scene(0.5), 24, 16)
    settings = Config().settings
    a, b, c = (tpt.trace_paths(gpu, rt, vc, settings, 16, 24, i, max_bounces=3)
               for i in (3, 3, 4))
    assert torch.equal(a, b)
    assert not torch.equal(a, c), "another accumulation index gave the same sample"


def _renderer(tmp_path):
    r = Renderer(Config(scene="cube", width=32, height=24, mode="path_tracer",
                        cache_dir=str(tmp_path)), device="cpu")
    r.camera.jitter_enabled = False
    return r


def test_pt_renderer_deterministic(tmp_path):
    """Two Renderers, two accumulated frames each: bit-identical."""
    runs = []
    for k in range(2):
        r = _renderer(tmp_path / f"r{k}")
        runs.append([r.render_frame(dt=0.0).numpy() for _ in range(2)] + [r._model.accum])
        r.shutdown()
    for x, y in zip(*runs):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_camera_move_resets_accumulation(tmp_path):
    """After a camera move the accumulation restarts: the next frame equals
    a fresh Renderer's first frame from the new viewpoint."""
    r = _renderer(tmp_path / "moved")
    for _ in range(2):
        r.render_frame(dt=0.0)
    assert r._model.num_accum == 2
    new_pos = r.camera.position + np.asarray([0.3, 0.0, 0.0], np.float32)
    r.camera.position = new_pos
    moved = r.render_frame(dt=0.0).numpy()
    assert r._model.num_accum == 1
    r.shutdown()
    fresh = _renderer(tmp_path / "fresh")
    fresh.camera.position = new_pos
    first = fresh.render_frame(dt=0.0).numpy()
    fresh.shutdown()
    assert np.array_equal(moved, first)
