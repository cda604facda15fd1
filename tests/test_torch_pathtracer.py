"""The port's path tracer (hobbyrenderer_tpu_torch/models/pathtracer.py::
trace_paths) against the JAX package's on the CPU, on the JAX SceneGPU and
SceneRT carried across (scene_gpu_from_numpy / scene_rt_from_numpy), at one
accumulation index:
- the cube at 64x32, 5 bounces, on the scan path;
- the same with COMPACT_MIN_LANES = 1024 and COMPACT_MIN_CAP = 256 set on
  both sides (as tests/test_pt_compact.py does), on the compacted path;
- stress:2 at 96x64, 8 bounces (textured, masked, emissive and glass
  materials);
- the cube at 32x32, spp = 2, 4 bounces, on the compacted path (the port
  keeps one accumulator row per (sample, pixel) lane and sums the samples
  in order);
and the port's spp = 2 frame against the mean of its two spp = 1 frames.

The JAX CPU route walks the 4-wide BVH and the port the 16-wide one, so hit
triangles agree and t differs by ulps; a ulp can flip a Russian-roulette or
lobe decision, so the gate is a share: >= 99% of pixels within 1e-3
relative (max channel difference over max(max channel, 1e-3)) and a
relative L1 distance <= 1e-3. Measured: 100% of pixels, relative L1
2.1e-6 (cube, both paths), 1.4e-6 (cube, spp = 2) and 3.4e-6 (stress:2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.config import RenderSettings as JaxRenderSettings
from hobbyrenderer_tpu.models import pathtracer as jpt
from hobbyrenderer_tpu.scene import Camera as JaxCamera
from hobbyrenderer_tpu.scene import make_default_cube_scene, make_stress_scene
from hobbyrenderer_tpu.scene.gpu import build_scene_gpu as jax_build_scene_gpu
from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.models import pathtracer as tpt
from hobbyrenderer_tpu_torch.models import scene_rt as tsrt
from hobbyrenderer_tpu_torch.renderer import device_view_constants
from hobbyrenderer_tpu_torch.scene.gpu import scene_gpu_from_numpy
from tests.torch_parity import same_mesh_cooker

SHARE_TOL, REL_L1_TOL = 0.99, 1e-3
ACCUM = 3


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


def carry_scene(scene):
    """The JAX SceneGPU / SceneRT of ``scene`` and the port's copies of them
    on the CPU (the same tables: pool, emissive index and 16-wide BVH)."""
    jg = jax_build_scene_gpu(scene, max_lights=max(64, len(scene.lights) + 8))
    jrt = jpt.build_scene_rt(scene, jg)
    tg = scene_gpu_from_numpy({k: np.asarray(getattr(jg, k)) for k in jg.__dataclass_fields__
                               if getattr(jg, k) is not None}, "cpu")
    d = {k: np.asarray(getattr(jrt, k)) for k in tsrt.RT_FIELDS + tsrt.TABLE_FIELDS}
    d["bvh16"] = {k: np.asarray(getattr(jrt.bvh16, k))
                  for k in ("table", "order", "root_box", "recs", "slot_of")}
    d["lights"] = {k: np.asarray(getattr(jrt.lights, k))
                   for k in ("n_analytic", "n_total") + tsrt.POOL_FIELDS}
    d["em_index"] = np.asarray(jrt.em_index)
    return jg, jrt, tg, tsrt.scene_rt_from_numpy(d, "cpu")


def _view(scene, W, H):
    cam = JaxCamera(scene.cameras[0] if scene.cameras else None, W, H)
    if not scene.cameras:
        cam.position = scene.center + np.asarray([0.6, 0.45, 1.1], np.float32) * scene.radius * 1.6
        cam.look_at(scene.center)
    cam.jitter_enabled = False
    return cam.view_constants(0)


def _both(scene, W, H, bounces, spp=1):
    jg, jrt, tg, trt = carry_scene(scene)
    vc = _view(scene, W, H)
    # the scene and view go in as arguments, not as constants of the program
    # (XLA folds constants: a slower compile)
    want, dropped_j = jax.jit(lambda g, rt, v, acc: jpt.trace_paths(
        g, rt, v, JaxRenderSettings().as_pytree(), H, W, acc,
        max_bounces=bounces, spp=spp, with_stats=True))(jg, jrt, vc, jnp.int32(ACCUM))
    got, stats = tpt.trace_paths(tg, trt, device_view_constants(vc, "cpu"), Config().settings,
                                 H, W, ACCUM, max_bounces=bounces, spp=spp, with_stats=True)
    return np.asarray(want), int(dropped_j), got.numpy(), stats


def _gate(want, got):
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.abs(got - want).max(-1) / np.maximum(np.abs(want).max(-1), 1e-3)
    share = float(np.mean(rel <= 1e-3))
    l1 = float(np.abs(got - want).sum() / np.abs(want).sum())
    assert share >= SHARE_TOL, share
    assert l1 <= REL_L1_TOL, l1


@pytest.mark.parametrize("compact,spp", [(False, 1), (True, 1), (True, 2)],
                         ids=["scan", "compacted", "compacted-spp2"])
def test_trace_paths_cube_matches_jax(monkeypatch, compact, spp):
    """spp = 2 runs at 32x32 with 4 bounces (one compacted bounce): the
    samples' lanes of one pixel meet in the accumulator, where the
    reference scatter-adds per pixel."""
    W, H, bounces = (64, 32, 5) if spp == 1 else (32, 32, 4)
    if compact:
        for mod in (jpt, tpt):
            monkeypatch.setattr(mod, "COMPACT_MIN_LANES", 1024)
            monkeypatch.setattr(mod, "COMPACT_MIN_CAP", 256)
    assert (W * H >= tpt.COMPACT_MIN_LANES) == compact
    want, dropped_j, got, stats = _both(make_default_cube_scene(), W, H, bounces, spp=spp)
    _gate(want, got)
    assert int(stats["pt_dropped_lanes"]) == dropped_j == 0
    assert int(stats["rt_k3_lanes_pt"]) > W * H * spp and int(stats["rt_k3_capped_pt"]) == 0


def test_trace_paths_stress_matches_jax():
    """stress:2 (textures, alpha-masked and emissive materials, glass)."""
    want, _, got, stats = _both(make_stress_scene(grid=2), 96, 64, 8)
    _gate(want, got)
    assert int(stats["rt_k3_lanes_pt_nee"]) > 0 and int(stats["rt_k3_capped_pt_nee"]) == 0


def test_spp2_is_the_mean_of_two_frames():
    """Sample s of accumulation frame a draws the stream of frame a*spp + s,
    so one spp=2 frame at a equals the mean of the spp=1 frames 2a, 2a+1
    (every lane's arithmetic is the same: exact)."""
    scene = make_default_cube_scene()
    W, H = 48, 32
    _, _, tg, trt = carry_scene(scene)
    vc = device_view_constants(_view(scene, W, H), "cpu")
    settings = Config().settings
    one = [tpt.trace_paths(tg, trt, vc, settings, H, W, i, max_bounces=4) for i in (2, 3)]
    two = tpt.trace_paths(tg, trt, vc, settings, H, W, 1, max_bounces=4, spp=2)
    torch.testing.assert_close(two, (one[0] + one[1]) / 2, rtol=0, atol=0)
