"""The flagship frame (ReSTIR DI + ReSTIR GI + traced specular) of the
PyTorch port on an animated stress:2 lit by an HDR environment turned into
16 directional lights, against the JAX Renderer on the CPU: 96x64, 3
frames of 0.25 s, both packages rendering the same scene (animations from
tests/torch_parity.py::animated_stress_scenes: nodes 2 and 4 rise and
turn) and the same map (a 64x128 sky with a bright lobe, written to a
temporary directory). Every frame refits the RT scene on both sides.

Gate: test_torch_flagship.py's (test_torch_frame.py's stress bounds),
>= 97% of LDR pixels within 2/255 and mean |delta| <= 1.5, with the
port's capped K3 walks run uncapped, as RTXDI's straggler caps are lifted
(measured: 99.28%, 99.30%, 99.10%, mean |delta| 0.06-0.14). Under the
port's budgets (max(24, steps // 4): 64 steps for the GI NEE rays) frame 3
agrees on 92.72% only: the refitted tree's moved subtrees overlap the
others, more NEE walks spend their budget, and a capped walk reports no
occluder, so the brightest environment light leaks through (ROADMAP
Queue 3, "K3's budgets on capped calls"). With neither package refitting,
frame 3 agrees on 98.68%."""

import numpy as np
import pytest
import torch

from hobbyrenderer_tpu_torch.ops import envmap as tenv
from hobbyrenderer_tpu_torch.scene.workload import sky_envmap
from tests.torch_parity import (animated_stress_scenes, frames_beside_jax, ldr_agreement,
                                same_mesh_cooker)

W, H = 96, 64
FRAMES = 3
ENV_LIGHTS = 16
LDR_TOL = (0.97, 1.5)     # test_torch_flagship.py's (test_torch_frame.py's stress bounds)
PASSES = ["Culling", "Raster", "HZBBuild", "RasterPhase2", "ResolveGBuffer", "MaskedLayer",
          "IBL", "RTXDI", "RTXDIGI", "Denoise", "SpecularIndirect", "DeferredLighting", "Sky",
          "TAA", "AutoExposure", "Bloom", "Tonemap"]
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


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    if not _CACHE:
        root = tmp_path_factory.mktemp("torch_env_anim")
        path = str(root / "sky.hdr")
        with open(path, "wb") as f:
            f.write(tenv.encode_hdr(sky_envmap(64, 128, seed=1)))
        kw = dict(scene="stress:2", width=W, height=H, direct_mode="restir",
                  indirect_mode="restir", envmap=path, env_lights=ENV_LIGHTS,
                  cache_dir=str(root / "hc"))
        scenes = animated_stress_scenes(2, every=2)
        _CACHE.update(zip(("jr", "tr", "ldr_j", "ldr_t", "stats"),
                          frames_beside_jax(kw, FRAMES, scenes=scenes, dt=0.25,
                                            lift_walk_budgets=True)))
        _CACHE["scenes"] = scenes
    return _CACHE


@pytest.mark.parametrize("frame", range(FRAMES), ids=[f"frame{i + 1}" for i in range(FRAMES)])
def test_env_anim_flagship_frame_matches_jax(frames, frame):
    within, mean, _ = ldr_agreement(frames["ldr_j"][frame], frames["ldr_t"][frame])
    assert within >= LDR_TOL[0], within
    assert mean <= LDR_TOL[1], mean


def test_env_anim_scene_state(frames):
    """The JAX graph's passes; the env lights in the pool (the scene's 9
    lights and 16 directional ones, the ambient zeroed); the animated
    instances moved, and the refitted tables moved with them."""
    tr, jr = frames["tr"], frames["jr"]
    assert [p.name for p in tr.graph.passes if p.enabled] == \
        [p.name for p in jr._model.graph.passes if p.enabled] == PASSES
    jscene, tscene = frames["scenes"]
    n = len(tscene.lights)
    assert n == len(jscene.lights) and 9 < n <= 9 + ENV_LIGHTS
    assert [tuple(x.direction) for x in tscene.lights] == \
        [tuple(x.direction) for x in jscene.lights]
    assert tr.gpu.meta["light_count"] == n
    assert tr._model.rt.lights.n_analytic == max(64, n + 8)
    np.testing.assert_array_equal(tr.gpu.inst_transform.numpy(), np.asarray(jr.gpu.inst_transform))
    # the refitted trees' root boxes: as tests/test_torch_refit.py bounds them
    for got, want in ((tr._model.rt.bvh.root_box, jr._model.rt.bvh.root_box),
                      (tr._model.rt.bvh16.root_box, jr._model.rt.bvh16.root_box)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2.0 ** -20,
                                   atol=2.0 ** -20)
    assert frames["stats"][-1]["pool_cdf_host_syncs"] == 1    # the first frame's refresh
