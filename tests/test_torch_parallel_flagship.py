"""The port's FlagshipShardedRenderer (ReSTIR DI with winner visibility,
ReSTIR GI, traced specular, TAA, banded bloom) on 2 CPU ranks against the
JAX package's FlagshipShardedRenderer: stress:2 at 96x64 (bands of one
32-row tile row), 3 frames, so both half-rate GI parities run. The port's
straggler capacity and step cap are lifted, as tests/test_torch_flagship.py
lifts them (the JAX CPU frame traces winner visibility exactly). The
port's ranks render beside the JAX compile.

The JAX renderer runs on a 2-device mesh (tests/conftest.py gives 8 CPU
devices), so that both sides run their halos (zeros past the frame's top
and bottom), bands and banded bloom.

Gate: the flagship's, >= 97% of LDR pixels within 2/255 and mean |delta|
<= 1.5, each frame; the two ranks' frames equal."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from hobbyrenderer_tpu.config import Config as JaxConfig
from hobbyrenderer_tpu.models.pathtracer import build_scene_rt
from hobbyrenderer_tpu.parallel import FlagshipShardedRenderer, build_mesh
from hobbyrenderer_tpu.renderer import Renderer as JaxRenderer
from hobbyrenderer_tpu_torch.bench_parallel import render_body
from hobbyrenderer_tpu_torch.parallel.launch import run_ranks
from tests.torch_parity import same_mesh_cooker

W, H, FRAMES = 96, 64, 3
LDR_TOL = (0.97, 1.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _same_mesh_cooker():
    same_mesh_cooker()


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    job = dict(kind="flagship", scene="stress:2", width=W, height=H, frames=FRAMES,
               keep_ldr=tuple(range(FRAMES)), straggler_steps=None)
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(run_ranks, render_body, 2, args=(job,), deadline_s=300)
        cfg = JaxConfig(scene="stress:2", width=W, height=H, direct_mode="restir",
                        indirect_mode="restir",
                        cache_dir=str(tmp_path_factory.mktemp("jax_sharded")))
        jr = JaxRenderer(cfg)
        fr = FlagshipShardedRenderer(jr.gpu, W, H, rt=build_scene_rt(jr.scene, jr.gpu),
                                     mesh=build_mesh(2))
        # the initial state placed as the frames return it, so that the
        # frame compiles once
        fr.state = jax.tree_util.tree_map(
            lambda spec, x: jax.device_put(x, NamedSharding(fr.mesh, spec)),
            fr._state_specs(), fr.state, is_leaf=lambda x: isinstance(x, P))
        settings = cfg.settings.as_pytree()
        ldr_j = [np.asarray(fr.render(jr.gpu, jr.camera.view_constants(i), settings)[0])
                 for i in range(FRAMES)]
        jr.shutdown()
        ranks = port.result()
    return ldr_j, ranks


def test_ranks_return_the_same_frames(frames):
    _, ranks = frames
    for a, b in zip(ranks[0]["ldr_frames"], ranks[1]["ldr_frames"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("frame", range(FRAMES), ids=[f"frame{i + 1}" for i in range(FRAMES)])
def test_sharded_flagship_matches_jax(frames, frame):
    ldr_j, ranks = frames
    lj, lt = ldr_j[frame], ranks[0]["ldr_frames"][frame]
    assert lt.shape == lj.shape == (H, W, 3) and lt.dtype == np.uint8
    diff = np.abs(lj.astype(np.int32) - lt.astype(np.int32))
    within, mean_max = LDR_TOL
    assert np.mean(diff.max(-1) <= 2) >= within, np.mean(diff.max(-1) <= 2)
    assert diff.mean() <= mean_max, diff.mean()
