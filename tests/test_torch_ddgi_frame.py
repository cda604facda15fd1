"""NormalBasic with DDGI in the PyTorch port against the JAX Renderer on
the CPU (stress:2, 96x64, two frames, both of which trace the probes). The
probe update and query at op level are in tests/test_torch_ddgi.py; the
frame bounds are test_torch_frame.py's for stress scenes."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.config import Config as JaxConfig
from hobbyrenderer_tpu.renderer import Renderer as JaxRenderer
from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.renderer import Renderer as TorchRenderer
from tests.torch_parity import same_mesh_cooker

W, H = 96, 64
FRAMES = 2
LDR_TOL = (0.97, 1.5)     # test_torch_frame.py's stress bounds
DDGI_PASSES = ["Culling", "Raster", "HZBBuild", "RasterPhase2", "ResolveGBuffer",
               "MaskedLayer", "ShadowCSM", "IBL", "DDGI", "DeferredLighting", "Sky",
               "TAA", "AutoExposure", "Bloom", "Tonemap"]


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
    """The port's Renderer and its LDR frames (run beside the JAX compile)."""
    torch.set_num_threads(1)      # a thread's own setting: not inherited
    tr = TorchRenderer(Config(**kw), device="cpu")
    ldr = [tr.render_frame().numpy() for _ in range(FRAMES)]
    tr.shutdown()
    return tr, ldr


def test_ddgi_frame_matches_jax(tmp_path):
    """The two Renderers are independent: the port renders its frames on a
    second thread while XLA compiles the JAX frame (most of this test's
    time), so the file stays short."""
    kw = dict(scene="stress:2", width=W, height=H, mode="normal_basic", indirect_mode="ddgi",
              cache_dir=str(tmp_path))
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_frames, kw)
        jr = JaxRenderer(JaxConfig(**kw))
        ldr_j = [np.asarray(jr.render_frame()) for _ in range(FRAMES)]
        jr.shutdown()
        tr, ldr_t = port.result()
    for lj, lt in zip(ldr_j, ldr_t):
        assert lt.shape == lj.shape and lt.dtype == np.uint8
        diff = np.abs(lj.astype(np.int32) - lt.astype(np.int32))
        within, mean_max = LDR_TOL
        assert np.mean(diff.max(-1) <= 2) >= within, np.mean(diff.max(-1) <= 2)
        assert diff.mean() <= mean_max, diff.mean()
    enabled = [p.name for p in tr.graph.passes if p.enabled]
    assert enabled == [p.name for p in jr._model.graph.passes if p.enabled] == DDGI_PASSES
    # both frames traced (the volume still changes), and the NEE rays ran
    stats = tr.stats()
    assert stats["ddgi_traced_frames"] == FRAMES
    assert stats["rt_k3_lanes_ddgi"] > 0
