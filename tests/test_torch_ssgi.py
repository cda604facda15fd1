"""NormalBasic with SSGI in the PyTorch port against the JAX package on the
CPU: the half-res march on the same G-buffer and previous HDR, and the
frame against the JAX Renderer (stress:2, 96x64, two frames: SSGI reads
the previous frame's TAA history, so the second frame carries bounce
light). The frame bounds are test_torch_frame.py's for stress scenes."""

import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.config import Config as JaxConfig
from hobbyrenderer_tpu.ops import ssgi as jssgi
from hobbyrenderer_tpu.ops.raster import GBuffer as JGBuffer
from hobbyrenderer_tpu.renderer import Renderer as JaxRenderer
from hobbyrenderer_tpu_torch.config import Config, RenderSettings
from hobbyrenderer_tpu_torch.ops import raster as traster
from hobbyrenderer_tpu_torch.ops import ssgi as tssgi
from hobbyrenderer_tpu_torch.renderer import Renderer as TorchRenderer
from tests.torch_parity import same_mesh_cooker

W, H = 96, 64
FRAMES = 2
LDR_TOL = (0.97, 1.5)     # test_torch_frame.py's stress bounds
PASSES = ["Culling", "Raster", "HZBBuild", "RasterPhase2", "ResolveGBuffer", "MaskedLayer",
          "ShadowCSM", "IBL", "SSGI", "DeferredLighting", "Sky", "TAA", "AutoExposure",
          "Bloom", "Tonemap"]


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


_CACHE = {}


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Both Renderers and their LDR frames; the port keeps its G-buffer."""
    if _CACHE:
        return _CACHE
    kw = dict(scene="stress:2", width=W, height=H, mode="normal_basic", indirect_mode="ssgi",
              cache_dir=str(tmp_path_factory.mktemp("torch_ssgi")))
    jr = JaxRenderer(JaxConfig(**kw))
    tr = TorchRenderer(Config(**kw), device="cpu")
    tr._model.keep = ("gbuffer",)
    ldr = [(np.asarray(jr.render_frame()), tr.render_frame().numpy()) for _ in range(FRAMES)]
    jr.shutdown()
    tr.shutdown()
    _CACHE.update(jr=jr, tr=tr, ldr=ldr)
    return _CACHE


def test_ssgi_half_res_matches_jax(frames):
    """One march from the port's G-buffer and a random previous HDR: within
    1e-5 on >= 99.5% of the pixels (a ray point on a depth-test boundary
    could hit in one package only; measured: all pixels, max |d| 4.8e-7)."""
    tr = frames["tr"]
    gb = {k: v.numpy() for k, v in tr._model.last_resources["gbuffer"]._asdict().items()}
    prev = np.random.default_rng(11).uniform(0, 3, (H, W, 3)).astype(np.float32)
    vc = tr.camera.view_constants(3)
    tvc = {k: (torch.as_tensor(v) if np.ndim(v) else v) for k, v in vc.items()}
    want = np.asarray(jssgi.ssgi_half_res(JGBuffer(**gb), vc, prev, np.zeros((9, 3), np.float32),
                                          RenderSettings(), 3))
    got = tssgi.ssgi_half_res(traster.GBuffer(**{k: torch.as_tensor(v) for k, v in gb.items()}),
                              tvc, torch.as_tensor(prev), 3).numpy()
    assert np.mean(want.max(-1) > 0) > 0.05, "no bounce light found"
    close = np.all(np.abs(got - want) <= 1e-5, -1)
    assert np.mean(close) >= 0.995, np.mean(close)


def test_ssgi_frame_matches_jax(frames):
    tr, jr = frames["tr"], frames["jr"]
    enabled = [p.name for p in tr.graph.passes if p.enabled]
    assert enabled == [p.name for p in jr._model.graph.passes if p.enabled] == PASSES
    for lj, lt in frames["ldr"]:
        assert lt.shape == lj.shape and lt.dtype == np.uint8
        diff = np.abs(lj.astype(np.int32) - lt.astype(np.int32))
        within, mean_max = LDR_TOL
        assert np.mean(diff.max(-1) <= 2) >= within, np.mean(diff.max(-1) <= 2)
        assert diff.mean() <= mean_max, diff.mean()
    assert tr._model.rt is None
