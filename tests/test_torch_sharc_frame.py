"""The Normal frame with ReSTIR DI and SHARC (indirect_mode="sharc") in the
PyTorch port against the JAX Renderer on the CPU: stress:2 at 96x64, 3
frames, so the cache feeds its own bounces back (the multi-bounce
feedback) and SpecularIndirect reads it at its hits. RTXDI's straggler caps
are lifted on the port's side, as tests/test_torch_flagship.py does. The
cache's update, resolve and query are held against the JAX package at op
level in tests/test_torch_sharc.py.

Gate: test_torch_frame.py's stress bounds, >= 97% of LDR pixels within
2/255 and mean |delta| <= 1.5 (measured: 99.59%, 99.35%, 99.17% of the 3
frames, mean |delta| 0.037-0.081, max 29-34)."""

import numpy as np
import pytest
import torch

from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.renderer import Renderer as TorchRenderer
from tests.torch_parity import frames_beside_jax, ldr_agreement, same_mesh_cooker

W, H = 96, 64
FRAMES = 3
LDR_TOL = (0.97, 1.5)     # test_torch_frame.py's stress bounds
KW = dict(scene="stress:2", width=W, height=H, direct_mode="restir", indirect_mode="sharc")
PASSES = ["Culling", "Raster", "HZBBuild", "RasterPhase2", "ResolveGBuffer", "MaskedLayer",
          "IBL", "RTXDI", "Denoise", "SHARC", "SpecularIndirect", "DeferredLighting", "Sky",
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
        kw = dict(KW, cache_dir=str(tmp_path_factory.mktemp("torch_sharc_frame")))
        _CACHE.update(zip(("jr", "tr", "ldr_j", "ldr_t", "stats"), frames_beside_jax(kw, FRAMES)))
    return _CACHE


@pytest.mark.parametrize("frame", range(FRAMES), ids=[f"frame{i + 1}" for i in range(FRAMES)])
def test_sharc_frame_matches_jax(frames, frame):
    within, mean, _ = ldr_agreement(frames["ldr_j"][frame], frames["ldr_t"][frame])
    assert within >= LDR_TOL[0], within
    assert mean <= LDR_TOL[1], mean


def test_sharc_passes_cache_and_stats(frames):
    """The JAX frame's passes; the cache holds about as many live cells as
    the reference's (the bounce hits agree but for the walks' rounding);
    every SHARC and reflection walk ran and none spent its step budget."""
    tr, jr = frames["tr"], frames["jr"]
    enabled = [p.name for p in tr.graph.passes if p.enabled]
    assert enabled == [p.name for p in jr._model.graph.passes if p.enabled] == PASSES
    n_t = int((tr._model.state["sharc_cache"].key != 0).sum())
    n_j = int((np.asarray(jr._model.state["sharc_cache"].key) != 0).sum())
    assert n_j > 100 and abs(n_t - n_j) <= 0.05 * n_j, (n_t, n_j)
    for s in frames["stats"]:
        assert s["rt_k3_lanes_sharc"] > 0 and s["rt_k3_lanes_sharc_nee"] > 0
        assert s["rt_k3_lanes_spec"] > 0 and s["spec_past_cap"] == 0
        assert s["rt_k3_capped_sharc"] == 0 and s["rt_k3_capped_spec"] == 0


@pytest.mark.cuda
def test_sharc_frame_cuda_matches_cpu(tmp_path):
    """The kernels' frame against the plain versions' (run by chip_smoke.py
    phase 23 on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run by chip_smoke.py on the card")
    cfg = Config(**dict(KW, width=128, height=96, cache_dir=str(tmp_path)))
    rc, rg = TorchRenderer(cfg, device="cpu"), TorchRenderer(cfg, device="cuda")
    for _ in range(2):
        lc, lg = rc.render_frame().numpy(), rg.render_frame().cpu().numpy()
    rc.shutdown()
    rg.shutdown()
    assert ldr_agreement(lc, lg)[0] >= 0.99
