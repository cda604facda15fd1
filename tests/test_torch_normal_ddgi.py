"""The Normal frame with simple direct light and DDGI (the pair the JAX
package renders in tests/test_ddgi.py: ray-traced sun shadows, the DDGI
probe volume, and SpecularIndirect, which runs with DDGI) in the PyTorch
port against the JAX Renderer on the CPU: stress:2 at 96x64, 3 frames.

Gate: test_torch_frame.py's stress bounds, >= 97% of LDR pixels within
2/255 and mean |delta| <= 1.5 (measured: 99.89%, 99.76%, 99.64% of the 3
frames, mean |delta| 0.005-0.016, max 13-16)."""

import pytest
import torch

from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.renderer import Renderer as TorchRenderer
from tests.torch_parity import frames_beside_jax, ldr_agreement, same_mesh_cooker

W, H = 96, 64
FRAMES = 3
LDR_TOL = (0.97, 1.5)     # test_torch_frame.py's stress bounds
KW = dict(scene="stress:2", width=W, height=H, indirect_mode="ddgi")
PASSES = ["Culling", "Raster", "HZBBuild", "RasterPhase2", "ResolveGBuffer", "MaskedLayer",
          "SunShadow", "IBL", "DDGI", "SpecularIndirect", "DeferredLighting", "Sky", "TAA",
          "AutoExposure", "Bloom", "Tonemap"]
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
        kw = dict(KW, cache_dir=str(tmp_path_factory.mktemp("torch_normal_ddgi")))
        _CACHE.update(zip(("jr", "tr", "ldr_j", "ldr_t", "stats"), frames_beside_jax(kw, FRAMES)))
    return _CACHE


@pytest.mark.parametrize("frame", range(FRAMES), ids=[f"frame{i + 1}" for i in range(FRAMES)])
def test_normal_ddgi_frame_matches_jax(frames, frame):
    within, mean, _ = ldr_agreement(frames["ldr_j"][frame], frames["ldr_t"][frame])
    assert within >= LDR_TOL[0], within
    assert mean <= LDR_TOL[1], mean


def test_normal_ddgi_passes_and_stats(frames):
    """The JAX frame's passes; the probes traced every frame (the volume
    still changes), the sun shadow's K4 tiles never overflowed."""
    tr, jr = frames["tr"], frames["jr"]
    enabled = [p.name for p in tr.graph.passes if p.enabled]
    assert enabled == [p.name for p in jr._model.graph.passes if p.enabled] == PASSES
    stats = frames["stats"]
    assert stats[-1]["ddgi_traced_frames"] == FRAMES
    assert all(s["rt_k3_lanes_ddgi"] > 0 and s["rt_overflow_tiles"] == 0 for s in stats)
    assert all(s["rt_k3_lanes_spec"] > 0 for s in stats)


@pytest.mark.cuda
def test_normal_ddgi_frame_cuda_matches_cpu(tmp_path):
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
