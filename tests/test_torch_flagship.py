"""The flagship Normal frame of the PyTorch port (ReSTIR DI + ReSTIR GI +
traced specular: 17 passes at stress:2, which has no transparent material)
against the JAX Renderer on the CPU: stress:2 at 96x64, 3 frames, so both
half-rate GI parities run. RTXDI's straggler capacity and step cap are
lifted on the port's side, as tests/test_torch_restir.py does (the JAX CPU
frame traces winner visibility exactly). The op-level parity of ReSTIR GI
and the specular pass is in tests/test_torch_restir_gi.py and
tests/test_torch_specular.py.

Gate: test_torch_frame.py's stress bounds, >= 97% of LDR pixels within
2/255 and mean |delta| <= 1.5 (measured: 99.53-99.58% within 2/255, mean
|delta| 0.029-0.043, max 30-52)."""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.config import Config as JaxConfig
from hobbyrenderer_tpu.renderer import Renderer as JaxRenderer
from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.ops import restir as trestir
from hobbyrenderer_tpu_torch.renderer import Renderer as TorchRenderer
from tests.torch_parity import same_mesh_cooker

W, H = 96, 64
FRAMES = 3
LDR_TOL = (0.97, 1.5)     # test_torch_frame.py's stress bounds
FLAGSHIP_PASSES = ["Culling", "Raster", "HZBBuild", "RasterPhase2", "ResolveGBuffer",
                   "MaskedLayer", "IBL", "RTXDI", "RTXDIGI", "Denoise", "SpecularIndirect",
                   "DeferredLighting", "Sky", "TAA", "AutoExposure", "Bloom", "Tonemap"]
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
    """The port's Renderer and its LDR frames and stats (run beside the JAX
    compile), with RTXDI's winner visibility traced exactly."""
    torch.set_num_threads(1)      # a thread's own setting: not inherited
    tr = TorchRenderer(Config(**kw), device="cpu")
    ldr, stats = [], []
    for _ in range(FRAMES):
        ldr.append(tr.render_frame().numpy())
        stats.append(tr.stats())
    tr.shutdown()
    return tr, ldr, stats


def _frames(tmp_root):
    if _CACHE:
        return _CACHE
    kw = dict(scene="stress:2", width=W, height=H, direct_mode="restir",
              indirect_mode="restir", cache_dir=str(tmp_root))
    restir_di = trestir.restir_di
    trestir.restir_di = functools.partial(restir_di, straggler_steps=None)
    try:
        with ThreadPoolExecutor(1) as pool:
            port = pool.submit(_port_frames, kw)
            jr = JaxRenderer(JaxConfig(**kw))
            ldr_j = [np.asarray(jr.render_frame()) for _ in range(FRAMES)]
            jr.shutdown()
            tr, ldr_t, stats = port.result()
    finally:
        trestir.restir_di = restir_di
    _CACHE.update(jr=jr, tr=tr, ldr_j=ldr_j, ldr_t=ldr_t, stats=stats)
    return _CACHE


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    return _frames(tmp_path_factory.mktemp("torch_flagship"))


@pytest.mark.parametrize("frame", range(FRAMES), ids=[f"frame{i + 1}" for i in range(FRAMES)])
def test_flagship_frame_matches_jax(frames, frame):
    lj, lt = frames["ldr_j"][frame], frames["ldr_t"][frame]
    assert lt.shape == lj.shape and lt.dtype == np.uint8
    diff = np.abs(lj.astype(np.int32) - lt.astype(np.int32))
    within, mean_max = LDR_TOL
    assert np.mean(diff.max(-1) <= 2) >= within, np.mean(diff.max(-1) <= 2)
    assert diff.mean() <= mean_max, diff.mean()


def test_flagship_passes_and_stats(frames):
    """The same 17 passes as the JAX frame; GI traced on frames 1 and 3
    (half rate), the bounce, NEE and reflection walks ran and none was
    capped, no glossy lane was past the capacity."""
    tr, jr, stats = frames["tr"], frames["jr"], frames["stats"]
    enabled = [p.name for p in tr.graph.passes if p.enabled]
    assert enabled == [p.name for p in jr._model.graph.passes if p.enabled] == FLAGSHIP_PASSES
    assert [s["gi_traced_frames"] for s in stats] == [1, 1, 2]
    for s in stats[0], stats[2]:
        assert s["rt_k3_lanes_gi"] > 0 and s["rt_k3_lanes_gi_nee"] > 0
    for s in stats:
        assert s["rt_k3_lanes_spec"] > 0 and s["spec_past_cap"] == 0
        assert s["rt_overflow_gi"] == 0
        assert all(s[k] == 0 for k in ("rt_k3_capped_gi", "rt_k3_capped_gi_nee",
                                       "rt_k3_capped_spec", "rt_k3_capped_spec_nee"))
