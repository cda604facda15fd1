"""The IBL frame with ReSTIR DI on ReGIR onion cells and the combined
indirect mode (SHARC plus a traced half-res bounce that reads the cache at
its hit) in the PyTorch port against the JAX Renderer on the CPU: stress:2
at 96x64, 3 frames. RTXDI's straggler caps are lifted on the port's side,
as tests/test_torch_flagship.py does. ReGIR's cells and the candidate stage
on them are held at op level in tests/test_torch_regir.py, the cache in
tests/test_torch_sharc.py.

Gate: test_torch_frame.py's stress bounds, >= 97% of LDR pixels within
2/255 and mean |delta| <= 1.5 (measured: 97.22%, 97.02%, 97.30% of the 3
frames, mean |delta| 0.140-0.171, max 23-55). The margin is thin because
the traced half-res bounce is a 1-spp signal that turns ulp differences
between the packages into other NEE outcomes; the pass itself is held on
identical inputs below."""

import numpy as np
import pytest
import torch

from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.graph.rendergraph import FrameContext
from hobbyrenderer_tpu_torch.ops import denoise as tdn
from hobbyrenderer_tpu_torch.ops import raster as traster
from hobbyrenderer_tpu_torch.ops import sharc as tsharc
from hobbyrenderer_tpu_torch.renderer import Renderer as TorchRenderer
from tests.torch_parity import frames_beside_jax, ldr_agreement, same_mesh_cooker

W, H = 96, 64
FRAMES = 3
LDR_TOL = (0.97, 1.5)     # test_torch_frame.py's stress bounds
PASS_RTOL, PASS_WITHIN = 1e-2, 0.995
KW = dict(scene="stress:2", width=W, height=H, mode="ibl", direct_mode="restir",
          indirect_mode="combined", regir=True, regir_mode="onion")
PASSES = ["Culling", "Raster", "HZBBuild", "RasterPhase2", "ResolveGBuffer", "MaskedLayer",
          "IBL", "RTXDI", "Denoise", "SHARC", "SharcIndirectQuery", "SpecularIndirect",
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


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    if not _CACHE:
        kw = dict(KW, cache_dir=str(tmp_path_factory.mktemp("torch_combined_frame")))
        _CACHE.update(zip(("jr", "tr", "ldr_j", "ldr_t", "stats"), frames_beside_jax(
            kw, FRAMES, jax_keep=("gbuffer", "sky_irradiance", "sharc_indirect"))))
    return _CACHE


@pytest.mark.parametrize("frame", range(FRAMES), ids=[f"frame{i + 1}" for i in range(FRAMES)])
def test_combined_frame_matches_jax(frames, frame):
    within, mean, _ = ldr_agreement(frames["ldr_j"][frame], frames["ldr_t"][frame])
    assert within >= LDR_TOL[0], within
    assert mean <= LDR_TOL[1], mean


def test_combined_passes_and_stats(frames):
    """The JAX frame's passes; both SHARC bounces, their NEE walks and the
    reflections ran, none spent its step budget."""
    tr, jr = frames["tr"], frames["jr"]
    enabled = [p.name for p in tr.graph.passes if p.enabled]
    assert enabled == [p.name for p in jr._model.graph.passes if p.enabled] == PASSES
    assert int((tr._model.state["sharc_cache"].key != 0).sum()) > 100
    for s in frames["stats"]:
        for walk in ("sharc", "sharc_nee", "sharcq", "sharcq_nee", "spec"):
            assert s[f"rt_k3_lanes_{walk}"] > 0, walk
            assert s[f"rt_k3_capped_{walk}"] == 0, walk
        assert s["rt_overflow_di"] == 0


def test_sharc_query_pass_matches_jax_pass(frames):
    """The port's SharcIndirectQuery pass and the JAX package's, run op by
    op outside the jitted frame, on the same inputs: the JAX frame's
    G-buffer, sky irradiance, the cache its SHARC pass wrote and the query's
    denoiser history, for each of the 3 frames. This holds the pass itself.
    The frames above differ more: inside the jitted frame XLA:CPU contracts
    products into FMAs, and the two G-buffers differ by ulps, which the
    1-spp traced bounce amplifies (a ray 1e-7 apart can move its NEE shadow
    ray across an occluder's edge; ROADMAP Queue 3, Held).
    Gate: >= 99.5% of pixels within 1e-2 relative, the median below 1e-6
    (measured: 99.85%, 100%, 100% of the 3 frames; medians 5.9e-8, 7.8e-8,
    5.5e-8; 98.8-99.9% within 1e-3)."""
    import jax.numpy as jnp

    from hobbyrenderer_tpu.graph.rendergraph import FrameContext as JaxFrameContext
    from hobbyrenderer_tpu.ops import denoise as jdn
    from hobbyrenderer_tpu.ops import raster as jraster
    from hobbyrenderer_tpu.ops import sharc as jsharc
    tr, jr = frames["tr"], frames["jr"]
    fn_t = tr.graph.get("SharcIndirectQuery").fn
    fn_j = jr._model.graph.get("SharcIndirectQuery").fn
    cam = tr.view_constants()["camera_pos"]

    def t(a):
        return torch.as_tensor(np.array(a))
    for k, kept in enumerate(jr.kept):
        g, sky = kept["gbuffer"], kept["sky_irradiance"]
        c, q = kept["state_after"]["sharc_cache"], kept["state_before"]["sharc_q_state"]
        res_t = {"gbuffer": traster.GBuffer(*[t(getattr(g, f)) for f in traster.GBuffer._fields]),
                 "sky_irradiance": t(sky),
                 "sharc_cache": tsharc.SharcCache(key=t(c.key.astype(np.int64)),
                                                  radiance=t(c.radiance), age=t(c.age)),
                 "sharc_q_state": tdn.DenoiseState(*[t(a) for a in q])}
        fn_t(FrameContext(gpu=tr.gpu, vc={"camera_pos": cam, "frame_index": k},
                          settings=tr.config.settings, rt=tr._model.rt), res_t)
        res_j = {"gbuffer": jraster.GBuffer(*[jnp.asarray(a) for a in g]),
                 "sky_irradiance": jnp.asarray(sky),
                 "sharc_cache": jsharc.SharcCache(*[jnp.asarray(a) for a in c]),
                 "sharc_q_state": jdn.DenoiseState(*[jnp.asarray(a) for a in q])}
        fn_j(JaxFrameContext(gpu=jr.gpu, vc={"camera_pos": jnp.asarray(cam.numpy()),
                                             "frame_index": jnp.int32(k)},
                             settings=jr.config.settings.as_pytree(), config=jr.config,
                             rt=jr._model.rt), res_j)
        got, want = res_t["sharc_indirect"].numpy(), np.asarray(res_j["sharc_indirect"])
        rel = np.abs(got - want).sum(-1) / (np.abs(want).sum(-1) + 1e-3)
        assert np.mean(rel < PASS_RTOL) >= PASS_WITHIN, (k, np.mean(rel < PASS_RTOL))
        assert np.median(rel) < 1e-6, (k, np.median(rel))


@pytest.mark.cuda
def test_combined_frame_cuda_matches_cpu(tmp_path):
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
