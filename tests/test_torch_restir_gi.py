"""ReSTIR GI of the PyTorch port against the JAX package on the CPU, at op
level: ``restir_gi`` on one G-buffer (the port's first stress:2 128x96
frame), the JAX SceneGPU and SceneRT carried across, and a non-empty
previous reservoir (the JAX package's frame-0 result), on an odd frame
(half rate: temporal playback, no bounce rays) and an even frame (bounce
rays, their NEE, reuse, final visibility).

``trace_max_steps=None``: the port's K3 plain walk and the JAX package's
4-wide wavefront walk both run the bounce rays uncapped, so they find the
same triangles; hit distances differ by rounding, and the reservoir merge
compares random numbers against weights, so a lane whose weights differ in
the last bits may keep another sample. Tolerances: the reservoir fields
within 1e-4 relative on >= 99% of the GI pixels (the sample payload on
the valid ones whose sample carries radiance), M equal on >= 99%, the full-res
indirect within 1e-3 relative L1 (measured on both frames: every field
and M on 100% of those pixels, the indirect 6.8e-8 and 1.3e-7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.config import Config as JaxConfig
from hobbyrenderer_tpu.models import pathtracer as jpt
from hobbyrenderer_tpu.ops import ibl as jibl
from hobbyrenderer_tpu.ops import raster as jraster
from hobbyrenderer_tpu.ops import restir_gi as jgi
from hobbyrenderer_tpu.scene import make_stress_scene
from hobbyrenderer_tpu.scene.gpu import build_scene_gpu as jax_build_scene_gpu
from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.models import scene_rt as tsrt
from hobbyrenderer_tpu_torch.ops import restir_gi as tgi
from hobbyrenderer_tpu_torch.renderer import Renderer as TorchRenderer
from tests.torch_parity import same_mesh_cooker

W, H = 128, 96
SCALE = 4
FIELDS = ("pos", "nrm", "rad", "w_sum", "M", "W")
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


def _setup(tmp_root):
    """One G-buffer, both scenes, the sky SH, and the JAX results of frames
    0 (from an empty reservoir), 1 and 2 (from frame 0's)."""
    if _CACHE:
        return _CACHE
    tr = TorchRenderer(Config(scene="stress:2", width=W, height=H,
                              cache_dir=str(tmp_root)), device="cpu")
    tr._model.keep = ("gbuffer",)
    tr.render_frame()
    tr.shutdown()
    gb_t = tr._model.last_resources["gbuffer"]
    scene = make_stress_scene(grid=2)
    jg = jax_build_scene_gpu(scene, max_lights=max(64, len(scene.lights) + 8))
    jrt = jpt.build_scene_rt(scene, jg)
    d = {k: np.asarray(getattr(jrt, k)) for k in tsrt.RT_FIELDS + tsrt.TABLE_FIELDS}
    d["bvh16"] = {k: np.asarray(getattr(jrt.bvh16, k))
                  for k in ("table", "order", "root_box", "recs", "slot_of")}
    d["lights"] = {k: np.asarray(getattr(jrt.lights, k))
                   for k in ("n_analytic", "n_total") + tsrt.POOL_FIELDS}
    d["em_index"] = np.asarray(jrt.em_index)
    trt = tsrt.scene_rt_from_numpy(d, "cpu", bvh=tr._model.rt.bvh)
    settings = JaxConfig().settings
    sun = np.asarray(tr.gpu.light_dir[tr.gpu.meta["sun_index"]])
    sky = np.asarray(jibl.build_sky_irradiance(jnp.asarray(sun), settings))
    gb_j = jraster.GBuffer(*[jnp.asarray(x.numpy()) for x in gb_t])

    def run(prev, frame):
        return jgi.restir_gi(jg, jrt, gb_j, None, settings, prev, frame, scale=SCALE,
                             half_rate=True, trace_max_steps=None, skip_pool_emissive=True,
                             sky_sh=jnp.asarray(sky), ibl_scale=1.0)
    run = jax.jit(run)
    _, res0 = run(jgi.gi_reservoir_init(H // SCALE, W // SCALE), 0)
    out = {f: run(res0, f) for f in (1, 2)}
    _CACHE.update(tr=tr, trt=trt, gb=gb_t, sky=sky, res0=res0, out=out)
    return _CACHE


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return _setup(tmp_path_factory.mktemp("torch_restir_gi"))


def _port(setup, frame):
    prev = tgi.GIReservoir(*[torch.as_tensor(np.array(getattr(setup["res0"], f)))
                             for f in FIELDS])
    so = {}
    full, res = tgi.restir_gi(setup["tr"].gpu, setup["trt"], setup["gb"], None,
                              setup["tr"].config.settings, prev, frame, scale=SCALE,
                              half_rate=True, trace_max_steps=None, skip_pool_emissive=True,
                              stats_out=so, sky_sh=torch.as_tensor(setup["sky"]), ibl_scale=1.0)
    return full, res, so


@pytest.mark.parametrize("frame", [1, 2], ids=["odd_playback", "even_traced"])
def test_restir_gi_matches_jax(setup, frame):
    full_t, res_t, so = _port(setup, frame)
    full_j, res_j = setup["out"][frame]
    assert float(np.asarray(setup["res0"].M).max()) > 0, "empty previous reservoir"
    assert so["traced"] == (frame % 2 == 0)
    if frame % 2 == 0:
        assert int(so["bounce_lanes"]) > 0 and int(so["bounce_capped"]) == 0
    m_j, m_t = np.asarray(res_j.M), res_t.M.numpy()
    assert m_j.max() > 0
    assert np.mean(m_t == m_j) >= 0.99, np.mean(m_t == m_j)
    # the sample payload is read only where it carries weight: a valid GI
    # pixel (the JAX CPU walk also traces sky pixels, the port's masks them)
    # whose sample has radiance (a miss's position is the ray at t = INF)
    valid = setup["gb"].valid[::SCALE, ::SCALE].numpy()
    live = valid & (np.asarray(res_j.rad).max(-1) > 0)
    assert live.mean() > 0.3, "degenerate case"
    for f in FIELDS:
        a, b = getattr(res_t, f).numpy(), np.asarray(getattr(res_j, f))
        close = np.isclose(a, b, rtol=1e-4, atol=1e-6)
        close = close.all(-1)[live] if close.ndim == 3 else close
        assert np.mean(close) >= 0.99, (f, np.mean(close))
    want = np.asarray(full_j)
    assert np.abs(want).sum() > 0
    rel = np.abs(full_t.numpy() - want).sum() / np.abs(want).sum()
    assert rel <= 1e-3, rel


def test_jacobian_matches_jax():
    rng = np.random.default_rng(3)
    a, b, c, n = (rng.normal(size=(512, 3)).astype(np.float32) for _ in range(4))
    want = np.asarray(jgi._jacobian(*map(jnp.asarray, (a, b, n, c))))
    got = tgi._jacobian(*map(torch.as_tensor, (a, b, n, c))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
