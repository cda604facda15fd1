"""Traced specular indirect of the PyTorch port against the JAX package on
the CPU: the GGX-VNDF and Smith helpers and ``to_local`` to float
rounding, the checkerboard ``sample_valid`` branch of the RELAX temporal
pass, and ``specular_indirect`` itself on two consecutive half-rate frames
(both checkerboard parities) of one G-buffer: the port's first stress:2
128x96 frame with seeded roughness and metalness (mirror, glossy and rough
lanes), the JAX SceneGPU and SceneRT carried across.

The JAX CPU path walks the 4-wide BVH, the port the 16-wide one (K3's plain
version): the same hit triangles, hit distances that differ by rounding.
Tolerances: helpers within 1e-5 relative + 1e-6 absolute (XLA:CPU FMA
contraction); the temporal pass within 1e-6; the blend weight equal; the
traced frames' output, colour history and moments within 1e-3 relative L1,
the history counts equal (measured: the output 2.7e-4 and 9.5e-5, colour
history and moments <= 8.2e-7; 361 and 357 reflection rays, none capped)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.config import Config as JaxConfig
from hobbyrenderer_tpu.models import pathtracer as jpt
from hobbyrenderer_tpu.ops import denoise as jdn
from hobbyrenderer_tpu.ops import ibl as jibl
from hobbyrenderer_tpu.ops import raster as jraster
from hobbyrenderer_tpu.ops import sampling as jsmp
from hobbyrenderer_tpu.ops import specular as jspec
from hobbyrenderer_tpu.scene import make_stress_scene
from hobbyrenderer_tpu.scene.gpu import build_scene_gpu as jax_build_scene_gpu
from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.models import scene_rt as tsrt
from hobbyrenderer_tpu_torch.ops import denoise as tdn
from hobbyrenderer_tpu_torch.ops import raster as traster
from hobbyrenderer_tpu_torch.ops import sampling as tsmp
from hobbyrenderer_tpu_torch.ops import specular as tspec
from hobbyrenderer_tpu_torch.renderer import Renderer as TorchRenderer
from tests.torch_parity import same_mesh_cooker

W, H = 128, 96
FRAMES = (2, 3)
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


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_vndf_helpers_match_jax():
    rng = np.random.default_rng(5)
    n, v = _unit(rng, 4096), _unit(rng, 4096)
    v = np.where(np.sum(n * v, -1, keepdims=True) < 0, -v, v)
    alpha = rng.uniform(0.0009, 1.0, 4096).astype(np.float32)
    u1, u2 = (rng.random(4096, np.float32) for _ in range(2))
    ndv, ndl = (rng.uniform(1e-4, 1.0, 4096).astype(np.float32) for _ in range(2))
    j, t = jnp.asarray, torch.as_tensor
    v_loc_j = jsmp.to_local(j(n), j(v))
    v_loc_t = tsmp.to_local(t(n), t(v))
    np.testing.assert_allclose(v_loc_t.numpy(), np.asarray(v_loc_j), rtol=1e-5, atol=1e-6)
    h_j = jsmp.sample_ggx_vndf(v_loc_j, j(alpha), j(u1), j(u2))
    h_t = tsmp.sample_ggx_vndf(t(np.asarray(v_loc_j)), t(alpha), t(u1), t(u2))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tsmp.smith_g2_over_g1(t(ndv), t(ndl), t(alpha)).numpy(),
                               np.asarray(jsmp.smith_g2_over_g1(j(ndv), j(ndl), j(alpha))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tsmp.smith_g1(t(ndv), t(alpha)).numpy(),
                               np.asarray(jsmp.smith_g1(j(ndv), j(alpha))), rtol=1e-5, atol=1e-6)


def test_temporal_accumulate_sample_valid_matches_jax():
    """History-only lanes, holes rebuilt from the horizontal neighbours and
    history 0 for "no data": a random state, motion and checkerboard."""
    rng = np.random.default_rng(11)
    h, w = 24, 40
    f = lambda *s: rng.random(s, np.float32)        # noqa: E731
    nrm = _unit(rng, h * w).reshape(h, w, 3)
    gb = dict(motion=(f(h, w, 2) - 0.5) * 3.0, depth=f(h, w) + 0.5, normal=nrm,
              valid=f(h, w) > 0.1)
    state = dict(color=f(h, w, 3), moments=f(h, w, 2), history=np.floor(f(h, w) * 6.0),
                 depth=gb["depth"] * np.where(f(h, w) > 0.2, 1.0, 2.0).astype(np.float32),
                 normal=nrm)
    signal = f(h, w, 3)
    sv = ((np.arange(h)[:, None] + np.arange(w)[None, :]) % 2) == 0
    js = jdn.DenoiseState(**{k: jnp.asarray(x) for k, x in state.items()})
    ts = tdn.DenoiseState(**{k: torch.as_tensor(x) for k, x in state.items()})
    jg = jspec._SubGB(**{k: jnp.asarray(x) for k, x in gb.items()})
    tg = tspec._SubGB(**{k: torch.as_tensor(x) for k, x in gb.items()})
    want = jdn.temporal_accumulate(jnp.asarray(signal), jg, js, max_history=8.0,
                                   sample_valid=jnp.asarray(sv))
    got = tdn.temporal_accumulate(torch.as_tensor(signal), tg, ts, max_history=8.0,
                                  sample_valid=torch.as_tensor(sv))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
    for a, b in zip(got[2], want[2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    hist = got[2].history.numpy()
    assert (hist == 0).any() and (hist > 1).any(), "degenerate case"


def _setup(tmp_root):
    """One G-buffer with seeded roughness / metalness, both scenes, the sky
    SH, and the JAX package's two frames (frame 3 from frame 2's state)."""
    if _CACHE:
        return _CACHE
    tr = TorchRenderer(Config(scene="stress:2", width=W, height=H,
                              cache_dir=str(tmp_root)), device="cpu")
    tr._model.keep = ("gbuffer",)
    tr.render_frame()
    tr.shutdown()
    gb = {f: tr._model.last_resources["gbuffer"][i].numpy()
          for i, f in enumerate(traster.GBuffer._fields)}
    rng = np.random.default_rng(2)
    rough = np.where(rng.random((H, W)) < 0.25, 0.01, rng.uniform(0.05, 0.7, (H, W)))
    orm = gb["orm"].copy()
    orm[..., 1] = rough
    orm[..., 2] = (rng.random((H, W)) < 0.5).astype(np.float32)
    gb["orm"] = orm.astype(np.float32)
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
    vc = tr.view_constants()
    gb_j = jraster.GBuffer(*[jnp.asarray(gb[f]) for f in traster.GBuffer._fields])

    def run(state, frame):
        return jspec.specular_indirect(jg, jrt, gb_j, {"camera_pos": jnp.asarray(
            vc["camera_pos"].numpy())}, settings, state, frame, sun_dir=jnp.asarray(sun),
            skip_pool_emissive=True, sky_sh=jnp.asarray(sky), ibl_scale=1.0, half_rate=True)
    run = jax.jit(run)
    states = [jspec.spec_state_init(H, W)]
    outs = []
    for f in FRAMES:
        spec, wgt, st = run(states[-1], f)
        outs.append((np.asarray(spec), np.asarray(wgt), st))
        states.append(st)
    _CACHE.update(tr=tr, trt=trt, gb=gb, sky=sky, sun=sun, vc=vc, states=states, outs=outs)
    return _CACHE


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return _setup(tmp_path_factory.mktemp("torch_specular"))


@pytest.mark.parametrize("k", [0, 1], ids=["frame2_from_empty", "frame3_from_frame2"])
def test_specular_indirect_matches_jax(setup, k):
    s = setup
    gb = traster.GBuffer(*[torch.as_tensor(s["gb"][f]) for f in traster.GBuffer._fields])
    state = tdn.DenoiseState(*[torch.as_tensor(np.array(x)) for x in s["states"][k]])
    so = {}
    spec, wgt, st = tspec.specular_indirect(
        s["tr"].gpu, s["trt"], gb, s["vc"], s["tr"].config.settings, state, FRAMES[k],
        sun_dir=torch.as_tensor(s["sun"]), skip_pool_emissive=True,
        sky_sh=torch.as_tensor(s["sky"]), ibl_scale=1.0, half_rate=True, stats_out=so)
    spec_j, wgt_j, st_j = s["outs"][k]
    assert int(so["lanes"]) > 200 and int(so["capped"]) == 0 and int(so["past_cap"]) == 0
    np.testing.assert_array_equal(wgt.numpy(), wgt_j)
    assert np.abs(spec_j).sum() > 0
    rel = np.abs(spec.numpy() - spec_j).sum() / np.abs(spec_j).sum()
    assert rel <= 1e-3, rel
    for name in ("color", "moments"):
        a, b = getattr(st, name).numpy(), np.asarray(getattr(st_j, name))
        assert np.abs(a - b).sum() / np.abs(b).sum() <= 1e-3, name
    np.testing.assert_array_equal(st.history.numpy(), np.asarray(st_j.history))
