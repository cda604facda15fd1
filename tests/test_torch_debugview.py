"""The debug views and overlays of the PyTorch port against the JAX package
on the CPU.

- Every name in ALL_VIEWS (ops/debugview.py), heatmap, csm_debug_overlay
  and ddgi_probe_overlay on seeded inputs carried across: the float views
  within 1e-5, then the uint8 images (clip(x, 0, 1) * 255 + 0.5) within
  1/255. The JAX ddgi_probe_overlay writes its float dot colours into the
  frame it is given (a uint8 frame comes back as float32, the dots in
  0-1); it is given the frame in 0-1 here, and its result converted as the
  port converts its dots.
- The SSGI march's and the denoiser's debug taps (``debug_out``) on a port
  frame's G-buffer: the march's within 1e-5 on >= 99.5% of the half-res
  pixels (tests/test_torch_ssgi.py's gate: a ray point on a depth-test
  boundary may hit in one package only), the denoiser's (HDR signals up to
  about 2) within 1e-5 + 1e-4 relative (the A-trous sums its taps in
  another order; measured: 9 of 18,432 values past 1e-5, at most 6.4e-5
  relative).
- The graph build's five ValueErrors, raised where the JAX graph raises
  them, and tex_debug without streaming disabling its pass.
- Each debug option's enabled passes equal to the JAX graph's (built, not
  compiled), and one CPU frame of each through the port's Renderer that is
  not constant (tests/test_debugview.py:108's check)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hobbyrenderer_tpu.config import Config as JaxConfig
from hobbyrenderer_tpu.config import RenderSettings
from hobbyrenderer_tpu.models.deferred import build_deferred_graph
from hobbyrenderer_tpu.ops import csm as jcsm
from hobbyrenderer_tpu.ops import ddgi as jddgi
from hobbyrenderer_tpu.ops import debugview as jdv
from hobbyrenderer_tpu.ops import denoise as jdn
from hobbyrenderer_tpu.ops import ssgi as jssgi
from hobbyrenderer_tpu.ops.raster import GBuffer as JGBuffer
from hobbyrenderer_tpu.scene.camera import Camera as JaxCamera
from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.models.deferred import to_ldr8
from hobbyrenderer_tpu_torch.ops import csm as tcsm
from hobbyrenderer_tpu_torch.ops import ddgi as tddgi
from hobbyrenderer_tpu_torch.ops import debugview as tdv
from hobbyrenderer_tpu_torch.ops import denoise as tdn
from hobbyrenderer_tpu_torch.ops import raster as traster
from hobbyrenderer_tpu_torch.ops import ssgi as tssgi
from hobbyrenderer_tpu_torch.renderer import Renderer as TorchRenderer
from hobbyrenderer_tpu_torch.renderer import device_view_constants
from tests.torch_parity import same_mesh_cooker

H, W = 33, 47          # odd: the half-res taps' nearest resize is not a plain 2x


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


class _GB:
    """A seeded G-buffer's fields, as jnp arrays or torch tensors."""

    def __init__(self, d, to):
        for k, v in d.items():
            setattr(self, k, to(v))


def _gbuffer_arrays(seed=0):
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(H, W, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    valid = rng.random((H, W)) > 0.2
    return dict(albedo=rng.random((H, W, 3), np.float32), normal=n, geo_normal=n,
                orm=rng.random((H, W, 3), np.float32),
                world_pos=rng.uniform([-12, -12, -45], [12, 12, 0], (H, W, 3)).astype(np.float32),
                depth=rng.random((H, W), np.float32), valid=valid,
                material=np.where(valid, rng.integers(0, 3, (H, W)), -1).astype(np.int32))


def _both(d):
    """(JAX object, port object) with the same fields."""
    return (_GB(d, jnp.asarray),
            _GB(d, lambda v: torch.as_tensor(v.astype(np.int64) if v.dtype == np.int32 else v)))


def _csm_arrays(seed=1):
    rng = np.random.default_rng(seed)
    S = jcsm.SHADOW_RES
    vp = np.stack([np.diag([0.1 / (c + 1), 0.1 / (c + 1), 0.05, 1.0]).astype(np.float32)
                   for c in range(jcsm.NUM_CASCADES)])
    vp[:, :3, 3] = rng.uniform(-0.2, 0.2, (jcsm.NUM_CASCADES, 3))
    return dict(view_proj=vp, depth=rng.random((jcsm.NUM_CASCADES, S, S), np.float32),
                splits=np.asarray([2.0, 5.0, 12.0, 30.0], np.float32))


def _view_matrix(seed=2):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    V = np.eye(4, dtype=np.float32)
    V[:3, :3] = q * np.sign(np.linalg.det(q))
    V[:3, 3] = rng.uniform(-2, 2, 3)
    return V


def _inputs():
    gbd = _gbuffer_arrays()
    jgb, tgb = _both(gbd)
    cs = _csm_arrays()
    jc = jcsm.CSMData(**{k: jnp.asarray(v) for k, v in cs.items()})
    tc = tcsm.CSMData(**{k: torch.as_tensor(v) for k, v in cs.items()})
    V = _view_matrix()
    rng = np.random.default_rng(4)
    ldr = rng.random((H, W, 3), np.float32)
    mask = rng.random((H, W), np.float32)
    masked = rng.random((H, W)) > 0.6
    sh, sw = H // 2, W // 2
    ss = {"irr_half": rng.random((sh, sw, 3), np.float32) * 3,
          "hit": (rng.random((sh, sw)) > 0.5).astype(np.float32),
          "ray_t": rng.random((sh, sw), np.float32),
          "direct": rng.random((sh, sw, 3), np.float32) * 2,
          "sky_eval": rng.random((sh, sw, 3), np.float32),
          "temporal": rng.random((H, W, 3), np.float32) * 2,
          "denoised": rng.random((H, W, 3), np.float32) * 2,
          "age": rng.random((H, W), np.float32) * 32,
          "composed": np.where(rng.random((H, W, 1)) > 0.9, np.nan,
                               rng.normal(size=(H, W, 3))).astype(np.float32),
          "view_dir": gbd["normal"]}
    key = rng.integers(1, 2 ** 32, (H, W), dtype=np.uint64)
    sc = {"radiance": rng.random((H, W, 3), np.float32) * 4,
          "hit": (rng.random((H, W)) > 0.5).astype(np.float32)}
    return dict(gbd=gbd, jgb=jgb, tgb=tgb, jc=jc, tc=tc, V=V, ldr=ldr, mask=mask,
                masked=masked, ss=ss, key=key, sc=sc)


_IN = {}


def inputs():
    if not _IN:
        _IN.update(_inputs())
    return _IN


def _views(name):
    x = inputs()
    ldr, mask = x["ldr"], x["mask"]
    if name in tdv.CSM_VIEWS:
        want = jdv.csm_view(name, jnp.asarray(ldr), x["jgb"], x["jc"],
                            {"view": jnp.asarray(x["V"])}, jnp.asarray(mask),
                            masked=jnp.asarray(x["masked"]))
        got = tdv.csm_view(name, torch.as_tensor(ldr), x["tgb"], x["tc"],
                           {"view": torch.as_tensor(x["V"])}, torch.as_tensor(mask),
                           masked=torch.as_tensor(x["masked"]))
    elif name in tdv.SSGI_VIEWS:
        want = jdv.ssgi_view(name, jnp.asarray(ldr), x["jgb"],
                             {k: jnp.asarray(v) for k, v in x["ss"].items()})
        got = tdv.ssgi_view(name, torch.as_tensor(ldr), x["tgb"],
                            {k: torch.as_tensor(v) for k, v in x["ss"].items()})
    else:
        jd = {k: jnp.asarray(v) for k, v in x["sc"].items()}
        jd["cell"] = jnp.asarray(x["key"].astype(np.uint32).view(np.int32))   # JAX: as int32
        td = {k: torch.as_tensor(v) for k, v in x["sc"].items()}
        td["cell"] = torch.as_tensor(x["key"].astype(np.int64))             # the uint32 key
        want = jdv.sharc_view(name, jnp.asarray(ldr), x["jgb"], jd)
        got = tdv.sharc_view(name, torch.as_tensor(ldr), x["tgb"], td)
    return np.asarray(want), got


def _to8(img):
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def test_view_lists_match_jax():
    assert tdv.CSM_VIEWS == jdv.CSM_VIEWS and tdv.SSGI_VIEWS == jdv.SSGI_VIEWS
    assert tdv.SHARC_VIEWS == jdv.SHARC_VIEWS and tdv.ALL_VIEWS == jdv.ALL_VIEWS


@pytest.mark.parametrize("name", jdv.ALL_VIEWS)
def test_view_matches_jax(name):
    want, got = _views(name)
    assert tuple(got.shape) == want.shape == (H, W, 3) and got.dtype == torch.float32
    g = got.numpy()
    assert np.array_equal(np.isnan(g), np.isnan(want))
    np.testing.assert_allclose(g, want, rtol=0, atol=1e-5, equal_nan=True)
    d = np.abs(to_ldr8(got).numpy().astype(np.int32) - _to8(np.nan_to_num(want)).astype(np.int32))
    assert d.max() <= 1, name


def test_heatmap_matches_jax():
    t = np.linspace(-0.5, 1.5, 401, dtype=np.float32)
    np.testing.assert_allclose(tdv.heatmap(torch.as_tensor(t)).numpy(),
                               np.asarray(jdv.heatmap(jnp.asarray(t))), rtol=0, atol=1e-6)


def test_resize_nearest_matches_jax():
    import jax
    img = np.random.default_rng(8).random((16, 23, 3), np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (H, W, 3), method="nearest"))
    np.testing.assert_array_equal(tdv.resize_nearest(torch.as_tensor(img), H, W).numpy(), want)


def test_csm_debug_overlay_matches_jax():
    x = inputs()
    Hh, Ww = 64, 96
    rng = np.random.default_rng(9)
    ldr = rng.integers(0, 256, (Hh, Ww, 3)).astype(np.uint8)
    wp = rng.uniform([-12, -12, -45], [12, 12, 0], (Hh, Ww, 3)).astype(np.float32)
    valid = rng.random((Hh, Ww)) > 0.3
    want = np.asarray(jcsm.csm_debug_overlay(jnp.asarray(ldr), x["jc"],
                                             {"view": jnp.asarray(x["V"])},
                                             jnp.asarray(wp), jnp.asarray(valid)))
    got = tcsm.csm_debug_overlay(torch.as_tensor(ldr), x["tc"], {"view": torch.as_tensor(x["V"])},
                                 torch.as_tensor(wp), torch.as_tensor(valid))
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1
    assert (np.abs(want.astype(np.int32) - ldr).max(-1) > 4)[Hh - 20:].mean() > 0.1   # thumbnails


def test_ddgi_probe_overlay_matches_jax():
    rng = np.random.default_rng(10)
    lo, hi = (-8.0, 0.0, -8.0), (8.0, 6.0, 8.0)
    jv = jddgi.ddgi_init(lo, hi)
    P = jv.irradiance.shape[0]
    irr = rng.random(tuple(jv.irradiance.shape), np.float32) * 2
    alive = (rng.random(P) > 0.2).astype(np.float32)
    off = rng.uniform(-0.5, 0.5, (P, 3)).astype(np.float32)
    jv.irradiance, jv.alive, jv.offset = jnp.asarray(irr), jnp.asarray(alive), jnp.asarray(off)
    tv = tddgi.ddgi_init(lo, hi, "cpu")._replace(
        irradiance=torch.as_tensor(irr), alive=torch.as_tensor(alive), offset=torch.as_tensor(off))
    Hh, Ww = 72, 128
    cam = JaxCamera(None, Ww, Hh)
    cam.position = np.asarray([2.0, 9.0, 16.0], np.float32)
    cam.look_at(np.asarray([0.0, 2.0, 0.0], np.float32))
    vc = cam.view_constants(0)
    ldr = rng.integers(0, 256, (Hh, Ww, 3)).astype(np.uint8)
    want = np.asarray(jddgi.ddgi_probe_overlay(jnp.asarray(ldr.astype(np.float32) / 255.0),
                                               jv, vc))
    got = tddgi.ddgi_probe_overlay(torch.as_tensor(ldr), tv, device_view_constants(vc, "cpu"))
    assert got.dtype == torch.uint8
    d = np.abs(got.numpy().astype(np.int32) - _to8(want).astype(np.int32))
    assert d.max() <= 1
    assert (got.numpy() != ldr).any(-1).mean() > 0.02, "no probe drawn"


@pytest.fixture(scope="module")
def ssgi_frame(tmp_path_factory):
    """A port NormalBasic + SSGI frame's G-buffer and view at stress:2 96x64."""
    tr = TorchRenderer(Config(scene="stress:2", width=96, height=64, mode="normal_basic",
                              indirect_mode="ssgi",
                              cache_dir=str(tmp_path_factory.mktemp("dv_ssgi"))), device="cpu")
    tr._model.keep = ("gbuffer",)
    tr.render_frame()
    gb = {k: v.numpy() for k, v in tr._model.last_resources["gbuffer"]._asdict().items()}
    vc = tr.camera.view_constants(3)
    tr.shutdown()
    return gb, vc


def test_ssgi_and_denoise_debug_taps_match_jax(ssgi_frame):
    gb, vc = ssgi_frame
    Hh, Ww = gb["depth"].shape
    rng = np.random.default_rng(11)
    prev = rng.uniform(0, 3, (Hh, Ww, 3)).astype(np.float32)
    irr = rng.normal(size=(9, 3)).astype(np.float32) * 0.3
    jgb = JGBuffer(**{k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
                      for k, v in gb.items()})
    tgb = traster.GBuffer(**{k: torch.as_tensor(v) for k, v in gb.items()})
    tvc = {k: (torch.as_tensor(v) if np.ndim(v) else v) for k, v in vc.items()}
    dj, dt = {}, {}
    want = jssgi.ssgi_half_res(jgb, vc, prev, irr, RenderSettings(), 3, debug_out=dj)
    got = tssgi.ssgi_half_res(tgb, tvc, torch.as_tensor(prev), 3, debug_out=dt,
                              irr=torch.as_tensor(irr))
    assert set(dt) == set(dj) == {"irr_half", "hit", "ray_t", "direct", "sky_eval"}
    assert float(np.asarray(dj["hit"]).mean()) > 0.05, "no march hit"
    for k in dj:
        a, b = dt[k].numpy(), np.asarray(dj[k])
        close = np.abs(a - b) <= 1e-5
        close = close.all(-1) if close.ndim == 3 else close
        assert np.mean(close) >= 0.995, (k, np.mean(close))
    # the denoiser's taps on the march's (JAX) signal and a fresh history
    sig = np.array(want)
    ej, et = {}, {}
    oj, _ = jdn.denoise(jnp.asarray(sig), jgb, jdn.denoise_init(Hh, Ww), debug_out=ej)
    ot, _ = tdn.denoise(torch.as_tensor(sig), tgb, tdn.denoise_init(Hh, Ww, "cpu"), debug_out=et)
    assert set(et) == set(ej) == {"temporal", "denoised", "age"}
    for k in ej:
        np.testing.assert_allclose(et[k].numpy(), np.asarray(ej[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-4, atol=1e-5)


# (option set, the JAX graph's message) for each ValueError of the graph build
BAD = [
    (dict(mode="normal_basic", debug_view="nope"), "unknown --debug-view"),
    (dict(mode="normal_basic", debug_view="csm_shadow_mask", render_scale=0.5),
     "native resolution"),
    (dict(mode="normal", debug_view="csm_shadow_mask"), "csm_\\* debug views"),
    (dict(mode="normal_basic", indirect_mode="ddgi", debug_view="ssgi_hit_mask"),
     "ssgi_\\* debug views"),
    (dict(mode="normal", direct_mode="restir", indirect_mode="restir",
          debug_view="sharc_heatmap"), "sharc_\\* debug views"),
]


def _jax_graph(kw, W_=64, H_=48, meta=None):
    jc = JaxConfig(**kw)
    mode, ind = jc.mode, jc.indirect_mode
    needs_rt = mode in ("normal", "ibl") or ind in ("ddgi", "restir")
    return build_deferred_graph(
        jc.render_width, jc.render_height, 1, mode=mode, with_rt_shadows=needs_rt,
        direct_mode=jc.direct_mode, indirect_mode=ind, has_masked=meta["has_masked"],
        has_transparent=meta["has_transparent"], scene_radius=meta["scene_radius"],
        scene_bounds=meta["scene_bounds"], specular_indirect=jc.specular_indirect,
        restir_quality=jc.restir_quality, denoiser_profile=jc.denoiser,
        out_width=jc.width, out_height=jc.height, ddgi_debug=jc.ddgi_debug,
        csm_debug=jc.csm_debug, tex_debug=jc.tex_debug, streaming=jc.tex_streaming,
        debug_view=jc.debug_view)


CUBE_META = dict(has_masked=False, has_transparent=False, scene_radius=2.0,
                 scene_bounds=((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)))


@pytest.mark.parametrize("kw,msg", BAD, ids=["unknown", "upscaled", "csm_mode", "ssgi_mode",
                                             "sharc_mode"])
def test_graph_build_raises_as_jax(tmp_path, kw, msg):
    with pytest.raises(ValueError, match=msg):
        _jax_graph(dict(kw, width=64, height=48), meta=CUBE_META)
    with pytest.raises(ValueError, match=msg):
        TorchRenderer(Config(scene="cube", width=64, height=48, cache_dir=str(tmp_path), **kw),
                      device="cpu")


# each debug option (and tex_debug without streaming, which disables its pass)
OPTIONS = {
    "ssgi_view": dict(mode="normal_basic", indirect_mode="ssgi", debug_view="ssgi_hit_mask"),
    "csm_view": dict(mode="normal_basic", debug_view="csm_depth_compare"),
    "csm_ddgi_overlays": dict(mode="normal_basic", indirect_mode="ddgi", csm_debug=True,
                              ddgi_debug=True, debug_view="csm_cascade_splits"),
    "sharc_view": dict(mode="normal", direct_mode="restir", indirect_mode="sharc",
                       debug_view="sharc_heatmap"),
    "combined_view": dict(mode="ibl", direct_mode="restir", indirect_mode="combined",
                          debug_view="sharc_voxel_color"),
    "tex_debug": dict(mode="normal", tex_streaming=True, tex_debug=True),
    "tex_debug_dense": dict(mode="normal_basic", tex_debug=True),
    "overlays_upscaled": dict(mode="normal_basic", indirect_mode="ddgi", csm_debug=True,
                              ddgi_debug=True, render_scale=0.5),
}
DEBUG_PASSES = {"DDGIDebug", "CSMDebug", "TexResidencyDebug", "DebugView"}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_debug_option_passes_and_frame(tmp_path, name):
    kw = dict(OPTIONS[name], scene="cube", width=64, height=48, cache_dir=str(tmp_path))
    tr = TorchRenderer(Config(**kw), device="cpu")
    enabled = [p.name for p in tr.graph.passes if p.enabled]
    m = tr.gpu.meta
    want = [p.name for p in _jax_graph(kw, meta=m).passes if p.enabled]
    assert enabled == want
    ldr = tr.render_frame().numpy()
    tr.shutdown()
    assert ldr.shape == (48, 64, 3) and ldr.dtype == np.uint8
    assert ldr.std() > 0                 # the diagnostic drew something
    expect = {"ssgi_view": {"DebugView"}, "csm_view": {"DebugView"},
              "csm_ddgi_overlays": {"DDGIDebug", "CSMDebug", "DebugView"},
              "sharc_view": {"DebugView"}, "combined_view": {"DebugView"},
              "tex_debug": {"TexResidencyDebug"}, "tex_debug_dense": set(),
              "overlays_upscaled": set()}[name]
    assert DEBUG_PASSES & set(enabled) == expect
