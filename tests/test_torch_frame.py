"""The whole default Normal frame of the PyTorch port against the JAX
Renderer on the CPU: G-buffer and final LDR at frames 1 and 3 (frame 3
carries TAA history), from identical scenes and cameras.

The two CPU paths are not the same algorithm everywhere: the JAX frame
rasterizes through its XLA segment-max branch (ties pick the max id) and
traces sun shadows with the capped wavefront BVH walk, the port through the
kernels' plain versions. Hence the tolerances: visid mismatch < 1% (depth
atol 1e-4 where the visids agree), and per-scene LDR bounds."""

import os

import jax
import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.config import Config as JaxConfig
from hobbyrenderer_tpu.graph.rendergraph import FrameContext
from hobbyrenderer_tpu.renderer import Renderer as JaxRenderer
from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.ops import beam as tbeam
from hobbyrenderer_tpu_torch.ops import raster_kernel as trk
from hobbyrenderer_tpu_torch.renderer import Renderer as TorchRenderer
from tests.torch_parity import same_mesh_cooker

FRAMES = 3
KEEP = ("raster_depth", "raster_visid", "gbuffer")
SCENES = {"cube": (64, 48), "stress:2": (96, 64), "stress:4": (96, 64)}
# (min share of pixels within 2/255 on every channel, max mean |delta|)
# stress:4 is the smallest grid with an alpha-blend instance (Transparent)
LDR_TOL = {"cube": (0.99, 0.5), "stress:2": (0.97, 1.5), "stress:4": (0.97, 1.5)}


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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run by chip_smoke.py on the card")
    return torch.device("cuda")


def _hook_jax(r):
    """Make the jitted JAX frame also return the G-buffer resources."""
    m = r._model

    def fn(gpu, rt, vc, settings, state, dt):
        ctx = FrameContext(gpu=gpu, vc=vc, settings=settings, config=m.config,
                           dt=dt, rt=rt)
        out = m.graph.execute(ctx, state, outputs=("ldr", "raster_overflow") + KEEP)
        o = out["outputs"]
        return o["ldr"], {k: o[k] for k in ("raster_overflow",) + KEEP}, out["state"]

    m._jitted = jax.jit(fn, donate_argnums=(4,))


_CACHE = {}


def _render_both(name, tmp_root):
    if name in _CACHE:
        return _CACHE[name]
    w, h = SCENES[name]
    kw = dict(scene=name, width=w, height=h,
              cache_dir=os.path.join(str(tmp_root), name.replace(":", "_")))
    jr = JaxRenderer(JaxConfig(**kw))
    _hook_jax(jr)
    tr = TorchRenderer(Config(**kw), device="cpu")
    tr._model.keep = KEEP
    frames = []
    for _ in range(FRAMES):
        lj = np.asarray(jr.render_frame())
        lt = tr.render_frame().numpy()
        sj, st = jr._model.last_stats, tr._model.last_resources
        frames.append(dict(
            ldr=(lj, lt),
            depth=(np.asarray(sj["raster_depth"]), st["raster_depth"].numpy()),
            visid=(np.asarray(sj["raster_visid"]), st["raster_visid"].numpy()),
            gb=(jax.tree_util.tree_map(np.asarray, sj["gbuffer"]),
                {k: v.numpy() for k, v in st["gbuffer"]._asdict().items()})))
    jr.shutdown()
    tr.shutdown()
    _CACHE[name] = frames
    return frames


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_frame")


@pytest.mark.parametrize("frame", [0, 2], ids=["frame1", "frame3"])
@pytest.mark.parametrize("name", list(SCENES))
def test_gbuffer_matches_jax(tmp_root, name, frame):
    f = _render_both(name, tmp_root)[frame]
    vj, vt = f["visid"]
    dj, dt = f["depth"]
    assert np.mean(vj >= 0) > 0.1, "degenerate view"
    assert np.mean(vj != vt) < 0.01, np.mean(vj != vt)
    agree = vj == vt
    np.testing.assert_allclose(dt[agree], dj[agree], atol=1e-4)
    gj, gt = f["gb"]
    np.testing.assert_array_equal(gt["valid"], np.asarray(gj.valid))
    # the final G-buffer also carries the masked layer, whose alpha test
    # reads a stochastic texel: a 1-ulp uv difference can move the mip pick
    # and flip a cutout pixel, so these fields may differ like visids do
    both = np.asarray(gj.valid) & agree
    for field, atol in (("world_pos", 1e-3), ("geo_normal", 1e-4), ("motion", 1e-3)):
        bad = np.abs(gt[field] - np.asarray(getattr(gj, field))).max(-1) > atol
        assert np.mean(bad[both]) < 0.01, (field, np.mean(bad[both]))
    assert np.mean(gt["material"] != np.asarray(gj.material)) < 0.01


@pytest.mark.parametrize("frame", [0, 2], ids=["frame1", "frame3"])
@pytest.mark.parametrize("name", list(SCENES))
def test_ldr_matches_jax(tmp_root, name, frame):
    lj, lt = _render_both(name, tmp_root)[frame]["ldr"]
    assert lt.shape == lj.shape and lt.dtype == np.uint8
    diff = np.abs(lj.astype(np.int32) - lt.astype(np.int32))
    within, mean_max = LDR_TOL[name]
    assert np.mean(diff.max(-1) <= 2) >= within, np.mean(diff.max(-1) <= 2)
    assert diff.mean() <= mean_max, diff.mean()


def test_cpu_frame_counts_no_kernel_launch(tmp_path):
    """On CPU tensors the wrappers run the plain versions: no launch."""
    k1, k4 = trk.launches, tbeam.launches
    r = TorchRenderer(Config(scene="cube", width=64, height=48,
                             cache_dir=str(tmp_path)), device="cpu")
    r.render_frame()
    r.shutdown()
    assert (trk.launches, tbeam.launches) == (k1, k4)
    assert len([p for p in r.graph.passes if p.enabled]) == 13   # cube: no masked/transparent


@pytest.mark.parametrize("opt", [
    dict(envmap="sky.hdr"), dict(csm_debug=True),
    dict(mode="path_tracer", envmap="sky.hdr"),
    dict(keep_hdr=True), dict(render_scale=0.5), dict(tex_streaming=True),
    dict(execute_per_pass=True), dict(debug_view="ssgi_radiance")])
def test_unported_options_raise(tmp_path, opt):
    cfg = Config(scene="cube", width=64, height=48, cache_dir=str(tmp_path), **opt)
    with pytest.raises(NotImplementedError):
        TorchRenderer(cfg, device="cpu")


def test_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        TorchRenderer(Config(scene="cube", width=64, height=48,
                             cache_dir=str(tmp_path)), device="cuda")


@pytest.mark.cuda
def test_cuda_frame_matches_cpu(cuda_device, tmp_path):
    cfg = Config(scene="stress:2", width=128, height=96, cache_dir=str(tmp_path))
    rc = TorchRenderer(cfg, device="cpu")
    rg = TorchRenderer(cfg, device=cuda_device)
    for _ in range(2):
        lc = rc.render_frame().numpy()
        lg = rg.render_frame().cpu().numpy()
    rc.shutdown()
    rg.shutdown()
    diff = np.abs(lc.astype(np.int32) - lg.astype(np.int32)).max(-1)
    assert np.mean(diff <= 2) >= 0.99
