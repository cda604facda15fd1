"""The deferred frame's lighting matrix in the PyTorch port: for every
(mode, direct_mode, indirect_mode) pair, and for ReGIR in both cell
layouts, the port's enabled passes equal the JAX package's graph (built by
its build_deferred_graph with the JAX Renderer's rule for the ray-tracing
scene, renderer.py:155-157; never compiled: no JAX frame runs here), the
port builds its ray-tracing scene by that rule, and one CPU frame of the
cube scene renders with a finite HDR. The image parity of the pairs that
add passes is held in tests/test_torch_sharc_frame.py,
test_torch_combined_frame.py and test_torch_normal_ddgi.py."""

import itertools

import pytest
import torch

from hobbyrenderer_tpu.config import Config as JaxConfig
from hobbyrenderer_tpu.models.deferred import build_deferred_graph
from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.renderer import INDIRECT_MODES, Renderer as TorchRenderer
from tests.torch_parity import same_mesh_cooker

W, H = 32, 24
PAIRS = [(m, d, i, False, "onion") for m, d, i in itertools.product(
    ("normal", "normal_basic", "ibl"), ("simple", "restir"), INDIRECT_MODES)]
REGIR = [("ibl", "restir", "combined", True, "onion"), ("normal", "restir", "sharc", True, "grid"),
         ("normal", "restir", "restir", True, "grid"), ("normal_basic", "restir", "none", True,
                                                         "onion")]


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


def _enabled(graph):
    return [p.name for p in graph.passes if p.enabled]


@pytest.mark.parametrize("mode,direct,indirect,regir,regir_mode", PAIRS + REGIR,
                         ids=["-".join(map(str, c[:3])) + (f"-regir_{c[4]}" if c[3] else "")
                              for c in PAIRS + REGIR])
def test_pass_matrix_matches_jax(tmp_path, mode, direct, indirect, regir, regir_mode):
    kw = dict(scene="cube", width=W, height=H, mode=mode, direct_mode=direct,
              indirect_mode=indirect, regir=regir, regir_mode=regir_mode,
              cache_dir=str(tmp_path))
    tr = TorchRenderer(Config(**kw), device="cpu")
    jc, m = JaxConfig(**kw), tr.gpu.meta
    needs_rt = mode in ("normal", "ibl") or indirect in ("ddgi", "restir")
    want = _enabled(build_deferred_graph(
        W, H, 1, mode=mode, with_rt_shadows=needs_rt, direct_mode=direct,
        indirect_mode=indirect, has_masked=m["has_masked"],
        has_transparent=m["has_transparent"], scene_radius=m["scene_radius"],
        use_regir=regir, regir_mode=regir_mode, scene_bounds=m["scene_bounds"],
        specular_indirect=jc.specular_indirect, restir_quality=jc.restir_quality,
        denoiser_profile=jc.denoiser))
    assert _enabled(tr.graph) == want
    assert (tr._model.rt is not None) == needs_rt
    tr._model.keep = ("hdr",)
    ldr = tr.render_frame()
    hdr = tr._model.last_resources["hdr"]
    tr.shutdown()
    assert tuple(ldr.shape) == (H, W, 3) and ldr.dtype == torch.uint8
    assert bool(torch.isfinite(hdr).all())
    assert float(hdr.abs().sum()) > 0


def test_set_mode_rebuilds_the_frame(tmp_path):
    """set_mode switches the graph and drops the old mode's persistent
    state (the JAX Renderer's set_mode)."""
    tr = TorchRenderer(Config(scene="cube", width=W, height=H, direct_mode="restir",
                              indirect_mode="sharc", cache_dir=str(tmp_path)), device="cpu")
    tr.render_frame()
    assert "SHARC" in _enabled(tr.graph) and "sharc_cache" in tr._model.state
    cache = tr._model.state["sharc_cache"]
    assert int((cache.key != 0).sum()) > 0
    tr.set_mode("normal_basic")
    assert "ShadowCSM" in _enabled(tr.graph) and "SHARC" not in _enabled(tr.graph)
    tr.render_frame()
    tr.set_mode("ibl")
    assert int((tr._model.state["sharc_cache"].key != 0).sum()) == 0
    tr.render_frame()
    assert "SHARC" in _enabled(tr.graph) and "RTXDI" in _enabled(tr.graph)
    tr.shutdown()
