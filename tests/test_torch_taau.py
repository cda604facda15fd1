"""TAA upscaling in the PyTorch port against the JAX package on the CPU.

taau_resolve: random frames, motion and jitter at 2x upscaling (and a
non-integer 1.5x), every output row and column compared, the first and
the last included, with and without history. The linear resample is
written as taps per axis where JAX runs jax.image.scale_and_translate's
weight matrices through an einsum (the same weights, at most two taps each
side, summed in another association, some products fused by XLA:CPU), so
the resampled frame and motion differ by an ulp or two. The history is
then fetched at the resampled motion; a random history has gradients up
to 4 a pixel, so the outputs (values in [0, 4]) agree within 1e-5
relative + 4e-5 absolute (measured: 2.1e-5 at most).

The NormalBasic frame at render_scale 0.5 (stress:2, 96x64 output, 48x32
render) against the JAX Renderer, 3 frames: test_torch_normal_basic.py's
gate, >= 97% of LDR pixels within 2/255 and mean |delta| <= 1.5 (measured:
99.95-99.97%, mean |delta| 0.002-0.004, max 5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.config import RenderSettings as JaxSettings
from hobbyrenderer_tpu.ops import taa as jtaa
from hobbyrenderer_tpu_torch.config import RenderSettings
from hobbyrenderer_tpu_torch.ops import taa as ttaa
from tests.torch_parity import frames_beside_jax, ldr_agreement, same_mesh_cooker

W, H = 96, 64
FRAMES = 3
LDR_TOL = (0.97, 1.5)     # test_torch_normal_basic.py's (test_torch_frame.py's stress bounds)
KW = dict(scene="stress:2", width=W, height=H, mode="normal_basic", render_scale=0.5)
RTOL, ATOL = 1e-5, 4e-5
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


@pytest.mark.parametrize("valid", [True, False], ids=["history", "first_frame"])
@pytest.mark.parametrize("size", [(24, 36, 48, 72), (20, 30, 30, 45)], ids=["2x", "1.5x"])
def test_taau_resolve_matches_jax(size, valid):
    h, w, oh, ow = size
    rng = np.random.default_rng(h + ow)
    hdr = (rng.random((h, w, 3)) * 4).astype(np.float32)
    hist = (rng.random((oh, ow, 3)) * 4).astype(np.float32)
    motion = rng.normal(0, 1.5, (h, w, 2)).astype(np.float32)
    for _ in range(2):
        jit = rng.uniform(-0.5, 0.5, 2).astype(np.float32)
        settings = RenderSettings(sharpness=0.3)
        got = ttaa.taau_resolve(torch.as_tensor(hdr), torch.as_tensor(hist),
                                torch.as_tensor(motion), valid, settings,
                                (float(jit[0]), float(jit[1])), oh, ow).numpy()
        want = np.asarray(jtaa.taau_resolve(jnp.asarray(hdr), jnp.asarray(hist),
                                            jnp.asarray(motion), jnp.bool_(valid),
                                            JaxSettings(sharpness=0.3), jnp.asarray(jit),
                                            oh, ow))
        assert got.shape == want.shape == (oh, ow, 3)
        for rows in (slice(0, 1), slice(oh - 1, oh), slice(None)):
            np.testing.assert_allclose(got[rows], want[rows], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[:, [0, -1]], want[:, [0, -1]], rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    if not _CACHE:
        kw = dict(KW, cache_dir=str(tmp_path_factory.mktemp("torch_taau")))
        _CACHE.update(zip(("jr", "tr", "ldr_j", "ldr_t", "stats"), frames_beside_jax(kw, FRAMES)))
    return _CACHE


@pytest.mark.parametrize("frame", range(FRAMES), ids=[f"frame{i + 1}" for i in range(FRAMES)])
def test_upscaled_normal_basic_frame_matches_jax(frames, frame):
    lj, lt = frames["ldr_j"][frame], frames["ldr_t"][frame]
    assert lt.shape == (H, W, 3)
    within, mean, _ = ldr_agreement(lj, lt)
    assert within >= LDR_TOL[0], within
    assert mean <= LDR_TOL[1], mean


def test_upscaled_frame_sizes(frames):
    """The passes up to Transparent at the render size, TAA's history and
    the post passes at the output size."""
    tr = frames["tr"]
    assert tr._model.state["taa_history"].shape == (H, W, 3)
    assert (tr._model.width, tr._model.height) == (W // 2, H // 2)
    assert [p.name for p in tr.graph.passes if p.enabled] == \
        [p.name for p in frames["jr"]._model.graph.passes if p.enabled]
