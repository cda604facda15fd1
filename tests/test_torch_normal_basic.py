"""The NormalBasic frame of the PyTorch port against the JAX package on the
CPU: the blue-noise copy and the joint bilateral upsample on the same
inputs, and the whole frame with no indirect mode (cascaded shadow maps
and contact shadows) against the JAX Renderer (stress:2, 96x64, two
frames). Its SSGI and DDGI modes are in tests/test_torch_ssgi.py and
tests/test_torch_ddgi.py, the shadow path's parts in tests/test_torch_csm.py.

The frames differ where the two CPU paths differ (see test_torch_frame.py:
the JAX raster and shadow atlas take their XLA segment-max branches), hence
the LDR bounds of test_torch_frame.py for stress scenes."""

import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.config import Config as JaxConfig
from hobbyrenderer_tpu.ops import upsample as jup
from hobbyrenderer_tpu.renderer import Renderer as JaxRenderer
from hobbyrenderer_tpu.utils import bluenoise as jbn
from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.ops import raster_kernel as trk
from hobbyrenderer_tpu_torch.ops import upsample as tup
from hobbyrenderer_tpu_torch.renderer import Renderer as TorchRenderer
from hobbyrenderer_tpu_torch.utils import bluenoise as tbn
from tests.torch_parity import same_mesh_cooker

W, H = 96, 64
FRAMES = 2
LDR_TOL = (0.97, 1.5)     # test_torch_frame.py's stress bounds
PASSES = ["Culling", "Raster", "HZBBuild", "RasterPhase2", "ResolveGBuffer", "MaskedLayer",
          "ShadowCSM", "IBL", "DeferredLighting", "Sky", "TAA", "AutoExposure", "Bloom",
          "Tonemap"]


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


def test_blue_noise_copy_matches_jax():
    for seed in (0, 1):
        np.testing.assert_array_equal(tbn.blue_noise(seed), jbn.blue_noise(seed=seed))
    bn = jbn.blue_noise(seed=1)
    for frame in (0, 5, 1234567, 0xFFFFFFFF):
        want = np.asarray(jbn.animate(bn, np.uint32(frame)))
        got = tbn.animate(torch.as_tensor(bn), frame).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tbn.tile_for(torch.as_tensor(bn), 70, 130).numpy(),
                                  np.asarray(jbn.tile_for(bn, 70, 130)))


def test_joint_bilateral_upsample_matches_jax():
    rng = np.random.default_rng(5)
    s, hg, wg = 4, 16, 24
    q = rng.uniform(0, 2, (hg, wg, 3)).astype(np.float32)
    f_depth = rng.uniform(0.2, 1.0, (hg * s, wg * s)).astype(np.float32)
    f_nrm = rng.normal(size=(hg * s, wg * s, 3)).astype(np.float32)
    f_nrm /= np.linalg.norm(f_nrm, axis=-1, keepdims=True)
    q_valid = rng.random((hg, wg)) < 0.85
    args = (q, f_depth[::s, ::s], f_nrm[::s, ::s], q_valid, f_depth, f_nrm)
    want = np.asarray(jup.joint_bilateral_upsample(*args, s))
    got = tup.joint_bilateral_upsample(*(torch.as_tensor(a) for a in args), s).numpy()
    assert got.shape == (hg * s, wg * s, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_normal_basic_frame_matches_jax(tmp_path):
    k5 = trk.tiles_launches
    kw = dict(scene="stress:2", width=W, height=H, mode="normal_basic", cache_dir=str(tmp_path))
    jr = JaxRenderer(JaxConfig(**kw))
    tr = TorchRenderer(Config(**kw), device="cpu")
    for _ in range(FRAMES):
        lj, lt = np.asarray(jr.render_frame()), tr.render_frame().numpy()
        assert lt.shape == lj.shape and lt.dtype == np.uint8
        diff = np.abs(lj.astype(np.int32) - lt.astype(np.int32))
        within, mean_max = LDR_TOL
        assert np.mean(diff.max(-1) <= 2) >= within, np.mean(diff.max(-1) <= 2)
        assert diff.mean() <= mean_max, diff.mean()
    jr.shutdown()
    tr.shutdown()
    enabled = [p.name for p in tr.graph.passes if p.enabled]
    assert enabled == [p.name for p in jr._model.graph.passes if p.enabled] == PASSES
    # no RT scene in NormalBasic without DDGI, and no launch on the CPU
    assert tr._model.rt is None
    assert trk.tiles_launches == k5
