"""An animated emissive strength relights the scene in the PyTorch port
(the counterpart of tests/test_loader.py::
test_animated_emissive_relights_scene_e2e), against the JAX Renderer on
the CPU: the same floor-and-lamp scene built by each package
(tests/torch_parity.py::emissive_pulse_scene), Normal mode with ReSTIR DI,
64x48, 3 frames of 0.5 s (the lamp at 8.25x, 15.5x and 22.75x). Each
frame's dirty material re-reads the light pool's radiance
(refresh_pool_emissive), so the light the lamp casts follows it: the
port's linear HDR frame brightens every frame, by over 1.5x from 0.5 s to
1.5 s (TAA carries most of the previous frames; the JAX test, 31 frames
of 0.05 s, asks 2x of its own), and its mean at 1.5 s is within 1% of the
JAX frame's.

Gate: test_torch_frame.py's stress bounds, >= 97% of LDR pixels within
2/255 and mean |delta| <= 1.5 (measured: 100% of the 3 frames, max 1)."""

import pytest
import torch

from tests.torch_parity import emissive_pulse_scene, frames_beside_jax, ldr_agreement, \
    same_mesh_cooker

W, H = 64, 48
FRAMES = 3
LDR_TOL = (0.97, 1.5)
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
        # a scene key of its own: the saved camera of another scene must not apply
        kw = dict(scene="__emissive_e2e__", width=W, height=H, direct_mode="restir",
                  keep_hdr=True, cache_dir=str(tmp_path_factory.mktemp("torch_emissive")))
        scenes = (emissive_pulse_scene("hobbyrenderer_tpu"),
                  emissive_pulse_scene("hobbyrenderer_tpu_torch"))
        _CACHE.update(zip(("jr", "tr", "ldr_j", "ldr_t", "stats"),
                          frames_beside_jax(kw, FRAMES, scenes=scenes, dt=0.5)))
    return _CACHE


@pytest.mark.parametrize("frame", range(FRAMES), ids=[f"frame{i + 1}" for i in range(FRAMES)])
def test_emissive_anim_frame_matches_jax(frames, frame):
    within, mean, _ = ldr_agreement(frames["ldr_j"][frame], frames["ldr_t"][frame])
    assert within >= LDR_TOL[0], within
    assert mean <= LDR_TOL[1], mean


def test_animated_emissive_relights_scene(frames):
    """The cast light brightens with the lamp; every frame refreshed the
    pool (one host round trip for the power CDF each)."""
    stats = frames["stats"]
    means = [s["hdr_mean"] for s in stats]
    assert means[0] < means[1] < means[2] and means[2] > 1.5 * means[0], means
    want = float(frames["jr"]._model.last_stats["hdr_frame"].mean())
    assert means[2] == pytest.approx(want, rel=0.01)
    assert [s["pool_cdf_host_syncs"] for s in stats] == [1, 2, 3]
    pool = frames["tr"]._model.rt.lights
    assert float(pool.em_rad.max()) == pytest.approx(4.0 * 22.75, rel=1e-6)
