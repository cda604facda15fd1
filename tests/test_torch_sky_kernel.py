"""The sky's in-scatter march (ops/atmosphere.py): the CUDA kernel
csrc/sky_march.cu against its plain version on the card, bit for bit (the
`cuda` tests; they skip without a GPU and import no jax, so that
`python -m pytest --noconftest tests/test_torch_sky_kernel.py -m cuda`
runs them on the card); on the CPU the plain version's mask, the path
tracer's per-bounce count of the lanes whose sky it marched, and the
benchmark's path-tracer cell rehearsed on the CPU, still correct."""

import dataclasses

import numpy as np
import pytest
import torch

from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.models import pathtracer as tpt
from hobbyrenderer_tpu_torch.ops import atmosphere as atm
from hobbyrenderer_tpu_torch.ops import sky as skyops
from hobbyrenderer_tpu_torch.ops import trace as traceops
from hobbyrenderer_tpu_torch.renderer import Renderer
from hobbyrenderer_tpu_torch.utils.timing import PROFILER

SETTINGS = dataclasses.replace(Config().settings, sun_color=(1.0, 0.9, 0.8), sun_intensity=7.5)
SUNS = {"high": (0.3, -0.8, 0.5), "low": (0.6, 0.02, -0.8)}   # sunlight's travel direction
N = 100_003          # no block of 256 divides it


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the plain versions' many small ops
    otherwise oversubscribe the cores the workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel); run by chip_smoke.py on the card")
    return torch.device("cuda")


def directions(n: int, sun, seed: int = 0) -> np.ndarray:
    """n seeded directions, not normalised: Gaussian ones (above and below
    the horizon), near-horizontal ones, and 1 in 16 inside the sun's disk."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)) * rng.uniform(0.5, 2.0, (n, 1))
    d[1::8, 1] *= 1e-3                                   # grazing the horizon
    to_sun = -np.asarray(sun) / np.linalg.norm(sun)
    k = d[::16].shape[0]
    d[::16] = to_sun + rng.normal(size=(k, 3)) * SETTINGS.sun_angular_radius * 0.5
    return d.astype(np.float32)


def _mismatch(got, ref):
    """(lanes that differ in any bit, the largest relative difference)."""
    diff = (got != ref).any(-1)
    rel = ((got - ref).abs() / ref.abs().clamp(min=1e-30)).max()
    return int(diff.sum()), float(rel)


@pytest.mark.parametrize("disk", [True, False], ids=["disk", "no_disk"])
def test_masked_plain_march(disk):
    """The mask keeps the unmasked march's values on its lanes and 0
    elsewhere; on the CPU the dispatcher is the plain version."""
    sun = torch.tensor(SUNS["high"])
    d = torch.as_tensor(directions(2048, SUNS["high"], seed=3)).reshape(32, 64, 3)
    mask = torch.as_tensor(np.random.default_rng(4).random((32, 64)) < 0.4)
    full = atm.sky_radiance_lut_reference(d, sun, SETTINGS, with_sun_disk=disk)
    got = atm.sky_radiance_lut(d, sun, SETTINGS, with_sun_disk=disk, mask=mask)
    assert got.shape == d.shape and float(full.amax()) > 0
    assert torch.equal(got[mask], full[mask])
    assert torch.equal(got[~mask], torch.zeros_like(got[~mask]))
    assert torch.equal(skyops.sky_radiance(d, sun, SETTINGS, disk), full)


def test_pt_sky_counts_the_missed_lanes(monkeypatch, tmp_path):
    """A 64x36 path-tracer frame on the CPU: the traced frame keeps
    pt_sky_b for every bounce, each the lanes that missed the scene in
    bounce b (live lanes whose closest hit found no triangle), and at most
    the bounce's live lanes; the sky reads 0 off the missed lanes."""
    monkeypatch.setattr(tpt, "COMPACT_MIN_LANES", 1024)
    monkeypatch.setattr(tpt, "COMPACT_MIN_CAP", 256)
    missed, skies = [], []
    real_hit, real_sky = traceops.closest_hit_auto, skyops.sky_radiance

    def hit_spy(rt, o, d, active=None, **kw):
        out = real_hit(rt, o, d, active=active, **kw)
        missed.append(int(((out[0].tri < 0) & active).sum()))
        return out

    def sky_spy(d, sun_dir, settings, with_sun_disk=True, mask=None):
        L = real_sky(d, sun_dir, settings, with_sun_disk, mask=mask)
        skies.append((int(mask.sum()), bool((L[~mask] == 0).all()),
                      float(L[mask].amax()) if mask.any() else 0.0))
        return L
    monkeypatch.setattr(traceops, "closest_hit_auto", hit_spy)
    monkeypatch.setattr(skyops, "sky_radiance", sky_spy)
    W, H, B = 64, 36, 8
    r = Renderer(Config(scene="cube", width=W, height=H, mode="path_tracer", pt_spp=1,
                        cache_dir=str(tmp_path)), device="cpu")
    n0 = len(PROFILER.frames)
    monkeypatch.setattr(PROFILER, "enabled", True)
    r.render_frame()
    r.shutdown()
    (rec,) = PROFILER.frames[n0:]
    counts = rec.counts()
    assert f"pt_sky_{B - 1}" in tpt.counter_names(B)
    sky = [counts[f"pt_sky_{b}"] for b in range(B)]
    assert sky == missed == [s[0] for s in skies]
    assert sky[0] > 0 and all(s[1] for s in skies) and skies[0][2] > 0
    assert all(counts[f"pt_sky_{b}"] <= counts[f"pt_live_{b}"] for b in range(B))


def test_pt_still_rehearsal_is_correct():
    """The benchmark's path-tracer cell driven on the CPU at a small size
    (its check against the plain reference, the sky included) reads correct."""
    from hrbench import run as hr
    out = hr.run("pt.still", 2147483659, 0.0, False, device="cpu",
                 overrides={"width": 128, "height": 72, "grid": 6, "lod_rich": False})[0]
    assert out["correct"], out["checks"]


# ---- the kernel on the card --------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("sun", sorted(SUNS))
@pytest.mark.parametrize("disk", [True, False], ids=["disk", "no_disk"])
def test_cuda_sky_kernel_matches_plain(cuda_device, sun, disk):
    """100,003 directions (a count no block divides), inside the sun's
    disk too: the kernel equals the plain march on the card bit for bit,
    and a second launch gives the same bits."""
    s = torch.tensor(SUNS[sun], device=cuda_device)
    d = torch.as_tensor(directions(N, SUNS[sun])).to(cuda_device)
    n0 = atm.launches
    got = atm.sky_radiance_lut(d, s, SETTINGS, with_sun_disk=disk)
    again = atm.sky_radiance_lut(d, s, SETTINGS, with_sun_disk=disk)
    ref = atm.sky_radiance_lut_reference(d, s, SETTINGS, with_sun_disk=disk)
    torch.cuda.synchronize()
    assert atm.launches == n0 + 2
    assert torch.equal(got, again)
    assert _mismatch(got, ref) == (0, 0.0)


@pytest.mark.cuda
def test_cuda_sky_kernel_strided_grid(cuda_device):
    """sky_radiance_fast's strided 1/4 grid of a direction image goes in as
    it is: the kernel equals the plain march on the same view."""
    s = torch.tensor(SUNS["high"], device=cuda_device)
    img = torch.as_tensor(directions(270 * 480, SUNS["high"], seed=1)).reshape(270, 480, 3)
    view = img.to(cuda_device)[::4, ::4][:67, :120]
    assert not view.is_contiguous()
    got = atm.sky_radiance_lut(view, s, SETTINGS, with_sun_disk=False)
    ref = atm.sky_radiance_lut_reference(view, s, SETTINGS, with_sun_disk=False)
    assert got.shape == view.shape
    assert _mismatch(got.reshape(-1, 3), ref.reshape(-1, 3)) == (0, 0.0)


@pytest.mark.cuda
def test_cuda_sky_kernel_mask_without_a_sync(cuda_device):
    """A mask keeping ~40% of the lanes: those equal the unmasked march,
    the others read exactly 0; the call makes no host sync."""
    s = torch.tensor(SUNS["high"], device=cuda_device)
    d = torch.as_tensor(directions(N, SUNS["high"], seed=2)).to(cuda_device)
    mask = torch.as_tensor(np.random.default_rng(5).random(N) < 0.4).to(cuda_device)
    full = atm.sky_radiance_lut(d, s, SETTINGS)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = atm.sky_radiance_lut(d, s, SETTINGS, mask=mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = atm.sky_radiance_lut_reference(d, s, SETTINGS, mask=mask)
    assert torch.equal(got[mask], full[mask])
    assert torch.equal(got[~mask], torch.zeros_like(got[~mask]))
    assert _mismatch(got, ref) == (0, 0.0)
