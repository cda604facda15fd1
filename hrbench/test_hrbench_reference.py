"""The plain reference on a small stress scene: its world triangles, its
brute-force hits, its random numbers, light pool and sky agree with what
the program builds (the program is the witness here; the reference never
reads it)."""

import dataclasses

import numpy as np
import pytest
import torch

from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.models.scene_rt import build_scene_rt
from hobbyrenderer_tpu_torch.ops import atmosphere, bvh16 as b16
from hobbyrenderer_tpu_torch.scene.gpu import build_scene_gpu
from hobbyrenderer_tpu_torch.scene.procedural import make_stress_scene
from hobbyrenderer_tpu_torch.utils import rng

from hrbench import ref_path, ref_sky, reference

SETTINGS = {"sun_intensity": 10.0, "sun_color": [1.0, 1.0, 1.0],
            "sun_angular_radius": 0.004675}


def _scene():
    return make_stress_scene(grid=2, seed=7)


def _rays(n, seed):
    g = torch.Generator().manual_seed(seed)
    o = torch.rand((n, 3), generator=g) * torch.tensor([6.0, 3.0, 6.0]) \
        - torch.tensor([3.0, -0.2, 3.0])
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    return o, d


def test_world_triangles_match_the_program_at_load():
    sc = _scene()
    snap = reference.snapshot_scene(sc)
    tris = reference.world_triangles(snap, "cpu").numpy()
    rt = build_scene_rt(sc, "cpu")
    # the program subdivides large triangles: compare total area
    prog = rt.split_world0.numpy()

    def area(t):
        return 0.5 * np.linalg.norm(np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]), axis=1).sum()
    assert area(tris) == pytest.approx(area(prog), rel=1e-5)
    assert int(rt.split_to_orig.max()) + 1 == tris.shape[0]


@pytest.mark.parametrize("any_hit", [False, True])
def test_brute_force_agrees_with_the_programs_walk(any_hit):
    sc = _scene()
    snap = reference.snapshot_scene(sc)
    tris = reference.world_triangles(snap, "cpu")
    rt = build_scene_rt(sc, "cpu", gpu=None)
    bvh = b16.bvh16_from_numpy(b16.build_bvh16_arrays(rt.split_world0.numpy()),
                               rt.split_world0.shape[0], "cpu")
    o, d = _rays(600, 3)
    t_max = torch.full((600,), 30.0)
    best_t, best_tri, _ = b16.bvh16_walk(bvh.table, o, d, t_max, any_hit=any_hit)
    ref = reference.trace(tris, o, d, torch.full((600,), 1e-4), t_max, any_hit=any_hit)
    hit = best_tri >= 0
    assert (hit == torch.isfinite(ref)).float().mean() >= 0.995
    if not any_hit:
        both = hit & torch.isfinite(ref)
        gap = (best_t[both] - ref[both]).abs() / ref[both].clamp(min=1.0)
        assert float((gap > 1e-4).float().mean()) <= 0.005


def test_bfloat16_reference_departs():
    sc = _scene()
    tris = reference.world_triangles(reference.snapshot_scene(sc), "cpu")
    o, d = _rays(400, 4)
    lo, hi = torch.full((400,), 1e-4), torch.full((400,), 30.0)
    t32 = reference.trace(tris, o, d, lo, hi)
    t16 = reference.trace(tris, o, d, lo, hi, dtype=torch.bfloat16)
    both = torch.isfinite(t32) & torch.isfinite(t16)
    assert both.sum() > 50
    assert float(((t16[both] - t32[both]).abs() / t32[both].clamp(min=1.0) > 1e-4)
                 .float().mean()) > 0.3


def test_random_numbers_are_the_programs():
    g = torch.Generator().manual_seed(5)
    v = torch.randint(0, 1 << 32, (1000, 3), generator=g, dtype=torch.int64)
    ref = torch.stack(ref_path.pcg3d(v[:, 0], v[:, 1], v[:, 2]), -1)
    assert torch.equal(ref, rng.pcg3d(v))


def test_light_pool_selects_as_the_program():
    sc = make_stress_scene(grid=4, seed=7, lod_rich=False)
    snap = reference.snapshot_scene(sc)
    W = ref_path.World(snap, SETTINGS, "cpu")
    gpu = build_scene_gpu(sc, "cpu")
    pool = build_scene_rt(sc, "cpu", gpu=gpu).lights
    live = pool.power_pdf > 0
    torch.testing.assert_close(W.pdf, pool.power_pdf[live], rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(W.cdf, pool.power_cdf[live], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(W.em_rad, pool.em_rad[:W.em_rad.shape[0]])


def test_sky_is_the_programs():
    d = torch.nn.functional.normalize(torch.randn((500, 3), generator=torch.Generator()
                                                  .manual_seed(2)), dim=-1)
    sun = torch.nn.functional.normalize(torch.tensor([0.35, -0.75, 0.45]), dim=0)
    s = dataclasses.replace(Config().settings, **SETTINGS)
    for disk in (False, True):
        torch.testing.assert_close(ref_sky.sky_radiance(d, sun, SETTINGS, disk),
                                   atmosphere.sky_radiance_lut(d, sun, s, with_sun_disk=disk))
