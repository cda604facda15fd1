"""The check has to fail: the rest of a run driven on the CPU at a small
size (the harness's look for a chip skipped), with the timed path broken
underneath, and with the control (the bfloat16 reference in the program's
place), reads ``correct`` false; the sound run reads true.

The size keeps the path tracer's wavefront compaction on (128 x 72 x 4
lanes is over its 32,768-lane threshold)."""

import pytest
import torch

from hobbyrenderer_tpu_torch.models import pathtracer
from hobbyrenderer_tpu_torch.ops import bvh16

from hrbench import run as hr

SMALL = {"width": 128, "height": 72, "grid": 6, "lod_rich": False}
REAL_WALK = bvh16.bvh16_walk
REAL_BOUNCE = pathtracer._bounce
REAL_COMPACT = pathtracer._compact
REAL_TRACE = pathtracer.trace_paths


def _unchanged(table, o, d, t_max, any_hit, max_steps=bvh16.UNCAPPED_STEPS, t_min=1e-4):
    """A walk that returns its state as it came in: no hit, no step."""
    R = o.shape[0]
    return (t_max.clone(), torch.full((R,), -1, dtype=torch.int32),
            torch.zeros((R,), dtype=torch.int32))


def _half(table, o, d, t_max, any_hit, max_steps=bvh16.UNCAPPED_STEPS, t_min=1e-4):
    """Half of the batch left out: the second half of the rays never walks."""
    t, tri, steps = REAL_WALK(table, o, d, t_max, any_hit, max_steps, t_min)
    h = o.shape[0] // 2
    t, tri = t.clone(), tri.clone()
    t[h:] = t_max[h:]
    tri[h:] = -1
    return t, tri, steps


def _altered(table, o, d, t_max, any_hit, max_steps=bvh16.UNCAPPED_STEPS, t_min=1e-4):
    """An answer altered where it is produced: every hit 0.1% farther."""
    t, tri, steps = REAL_WALK(table, o, d, t_max, any_hit, max_steps, t_min)
    return torch.where(tri >= 0, t * 1.001, t), tri, steps


def _bounce_unchanged(gpu, rt, vc, settings, height, p, bounce, *rest):
    """A bounce that returns its state unchanged."""
    REAL_BOUNCE(gpu, rt, vc, settings, height, p, bounce, *rest)
    return p


def _bounce_altered(gpu, rt, vc, settings, height, p, bounce, *rest):
    """Radiance altered where it is produced: each bounce adds 1% more."""
    out = REAL_BOUNCE(gpu, rt, vc, settings, height, p, bounce, *rest)
    return out._replace(radiance=p.radiance + (out.radiance - p.radiance) * 1.01)


def _primary_half(gpu, rt, vc, settings, height, p, bounce, *rest):
    """Half of the batch left out: the second half of the primary wavefront
    never walks or shades."""
    if bounce == 0:
        lane = torch.arange(p.active.shape[0], device=p.active.device)
        p = p._replace(active=p.active & (lane < p.active.shape[0] // 2))
    return REAL_BOUNCE(gpu, rt, vc, settings, height, p, bounce, *rest)


def _compact_biased(p, b, cap, stats):
    """The capacity roulette without its 1 / p_keep: the kept lanes' weight
    is not restored."""
    q, selc, pad = REAL_COMPACT(p, b, cap, stats)
    return q._replace(throughput=q.throughput * 0.8), selc, pad


def _mean_over_rest(*args, **kwargs):
    """The mean over the samples taken as if half were there."""
    rad, stats = REAL_TRACE(*args, **kwargs)
    return rad * 0.5, stats


def _run(**kw):
    return hr.run("pt.still", 987654321987, 0.0, False, device="cpu", overrides=SMALL, **kw)[0]


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered], ids=lambda f: f.__name__)
def test_a_broken_walk_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(bvh16, "bvh16_walk", fault)
    out = _run()
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name,fault,number", [
    ("_bounce", _bounce_unchanged, "shade_bad_share"),
    ("_bounce", _bounce_altered, "shade_bad_share"),
    ("_bounce", _primary_half, "primary_lane_shortfall"),
    ("_compact", _compact_biased, "chain_bad_share"),
    ("trace_paths", _mean_over_rest, "pixel_bad_share"),
], ids=lambda x: x.__name__ if callable(x) else None)
def test_a_broken_path_tracer_is_not_correct(name, fault, number, monkeypatch):
    monkeypatch.setattr(pathtracer, name, fault)
    out = _run()
    assert not out["correct"], out["checks"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"], out["checks"]


def test_the_control_is_not_correct():
    out = _run(control=True)
    assert not out["correct"], out["checks"]
    assert out["checks"]["shade_bad_share"]["value"] > 0.5, out["checks"]
