"""What a configuration's and a mix's own files decide, driven on the CPU at
the small size of ``test_hrbench_faults``: the scene kind and the reference
are found by name, and the frames the checked average holds come from the
mix alone, with the program's own count held to them.

Each run reads a temporary manifest with one cell, the ``pathtracer``
configuration under a mix made from ``still``, handed to ``run(...,
root=)``."""

import copy
import json
import os

import pytest

from hobbyrenderer_tpu_torch.models import pathtracer
from hobbyrenderer_tpu_torch.renderer import Renderer

from hrbench import run as hr, traffic as traffic_mod
from hrbench.test_hrbench_faults import SMALL

SEED = 987654321987
REAL_RENDER = pathtracer.PathTracerRenderer.render


def rehearsal_root(tmp, camera=None, mix=None, conf=None) -> str:
    """A checkout holding a manifest whose one cell, ``pt.rehearsal``, runs
    the ``pathtracer`` configuration (its keys updated by ``conf``) under
    the ``still`` mix (its camera updated by ``camera``, its keys by
    ``mix``); the harness's code stays the repository's."""
    man = hr.load_manifest()
    entry = next(c for c in man["configs"] if c["name"] == "pathtracer")
    with open(os.path.join(hr.ROOT, entry["file"])) as f:
        c = dict(json.load(f), **(conf or {}))
    m = copy.deepcopy(traffic_mod.load("still"))
    m["camera"].update(camera or {})
    m.update(mix or {})
    harness = os.path.basename(hr.HERE)
    os.makedirs(os.path.join(tmp, os.path.dirname(entry["file"])), exist_ok=True)
    os.makedirs(os.path.join(tmp, harness, "traffic"), exist_ok=True)
    with open(os.path.join(tmp, entry["file"]), "w") as f:
        json.dump(c, f)
    with open(os.path.join(tmp, harness, "traffic", "rehearsal.json"), "w") as f:
        json.dump(m, f)
    cell = dict(name="pt.rehearsal", config="pathtracer", traffic="rehearsal", chips=1,
                why="a rehearsal of the harness")
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(dict(man, workloads=[cell]), f)
    return str(tmp)


def _run(root, **kw):
    return hr.run("pt.rehearsal", SEED, 0.0, False, device="cpu", overrides=SMALL, root=root,
                  **kw)[0]


def _over(out, number):
    c = out["checks"][number]
    return c["value"] > c["limit"]


def test_a_moving_camera_reads_correct(tmp_path):
    out = _run(rehearsal_root(tmp_path, camera={"deg_per_frame": 2.0}))
    assert out["correct"], out["checks"]


def test_a_moving_camera_checked_as_if_it_accumulated_is_not_correct(tmp_path, monkeypatch):
    """The rule before the mix decided: every frame since the first counted."""
    root = rehearsal_root(tmp_path, camera={"deg_per_frame": 2.0})
    monkeypatch.setattr(traffic_mod.Traffic, "accumulated_before", lambda self, frame: frame)
    out = _run(root)
    assert not out["correct"] and _over(out, "pixel_bad_share"), out["checks"]


def _accum_ahead(self, *args, **kwargs):
    """The program's count of accumulated frames one ahead from the second
    frame after a restart on."""
    if self.num_accum == self.spp:
        self.num_accum += self.spp
    return REAL_RENDER(self, *args, **kwargs)


def test_a_program_count_off_by_one_is_not_correct(tmp_path, monkeypatch):
    monkeypatch.setattr(pathtracer.PathTracerRenderer, "render", _accum_ahead)
    out = _run(rehearsal_root(tmp_path))
    assert not out["correct"] and _over(out, "chain_bad_share"), out["checks"]


def test_a_mix_that_restarts_every_frame_holds_the_program_to_it(tmp_path):
    """Under a still camera the program accumulates on; a mix that says
    each frame stands alone reads it not correct."""
    out = _run(rehearsal_root(tmp_path, mix={"accumulation": "restart_every_frame"}))
    assert not out["correct"] and _over(out, "chain_bad_share"), out["checks"]


@pytest.mark.parametrize("conf,words", [
    ({"scene": {"kind": "nosuch", "grid": 12, "seed": 7}}, ["nosuch", "stress"]),
    ({"reference": "ref_nosuch"}, ["ref_nosuch", "ref_path"]),
    ({"reference": "reference"}, ["'reference'", "ref_path"]),
    ({"renderer": {"mode": "path_tracer", "scene": "cube"}}, ["both set scene"]),
], ids=["kind", "reference", "not_a_reference", "renderer_sets_the_kinds_key"])
def test_what_a_configuration_cannot_name_stops_the_run_before_its_first_frame(
        tmp_path, monkeypatch, conf, words):
    frames = []
    monkeypatch.setattr(Renderer, "render_frame", lambda self, dt=0.0: frames.append(dt))
    with pytest.raises(ValueError) as err:
        _run(rehearsal_root(tmp_path, conf=conf))
    assert frames == []
    assert all(w in str(err.value) for w in words), str(err.value)


def test_an_unknown_accumulation_is_refused():
    mix = dict(traffic_mod.load("still"), accumulation="sometimes")
    with pytest.raises(ValueError, match="restart_every_frame"):
        traffic_mod.Traffic(mix, SEED)


@pytest.mark.parametrize("camera,mix,frames", [
    ({}, {}, [0, 1, 2, 4]),
    ({"deg_per_frame": 2.0}, {}, [0, 0, 0, 0]),
    ({}, {"accumulation": "restart_every_frame"}, [0, 0, 0, 0]),
], ids=["still", "moving", "restart_every_frame"])
def test_the_frames_an_average_holds_come_from_the_mix(camera, mix, frames):
    m = copy.deepcopy(traffic_mod.load("still"))
    m["camera"].update(camera)
    m.update(mix)
    t = traffic_mod.Traffic(m, SEED)
    assert [t.accumulated_before(k) for k in (0, 1, 2, 4)] == frames
