"""The port's tracer (utils/timing.py) on the CPU: spans nest and reach a
torch.profiler trace, set-up spans stay out of the frames, host syncs are
counted into the innermost open span, a traced frame keeps the program's
counts and an untraced one keeps none; and the path tracer's per-bounce
counters on a 64x36, 1-spp, 8-bounce frame with its wavefront compacted."""

import warnings

import pytest
import torch

from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.models import pathtracer as tpt
from hobbyrenderer_tpu_torch.ops import atmosphere as atm
from hobbyrenderer_tpu_torch.renderer import Renderer
from hobbyrenderer_tpu_torch.utils.timing import PROFILER, FrameProfiler


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test worker: the plain versions' many small ops
    otherwise oversubscribe the cores the workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_spans_nest_and_appear_in_a_profiler_trace():
    prof = FrameProfiler()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        with prof.frame():
            with prof.span("Frame/Outer"):
                with prof.span("PT inner"):
                    torch.ones(4).sum()
                with prof.span("PT inner"):
                    pass
    (rec,) = prof.frames
    assert rec.profiled and rec.index == 0
    assert [(s.name, s.parent) for s in rec.spans] == [
        ("Frame/Outer", None), ("PT inner", "Frame/Outer"), ("PT inner", "Frame/Outer")]
    outer, a, b = rec.spans
    assert outer.host_ms >= a.host_ms + b.host_ms >= 0.0
    assert prof.history == [{"Frame/Outer": outer.host_ms, "PT inner": a.host_ms + b.host_ms}]
    names = [e.name for e in p.events()]
    assert names.count("Frame/Outer") == 1 and names.count("PT inner") == 2


def test_setup_spans_stay_out_of_the_first_frame():
    prof = FrameProfiler()
    with prof.span("Init/Upload"):
        pass
    with prof.frame():
        with prof.span("Frame/Render"):
            pass
    assert list(prof.setup) == ["Init/Upload"]
    assert list(prof.history[0]) == ["Frame/Render"]
    assert "Init/Upload" in prof.table() and "Frame/Render" in prof.table()


def test_syncs_are_counted_in_the_innermost_open_span():
    prof = FrameProfiler()
    prof.enabled = True
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with prof.frame():
            prof.note_sync()
            with prof.span("Frame/ViewConstants"):
                prof.note_sync()
                with prof.span("PT setup"):
                    # the sync-debug mode's warning: counted, not shown
                    warnings.warn("called a synchronizing CUDA operation")
                    prof.note_sync()
                warnings.warn("another warning")
    (rec,) = prof.frames
    assert not rec.profiled
    assert [(s.name, s.syncs) for s in rec.spans] == [("Frame/ViewConstants", 1),
                                                      ("PT setup", 2)]
    assert rec.syncs_outside == 1 and rec.host_syncs == 4
    assert [str(w.message) for w in shown] == ["another warning"]
    assert prof.sync_summary() == {"Frame/ViewConstants": 1.0, "PT setup": 2.0,
                                   "(outside spans)": 1.0}


def test_only_a_traced_frame_keeps_counts():
    prof = FrameProfiler()
    with prof.frame():
        prof.note_sync()
        prof.count(["a", "b"], torch.tensor([1, 2]))
    assert prof.frames == [] and len(prof.history) == 1
    prof.enabled = True
    with prof.frame():
        prof.count(["a", "b"], torch.tensor([1, 2]))
        prof.count(["w"], [7])
    prof.count(["x"], [1])                    # outside a frame: dropped
    assert prof.frames[0].counts() == {"a": 1, "b": 2, "w": 7}


def test_pt_frame_counters(monkeypatch, tmp_path):
    """The per-bounce live lanes sum to Renderer.stats()'s K3 lanes, each
    bounce's width is the capacity trace_paths computes, and every _bounce
    call carries its wavefront and bounce at positions 5 and 6 (the
    benchmark's check wraps it so)."""
    monkeypatch.setattr(tpt, "COMPACT_MIN_LANES", 1024)
    monkeypatch.setattr(tpt, "COMPACT_MIN_CAP", 256)
    # the sky only adds radiance, which no lane count reads: a zero
    # multiple-scattering table stands in for the 3.5 s numpy build
    monkeypatch.setattr(atm, "device_tables", lambda device: {
        "beta_r": torch.as_tensor(atm.BETA_R, device=device),
        "beta_o": torch.as_tensor(atm.BETA_O, device=device),
        "multiscatter": torch.zeros((atm.MS_RES, atm.MS_RES, 3), device=device)})
    seen = []
    real = tpt._bounce

    def spy(*args):
        p, b = args[5], args[6]
        seen.append((b, int(p.active.shape[0]), int(p.active.sum())))
        return real(*args)
    monkeypatch.setattr(tpt, "_bounce", spy)
    W, H, B = 64, 36, 8
    r = Renderer(Config(scene="cube", width=W, height=H, mode="path_tracer", pt_spp=1,
                        cache_dir=str(tmp_path)), device="cpu")
    n0 = len(PROFILER.frames)
    monkeypatch.setattr(PROFILER, "enabled", True)
    r.render_frame()
    stats = r.stats()
    r.shutdown()
    (rec,) = PROFILER.frames[n0:]
    counts = rec.counts()
    RS, cur, want = W * H, W * H, []
    for b in range(B):
        if b >= tpt.COMPACT_START:
            frac = tpt.CAP_FRACS[min(b - tpt.COMPACT_START, len(tpt.CAP_FRACS) - 1)]
            cur = min(max((int(RS * frac) // 1024) * 1024, tpt.COMPACT_MIN_CAP), cur)
        want.append(cur)
    assert [s[0] for s in seen] == list(range(B))
    assert [counts[f"pt_width_{b}"] for b in range(B)] == [s[1] for s in seen] == want
    assert want[-1] < RS                       # the wavefront was compacted
    assert [counts[f"pt_live_{b}"] for b in range(B)] == [s[2] for s in seen]
    assert sum(counts[f"pt_live_{b}"] for b in range(B)) == stats["rt_k3_lanes_pt"] > RS
    assert sum(counts[f"pt_nee_{b}"] for b in range(B)) == stats["rt_k3_lanes_pt_nee"] > 0
    assert sum(counts[f"pt_capped_{b}"] for b in range(B)) == stats["rt_k3_capped_pt"]
    assert counts["pt_dropped_lanes"] == stats["pt_dropped_lanes"]
    parents = {s.name: s.parent for s in rec.spans}
    for name in ("PT setup", "PT bounce 0", "PT compact 3", "PT gather", "PT accumulate"):
        assert parents[name] == "Frame/Render", name
    assert parents["Frame/Render"] is None
