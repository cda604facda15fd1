"""Per-pass profile of the port's frame on the GPU.

    python -m hobbyrenderer_tpu_torch.profile_frame --scene stress \
        [--direct-mode restir] [--indirect-mode restir] \
        [--mode normal_basic --indirect-mode ddgi] [--mode path_tracer] [--frames 8]
    python -m hobbyrenderer_tpu_torch.profile_frame --mode ibl --direct-mode restir \
        --indirect-mode combined --regir

Renders ``--frames`` frames and prints, per pass: the stream time (CUDA
events around each pass, median over the frames after the first) and the
device time of the kernels that ran inside it (a torch.profiler trace of
the last 3 frames: kernels that start inside the pass's device-side
record_function range, / 3). A path-tracer frame (960x540 unless a size
is given) has no passes: its rows are the bounces, each split into its two
K3 walks (closest hit, NEE any hit) and the shading around them, and the
wavefront compactions.
Then the frame time (host clock with a synchronize, median after the
first), the kernels per frame, and the device's busy share of the traced
frames (kernel time / wall time). The first line is the card's name and
power limit. Needs a GPU."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
import warnings

import torch


def time_passes(graph, strict=(), watch=(), syncs=None):
    """Wrap every enabled pass of ``graph`` with CUDA events recorded on the
    stream (no host sync); the passes named in ``strict`` also run under
    ``torch.cuda.set_sync_debug_mode("error")``, so a host sync inside
    them raises, and those in ``watch`` under "warn", counting their host
    syncs into ``syncs`` {pass: n}. Returns {pass: [(start, end) event
    pairs, one per frame]}."""
    events = {}

    def wrap(ps):
        fn = ps.fn

        def run(ctx, res):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            if ps.name in watch:
                with warnings.catch_warnings(record=True) as seen:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        fn(ctx, res)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                if syncs is not None:
                    syncs[ps.name] = syncs.get(ps.name, 0) + sum(
                        "synchroniz" in str(w.message) for w in seen)
            elif ps.name in strict:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    fn(ctx, res)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            else:
                fn(ctx, res)
            e1.record()
            events.setdefault(ps.name, []).append((e0, e1))
        return run

    for ps in graph.passes:
        if ps.enabled:
            ps.fn = wrap(ps)
    return events


def median_ms(pairs, skip: int = 1) -> float:
    """Median elapsed ms of event pairs after the first ``skip``."""
    return round(statistics.median(e0.elapsed_time(e1) for e0, e1 in pairs[skip:]), 3)


def _in(k, rng):
    return rng.time_range.start <= k.time_range.start < rng.time_range.end


def _pt_rows(dev_events, frames: int):
    """Per-bounce kernel ms of a path-tracer trace (ms a frame): the 'PT
    bounce b' and 'PT compact b' ranges, each bounce split into its two K3
    walks (the bvh16 walk kernels in the range, in order: the closest hit,
    then the NEE any hit) and the shading around them."""
    def ms(ks):
        return round(sum(k.time_range.elapsed_us() for k in ks) / 1e3 / frames, 3)
    ranges = [e for e in dev_events if e.name.startswith("PT ")]
    kern = [e for e in dev_events if not e.name.startswith("PT ")]
    rows = {}
    for name in sorted({e.name for e in ranges}, key=lambda n: (int(n.split()[-1]), n)):
        row = {"kernel_ms": 0.0, "kernels": 0}
        walks = [[], []]
        for r in (r for r in ranges if r.name == name):
            inside = [k for k in kern if _in(k, r)]
            row["kernel_ms"] += ms(inside)
            row["kernels"] += len(inside)
            k3 = sorted((k for k in inside if "bvh16_walk" in k.name),
                        key=lambda k: k.time_range.start)
            for w, k in zip(walks, k3):
                w.append(k)
        row["kernel_ms"] = round(row["kernel_ms"], 3)
        row["kernels"] = round(row["kernels"] / frames)
        if name.startswith("PT bounce"):
            row["closest_hit_ms"], row["nee_any_hit_ms"] = ms(walks[0]), ms(walks[1])
            row["shading_ms"] = round(row["kernel_ms"] - row["closest_hit_ms"]
                                      - row["nee_any_hit_ms"], 3)
        rows[name[3:]] = row
    return rows, kern


def main(argv=None):
    p = argparse.ArgumentParser(prog="hobbyrenderer_tpu_torch.profile_frame")
    p.add_argument("--scene", default="stress")
    p.add_argument("--width", type=int, default=None,
                   help="default 1920 (960 for the path tracer, bench.py's PT size)")
    p.add_argument("--height", type=int, default=None, help="default 1080 (540)")
    p.add_argument("--direct-mode", default="simple", choices=("simple", "restir"))
    p.add_argument("--mode", default="normal",
                   choices=("normal", "normal_basic", "ibl", "path_tracer"))
    p.add_argument("--indirect-mode", default="none",
                   choices=("none", "sharc", "ssgi", "restir", "ddgi", "combined"))
    p.add_argument("--regir", action="store_true")
    p.add_argument("--regir-mode", default="onion", choices=("onion", "grid"))
    p.add_argument("--no-specular-indirect", dest="specular_indirect", action="store_false")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--cache-dir", default=".hr_cache")
    a = p.parse_args(argv)
    pt = a.mode == "path_tracer"
    a.width = a.width or (960 if pt else 1920)
    a.height = a.height or (540 if pt else 1080)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame needs an NVIDIA GPU")
    from hobbyrenderer_tpu_torch.config import Config
    from hobbyrenderer_tpu_torch.renderer import Renderer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    r = Renderer(Config(scene=a.scene, width=a.width, height=a.height, mode=a.mode,
                        direct_mode=a.direct_mode, indirect_mode=a.indirect_mode,
                        regir=a.regir, regir_mode=a.regir_mode,
                        specular_indirect=a.specular_indirect, cache_dir=a.cache_dir),
                 device="cuda")
    names = [] if pt else [ps.name for ps in r.graph.passes if ps.enabled]
    events = {} if pt else time_passes(r.graph)
    frame_ms = []
    for _ in range(a.frames - 3):
        t0 = time.perf_counter()
        r.render_frame()
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            f0 = time.perf_counter()
            r.render_frame()
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - f0) * 1e3)
        wall_ms = (time.perf_counter() - t0) * 1e3
    r.shutdown()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if pt:
        rows, kern = _pt_rows(dev, 3)
        print("per-bounce " + json.dumps(rows))
    else:
        ann = [e for e in dev if e.name in names]        # device-side pass ranges
        kern = [e for e in dev if e.name not in names]
        per = {}
        for rng in ann:
            per[rng.name] = per.get(rng.name, 0.0) + sum(
                k.time_range.elapsed_us() for k in kern if _in(k, rng)) / 1e3
        rows = {n: {"stream_ms": median_ms(events[n]),
                    "kernel_ms": round(per[n] / 3, 3) if n in per else None} for n in names}
        print("per-pass " + json.dumps(rows))
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    print(json.dumps({"scene": a.scene, "size": [a.width, a.height], "mode": a.mode,
                      "direct_mode": a.direct_mode, "indirect_mode": a.indirect_mode,
                      "specular_indirect": a.specular_indirect,
                      "frame_ms": [round(x, 2) for x in frame_ms],
                      "median_ms_after_first": round(statistics.median(frame_ms[1:]), 2),
                      "kernels_per_frame": round(len(kern) / 3),
                      "kernel_ms_per_frame": round(busy_ms / 3, 2),
                      "traced_wall_ms_per_frame": round(wall_ms / 3, 2),
                      "device_busy_share": round(busy_ms / wall_ms, 4)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
