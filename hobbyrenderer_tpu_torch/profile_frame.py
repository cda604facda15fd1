"""Per-pass profile of the port's frame on the GPU.

    python -m hobbyrenderer_tpu_torch.profile_frame --scene stress \
        [--direct-mode restir] [--indirect-mode restir] \
        [--mode normal_basic --indirect-mode ddgi] [--mode path_tracer] [--frames 8]
    python -m hobbyrenderer_tpu_torch.profile_frame --mode ibl --direct-mode restir \
        --indirect-mode combined --regir
    python -m hobbyrenderer_tpu_torch.profile_frame --direct-mode restir \
        --indirect-mode restir --envmap 2048 --env-lights 64 --animate [--render-scale 0.5]
    python -m hobbyrenderer_tpu_torch.profile_frame --direct-mode restir \
        --indirect-mode restir --tex-streaming --frames 24

Renders ``--frames`` frames and prints, per pass: the stream time (CUDA
events around each pass, median over the frames after the first) and the
device time of the kernels that ran inside it (a torch.profiler trace of
the last 3 frames: kernels that start inside the pass's device-side
record_function range, / 3). A path-tracer frame (960x540 unless a size
is given) has no passes: its rows are the bounces, each split into its two
K3 walks (closest hit, NEE any hit) and the shading around them, and the
wavefront compactions. ``--envmap`` takes an image path, or a width for
the seeded sky of scene/workload.py (written to a temporary directory);
``--animate`` gives every 8th node of the scene a rise-and-turn animation,
so every frame refits the ray-tracing scene (its device time is the
"Frame/RTRefit" row); ``--tex-streaming`` streams the textures through the
default 64 MB pool (the batch applied at frame start is the
"Frame/TexStreaming" row).
Then the frame time (host clock with a synchronize, median after the
first), the kernels per frame, and the device's busy share of the traced
frames (the union of the device's operations over the device's window,
first start to last end). The first line is the card's name and
power limit. Needs a GPU."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

import torch


def time_passes(graph, strict=()):
    """Wrap every enabled pass of ``graph`` with CUDA events recorded on the
    stream (no host sync); the passes named in ``strict`` also run under
    ``torch.cuda.set_sync_debug_mode("error")``, so a host sync inside
    them raises. Returns {pass: [(start, end) event pairs, one per frame]}.
    The host syncs of each pass are the tracer's (utils/timing.py)."""
    events = {}

    def wrap(ps):
        fn = ps.fn

        def run(ctx, res):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            if ps.name in strict:
                prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    fn(ctx, res)
                finally:
                    torch.cuda.set_sync_debug_mode(prev)
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


def traced_frames(r, frames: int = 3):
    """Render ``frames`` frames of Renderer ``r`` under torch.profiler:
    (the trace's device events, each frame's ms on the host clock with a
    synchronize)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    frame_ms = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(frames):
            f0 = time.perf_counter()
            r.render_frame()
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - f0) * 1e3)
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return dev, frame_ms


def is_range(name: str, passes=()) -> bool:
    """A device-side range of the program's spans (a pass, 'PT ...',
    'Frame/...'), as against a device operation."""
    return name in passes or name.startswith(("PT ", "Frame/"))


def union_us(events) -> float:
    """The union of the device events' intervals, us."""
    total, end = 0.0, None
    for e in sorted(events, key=lambda e: e.time_range.start):
        s_, e_ = e.time_range.start, e.time_range.end
        if end is None or s_ > end:
            total += e_ - s_
            end = e_
        elif e_ > end:
            total += e_ - end
            end = e_
    return total


def device_busy(ops, frames: int) -> dict:
    """Kernels and kernel ms a frame of ``ops``, the device operations of
    ``frames`` traced frames, and the device's busy share: the union of
    their intervals over the device's window, first start to last end."""
    kern = [e for e in ops if not e.name.startswith(("Memcpy", "Memset"))]
    window = (max(e.time_range.end for e in ops) - min(e.time_range.start for e in ops)
              if ops else 0.0)
    return {"kernels_per_frame": round(len(kern) / frames),
            "kernel_ms_per_frame": round(sum(e.time_range.elapsed_us() for e in kern)
                                         / 1e3 / frames, 2),
            "device_busy_share": round(union_us(ops) / window, 4) if window else None}


def envmap_path(envmap):
    """--envmap: an image path as it is, or a width: scene/workload.py's
    seeded sky at that width (seed 7), written as .hdr to a temporary
    directory."""
    if envmap is None or not envmap.isdigit():
        return envmap
    from hobbyrenderer_tpu_torch.ops.envmap import encode_hdr
    from hobbyrenderer_tpu_torch.scene.workload import sky_envmap
    w = int(envmap)
    path = os.path.join(tempfile.mkdtemp(prefix="hr_profile_env"), "sky.hdr")
    with open(path, "wb") as f:
        f.write(encode_hdr(sky_envmap(w // 2, w, seed=7)))
    return path


def _in(k, rng):
    return rng.time_range.start <= k.time_range.start < rng.time_range.end


def _pt_order(name: str):
    """'PT setup', then the bounces and compactions by number, 'PT gather',
    'PT accumulate'."""
    last = name.split()[-1]
    return (-1, name) if last == "setup" else (int(last), name) if last.isdigit() else (99, name)


def _pt_rows(dev_events, frames: int):
    """Per-span kernel ms of a path-tracer trace (ms a frame): 'PT setup',
    the 'PT bounce b' and 'PT compact b' ranges, 'PT gather' and 'PT
    accumulate', each bounce split into its two K3 walks (the bvh16 walk
    kernels in the range, in order: the closest hit, then the NEE any hit)
    and the shading around them. Returns (rows, the device operations)."""
    def ms(ks):
        return round(sum(k.time_range.elapsed_us() for k in ks) / 1e3 / frames, 3)
    ranges = [e for e in dev_events if e.name.startswith("PT ")]
    kern = [e for e in dev_events if not is_range(e.name)]
    rows = {}
    for name in sorted({e.name for e in ranges}, key=_pt_order):
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
    p.add_argument("--envmap", default=None,
                   help="an equirect image, or a width for the seeded sky (scene/workload.py)")
    p.add_argument("--env-lights", type=int, default=0)
    p.add_argument("--animate", action="store_true",
                   help="animate every 8th node: each frame refits the RT scene")
    p.add_argument("--render-scale", type=float, default=1.0)
    p.add_argument("--tex-streaming", action="store_true")
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
    envmap = envmap_path(a.envmap)
    scene = None
    if a.animate:
        from hobbyrenderer_tpu_torch.scene.procedural import make_stress_scene
        from hobbyrenderer_tpu_torch.scene.workload import animate_nodes
        if not a.scene.startswith("stress"):
            raise SystemExit("--animate takes the stress scene")
        grid = int(a.scene.split(":")[1]) if ":" in a.scene else 12
        scene = animate_nodes(make_stress_scene(grid=grid))
    r = Renderer(Config(scene=a.scene, width=a.width, height=a.height, mode=a.mode,
                        direct_mode=a.direct_mode, indirect_mode=a.indirect_mode,
                        regir=a.regir, regir_mode=a.regir_mode, envmap=envmap,
                        env_lights=a.env_lights, render_scale=a.render_scale,
                        specular_indirect=a.specular_indirect, cache_dir=a.cache_dir,
                        tex_streaming=a.tex_streaming),
                 scene=scene, device="cuda")
    names = [] if pt else [ps.name for ps in r.graph.passes if ps.enabled] + [
        "Frame/RTRefit", "Frame/TexStreaming"]
    passes = set(names)
    events = {} if pt else time_passes(r.graph)
    frame_ms = []
    for _ in range(a.frames - 3):
        t0 = time.perf_counter()
        r.render_frame()
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    dev, traced_ms = traced_frames(r, 3)
    frame_ms += traced_ms
    r.shutdown()
    if pt:
        rows, kern = _pt_rows(dev, 3)
        print("per-bounce " + json.dumps(rows))
    else:
        ann = [e for e in dev if e.name in passes]       # device-side pass ranges
        kern = [e for e in dev if not is_range(e.name, passes)]
        per = {}
        for rng in ann:
            per[rng.name] = per.get(rng.name, 0.0) + sum(
                k.time_range.elapsed_us() for k in kern if _in(k, rng)) / 1e3
        rows = {n: {"stream_ms": median_ms(events[n]) if n in events else None,
                    "kernel_ms": round(per[n] / 3, 3) if n in per else None} for n in names}
        print("per-pass " + json.dumps(rows))
    print(json.dumps({"scene": a.scene, "size": [a.width, a.height], "mode": a.mode,
                      "direct_mode": a.direct_mode, "indirect_mode": a.indirect_mode,
                      "specular_indirect": a.specular_indirect, "envmap": a.envmap,
                      "env_lights": a.env_lights, "animate": a.animate,
                      "render_scale": a.render_scale, "tex_streaming": a.tex_streaming,
                      "frame_ms": [round(x, 2) for x in frame_ms],
                      "median_ms_after_first": round(statistics.median(frame_ms[1:]), 2),
                      **device_busy(kern, 3)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
