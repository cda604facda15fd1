"""One run of one benchmark cell of hobbyrenderer_tpu_torch.

    python3 -m hrbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``, read
by ``traffic.py``). A configuration's file holds:

- ``renderer``: the ``Config`` keywords (mode, size, samples a frame);
- ``settings``: the renderer settings, handed to the program and to the
  reference alike;
- ``scene``: its ``kind`` selects ``scenes/<kind>.py``, whose
  ``make(scene, overrides, tmpdir) -> (scene, config_kwargs)`` builds the
  scene from the rest of the keys; ``config_kwargs`` are the ``Config``
  keywords the kind sets itself (the scene's name, a file it wrote under
  ``tmpdir``), and a keyword that ``renderer`` sets too is an error;
- ``reference`` (default ``ref_path``): the plain reference, a module
  ``<reference>.py`` beside this one that offers ``snapshot(scene)``,
  ``World(snap, settings, device, scene_time)`` and the steps the check
  calls (``check.py``);
- ``warmup_frames``, ``trace_frames``.

An unknown scene kind or reference stops the run before set-up. The run:

1. set-up: builds the scene, the Renderer (upload, BVH, kernel library)
   with the configuration's settings, and renders the configuration's
   warm-up frames, the last of them armed as the window's armed frame will
   be and what it kept dropped, so that nothing of the capture allocates
   or loads for the first time in the window; ``setup_s`` runs from
   process start to the first timed frame;
2. the window (``window.py``): frames while the host clock is before the
   deadline, and at least three; per-frame device events, no added sync;
   each frame's primary wavefront counted on the device (the samples it
   walked, which the rate counts); one frame of the first three, drawn
   from the seed, keeps a sample of its walks and of its pixels' lanes
   through every bounce (``capture.py``);
3. with ``--trace 1`` the configuration's traced frames under
   ``torch.profiler`` after the window (``devtrace.py``);
4. the check (``check.py``): the program's state freed, what the armed
   frame kept against the configuration's reference, and every frame's
   primary lanes against W x H x spp. The reference's world is posed at
   the armed frame's scene time, (frames rendered before it + 1) x ``dt``
   (the Renderer advances its clock by ``dt`` before each frame), and the
   check blends the frame into an average of the frames since the
   accumulation last restarted, which the mix alone decides
   (``Traffic.accumulated_before``): the program's own count is held to
   it;
5. the metrics: each a reader ``metrics/<name>.py`` found by the name in
   ``BENCHMARK.json`` (the cell's ``end_to_end`` metrics with ``--trace
   0``, its ``per_layer`` ones with ``--trace 1``), then one JSON line.

Kernel and build caches stay in fixed directories inside the checkout
(``.hrbench_cache/``; the program's kernel library in its own
``build/``); the renderer's cache directory is a fresh one under TMPDIR."""

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "hobbyrenderer_tpu")
CHECK_FRAMES = 3          # the checked frame is one of the window's first three


def process_start() -> float:
    """The wall-clock time this process started (Linux /proc), else the
    time this module was first imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _T_IMPORT


def set_cache_dirs(root: str = ROOT):
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        path = os.path.join(root, ".hrbench_cache", sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (compared whole: hobbyrenderer_tpu_torch is none of them)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# the manifest
# ---------------------------------------------------------------------------

def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_of(man: dict, workload: str):
    """(cell, configuration entry) of a workload name; KeyError if none."""
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload '{workload}' in BENCHMARK.json "
                       f"({', '.join(sorted(cells))})")
    cell = cells[workload]
    conf = next(c for c in man["configs"] if c["name"] == cell["config"])
    return cell, conf


def metrics_of(man: dict, workload: str, kind: str) -> list:
    """The metric entries of ``kind`` ("end_to_end" | "per_layer") that the
    cell reports: those that list it under ``workloads``; one without the
    key: every cell (end-to-end), or every cell that reports the end-to-end
    metric it moves (per-layer)."""
    e2e = [m["name"] for m in man["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    out = []
    for m in man[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    return _load(os.path.join(HERE, "metrics", name + ".py"),
                 "hrbench_metric_" + name.replace(".", "_")).read


def _names(folder: str, prefix: str = "") -> list:
    return sorted(f[:-3] for f in os.listdir(folder)
                  if f.startswith(prefix) and f.endswith(".py"))


def scene_kind(kind: str):
    """The module ``scenes/<kind>.py``; ValueError naming the kinds there."""
    kinds = _names(os.path.join(HERE, "scenes"))
    if kind not in kinds:
        raise ValueError(f"no scene kind '{kind}' (scenes/: {', '.join(kinds)})")
    return _load(os.path.join(HERE, "scenes", kind + ".py"), "hrbench_scene_" + kind)


def reference_of(name: str):
    """The reference module ``<name>.py`` beside this one (a ``ref_*``
    module that offers ``snapshot`` and ``World``); ValueError naming those
    there."""
    refs = _names(HERE, "ref_")
    mod = importlib.import_module("hrbench." + name) if name in refs else None
    if mod is None or not all(hasattr(mod, a) for a in ("snapshot", "World")):
        raise ValueError(f"no reference '{name}' (hrbench/: {', '.join(refs)})")
    return mod


class Ctx:
    """What a metric reader reads: ``window`` (window.Window), ``setup_s``,
    and after a traced run ``trace`` (devtrace.DeviceTrace), ``calls`` (the
    hand kernels' sizes in the traced frames), ``bvh_seconds``,
    ``peaks`` (roofline.peak of the card)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def build(conf: dict, device, tmpdir: str, overrides: dict, maker, ref):
    """(renderer, scene snapshot) for a configuration: the scene made by
    its kind, the snapshot taken by its reference before the renderer sees
    the scene, the renderer handed the configuration's settings."""
    import dataclasses

    from hobbyrenderer_tpu_torch.config import Config
    from hobbyrenderer_tpu_torch.renderer import Renderer
    scene, made = maker.make(conf["scene"], overrides, tmpdir)
    both = sorted(set(made) & set(conf["renderer"]))
    if both:
        raise ValueError(f"the scene kind and the configuration's renderer both set "
                         f"{', '.join(both)}")
    snap = ref.snapshot(scene)
    kw = dict(conf["renderer"], **made)
    kw.update({k: v for k, v in overrides.items() if k in ("width", "height")})
    cfg = Config(cache_dir=os.path.join(tmpdir, "renderer"), **kw)
    cfg = dataclasses.replace(cfg, settings=dataclasses.replace(cfg.settings,
                                                                **conf["settings"]))
    r = Renderer(cfg, scene=scene, device=device)
    return r, snap


def set_pose(r, traffic, frame: int):
    pos, target = traffic.camera_pose(frame)
    r.camera.position = pos
    r.camera.look_at(target)


def run_window(r, traffic, seconds: float, frame0: int, capture, check_frame: int):
    """Frames while the host clock is before the deadline (and at least
    CHECK_FRAMES) -> window.Window; frame ``check_frame`` runs armed."""
    import torch

    from hrbench.window import Window
    cuda = r.device.type == "cuda"
    marks = []
    if cuda:
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        marks.append(e0)
    t_start = time.perf_counter()
    deadline = t_start + seconds
    n = 0
    while time.perf_counter() < deadline or n < CHECK_FRAMES:
        if traffic.moves:
            set_pose(r, traffic, frame0 + n)
        capture.armed = n == check_frame
        capture.frame_no = n
        r.render_frame(traffic.dt)
        capture.armed = False
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())
        n += 1
    capture.frame_no = -1
    r.synchronize()
    t_end = time.perf_counter()
    if cuda:
        frame_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        frame_ms = [(b - a) * 1e3 for a, b in zip([t_start] + marks, marks)]
    return Window(t_start, t_end, n, frame_ms, float(n))


def traced_frames(r, traffic, frames: int, frame0: int, capture):
    """``frames`` frames under torch.profiler -> devtrace.DeviceTrace."""
    import torch

    from hrbench import devtrace
    passes = {p.name for p in r.graph.passes} if r.graph is not None else set()

    def is_range(name):
        return name in passes or name.startswith(("PT ", "Frame/"))

    acts = [torch.profiler.ProfilerActivity.CPU]
    if r.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    capture.shapes = True
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(frames):
            if traffic.moves:
                set_pose(r, traffic, frame0 + i)
            r.render_frame(traffic.dt)
        r.synchronize()
        window_s = time.perf_counter() - t0
    capture.shapes = False
    ops, ranges = devtrace.from_profiler(prof, is_range)
    return devtrace.DeviceTrace(ops, ranges, frames, window_s)


def card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi failed"


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        overrides: dict = None, control: bool = False, root: str = ROOT,
        start: float = None):
    """One run of a cell -> (the result's dict: ``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, [``breakdown``], ``checks``; the
    window). ``device="cpu"`` with ``overrides`` (width, height, grid,
    lod_rich) is the CPU rehearsal the tests drive;
    ``control`` puts the bfloat16 reference in the program's place in the
    check."""
    import numpy as np
    import torch

    from hrbench import check, devtrace, roofline, traffic as traffic_mod
    from hrbench.capture import Capture
    start = process_start() if start is None else start
    overrides = overrides or {}
    man = load_manifest(root)
    cell, entry = cell_of(man, workload)
    with open(os.path.join(root, entry["file"])) as f:
        conf = json.load(f)
    maker = scene_kind(conf["scene"]["kind"])
    ref = reference_of(conf.get("reference", "ref_path"))
    traffic = traffic_mod.Traffic(traffic_mod.load(cell["traffic"], root), seed)
    dev = torch.device(device)
    check_frame = int(np.random.default_rng([seed, 1]).integers(CHECK_FRAMES))
    warm = int(conf["warmup_frames"])
    tmpdir = tempfile.mkdtemp(prefix="hrbench_")
    capture = Capture(seed, dev).install()
    try:
        r, snap = build(conf, dev, tmpdir, overrides, maker, ref)
        set_pose(r, traffic, 0)
        for i in range(warm):
            if traffic.moves:
                set_pose(r, traffic, i)
            capture.armed = i == warm - 1
            r.render_frame(traffic.dt)
        capture.armed = False
        r.synchronize()
        capture.reset()
        setup_s = time.time() - start
        win = run_window(r, traffic, seconds, warm, capture, check_frame)
        w, h = r.config.render_width, r.config.render_height
        # the samples a frame walked: its primary wavefront's live lanes
        walked = [int(x) for x in torch.stack([capture.primary.get(i, torch.zeros(
            (), dtype=torch.int64, device=dev)) for i in range(win.frames)]).tolist()]
        win = win._replace(work=float(sum(walked)))
        tr = None
        if trace:
            tr = traced_frames(r, traffic, int(conf["trace_frames"]), warm + win.frames,
                               capture)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        bvh_seconds = r.bvh_seconds
        r.shutdown()
        del r
    finally:
        capture.uninstall()
        shutil.rmtree(tmpdir, ignore_errors=True)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    spp = int(conf["renderer"].get("pt_spp", 1))
    numbers = {"primary_lane_shortfall": max(w * h * spp - x for x in walked)}
    armed = warm + check_frame          # frames rendered before the armed one
    world = ref.World(snap, conf["settings"], dev, (armed + 1) * traffic.dt)
    numbers.update(check.compare_walks(capture.walks, world.tris, control=control))
    pos, target = traffic.camera_pose(armed)
    fov = snap["fov_y"]
    camera = dict(pos=pos, target=target, fov_y=fov, width=w, height=h,
                  proj11=float(np.float32(1.0 / np.tan(0.5 * fov))),
                  frame_index=armed, frames_before=traffic.accumulated_before(armed))
    numbers.update(check.compare_paths(ref, world, capture.path, camera,
                                       int(conf["settings"]["rr_start_bounce"]),
                                       control=control))
    correct, checks = check.judge(numbers)
    checks["capped_share"] = {"value": numbers["capped_share"], "limit": None}
    print(f"hrbench: the check took {time.perf_counter() - t_check:.2f} s", file=sys.stderr)

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    ctx = Ctx(window=win, setup_s=setup_s, trace=tr, calls=capture.calls,
              bvh_seconds=bvh_seconds, peaks=roofline.peak(kind))
    metrics = {}
    for m in metrics_of(man, workload, "per_layer" if trace else "end_to_end"):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": win.frames, "failed": 0, "metrics": metrics,
           "device": device_info}
    if tr is not None:
        device_info["busy_s"] = devtrace.union_us(tr.ops) / 1e6
        device_info["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": devtrace.top_ops(tr),
                            "idle_gaps": devtrace.idle_gaps(tr)}
    out["checks"] = checks
    return out, win


def main(argv=None) -> int:
    start = process_start()
    p = argparse.ArgumentParser(prog="hrbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="the bfloat16 reference in the program's place (must read not correct)")
    a = p.parse_args(argv)
    set_cache_dirs()
    import torch
    man = load_manifest()
    cell, _ = cell_of(man, a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"hrbench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    out, win = run(a.workload, a.seed, a.seconds, bool(a.trace), device="cuda",
                   control=a.control, start=start)
    print(card_line(), file=sys.stderr)
    q = statistics.quantiles(win.frame_ms, n=10)
    print(f"frames {win.frames} ms min {min(win.frame_ms):.2f} p10 {q[0]:.2f} p50 {q[4]:.2f} "
          f"p90 {q[8]:.2f} max {max(win.frame_ms):.2f}", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    # after every reader has run: nothing of JAX may be loaded in this process
    found = forbidden_modules()
    if found:
        print(f"hrbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
