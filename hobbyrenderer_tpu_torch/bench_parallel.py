"""The sharded flagship (parallel/) driven on n ranks, as bench.py drives the
JAX package's.

    python -m hobbyrenderer_tpu_torch.bench_parallel --ranks 2 --backend gloo \
        [--scene stress] [--width 1920] [--height 1080] [--frames 8] [--device cuda]
    torchrun --nproc-per-node 2 -m hobbyrenderer_tpu_torch.bench_parallel --torchrun ...

Renders ``--frames`` frames of FlagshipShardedRenderer (direct and indirect
ReSTIR with traced specular and transparency) on the stress scene (or a
smaller stress:N). The
height is rounded up to a multiple of ranks x 32 (a band is whole 32-row
tiles; bench.py's rule), the camera is the port Renderer's at that size.
Prints, per rank: the frame ms (host clock around a frame that ends in a
synchronize; median of the frames after the first), the collectives of a
frame (calls, bytes landed on the rank, host syncs) and, from one more
frame with every collective timed alone (device synchronised before and
after), their ms; then the LDR frame's checksum. The ranks are this
process's children (parallel/launch.py::run_ranks), or, with
``--torchrun``, the processes torchrun started. NCCL takes one GPU a rank;
ranks that share a card need ``--backend gloo``, and their times measure
the ranks' contention for the card, not scaling. The first line is the
card's name and power limit.

The helpers (make_renderer, make_sharded, view_constants, render_body)
also serve the sample-parallel path tracer (job kind "pt")."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

ROW_MULTIPLE = 32


def sharded_height(height: int, n: int) -> int:
    """The height rounded up to a multiple of n x 32 rows."""
    m = n * ROW_MULTIPLE
    return -(-height // m) * m


def make_renderer(job: dict, device):
    """The port's Renderer for ``job`` on ``device`` (scene, camera, scene
    buffers, the ray-tracing scene with its light pool): the sharded
    renderers take its gpu, rt, camera and settings. ``job["kind"]`` is
    "flagship" or "pt". Its cache directory is private to the process."""
    from hobbyrenderer_tpu_torch.config import Config
    from hobbyrenderer_tpu_torch.renderer import Renderer
    kw = dict(scene=job.get("scene", "stress"), width=job["width"], height=job["height"],
              cache_dir=os.path.join(tempfile.gettempdir(), f"hr_par_{os.getpid()}"),
              tex_streaming=job.get("tex_streaming", False))
    if job["kind"] == "flagship":
        kw.update(direct_mode="restir", indirect_mode="restir")
    else:
        kw.update(mode="path_tracer")
    return Renderer(Config(**kw), device=device)


def make_sharded(job: dict, r, mesh):
    """The sharded renderer of ``job`` over ``mesh`` on Renderer r's scene:
    the flagship (``job["indirect"]``, ``job["straggler_steps"]`` when
    given) or the path tracer."""
    from hobbyrenderer_tpu_torch.parallel import (FlagshipShardedRenderer,
                                                  PathTracerShardedRenderer)
    W, H = job["width"], job["height"]
    if job["kind"] == "pt":
        return PathTracerShardedRenderer(r.gpu, W, H, rt=r._model.rt, mesh=mesh, config=r.config)
    kw = {}
    if "straggler_steps" in job:
        kw["straggler_steps"] = job["straggler_steps"]
    return FlagshipShardedRenderer(r.gpu, W, H, rt=r._model.rt, mesh=mesh,
                                   indirect=job.get("indirect", "restir"), **kw)


def view_constants(r, i: int):
    """Frame i's view constants on the Renderer's device, and the host
    camera matrix (the path tracer's reset)."""
    from hobbyrenderer_tpu_torch.renderer import device_view_constants
    vc = r.camera.view_constants(i)
    return device_view_constants(vc, r.device), vc["view_proj_no_jitter"]


def render_body(mesh, job: dict):
    """Rank body: ``job["frames"]`` frames of the job's sharded renderer.
    Returns {"ldr": the last LDR frame (numpy), "frame_ms": [...],
    "collectives": one frame's CollectiveStats (calls, bytes, host syncs)
    and, timed alone in one more frame, their ms; "tex_feedback"} (the
    ``keep_ldr`` frames' LDR too when asked)."""
    dev = mesh.device
    r = make_renderer(job, dev)
    try:
        sr = make_sharded(job, r, mesh)
        settings = r.config.settings
        out = {"frame_ms": [], "ldr_frames": []}
        for i in range(job["frames"] + 1):
            timed = i == job["frames"]          # the extra frame: collectives timed alone
            vc, vp = view_constants(r, i)
            mesh.stats.reset()
            mesh.timed = timed
            t0 = time.perf_counter()
            ldr = sr.render(r.gpu, vc, settings, 1 / 60, vp)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
            mesh.timed = False
            if timed:
                out["collectives_timed"] = mesh.stats.as_dict()
                continue
            out["frame_ms"].append(ms)
            out["collectives"] = mesh.stats.as_dict()
            if i in job.get("keep_ldr", ()):
                out["ldr_frames"].append(ldr)
            out["ldr"] = ldr
        fb = getattr(sr, "last_tex_feedback", None)
        out["tex_feedback"] = fb
        return out
    finally:
        r.shutdown()


def summary(res: dict) -> dict:
    """A rank's numbers for printing."""
    fm = res["frame_ms"]
    return {"frame_ms": [round(x, 3) for x in fm],
            "median_ms": statistics.median(fm[1:]) if len(fm) > 1 else fm[0],
            "collectives_a_frame": res["collectives"],
            "collective_ms_timed_frame": res["collectives_timed"]["ms"],
            "ldr_checksum": int(np.asarray(res["ldr"], np.int64).sum())}


def main(argv=None):
    p = argparse.ArgumentParser(prog="hobbyrenderer_tpu_torch.bench_parallel")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    p.add_argument("--device", default="cuda", help="'cuda' (rank r on card r modulo the "
                   "visible cards) or 'cpu'")
    p.add_argument("--scene", default="stress", help="stress, or stress:N for a small run")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--torchrun", action="store_true",
                   help="this process is one rank of a torchrun launch")
    a = p.parse_args(argv)
    from hobbyrenderer_tpu_torch.parallel.launch import run_ranks
    from hobbyrenderer_tpu_torch.parallel.mesh import build_mesh
    if a.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda needs an NVIDIA GPU (or pass --device cpu "
                             "--backend gloo)")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed",
              flush=True)
    n = int(os.environ.get("WORLD_SIZE", a.ranks)) if a.torchrun else a.ranks
    job = dict(kind="flagship", scene=a.scene, width=a.width, height=sharded_height(a.height, n),
               frames=a.frames)
    if a.torchrun:
        mesh = build_mesh(n, backend=a.backend,
                          device=None if a.device == "cuda" else a.device)
        res = [render_body(mesh, job)]
        ranks = [mesh.rank]
    else:
        if a.device == "cuda":
            from hobbyrenderer_tpu_torch import kernels
            kernels.library()       # built once here, not by every rank
            devices = [f"cuda:{r % torch.cuda.device_count()}" for r in range(n)]
        else:
            devices = ["cpu"] * n
        res = run_ranks(render_body, n, backend=a.backend, devices=devices, args=(job,))
        ranks = list(range(n))
    for rank, x in zip(ranks, res):
        print(json.dumps({"rank": rank, "ranks": n, "backend": a.backend,
                          "size": [job["width"], job["height"]], **summary(x)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
