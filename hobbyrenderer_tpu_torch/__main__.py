"""CLI entry point of the PyTorch port.

Usage:
    python -m hobbyrenderer_tpu_torch --scene stress --frames 8 \
        --screenshot out.png --timings            # on the GPU (default)
    python -m hobbyrenderer_tpu_torch --scene cube --width 128 --height 96 \
        --device cpu                              # plain PyTorch versions
    python -m hobbyrenderer_tpu_torch --scene stress --frames 8 \
        --direct-mode restir                      # ReSTIR DI + RELAX
    python -m hobbyrenderer_tpu_torch --scene stress --frames 8 \
        --mode normal_basic --indirect-mode ddgi  # CSM shadows + DDGI
    python -m hobbyrenderer_tpu_torch --scene stress --frames 8 \
        --direct-mode restir --indirect-mode restir   # the flagship frame
    python -m hobbyrenderer_tpu_torch --scene stress --frames 8 --mode ibl \
        --direct-mode restir --indirect-mode combined --regir   # SHARC + ReGIR
    python -m hobbyrenderer_tpu_torch --scene stress --width 960 --height 540 \
        --mode path_tracer --frames 8             # the reference path tracer
    python -m hobbyrenderer_tpu_torch --scene stress --frames 8 --direct-mode restir \
        --envmap sky.hdr --env-lights 64 --render-scale 0.5   # env lights, TAA upscaling
    python -m hobbyrenderer_tpu_torch --scene stress --frames 24 --direct-mode restir \
        --indirect-mode restir --tex-streaming --tex-debug     # streamed textures
    python -m hobbyrenderer_tpu_torch --scene stress --mode normal_basic \
        --indirect-mode ssgi --debug-view ssgi_hit_mask        # a named debug view
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from hobbyrenderer_tpu_torch.config import Config, RenderingMode
from hobbyrenderer_tpu_torch.utils.timing import PROFILER


def main(argv=None):
    p = argparse.ArgumentParser(prog="hobbyrenderer-tpu-torch")
    p.add_argument("--scene", type=str, default=None,
                   help="glTF path | 'cube' | 'stress' | 'stress:N'")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--mode", type=str, default=RenderingMode.NORMAL,
                   choices=RenderingMode.ALL,
                   help="normal | normal_basic (cascaded shadow maps, no ray-traced "
                        "lighting) | ibl (the Normal frame with the IBL ambient doubled) "
                        "| path_tracer")
    p.add_argument("--render-scale", dest="render_scale", type=float, default=1.0,
                   help="internal resolution scale; < 1 renders smaller and TAA upscales "
                        "to the output size (the path tracer renders at the internal "
                        "resolution)")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--screenshot", type=str, default=None)
    p.add_argument("--cache-dir", type=str, default=".hr_cache")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shadow-scale", type=int, default=2)
    p.add_argument("--direct-mode", type=str, default="simple",
                   choices=("simple", "restir"))
    p.add_argument("--indirect-mode", type=str, default="none",
                   choices=("none", "sharc", "ssgi", "restir", "ddgi", "combined"),
                   help="sharc = the SHARC radiance cache; combined = ReSTIR DI + a traced "
                        "half-res bounce that reads the SHARC cache at its hit; restir = "
                        "ReSTIR GI; sharc, restir and combined run in the normal and ibl "
                        "modes only")
    p.add_argument("--no-specular-indirect", dest="specular_indirect", action="store_false",
                   help="disable the traced specular pass of --indirect-mode "
                        "restir|sharc|ddgi|combined")
    p.add_argument("--restir-quality", default="balanced",
                   choices=("highperf", "balanced", "highquality"))
    p.add_argument("--denoiser", type=str, default="relax", choices=("relax", "reblur"))
    p.add_argument("--regir", action="store_true",
                   help="ReGIR world-space reservoir cells for ReSTIR DI's initial "
                        "candidates (with --direct-mode restir)")
    p.add_argument("--regir-mode", default="onion", choices=("onion", "grid"),
                   help="ReGIR cell layout: onion = camera-centred detail and coverage "
                        "shells (the default); grid = a uniform grid over the scene's bounds")
    p.add_argument("--pt-spp", dest="pt_spp", type=int, default=1,
                   help="path tracer: samples per pixel per frame, batched into one wavefront")
    p.add_argument("--envmap", type=str, default=None,
                   help="equirect environment map (.hdr / .png / .jpg / .dds)")
    p.add_argument("--env-lights", dest="env_lights", type=int, default=0,
                   help="turn the envmap into N directional lights for ReSTIR DI / the "
                        "path tracer's NEE (with --direct-mode restir or --mode path_tracer)")
    p.add_argument("--irradiance", type=str, default=None,
                   help="prebaked irradiance map (equirect .hdr / .dds)")
    p.add_argument("--radiance", type=str, default=None,
                   help="prebaked prefiltered radiance map (equirect)")
    p.add_argument("--brdflut", type=str, default=None,
                   help="authored split-sum BRDF LUT image (default: the analytic fit)")
    p.add_argument("--tex-streaming", action="store_true",
                   help="budgeted texture residency: a worker thread streams 32x32 tiles into "
                        "a paged pool as the frames' feedback asks for them")
    p.add_argument("--tex-budget-mb", type=int, default=64,
                   help="the streamed texel pool's size (16-byte texels)")
    p.add_argument("--tex-debug", action="store_true",
                   help="texture-streaming residency heatmap over the frame (with "
                        "--tex-streaming)")
    p.add_argument("--debug-view", dest="debug_view", type=str, default=None,
                   help="a named debug view in place of the frame: csm_* (normal_basic), "
                        "ssgi_* (--indirect-mode ssgi), sharc_* (sharc / combined); see "
                        "ops/debugview.py for the names")
    p.add_argument("--csm-debug", action="store_true",
                   help="cascade tint and shadow-map thumbnails over the frame (normal_basic)")
    p.add_argument("--ddgi-debug", action="store_true",
                   help="DDGI probes as dots over the frame (--indirect-mode ddgi)")
    p.add_argument("--execute-per-pass", action="store_true",
                   help="wait for and time each pass on its own (rows in --timings)")
    p.add_argument("--tune-file", dest="tune_file", type=str, default=None, metavar="PATH",
                   help="JSON of RenderSettings knobs, re-read when it changes; a change "
                        "applies from the next frame")
    p.add_argument("--describe-graph", action="store_true")
    p.add_argument("--export-graph", type=str, default=None, metavar="PATH",
                   help="write the pass graph with the last frame's resource shapes (and "
                        "per-pass ms under --execute-per-pass) as JSON")
    p.add_argument("--profile-dir", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run (Chrome trace JSON) here")
    p.add_argument("--timings", action="store_true",
                   help="trace every frame: host ms and host syncs by span (also traced: "
                        "the frames --profile-dir records)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    a = p.parse_args(argv)
    cfg = Config(scene=a.scene, width=a.width, height=a.height, mode=a.mode,
                 render_scale=a.render_scale, pt_spp=a.pt_spp,
                 cache_dir=a.cache_dir, seed=a.seed, shadow_scale=a.shadow_scale,
                 direct_mode=a.direct_mode, indirect_mode=a.indirect_mode,
                 restir_quality=a.restir_quality, denoiser=a.denoiser, regir=a.regir,
                 regir_mode=a.regir_mode,
                 specular_indirect=a.specular_indirect, envmap=a.envmap,
                 env_lights=a.env_lights, irradiance=a.irradiance, radiance=a.radiance,
                 brdflut=a.brdflut, execute_per_pass=a.execute_per_pass, tune_file=a.tune_file,
                 tex_streaming=a.tex_streaming, tex_budget_mb=a.tex_budget_mb,
                 tex_debug=a.tex_debug, debug_view=a.debug_view, csm_debug=a.csm_debug,
                 ddgi_debug=a.ddgi_debug,
                 keep_hdr=bool(a.screenshot and a.screenshot.lower().endswith(".hdr")))
    from hobbyrenderer_tpu_torch.renderer import Renderer
    r = Renderer(cfg, device=a.device)
    if a.describe_graph:
        print(r.describe_graph())
    prof = contextlib.nullcontext()
    if a.profile_dir:
        import os
        import torch
        os.makedirs(a.profile_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if r.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(
                a.profile_dir))
    PROFILER.enabled = a.timings
    with prof:
        stats = r.run(num_frames=a.frames, screenshot=a.screenshot)
    stats.update(r.stats())
    print(json.dumps(stats))
    if a.export_graph:
        with open(a.export_graph, "w") as f:
            json.dump(r.export_graph(), f, indent=1)
    if a.timings:
        print(r.timings())
    r.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
