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
"""

from __future__ import annotations

import argparse
import json
import sys

from hobbyrenderer_tpu_torch.config import Config, RenderingMode


def main(argv=None):
    p = argparse.ArgumentParser(prog="hobbyrenderer-tpu-torch")
    p.add_argument("--scene", type=str, default=None,
                   help="glTF path | 'cube' | 'stress' | 'stress:N'")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--mode", type=str, default=RenderingMode.NORMAL,
                   choices=RenderingMode.ALL)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--screenshot", type=str, default=None)
    p.add_argument("--cache-dir", type=str, default=".hr_cache")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shadow-scale", type=int, default=2)
    p.add_argument("--direct-mode", type=str, default="simple",
                   choices=("simple", "restir"))
    p.add_argument("--indirect-mode", type=str, default="none",
                   help="ported: 'none' and 'restir' (ReSTIR GI + traced specular) with "
                        "--mode normal, 'none', 'ssgi' and 'ddgi' with --mode normal_basic; "
                        "others raise NotImplementedError")
    p.add_argument("--no-specular-indirect", dest="specular_indirect", action="store_false",
                   help="disable the traced specular pass of --indirect-mode restir")
    p.add_argument("--restir-quality", default="balanced",
                   choices=("highperf", "balanced", "highquality"))
    p.add_argument("--denoiser", type=str, default="relax", choices=("relax", "reblur"))
    p.add_argument("--regir", action="store_true",
                   help="not ported yet (raises NotImplementedError)")
    p.add_argument("--describe-graph", action="store_true")
    p.add_argument("--timings", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    a = p.parse_args(argv)
    cfg = Config(scene=a.scene, width=a.width, height=a.height, mode=a.mode,
                 cache_dir=a.cache_dir, seed=a.seed, shadow_scale=a.shadow_scale,
                 direct_mode=a.direct_mode, indirect_mode=a.indirect_mode,
                 restir_quality=a.restir_quality, denoiser=a.denoiser, regir=a.regir,
                 specular_indirect=a.specular_indirect,
                 keep_hdr=bool(a.screenshot and a.screenshot.lower().endswith(".hdr")))
    from hobbyrenderer_tpu_torch.renderer import Renderer
    r = Renderer(cfg, device=a.device)
    if a.describe_graph:
        print(r.describe_graph())
    stats = r.run(num_frames=a.frames, screenshot=a.screenshot)
    stats.update(r.stats())
    print(json.dumps(stats))
    if a.timings:
        print(r.timings())
    r.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
