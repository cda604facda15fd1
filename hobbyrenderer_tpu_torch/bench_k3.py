"""K3, the bvh16 walk (csrc/bvh16_walk.cu), on the walks of the main paths,
timed on one GPU, optionally in turns against another build of the walk.

    python -m hobbyrenderer_tpu_torch.bench_k3 [--baseline CHECKOUT] [--reps N]

The walks are captured from the paths that run them:
- the path tracer at bench.py's PT configuration (stress, 960x540, 1 spp):
  its first frame's full-width closest-hit and NEE any-hit walks (bounce 0)
  and its first compacted NEE walk (bounce 3);
- the first 1080p stress frame with ReSTIR DI: its straggler any-hit walks
  (capped), and 65,536 closest-hit rays from G-buffer points, cosine
  distributed about the normal (``gbuffer_rays``: chip_smoke.py phase 7's
  ``closest64k``);
- 100,003 rays of the stress table (a count no CTA size divides): random
  closest-hit rays from inside the scene box and shadow rays toward scene
  points, a third of them masked (t_max 1e-4), capped at 24 and uncapped.

Each walk is held against the plain walk (every output bit-equal) and
launched three times (equal outputs). ``--baseline`` takes the root of
another checkout of the repo (e.g. a parent commit unpacked with ``git
archive`` into the git-ignored ``build/``), imports that checkout's
``bvh16_walk`` with its own kernel library, whatever C interface it has,
and times it against this one on the same inputs, in turns: baseline,
this, this, baseline. Every kernel time is a median over ``--reps``
CUDA-event timings of 10 calls back to back (the plain walk's: one run of
one call), on the card named in the first line (name and power limit as
nvidia-smi prints them). The bound (``walk_bound``, which chip_smoke.py
uses too) is the larger of the bytes over 3.35 TB/s, the rays, the
outputs and each row the rays read once (384 B of an interior row, 480 B
of a leaf row), and 432 fp32 operations a step over 67 TFLOP/s. The last
line is one JSON object with every number printed."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
OPS_A_STEP = 432          # 16 slab tests of 27 fp32 operations
INTERIOR_ROW_BYTES = 96 * 4   # the 16 child boxes a step reads of an interior row
LEAF_ROW_BYTES = 120 * 4      # the 12 records a step reads of a leaf row


def gbuffer_rays(gb, n=65536, seed=7):
    """n closest-hit rays from valid G-buffer points (spread evenly over
    them), offset along the geometric normal, cosine-distributed about the
    shading normal: (o, d, t_max) on the G-buffer's device."""
    from hobbyrenderer_tpu_torch.ops import bvh16 as b16ops
    from hobbyrenderer_tpu_torch.ops import sampling as smp
    dev = gb.valid.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    vpix = torch.nonzero(gb.valid.reshape(-1)).flatten()
    pick = vpix[torch.linspace(0, vpix.numel() - 1, n, device=dev).round().long()]
    nrm = gb.normal.reshape(-1, 3)[pick]
    o = gb.world_pos.reshape(-1, 3)[pick] + gb.geo_normal.reshape(-1, 3)[pick] * 0.05
    u1 = torch.rand(n, device=dev, generator=gen)
    u2 = torch.rand(n, device=dev, generator=gen)
    local = torch.stack([torch.sqrt(u1) * torch.cos(6.283185307 * u2),
                         torch.sqrt(u1) * torch.sin(6.283185307 * u2),
                         torch.sqrt(1.0 - u1)], -1)
    d = smp.to_world(nrm, local).contiguous()
    return o.contiguous(), d, torch.full((n,), b16ops.INF, device=dev)


def scene_rays(root_box, n, seed=0, device="cuda"):
    """n rays in the scene box: the first half closest-hit rays in random
    directions, the second half shadow rays toward random scene points
    (t_max short of them); every third ray masked (t_max 1e-4)."""
    rng = np.random.default_rng(seed)
    box = root_box.cpu().numpy()
    lo, hi = box[:3], box[3:]
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    h = n // 2
    v = rng.uniform(lo, hi, (n - h, 3)).astype(np.float32) - o[h:]
    dist = np.linalg.norm(v, axis=1)
    d[h:] = v / dist[:, None]
    tmax = np.full(n, 3.0e38, np.float32)
    tmax[h:] = dist - 1e-3
    tmax[::3] = 1e-4
    return tuple(torch.as_tensor(a, device=device) for a in (o, d, tmax))


def capture_pt(Renderer, Config):
    """The PT frame's walks: {name: (table, o, d, t_max, any_hit, max_steps,
    t_min)}, and the scene's BVH16."""
    from hobbyrenderer_tpu_torch.ops import bvh16 as b16ops
    RS = 960 * 540
    walks = {}
    orig = b16ops.bvh16_walk

    def spy(table, o, d, t_max, any_hit, max_steps, t_min=1e-4):
        n = o.shape[0]
        key = ("pt closest full width" if not any_hit and n == RS else
               "pt NEE full width" if any_hit and n == RS else
               "pt NEE compacted" if any_hit else None)
        if key is not None and key not in walks:
            walks[key] = (table, o.clone(), d.clone(), t_max.clone(), any_hit, max_steps, t_min)
        return orig(table, o, d, t_max, any_hit, max_steps, t_min)

    r = Renderer(Config(scene="stress", width=960, height=540, mode="path_tracer",
                        cache_dir=os.path.join(tempfile.gettempdir(), "hr_bench_k3_pt")),
                 device="cuda")
    b16ops.bvh16_walk = spy
    try:
        r.render_frame()
        torch.cuda.synchronize()
    finally:
        b16ops.bvh16_walk = orig
    bvh = r._model.rt.bvh16
    r.shutdown()
    return walks, bvh


def capture_restir(Renderer, Config):
    """The first 1080p ReSTIR DI frame's straggler walks and closest64k."""
    from hobbyrenderer_tpu_torch.ops import bvh16 as b16ops
    calls = []
    orig = b16ops.bvh16_walk

    def spy(table, o, d, t_max, any_hit, max_steps, t_min=1e-4):
        calls.append((table, o.clone(), d.clone(), t_max.clone(), any_hit, max_steps, t_min))
        return orig(table, o, d, t_max, any_hit, max_steps, t_min)

    r = Renderer(Config(scene="stress", width=1920, height=1080, direct_mode="restir",
                        cache_dir=os.path.join(tempfile.gettempdir(), "hr_bench_k3_rx")),
                 device="cuda")
    r._model.keep = ("gbuffer",)
    b16ops.bvh16_walk = spy
    try:
        r.render_frame()
        torch.cuda.synchronize()
    finally:
        b16ops.bvh16_walk = orig
    gb = r._model.last_resources["gbuffer"]
    table = r._model.rt.bvh16.table
    r.shutdown()
    walks = {f"restir any[{i}]": c for i, c in enumerate(calls)}
    walks["closest64k"] = (table, *gbuffer_rays(gb), False, b16ops.UNCAPPED_STEPS, 1e-4)
    return walks


def cuda_ms(fn, reps, inner=10):
    """Median CUDA-event time (ms) of one fn() over reps runs of inner calls
    back to back, after a warm-up: the host enqueues a call while the card
    runs the one before, so a short walk is not timed at the host's pace."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def walk_bound(table, R, visited, steps_sum):
    """(bound_ms, bound_by) of a walk of R rays: its bytes (the rays o, d,
    t_max and the outputs t, tri, steps, and each row some ray read, once:
    ``visited`` is the plain walk's (I+L,) mask, rows >= I are leaves) or
    its operations, whichever takes longer."""
    from hobbyrenderer_tpu_torch.ops import bvh16 as b16ops
    I, _ = b16ops._dims(table)
    n_int, n_leaf = int(visited[:I].sum()), int(visited[I:].sum())
    nbytes = (n_int * INTERIOR_ROW_BYTES + n_leaf * LEAF_ROW_BYTES
              + R * (3 + 3 + 1) * 4 + R * 3 * 4)
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = int(steps_sum) * OPS_A_STEP / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def load_baseline(root):
    """Import the checkout at root's walk module (its ops/bvh16.py, bound to
    its own kernels.py, which builds its own csrc/ into its own build/) and
    leave this process's modules as they were: the module returned walks
    with that version's wrapper and C interface."""
    pkg = "hobbyrenderer_tpu_torch"
    root = os.path.abspath(root)
    ours = lambda: [k for k in sys.modules if k == pkg or k.startswith(pkg + ".")]
    saved = {k: sys.modules.pop(k) for k in ours()}
    sys.path.insert(0, root)
    try:
        mod = importlib.import_module(pkg + ".ops.bvh16")
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{root} holds no {pkg} package")
    finally:
        sys.path.remove(root)
        for k in ours():
            del sys.modules[k]
        sys.modules.update(saved)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", default=None,
                    help="the root of another checkout whose walk is timed in turns")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_k3 times the CUDA kernel: it needs an NVIDIA GPU")
    from hobbyrenderer_tpu_torch import kernels
    from hobbyrenderer_tpu_torch.config import Config
    from hobbyrenderer_tpu_torch.ops import bvh16 as b16ops
    from hobbyrenderer_tpu_torch.renderer import Renderer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card, flush=True)
    t0 = time.perf_counter()
    lib = kernels.library()
    base = load_baseline(args.baseline) if args.baseline else None
    if base is not None:
        base.kernels.library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for p in os.listdir(kernels.BUILD_DIR):
        if p.endswith(".ptxas.txt"):
            with open(os.path.join(kernels.BUILD_DIR, p)) as f:
                text = f.read()
            k3 = text[text.index("== bvh16_walk.cu"):].split("\n== ")[0]
            print("\n".join("  ptxas: " + x.strip() for x in k3.splitlines()
                            if "bvh16_walk_kernel" in x or "registers" in x or "spill" in x))

    t0 = time.perf_counter()
    walks, bvh = capture_pt(Renderer, Config)
    walks.update(capture_restir(Renderer, Config))
    o, d, tm = scene_rays(bvh.root_box, 100_003)
    for steps in (24, b16ops.UNCAPPED_STEPS):
        walks[f"scene 100003 closest max_steps {steps}"] = (bvh.table, o, d, tm, False, steps, 1e-4)
        walks[f"scene 100003 any max_steps {steps}"] = (bvh.table, o, d, tm, True, steps, 1e-4)
    print(f"captured {len(walks)} walks in {time.perf_counter() - t0:.1f} s", flush=True)

    rows, failures = {}, []
    for name, (tab, o, d, tm, any_hit, steps, t_min) in walks.items():
        grid = b16ops.launch_grid(o.shape[0], b16ops._resident_ctas(lib, o.device))
        new = lambda: b16ops.bvh16_walk(tab, o, d, tm, any_hit, steps, t_min)
        got = [new() for _ in range(3)]
        pt, ptri, ps, seen = b16ops.bvh16_walk_reference(tab, o, d, tm, any_hit, steps, t_min,
                                                         return_visited=True)
        torch.cuda.synchronize()
        mism = {k: int((a != b).sum()) for k, a, b in zip(("t", "tri", "steps"), got[0],
                                                          (pt, ptri, ps))}
        repeat_equal = all(torch.equal(a, b) for g in got[1:] for a, b in zip(got[0], g))
        row = dict(rays=o.shape[0], live=int((tm > 1e-4).sum()), any_hit=any_hit,
                   max_steps=steps, steps=int(ps.sum()), rows_read=int(seen.sum()),
                   mismatches=mism, repeat_equal=repeat_equal, grid=grid)
        row["bound_ms"], row["bound_by"] = walk_bound(tab, o.shape[0], seen, row["steps"])
        row["plain_ms"] = cuda_ms(lambda: b16ops.bvh16_walk_reference(tab, o, d, tm, any_hit,
                                                                      steps, t_min), 1, 1)
        if base is not None:
            base_walk = lambda: base.bvh16_walk(tab, o, d, tm, any_hit, steps, t_min)
            bo = base_walk()
            torch.cuda.synchronize()
            row["baseline_equal"] = all(torch.equal(a, b) for a, b in zip(got[0], bo))
            turns = []
            for who in ("baseline", "new", "new", "baseline"):
                turns.append((who, cuda_ms(base_walk if who == "baseline" else new, args.reps)))
            row["turns"] = turns
            row["baseline_ms"] = statistics.mean(t for w, t in turns if w == "baseline")
            row["ms"] = statistics.mean(t for w, t in turns if w == "new")
        else:
            row["ms"] = cuda_ms(new, args.reps)
        row["gsteps_per_s"] = row["steps"] / (row["ms"] * 1e-3) / 1e9
        rows[name] = row
        print(f"{name}: rays {row['rays']} (live {row['live']}) any_hit={any_hit} max_steps="
              f"{steps}: mismatches vs plain {mism}, three launches equal {repeat_equal}"
              + (f", equal to the baseline {row['baseline_equal']}" if base is not None else "")
              + f"; steps {row['steps']} (mean {row['steps'] / row['rays']:.2f}), rows read "
              f"{row['rows_read']}; grid {grid} CTAs of 256 threads; kernel {row['ms']:.4f} ms"
              + (f", baseline {row['baseline_ms']:.4f} ms (turns "
                 f"{[(w, round(t, 4)) for w, t in row['turns']]})" if base is not None else "")
              + f", {row['gsteps_per_s']:.2f} G ray-steps/s, plain {row['plain_ms']:.2f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
        if any(mism.values()) or not repeat_equal:
            failures.append(f"{name}: mismatches {mism}, repeat equal {repeat_equal}")
        if base is not None and not row["baseline_equal"]:
            failures.append(f"{name}: differs from the baseline")
    print(json.dumps({"card": card, "walks": rows, "failures": failures}), flush=True)
    if failures:
        raise SystemExit("K3 failed: " + "; ".join(failures))


if __name__ == "__main__":
    main()
