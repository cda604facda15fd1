#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (one nvcc per source, in
parallel), holds each against its plain PyTorch version at the shapes of
the 1080p stress frames, renders small frames on the GPU and on the CPU and
compares them, then drives the main paths — Renderer(Config(
scene="stress", 1920x1080), device="cuda") with simple direct light, the
same with direct_mode="restir" (RTXDI + Denoise, whose passes run under
torch.cuda.set_sync_debug_mode("error")), and mode="normal_basic" with
indirect_mode="ddgi" (cascaded shadow maps + DDGI), 8 frames each, then 4
NormalBasic frames with SSGI; then the flagship frame (direct_mode and
indirect_mode "restir": ReSTIR GI + traced specular), once to capture its
GI bounce and reflection rays, which then go through the sorted-block
route closest_hit_auto(..., force_kernel=True) and its kernel K6 (phase
13), and 8 frames as the main path (phase 15) — and checks that every
kernel of each path launched. Any failed check raises: the script then exits nonzero without
its final line.

Kernels: K1 tile raster and K5 depth-only tile raster
(csrc/raster_resolve.cu), K2 ReSTIR candidates (csrc/restir_candidates.cu),
K3 bvh16 walk (csrc/bvh16_walk.cu), K4 any hit (csrc/beam_any_hit.cu), K6
sorted-block closest hit (csrc/closest_blocks.cu). Each one's bound
(bound_ms) is the larger of its bytes (inputs read once, outputs written
once; of the walks' node tables, K3, K4 and K6, only the rows this run's
rays read) over 3.35 TB/s and its fp32 operations on this run's data over
67 TFLOP/s (H100 SXM data sheet). K2, K3, K5 and K6 must equal their plain
versions bit for bit, in every output.

Output, in order: the card's name and power limit, versions, build time,
one line per phase, the kernels JSON line, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits nonzero when no GPU is visible, and when run outside the repository.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=5):
    """Median device time of fn() over reps runs (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the byte and the operation time."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def capture_first_frame(Renderer, Config, rk, beamops):
    """Render the first 1080p stress frame, capturing the inputs of the
    first raster-kernel call (the Raster pass) and of the sun-shadow call."""
    seen = {}
    k1_orig, k4_orig = rk.raster_resolve_tiles, beamops.beam_any_hit_tiles

    def k1_spy(records, work_tile, work_slot, **kw):
        seen.setdefault("k1", (records, work_tile, work_slot, kw))
        return k1_orig(records, work_tile, work_slot, **kw)

    def k4_spy(btable, rays):
        seen.setdefault("k4", (btable, rays))
        return k4_orig(btable, rays)

    rk.raster_resolve_tiles, beamops.beam_any_hit_tiles = k1_spy, k4_spy
    try:
        r = Renderer(Config(scene="stress", width=1920, height=1080,
                            cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke")),
                     device="cuda")
        r.render_frame()
        torch.cuda.synchronize()
        r.shutdown()
    finally:
        rk.raster_resolve_tiles, beamops.beam_any_hit_tiles = k1_orig, k4_orig
    assert "k1" in seen and "k4" in seen, "first frame did not reach both kernels"
    return seen


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from hobbyrenderer_tpu_torch import kernels
    from hobbyrenderer_tpu_torch.config import Config
    from hobbyrenderer_tpu_torch.ops import beam as beamops
    from hobbyrenderer_tpu_torch.ops import bvh16 as b16ops
    from hobbyrenderer_tpu_torch.ops import raster_kernel as rk
    from hobbyrenderer_tpu_torch.ops import restir_kernel as rko
    from hobbyrenderer_tpu_torch.ops import sampling as smp
    from hobbyrenderer_tpu_torch.ops import sky as skyops
    from hobbyrenderer_tpu_torch.ops import trace as traceops
    from hobbyrenderer_tpu_torch.ops import trace_kernel as tk
    from hobbyrenderer_tpu_torch.profile_frame import median_ms, time_passes
    from hobbyrenderer_tpu_torch.renderer import Renderer
    t_start = time.perf_counter()
    late_failures = []
    # each kernel's launch count: (module, attribute)
    counters = {"K1": (rk, "launches"), "K2": (rko, "launches"), "K3": (b16ops, "launches"),
                "K4": (beamops, "launches"), "K5": (rk, "tiles_launches"), "K6": (tk, "launches")}

    def reset_counts():
        for m, attr in counters.values():
            setattr(m, attr, 0)

    def counts():
        return {k: getattr(m, attr) for k, (m, attr) in counters.items()}

    # ---- phase 1: card, versions, kernel build ------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    assert smi.returncode == 0, smi.stderr
    log(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    kernels.library()
    log(f"phase1 build: kernels built+loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kernels.build_seconds if kernels.build_seconds is not None else 'cached'} s)")
    ptxas = [p for p in os.listdir(kernels.BUILD_DIR) if p.endswith(".ptxas.txt")]
    for p in ptxas:
        with open(os.path.join(kernels.BUILD_DIR, p)) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log("  ptxas: " + line.strip())

    # ---- capture the first 1080p stress frame's kernel inputs ---------------
    t0 = time.perf_counter()
    seen = capture_first_frame(Renderer, Config, rk, beamops)
    log(f"captured first 1080p stress frame in {time.perf_counter() - t0:.1f} s")

    # ---- phase 2: K1 against its plain version ------------------------------
    records, work_tile, work_slot, kw = seen["k1"]
    d, v, a = rk.raster_resolve_tiles(records, work_tile, work_slot, **kw)
    rd, rv, ra = rk.raster_resolve_tiles_reference(records, work_tile, work_slot, **kw)
    torch.cuda.synchronize()
    n_pix = v.numel()
    depth_err = float((d - rd).abs().max())
    vis_mis = int((v != rv).sum())
    agree = (v == rv)[:, None, :].expand_as(a)
    attr_err = float((a - ra).abs()[agree].max())
    k1_ms = cuda_ms(lambda: rk.raster_resolve_tiles(records, work_tile, work_slot, **kw))
    k1_plain_ms = cuda_ms(lambda: rk.raster_resolve_tiles_reference(
        records, work_tile, work_slot, **kw))
    log(f"phase2 K1 tiles={kw['tiles']} items={int((work_slot >= 0).sum())} "
        f"records={tuple(records.shape)}: depth max|d|={depth_err:.3g} "
        f"visid mismatch={vis_mis}/{n_pix} attrs max|d|={attr_err:.3g} "
        f"drawn={int((v >= 0).sum())} kernel {k1_ms:.3f} ms plain {k1_plain_ms:.3f} ms")
    assert depth_err <= 1e-5, depth_err
    assert vis_mis < 1e-3 * n_pix, vis_mis
    assert attr_err <= 1e-4, attr_err
    assert int((v >= 0).sum()) > n_pix // 2, "first frame drew too little"
    # loop 1: 3 planes x (2 mul + 2 add) + l1+l2 per (pixel, triangle) of each
    # worklist item; loop 2: 16 planes x 4 + 1 div + 11 mul per drawn pixel
    n_items = int((work_slot >= 0).sum())
    k1_bound = bound(nbytes(records, work_tile, work_slot, d, v, a),
                     n_items * 1024 * 32 * 13 + int((v >= 0).sum()) * 76)

    # ---- phase 3: K4 against its plain version (all tiles) -----------------
    btable, rays = seen["k4"]
    T = rays.shape[0]
    occ, ovf = beamops.beam_any_hit_tiles(btable, rays)
    ref4, _ = beamops.beam_any_hit_tiles_reference(btable, rays)
    torch.cuda.synchronize()
    act = rays[:, 7] > 0.5
    n_act = int(act.sum())
    k4_mis = int(((occ != ref4) & act).sum())
    k4_err = float((occ - ref4)[act].abs().max())
    k4_ms = cuda_ms(lambda: beamops.beam_any_hit_tiles(btable, rays))
    k4_plain_ms = cuda_ms(lambda: beamops.beam_any_hit_tiles_reference(btable, rays), reps=3)
    # bytes: the table rows the kernel's walk reads (its walk replayed as a
    # plain wavefront), the rays and the outputs; operations: at least the
    # root row's 4 child slab tests (27 fp32 ops each) per ray
    walk4, rows4 = beamops.beam_walk_rows(btable, rays)
    walk4_mis = int((walk4 != occ).sum())
    n_rows4 = int(rows4.sum())
    k4_bound = bound(n_rows4 * btable.shape[1] * 4 + nbytes(rays, occ, ovf), n_act * 4 * 27)
    log(f"phase3 K4 rays={tuple(rays.shape)} btable={tuple(btable.shape)}: occlusion "
        f"mismatch={k4_mis}/{n_act} active, occluded share {float(ref4[act].mean()):.3f}, "
        f"ovf nonzero={int((ovf != 0).sum())}, walk replay mismatch={walk4_mis}, rows read "
        f"{n_rows4} of {btable.shape[0]}; kernel {k4_ms:.3f} ms, plain "
        f"{k4_plain_ms:.3f} ms, bound {k4_bound[0]:.4f} ms ({k4_bound[1]})")
    assert n_act > 0
    assert k4_mis <= 1e-4 * n_act, k4_mis
    assert walk4_mis == 0, walk4_mis
    assert int((ovf != 0).sum()) == 0

    # ---- phase 4: the port's frame, CUDA (kernels) against CPU (plain) -----
    cfg = Config(scene="stress:4", width=256, height=192,
                 cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke4"))
    t0 = time.perf_counter()
    rg = Renderer(cfg, device="cuda")
    rc = Renderer(cfg, device="cpu")
    for _ in range(3):
        lg = rg.render_frame().cpu().numpy()
        lc = rc.render_frame().numpy()
    rg.shutdown()
    rc.shutdown()
    diff = np.abs(lg.astype(np.int32) - lc.astype(np.int32)).max(-1)
    within = float(np.mean(diff <= 2))
    log(f"phase4 stress:4 256x192 x3 frames cuda vs cpu: {within * 100:.3f}% of LDR "
        f"pixels within 2/255, mean |d| {float(diff.mean()):.4f}, max {int(diff.max())} "
        f"({time.perf_counter() - t0:.1f} s)")
    assert within >= 0.99, within

    # ---- phase 5: the simple-direct main path ------------------------------
    t0 = time.perf_counter()
    r = Renderer(Config(scene="stress", width=1920, height=1080,
                        cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke_main")),
                 device="cuda")
    setup_s = time.perf_counter() - t0
    r._model.keep = ("gbuffer", "hdr")
    n_frames = 8
    reset_counts()
    frame_ms = []
    for _ in range(n_frames):
        f0 = time.perf_counter()
        r.render_frame()
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - f0) * 1e3)
    launches = counts()
    ldr = r.last_frame
    gb = r._model.last_resources["gbuffer"]
    hdr = r._model.last_resources["hdr"]
    stats = r.stats()
    png = os.path.join(tempfile.gettempdir(), "chip_smoke_stress_1080p.png")
    r.save_screenshot(png)
    r.shutdown()
    valid = float(gb.valid.float().mean())
    ms_med = statistics.median(frame_ms[1:])
    log(f"phase5 simple main path stress 1920x1080 x{n_frames}: setup {setup_s:.1f} s "
        f"(BVH+beam table {r.bvh_seconds:.1f} s), frame ms "
        f"{[round(x, 2) for x in frame_ms]}, median frames 2-{n_frames} {ms_med:.2f} ms, "
        f"launches {launches}, gbuffer valid {valid:.3f}, stats {json.dumps(stats)}, png {png}")
    assert tuple(ldr.shape) == (1080, 1920, 3) and ldr.dtype == torch.uint8
    assert bool(torch.isfinite(hdr).all()), "non-finite HDR"
    assert valid > 0.5, valid
    assert launches["K1"] >= 3 * n_frames, launches
    assert launches["K4"] >= n_frames, launches
    assert launches["K2"] == 0 and launches["K3"] == 0 and launches["K5"] == 0, launches
    assert stats["rt_overflow_tiles"] == 0
    del r, gb, hdr, ldr

    # ---- capture the first 1080p stress restir frame's K2 / K3 inputs ------
    t0 = time.perf_counter()
    cap = {"k3": []}
    k2_orig, k3_orig = rko.restir_candidates, b16ops.bvh16_walk

    def k2_spy(*a, **kw):
        cap.setdefault("k2", (a, kw))
        return k2_orig(*a, **kw)

    def k3_spy(table, o, d, t_max, any_hit, max_steps, t_min=1e-4):
        cap["k3"].append((table, o, d, t_max, any_hit, max_steps, t_min))
        return k3_orig(table, o, d, t_max, any_hit, max_steps, t_min)

    rko.restir_candidates, b16ops.bvh16_walk = k2_spy, k3_spy
    try:
        rr = Renderer(Config(scene="stress", width=1920, height=1080, direct_mode="restir",
                             cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke_rx")),
                      device="cuda")
        rr._model.keep = ("gbuffer",)
        rr.render_frame()
        torch.cuda.synchronize()
        gb = rr._model.last_resources["gbuffer"]
        table16 = rr._model.rt.bvh16.table
        rr.shutdown()
    finally:
        rko.restir_candidates, b16ops.bvh16_walk = k2_orig, k3_orig
    assert "k2" in cap and cap["k3"], "the first restir frame did not reach K2 and K3"
    log(f"captured first 1080p stress restir frame in {time.perf_counter() - t0:.1f} s "
        f"(K3 calls: {[tuple(c[1].shape) for c in cap['k3']]})")

    # ---- phase 6: K2 against its plain version ------------------------------
    a, kw = cap["k2"]
    got = rko.restir_candidates(*a, **kw)
    ref = rko.restir_candidates_reference(*a, **kw)
    torch.cuda.synchronize()
    flat3, tsel, planes = a[0], a[1], a[2]
    y_same = got[0] == ref[0]
    id_share = float(y_same.float().mean())
    w_rel = float(((got[3] - ref[3]).abs() / ref[3].abs().clamp(min=1e-30))[y_same].max())
    k2_err = max(float((g - r_).abs().max()) for g, r_ in zip(got, ref))   # y/u/v/w_sum/row
    k2_ms = cuda_ms(lambda: rko.restir_candidates(*a, **kw))
    k2_plain_ms = cuda_ms(lambda: rko.restir_candidates_reference(*a, **kw), reps=3)
    Hp, Wp = planes.shape[1:]
    n_cand = kw["num_candidates"]
    # per pixel ~40 fp32 ops of set-up, per candidate 189 (light 34 + emissive
    # 57 + GGX p-hat 92 + RIS 3 + uniforms 3), counted from the kernel source
    k2_bound = bound(nbytes(flat3, tsel, planes, a[3], *got), Hp * Wp * (40 + 189 * n_cand))
    drawn = float((ref[0] >= 0).float().mean())
    log(f"phase6 K2 planes={tuple(planes.shape)} tiles={tuple(flat3.shape)} "
        f"candidates={n_cand}: id agreement {id_share:.6f}, w_sum max rel err {w_rel:.3g} "
        f"where ids agree, max|d| all outputs {k2_err:.3g}, pixels with a winner {drawn:.3f}; "
        f"kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms, bound {k2_bound[0]:.4f} ms "
        f"({k2_bound[1]})")
    assert id_share >= 0.999, id_share
    assert w_rel <= 1e-5, w_rel
    assert k2_err == 0.0, "K2 is not bit-exact with its plain version"
    assert drawn > 0.3, drawn

    # ---- phase 7: K3 against its plain version ------------------------------
    # the captured any-hit walks (stragglers, reduced-rate mismatches) and 64k
    # closest-hit rays from G-buffer points, cosine-distributed about the normal
    gen = torch.Generator(device="cuda").manual_seed(7)
    vpix = torch.nonzero(gb.valid.reshape(-1)).flatten()
    pick = vpix[torch.linspace(0, vpix.numel() - 1, 65536, device="cuda").round().long()]
    n_ = gb.normal.reshape(-1, 3)[pick]
    o_ = gb.world_pos.reshape(-1, 3)[pick] + gb.geo_normal.reshape(-1, 3)[pick] * 0.05
    u1 = torch.rand(65536, device="cuda", generator=gen)
    u2 = torch.rand(65536, device="cuda", generator=gen)
    local = torch.stack([torch.sqrt(u1) * torch.cos(6.283185307 * u2),
                         torch.sqrt(u1) * torch.sin(6.283185307 * u2),
                         torch.sqrt(1.0 - u1)], -1)
    d_ = smp.to_world(n_, local).contiguous()
    tmax_ = torch.full((65536,), b16ops.INF, device="cuda")
    walks = [(f"any[{i}]", c) for i, c in enumerate(cap["k3"])]
    walks.append(("closest64k", (table16, o_.contiguous(), d_, tmax_, False,
                                 b16ops.UNCAPPED_STEPS, 1e-4)))
    k3_rows = []
    for name, (tab, o, d, tm, any_hit, steps, t_min) in walks:
        bt, btri, bs = b16ops.bvh16_walk(tab, o, d, tm, any_hit, steps, t_min)
        pt, ptri, ps, rows = b16ops.bvh16_walk_reference(tab, o, d, tm, any_hit, steps, t_min,
                                                         return_visited=True)
        torch.cuda.synchronize()
        tri_mis = int((btri != ptri).sum())
        t_mis = int((bt != pt).sum())
        step_mis = int((bs != ps).sum())
        hit = ptri >= 0
        occ_mis = int((((btri >= 0) & (bt < tm)) != (hit & (pt < tm))).sum())
        capped = float(((ps >= steps) & ~hit).float().mean())
        ms = cuda_ms(lambda: b16ops.bvh16_walk(tab, o, d, tm, any_hit, steps, t_min))
        pms = cuda_ms(lambda: b16ops.bvh16_walk_reference(tab, o, d, tm, any_hit, steps, t_min),
                      reps=3)
        # bytes: the rows the walk reads (the plain walk reads the same), the
        # rays and the outputs; >= 432 fp32 ops per step (16 slab tests of 27)
        n_rows = int(rows.sum())
        bnd = bound(n_rows * tab.shape[1] * 4 + nbytes(o, d, tm, bt, btri, bs),
                    int(ps.sum()) * 432)
        k3_rows.append(dict(name=name, rays=o.shape[0], ms=ms, plain_ms=pms, bound=bnd,
                            err=float((bt - pt).abs().max())))
        log(f"phase7 K3 {name} rays={o.shape[0]} any_hit={any_hit} max_steps={steps}: "
            f"tri mismatch {tri_mis}, t mismatch {t_mis}, occlusion mismatch {occ_mis}, "
            f"steps mismatch {step_mis}, hit share {float(hit.float().mean()):.3f}, capped "
            f"share {capped:.4f}, mean steps {float(ps.float().mean()):.2f}, rows read "
            f"{n_rows} of {tab.shape[0]}; kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]})")
        assert tri_mis == 0 and t_mis == 0 and step_mis == 0 and occ_mis == 0, \
            f"K3 {name} is not bit-exact with its plain version"
    k3_main = max(k3_rows, key=lambda x: x["rays"] if x["name"] != "closest64k" else -1)
    del gb

    # ---- phase 8: the restir frame, CUDA (kernels) against CPU (plain) -----
    cfg = Config(scene="stress:4", width=256, height=192, direct_mode="restir",
                 cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke4rx"))
    t0 = time.perf_counter()
    rg = Renderer(cfg, device="cuda")
    rc = Renderer(cfg, device="cpu")
    for _ in range(3):
        lg = rg.render_frame().cpu().numpy()
        lc = rc.render_frame().numpy()
    sg, sc_ = rg.stats(), rc.stats()
    rg.shutdown()
    rc.shutdown()
    diff = np.abs(lg.astype(np.int32) - lc.astype(np.int32)).max(-1)
    within = float(np.mean(diff <= 2))
    log(f"phase8 restir stress:4 256x192 x3 frames cuda vs cpu: {within * 100:.3f}% of LDR "
        f"pixels within 2/255, mean |d| {float(diff.mean()):.4f}, max {int(diff.max())}; "
        f"stats cuda {json.dumps(sg)} cpu {json.dumps(sc_)} ({time.perf_counter() - t0:.1f} s)")
    assert within >= 0.97, within

    # ---- phase 9: the restir main path ---------------------------------------
    t0 = time.perf_counter()
    r = Renderer(Config(scene="stress", width=1920, height=1080, direct_mode="restir",
                        cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke_rx_main")),
                 device="cuda")
    setup_rx = time.perf_counter() - t0
    r._model.keep = ("gbuffer", "hdr")
    # per-pass CUDA events; a host sync inside RTXDI or Denoise raises
    events = time_passes(r.graph, strict=("RTXDI", "Denoise"))
    reset_counts()
    frame_rx, stats_rx = [], []
    for _ in range(n_frames):
        f0 = time.perf_counter()
        r.render_frame()
        torch.cuda.synchronize()
        frame_rx.append((time.perf_counter() - f0) * 1e3)
        stats_rx.append(r.stats())
    launches_rx = counts()
    ldr = r.last_frame
    gb = r._model.last_resources["gbuffer"]
    hdr = r._model.last_resources["hdr"]
    png_rx = os.path.join(tempfile.gettempdir(), "chip_smoke_stress_restir_1080p.png")
    r.save_screenshot(png_rx)
    passes = [p.name for p in r.graph.passes if p.enabled]
    r.shutdown()
    pass_ms = {k: median_ms(v) for k, v in events.items()}
    rx_med = statistics.median(frame_rx[1:])
    lanes = sum(s_["rt_k3_lanes_di"] for s_ in stats_rx)
    capped = sum(s_["rt_k3_capped_di"] for s_ in stats_rx)
    log(f"phase9 restir main path stress 1920x1080 x{n_frames}: setup {setup_rx:.1f} s "
        f"(BVH+beam table+bvh16+light pool {r.bvh_seconds:.1f} s), "
        f"passes {passes}, frame ms {[round(x, 2) for x in frame_rx]}, median frames "
        f"2-{n_frames} {rx_med:.2f} ms, launches {launches_rx}, rt_overflow_di per frame "
        f"{[s_['rt_overflow_di'] for s_ in stats_rx]}, K3 lanes {lanes}, capped {capped} "
        f"(share {capped / max(lanes, 1):.4f}), gbuffer valid "
        f"{float(gb.valid.float().mean()):.3f}, png {png_rx}")
    log(f"phase9 per-pass stream ms (CUDA events, median of frames 2-{n_frames}): "
        f"{json.dumps(pass_ms)}")
    assert tuple(ldr.shape) == (1080, 1920, 3) and ldr.dtype == torch.uint8
    assert bool(torch.isfinite(hdr).all()), "non-finite HDR"
    assert "RTXDI" in passes and "Denoise" in passes and "SunShadow" not in passes, passes
    assert launches_rx["K1"] >= 3 * n_frames, launches_rx
    assert launches_rx["K2"] >= n_frames and launches_rx["K3"] >= n_frames, launches_rx
    assert launches_rx["K4"] >= 2 * n_frames, launches_rx
    assert launches_rx["K5"] == 0, launches_rx
    del r, gb, hdr, ldr

    # ---- phase 10: K5 against its plain version on the first NormalBasic
    # 1080p stress frame's shadow atlas --------------------------------------
    t0 = time.perf_counter()
    cap5 = {}
    k5_orig = rk.raster_tiles

    def k5_spy(records, work_tile, work_slot, **kw):
        cap5.setdefault("k5", (records, work_tile, work_slot, kw))
        return k5_orig(records, work_tile, work_slot, **kw)

    rk.raster_tiles = k5_spy
    try:
        r = Renderer(Config(scene="stress", width=1920, height=1080, mode="normal_basic",
                            cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke_nb")),
                     device="cuda")
        r.render_frame()
        torch.cuda.synchronize()
        r.shutdown()
    finally:
        rk.raster_tiles = k5_orig
    assert "k5" in cap5, "the first NormalBasic frame did not reach K5"
    records5, wt5, ws5, kw5 = cap5["k5"]
    assert kw5["depth_only"], kw5
    tiles5, tx5 = kw5["tiles"], kw5["tx"]
    n_items5 = int((wt5 < tiles5).sum())
    log(f"captured first 1080p stress NormalBasic frame in {time.perf_counter() - t0:.1f} s")
    k5_runs = {}
    for depth_only in (True, False):
        def k5_call(fn=rk.raster_tiles, depth_only=depth_only):
            return fn(records5, wt5, ws5, tiles=tiles5, tx=tx5, depth_only=depth_only)
        d5, v5 = k5_call()
        rd5, rv5 = k5_call(rk.raster_tiles_reference)
        torch.cuda.synchronize()
        d_mis, v_mis = int((d5 != rd5).sum()), int((v5 != rv5).sum())
        ms = cuda_ms(k5_call)
        pms = cuda_ms(lambda: k5_call(rk.raster_tiles_reference), reps=3)
        # 13 fp32 ops per (item, pixel, row): 3 planes x (2 mul + 2 add), l1 + l2
        bnd = bound(nbytes(records5, wt5, ws5, d5, v5), n_items5 * 1024 * 32 * 13)
        k5_runs[depth_only] = dict(ms=ms, plain_ms=pms, bound=bnd,
                                   err=float((d5 - rd5).abs().max()))
        log(f"phase10 K5 depth_only={depth_only} tiles={tiles5} items={n_items5} "
            f"records={tuple(records5.shape)}: depth mismatch {d_mis}, visid mismatch {v_mis}, "
            f"covered texels {float((rd5 > 0).float().mean()):.3f}, kernel {ms:.3f} ms, plain "
            f"{pms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        assert d_mis == 0 and v_mis == 0, "K5 is not bit-exact with its plain version"
        assert depth_only or int((v5 >= 0).sum()) > 0
    k5_main = k5_runs[True]
    del records5, wt5, ws5, d5, v5, rd5, rv5

    # ---- phase 11: NormalBasic frames, CUDA (kernels) against CPU (plain) --
    for mode, need in (("none", 0.99), ("ssgi", 0.97), ("ddgi", 0.97)):
        cfg = Config(scene="stress:4", width=256, height=192, mode="normal_basic",
                     indirect_mode=mode,
                     cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke4nb_" + mode))
        t0 = time.perf_counter()
        rg = Renderer(cfg, device="cuda")
        rc = Renderer(cfg, device="cpu")
        for _ in range(3):
            lg = rg.render_frame().cpu().numpy()
            lc = rc.render_frame().numpy()
        rg.shutdown()
        rc.shutdown()
        diff = np.abs(lg.astype(np.int32) - lc.astype(np.int32)).max(-1)
        within = float(np.mean(diff <= 2))
        log(f"phase11 normal_basic+{mode} stress:4 256x192 x3 frames cuda vs cpu: "
            f"{within * 100:.3f}% of LDR pixels within 2/255, mean |d| {float(diff.mean()):.4f}, "
            f"max {int(diff.max())} ({time.perf_counter() - t0:.1f} s)")
        assert within >= need, (mode, within)

    # ---- phase 12: the NormalBasic + DDGI main path, then SSGI --------------
    t0 = time.perf_counter()
    r = Renderer(Config(scene="stress", width=1920, height=1080, mode="normal_basic",
                        indirect_mode="ddgi",
                        cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke_nb_main")),
                 device="cuda")
    setup_nb = time.perf_counter() - t0
    r._model.keep = ("hdr",)
    events = time_passes(r.graph)
    reset_counts()
    frame_nb, stats_nb, k3_frames = [], [], []
    for _ in range(n_frames):
        k3_0 = b16ops.launches
        f0 = time.perf_counter()
        r.render_frame()
        torch.cuda.synchronize()
        frame_nb.append((time.perf_counter() - f0) * 1e3)
        stats_nb.append(r.stats())
        k3_frames.append(b16ops.launches - k3_0)
    launches_nb = counts()
    hdr = r._model.last_resources["hdr"]
    png_nb = os.path.join(tempfile.gettempdir(), "chip_smoke_stress_nb_ddgi_1080p.png")
    r.save_screenshot(png_nb)
    passes_nb = [p.name for p in r.graph.passes if p.enabled]
    r.shutdown()
    pass_ms_nb = {k: median_ms(v) for k, v in events.items()}
    nb_med = statistics.median(frame_nb[1:])
    traced = [b - a for a, b in zip([0] + [s_["ddgi_traced_frames"] for s_ in stats_nb],
                                    [s_["ddgi_traced_frames"] for s_ in stats_nb])]
    lanes_nb = sum(s_["rt_k3_lanes_ddgi"] for s_ in stats_nb)
    capped_nb = sum(s_["rt_k3_capped_ddgi"] for s_ in stats_nb)
    log(f"phase12 normal_basic+ddgi main path stress 1920x1080 x{n_frames}: setup "
        f"{setup_nb:.1f} s (BVH+beam table+bvh16+light pool {r.bvh_seconds:.1f} s), passes "
        f"{passes_nb}, frame ms {[round(x, 2) for x in frame_nb]}, median frames 2-{n_frames} "
        f"{nb_med:.2f} ms, launches {launches_nb}, K3 launches per frame {k3_frames}, DDGI "
        f"traced frames {traced} (total {stats_nb[-1]['ddgi_traced_frames']}), NEE K3 rays "
        f"{lanes_nb}, capped {capped_nb} (share {capped_nb / max(lanes_nb, 1):.5f}), png {png_nb}")
    log(f"phase12 per-pass stream ms (CUDA events, median of frames 2-{n_frames}): "
        f"{json.dumps(pass_ms_nb)}")
    assert passes_nb == ["Culling", "Raster", "HZBBuild", "RasterPhase2", "ResolveGBuffer",
                         "MaskedLayer", "ShadowCSM", "IBL", "DDGI", "DeferredLighting", "Sky",
                         "Transparent", "TAA", "AutoExposure", "Bloom", "Tonemap"], passes_nb
    assert bool(torch.isfinite(hdr).all()), "non-finite HDR"
    assert launches_nb["K1"] >= 3 * n_frames and launches_nb["K5"] >= n_frames, launches_nb
    assert launches_nb["K2"] == 0 and launches_nb["K4"] == 0, launches_nb
    assert traced[0] == 1 and all(k >= 2 * t for k, t in zip(k3_frames, traced)), \
        (k3_frames, traced)
    del r, hdr

    t0 = time.perf_counter()
    r = Renderer(Config(scene="stress", width=1920, height=1080, mode="normal_basic",
                        indirect_mode="ssgi",
                        cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke_nb_ssgi")),
                 device="cuda")
    setup_ssgi = time.perf_counter() - t0
    events = time_passes(r.graph)
    reset_counts()
    frame_ssgi = []
    for _ in range(4):
        f0 = time.perf_counter()
        r.render_frame()
        torch.cuda.synchronize()
        frame_ssgi.append((time.perf_counter() - f0) * 1e3)
    launches_ssgi = counts()
    passes_ssgi = [p.name for p in r.graph.passes if p.enabled]
    rt_built = r._model.rt is not None
    r.shutdown()
    log(f"phase12 normal_basic+ssgi stress 1920x1080 x4: setup {setup_ssgi:.1f} s, frame ms "
        f"{[round(x, 2) for x in frame_ssgi]}, median frames 2-4 "
        f"{statistics.median(frame_ssgi[1:]):.2f} ms, launches {launches_ssgi}, RT scene built "
        f"{rt_built}; per-pass stream ms (median of frames 2-4) "
        f"{json.dumps({k: median_ms(v) for k, v in events.items()})}")
    assert "SSGI" in passes_ssgi and "DDGI" not in passes_ssgi, passes_ssgi
    assert launches_ssgi["K1"] >= 12 and launches_ssgi["K5"] >= 4, launches_ssgi
    assert launches_ssgi["K3"] == 0 and not rt_built, launches_ssgi

    # ---- phase 13: K6 on the first 1080p stress flagship frame's GI bounce
    # and reflection rays. The frame runs on its default route (K3); its two
    # closest_hit_counted calls are captured. The K6 path, closest_hit_auto(
    # ..., force_kernel=True) on those rays, runs with the counts reset just
    # before and read just after. Then K6 against its plain version on the
    # packed blocks, and against K3 -----------------------------------------
    t0 = time.perf_counter()
    cap13 = []
    counted_orig = traceops.closest_hit_counted

    def counted_spy(rt, o, d, active, max_steps=None):
        cap13.append((o, d, active))
        return counted_orig(rt, o, d, active, max_steps=max_steps)

    traceops.closest_hit_counted = counted_spy
    try:
        r = Renderer(Config(scene="stress", width=1920, height=1080, direct_mode="restir",
                            indirect_mode="restir",
                            cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke_flag_k6")),
                     device="cuda")
        r.render_frame()
        torch.cuda.synchronize()
    finally:
        traceops.closest_hit_counted = counted_orig
    stats_13 = r.stats()
    rt13 = r._model.rt
    assert len(cap13) == 2, f"expected the GI bounce and reflection calls, got {len(cap13)}"
    cap6 = []
    k6_orig = tk.closest_hit_blocks

    def k6_spy(btable, rays, t_min=1e-4):
        cap6.append((btable, rays, t_min))
        return k6_orig(btable, rays, t_min)

    tk.closest_hit_blocks = k6_spy
    try:
        reset_counts()
        for o13, d13, act13 in cap13:
            traceops.closest_hit_auto(rt13, o13, d13, active=act13, force_kernel=True)
        torch.cuda.synchronize()
        launches_k6 = counts()
    finally:
        tk.closest_hit_blocks = k6_orig
    table16 = rt13.bvh16.table
    # a coherent control set: the camera rays of every other pixel
    vc = r.view_constants()
    d_cam = skyops.view_dirs_from_pixels(vc, 1080, 1920)[::2, ::2].reshape(-1, 3)
    o_cam = vc["camera_pos"][None, :].expand_as(d_cam)
    cam_rays, _ = traceops.pack_rays_sorted(
        o_cam, d_cam, torch.full((d_cam.shape[0],), traceops.TMAX_CAP, device="cuda"),
        torch.ones((d_cam.shape[0],), dtype=torch.bool, device="cuda"),
        torch.as_tensor(rt13.bvh.root_box, device="cuda"))
    cap6.append((rt13.btable, cam_rays, 1e-4))
    r.shutdown()
    del cap13, rt13
    log(f"phase13 flagship frame 1 on the default route, then its GI bounce and reflection "
        f"rays through closest_hit_auto(force_kernel=True): launches {launches_k6}, frame stats "
        f"{json.dumps(stats_13)} ({time.perf_counter() - t0:.1f} s)")
    assert len(cap6) == 3 and launches_k6["K6"] == 2, (len(cap6), launches_k6)
    assert sum(launches_k6.values()) == 2, launches_k6
    k6_rows = []
    for name, (btab, rays6, t_min) in zip(("gi_bounce", "specular", "camera_control"), cap6):
        got = tk.closest_hit_blocks(btab, rays6, t_min)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        st6 = {}
        e0.record()
        ref = tk.closest_hit_blocks_reference(btab, rays6, t_min, stats=st6)
        e1.record()
        torch.cuda.synchronize()
        pms = e0.elapsed_time(e1)
        mism = [int((g != x).sum()) for g, x in zip(got, ref)]
        ms = cuda_ms(lambda: tk.closest_hit_blocks(btab, rays6, t_min))
        T6 = rays6.shape[0]
        flat = rays6.permute(0, 2, 1).reshape(-1, 8)
        act = flat[:, 7] > 0.5
        o6, d6, tm6 = (flat[act, 0:3].contiguous(), flat[act, 3:6].contiguous(),
                       flat[act, 6].contiguous())
        steps3 = max(24, 512 // 4)          # the main path's K3 budget for these rays
        bt3, btri3, bs3 = b16ops.bvh16_walk(table16, o6, d6, tm6, False, steps3, t_min)
        ms3 = cuda_ms(lambda: b16ops.bvh16_walk(table16, o6, d6, tm6, False, steps3, t_min))
        tri6 = got[1].reshape(-1)[act].to(torch.int32)
        t6 = got[0].reshape(-1)[act]
        ovf_lane = (got[5] > 0.5)[:, None].expand(T6, tk.PIX).reshape(-1)[act]
        capped3 = bs3 >= steps3
        clean = ~ovf_lane & ~capped3
        agree = tri6 == btri3
        ties = ~agree & (t6 == bt3)
        n_clean = int(clean.sum())
        bad = int((clean & ~agree & ~ties).sum())
        missed = int((ovf_lane & (btri3 >= 0) & (tri6 < 0)).sum())
        n_ovf6 = int((got[5] > 0.5).sum())
        bnd = bound(st6["rows"] * btab.shape[1] * 4 + nbytes(rays6, *got),
                    st6["leaf_lane_rows"] * 4 * tk.MT_OPS + st6["box_tests"] * tk.BOX_OPS)
        k6_rows.append(dict(name=name, blocks=T6, lanes=int(act.sum()), ms=ms, plain_ms=pms,
                            k3_ms=ms3, bound=bnd, err=max(float((g - x).abs().max())
                                                          for g, x in zip(got[:5], ref[:5])),
                            ovf_blocks=n_ovf6))
        log(f"phase13 K6 {name} blocks={T6} active lanes={int(act.sum())}: mismatches vs plain "
            f"(t, tri, u, v, front, ovf) {mism}; overflowed blocks {n_ovf6}/{T6} "
            f"({n_ovf6 / T6:.3f}); rows read {st6['rows']} (leaf {st6['leaf_rows']}); hit share "
            f"K6 {float((tri6 >= 0).float().mean()):.4f} "
            f"K3 {float((btri3 >= 0).float().mean()):.4f}; K6 vs K3 ({steps3} steps) on {n_clean} lanes outside overflowed blocks and "
            f"K3-capped lanes: tri agree {int((clean & agree).sum())}, t ties "
            f"{int((clean & ties).sum())}, other {bad}; K3-capped lanes {int(capped3.sum())}; "
            f"hits K6 missed in overflowed blocks {missed}; kernel {ms:.3f} ms, K3 {ms3:.3f} ms, "
            f"plain {pms:.1f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        assert all(m == 0 for m in mism), f"K6 {name} is not bit-exact with its plain version"
        if bad:         # checked at the end, so that the later phases still report
            late_failures.append(f"K6 {name} disagrees with K3 on {bad} clean lanes")
        k6_rows[-1]["clean"] = n_clean
    if k6_rows[-1]["clean"] == 0:
        late_failures.append("no camera-ray block stayed inside the frontier")
    k6_main = k6_rows[0]         # the GI bounce rays: the main path's largest K6 call
    del cap6, got, ref, table16

    # ---- phase 14: the flagship frame, CUDA (kernels) against CPU (plain) --
    cfg = Config(scene="stress:4", width=256, height=192, direct_mode="restir",
                 indirect_mode="restir",
                 cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke4flag"))
    t0 = time.perf_counter()
    rg = Renderer(cfg, device="cuda")
    rc = Renderer(cfg, device="cpu")
    for _ in range(3):
        lg = rg.render_frame().cpu().numpy()
        lc = rc.render_frame().numpy()
    sg, sc_ = rg.stats(), rc.stats()
    rg.shutdown()
    rc.shutdown()
    diff = np.abs(lg.astype(np.int32) - lc.astype(np.int32)).max(-1)
    within = float(np.mean(diff <= 2))
    log(f"phase14 flagship stress:4 256x192 x3 frames cuda vs cpu: {within * 100:.3f}% of LDR "
        f"pixels within 2/255, mean |d| {float(diff.mean()):.4f}, max {int(diff.max())}; "
        f"stats cuda {json.dumps(sg)} cpu {json.dumps(sc_)} ({time.perf_counter() - t0:.1f} s)")
    assert within >= 0.99, within

    # ---- phase 15: the flagship main path -----------------------------------
    t0 = time.perf_counter()
    r = Renderer(Config(scene="stress", width=1920, height=1080, direct_mode="restir",
                        indirect_mode="restir",
                        cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke_flag_main")),
                 device="cuda")
    setup_fl = time.perf_counter() - t0
    r._model.keep = ("hdr",)
    syncs = {}
    events = time_passes(r.graph, strict=("RTXDI", "Denoise"),
                         watch=("RTXDIGI", "SpecularIndirect"), syncs=syncs)
    reset_counts()
    frame_fl, stats_fl, per_frame = [], [], []
    for _ in range(n_frames):
        c0 = counts()
        f0 = time.perf_counter()
        r.render_frame()
        torch.cuda.synchronize()
        frame_fl.append((time.perf_counter() - f0) * 1e3)
        stats_fl.append(r.stats())
        per_frame.append({k: v - c0[k] for k, v in counts().items()})
    launches_fl = counts()
    ldr = r.last_frame
    hdr = r._model.last_resources["hdr"]
    png_fl = os.path.join(tempfile.gettempdir(), "chip_smoke_stress_flagship_1080p.png")
    r.save_screenshot(png_fl)
    passes_fl = [p.name for p in r.graph.passes if p.enabled]
    r.shutdown()
    pass_ms_fl = {k: median_ms(v) for k, v in events.items()}
    fl_med = statistics.median(frame_fl[1:])

    def share(lanes_key, capped_key):
        lanes_ = sum(s_[lanes_key] for s_ in stats_fl)
        capped_ = sum(s_[capped_key] for s_ in stats_fl)
        return f"{capped_}/{lanes_} ({capped_ / max(lanes_, 1):.5f})"
    log(f"phase15 flagship main path stress 1920x1080 x{n_frames}: setup {setup_fl:.1f} s "
        f"(BVH+beam table+bvh16+light pool {r.bvh_seconds:.1f} s), passes {passes_fl}, frame ms "
        f"{[round(x, 2) for x in frame_fl]}, median frames 2-{n_frames} {fl_med:.2f} ms, "
        f"launches {launches_fl}, per frame {per_frame}, rt_overflow_di per frame "
        f"{[s_['rt_overflow_di'] for s_ in stats_fl]}, rt_overflow_gi per frame "
        f"{[s_['rt_overflow_gi'] for s_ in stats_fl]}, GI traced frames "
        f"{stats_fl[-1]['gi_traced_frames']}, K3 capped: GI bounce "
        f"{share('rt_k3_lanes_gi', 'rt_k3_capped_gi')}, GI NEE "
        f"{share('rt_k3_lanes_gi_nee', 'rt_k3_capped_gi_nee')}, specular "
        f"{share('rt_k3_lanes_spec', 'rt_k3_capped_spec')}, specular NEE "
        f"{share('rt_k3_lanes_spec_nee', 'rt_k3_capped_spec_nee')}; specular lanes past CAP per "
        f"frame {[s_['spec_past_cap'] for s_ in stats_fl]}; host syncs in RTXDIGI / "
        f"SpecularIndirect over the {n_frames} frames {syncs}; png {png_fl}")
    log(f"phase15 per-pass stream ms (CUDA events, median of frames 2-{n_frames}): "
        f"{json.dumps(pass_ms_fl)}")
    assert tuple(ldr.shape) == (1080, 1920, 3) and ldr.dtype == torch.uint8
    assert bool(torch.isfinite(hdr).all()), "non-finite HDR"
    assert passes_fl == ["Culling", "Raster", "HZBBuild", "RasterPhase2", "ResolveGBuffer",
                         "MaskedLayer", "IBL", "RTXDI", "RTXDIGI", "Denoise", "SpecularIndirect",
                         "DeferredLighting", "Sky", "Transparent", "TAA", "AutoExposure",
                         "Bloom", "Tonemap"], passes_fl
    assert launches_fl["K1"] >= 3 * n_frames and launches_fl["K2"] >= n_frames, launches_fl
    assert launches_fl["K4"] >= 3 * n_frames and launches_fl["K3"] >= 4 * n_frames, launches_fl
    assert launches_fl["K5"] == 0 and launches_fl["K6"] == 0, launches_fl
    assert stats_fl[-1]["gi_traced_frames"] == n_frames // 2
    del r, hdr, ldr

    assert not late_failures, late_failures
    jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    assert not jax_mods, f"the port loaded jax: {jax_mods[:5]}"
    ref_mods = sorted(m for m in sys.modules
                      if m == "hobbyrenderer_tpu" or m.startswith("hobbyrenderer_tpu."))
    assert not ref_mods, f"the port loaded the JAX package: {ref_mods[:5]}"

    def entry(name, source, replaces, key, err, ms, plain_ms, bnd, main=None, **extra):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=(main or launches_fl)[key], max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                    launches_simple_path=launches[key], launches_restir_path=launches_rx[key],
                    launches_normal_basic=launches_nb[key],
                    launches_flagship_path=launches_fl[key],
                    launches_flagship_k6_route=launches_k6[key], **extra)

    kernels_line = {"kernels": [
        entry("raster_resolve_tiles", "hobbyrenderer_tpu_torch/csrc/raster_resolve.cu",
              "hobbyrenderer_tpu/ops/raster_pallas.py:212", "K1", max(depth_err, attr_err),
              k1_ms, k1_plain_ms, k1_bound),
        entry("restir_candidates", "hobbyrenderer_tpu_torch/csrc/restir_candidates.cu",
              "hobbyrenderer_tpu/ops/restir_pallas.py:65", "K2", k2_err, k2_ms, k2_plain_ms,
              k2_bound),
        entry("bvh16_walk", "hobbyrenderer_tpu_torch/csrc/bvh16_walk.cu",
              "hobbyrenderer_tpu/ops/wtrace.py:71", "K3", k3_main["err"], k3_main["ms"],
              k3_main["plain_ms"], k3_main["bound"], rays=k3_main["rays"],
              walks={x["name"]: [x["rays"], x["ms"], x["plain_ms"], x["bound"][0]]
                     for x in k3_rows}),
        entry("beam_any_hit_tiles", "hobbyrenderer_tpu_torch/csrc/beam_any_hit.cu",
              "hobbyrenderer_tpu/ops/beam.py:68", "K4", k4_err, k4_ms, k4_plain_ms, k4_bound),
        entry("raster_tiles", "hobbyrenderer_tpu_torch/csrc/raster_resolve.cu",
              "hobbyrenderer_tpu/ops/raster_pallas.py:148", "K5", k5_main["err"],
              k5_main["ms"], k5_main["plain_ms"], k5_main["bound"], main=launches_nb,
              depth_visid={k: k5_runs[False][k] for k in ("ms", "plain_ms")}),
        entry("closest_hit_blocks", "hobbyrenderer_tpu_torch/csrc/closest_blocks.cu",
              "hobbyrenderer_tpu/ops/trace.py:64", "K6", k6_main["err"], k6_main["ms"],
              k6_main["plain_ms"], k6_main["bound"], main=launches_k6,
              ray_sets={x["name"]: dict(blocks=x["blocks"], lanes=x["lanes"], ms=x["ms"],
                                        plain_ms=x["plain_ms"], k3_ms=x["k3_ms"],
                                        bound_ms=x["bound"][0], overflowed=x["ovf_blocks"],
                                        lanes_checked_against_k3=x["clean"])
                        for x in k6_rows})]}
    log(f"chip_smoke total seconds: {time.perf_counter() - t_start:.1f}")
    log(json.dumps(kernels_line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
