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
kernel of each path launched. Then the walk-step microbenchmarks K7-K9
(their entry point `python -m hobbyrenderer_tpu_torch.bench_wkernels`, then
each against its plain version, phase 16) and the reference path tracer:
CUDA against CPU at 256x192 on the compacted wavefront, every K3 walk of
both runs spied on to show where they part (phase 17), its main
path, bench.py's PT configuration (stress at 960x540, 1 spp, 8 bounces;
trace_paths under set_sync_debug_mode("error"); the first frame's
full-width closest-hit and compacted NEE walks held against the plain K3
walk, phase 18), and ROADMAP item 18: the port's PT references (each
reference's first compacted 16-spp frame rendered twice, bit-identical)
against the port's flagship under tests/test_golden.py's gates (phase 19).
Between phases 15 and 16 run the IBL frame with ReSTIR DI on ReGIR onion
cells and the combined indirect mode (SHARC plus a traced half-res bounce
that reads the cache), 8 frames at 1920x1080 as the main path (phase 20:
the JAX graph's passes, K1-K4 every frame, a finite HDR, SHARC's occupied
slots never shrinking), K2 on its first frame's 1,080-cell table (phase
21), its second frame's SHARC update twice on the card and once on the
CPU (phase 22), and three new configurations CUDA against CPU at 256x192
(phase 23). Last, this slice's main path: the flagship frame on the
stress scene with every 8th node animated (so every frame refits the
ray-tracing scene on the card) and a seeded 2048x1024 HDR sky turned into
64 directional lights, 8 frames at 1920x1080 (phase 24: frame and pass
times with the refit's, host syncs by pass, K1-K4 every frame; frame 3's
K3 walks and K4 calls on the refitted tables and its K2 call on the
env-light pool held bit for bit against their plain versions, three
launches equal; the refit twice on the card, the same bits, and once on
the CPU), the same upscaled from render_scale 0.5 in turns with the native
one (phase 25: K1 at 960x540 bit-exact), and three configurations CUDA
against CPU at 256x192 (phase 26). Then texture streaming and the debug
views: the flagship at 1920x1080 with tex_streaming (the default 64 MB
pool, the streamer's worker thread, feedback fetched every 8th frame), 24
frames in turns with the plain flagship's (phase 27: frame ms, per-pass
stream ms with Frame/TexStreaming, tiles uploaded a frame, the frame the
resident mips settle on, host syncs by pass, K1-K4 launches a frame;
frame 13's K1-K4 calls held against their plain versions; every textured
material the feedback demands finer than its tail off the tail), four
debug configurations at 1080p, 3 frames each (phase 28: ssgi_hit_mask;
csm_debug + ddgi_debug + csm_cascade_splits; sharc_heatmap; the streamed
flagship with tex_debug), and CUDA against CPU at 256x192 (phase 29: the
streamed flagship in a 2 MB pool with lockstep sync-mode streamers, the
streaming tables equal after every apply; every view of ALL_VIEWS on one
frame's DebugView inputs; the streamed path tracer). Last, the multi-GPU
layer (parallel/): the machine has one card, so NCCL runs one rank and 2
and 4 ranks are gloo ranks sharing cuda:0 (their times measure contention,
not scaling), started by parallel/launch.py::run_ranks. Phase 30: on each
world size, extend_rows (halos 1, 8, 32), all_gather_rows, psum_int and
sum_ordered on the card equal to the same calls on CPU tensors of the same
ranks, each one's ms, and which collectives gloo takes on CUDA tensors.
Phase 31: bench.py's sharded flagship (FlagshipShardedRenderer on stress,
1920 wide, the height rounded up to ranks x 32: 1088, 1088, 1152), 8
frames on each rank (frame ms, collectives and their ms timed alone, host
syncs by stage, K1-K4 launches a frame); rank 1 holds one frame's K1 (ty0
= 17 at n = 2), K2 (y0 = 544), K3 and K4 calls bit for bit with three
launches equal; its Raster depth and visid equal rows 544-1087 of the one
rank frame's; with the straggler caps lifted the 2-rank frames against
the one-rank frames, printed as they are (the JAX package's sharded
semantics: zero halo rows past the frame, a band-limited bloom pyramid),
and, with those two reference deltas also lifted, >= 99% within 2/255;
one DeferredShardedRenderer
(with_csm) frame holds K5's atlas call. Phase 32: the flagship's ssgi,
sharc and ddgi modes on 2 ranks (finite, the SHARC caches equal), the
sample-parallel path tracer at 960x540 on 2 ranks equal bit for bit to
trace_paths(spp=2) in this process, the streamed feedback summed over 2
ranks equal to the whole frame's, and 2 CUDA ranks against 2 CPU ranks at
256x192 (>= 99% within 2/255). Ranks print nothing: they return their
lines to this process.
Any failed check raises: the script then exits nonzero without its final
line.

Phase 33 runs right after the build: the sky's in-scatter march
(csrc/sky_march.cu, a kernel of the port alone) against its plain version
at pt.still's 8,294,400 lanes (with the sun disk, then under a mask keeping
~40% of them) and at sky_radiance_fast's 480x270 grid of a 1080p image, bit
for bit, with ms a call of both; phase 18 counts its launches, one a bounce.

Kernels: K1 tile raster and K5 depth-only tile raster
(csrc/raster_resolve.cu), K2 ReSTIR candidates (csrc/restir_candidates.cu),
K3 bvh16 walk (csrc/bvh16_walk.cu), K4 any hit (csrc/beam_any_hit.cu), K6
sorted-block closest hit (csrc/closest_blocks.cu), K7-K9 the walk-step
microbenchmarks (csrc/wkernels.cu). Each one's bound
(bound_ms) is the larger of its bytes (inputs read once, outputs written
once; of the walks' node tables, K3, K4 and K6, only the rows this run's
rays read, for K3 the 384 B of an interior row or 480 B of a leaf row that
a step reads, for K4 an interior row's 96 B and a leaf row's 160 B) over
3.35 TB/s and its fp32 operations on this run's data over 67 TFLOP/s (H100
SXM data sheet); for K1 and K5 the bytes and operations their work needs
(bench_raster.raster_bound), for K2 and K4 bench_k2k4.k2_bound and
k4_bound, for K6 bench_k6.k6_bound; K2's entry also carries its issue-rate estimate (its SASS
instructions, from cuobjdump, over the card's 132 x 4 warp schedulers).
K2, K3, K5, K6 and K7-K9 must equal their plain versions bit for bit, in
every output, K1 in depth and visid (its attribute planes within 1e-4),
and K4 in the occlusion of all but 1e-4 of the active lanes (and equal its
walk replayed in plain PyTorch on every lane). K3, which hands rays out
through an atomic queue, is launched three times on each walk of phases 7
and 18, K4, which hands out tile parts through one, on each of phase 3's
four calls (the simple frame's SunShadow call and the first flagship
frame's RTXDI and RTXDIGI calls), K2 on phases 6's and 21's calls, K6 (a block's
lanes over a thread-block cluster) on phase 13's three calls, and K1 and K5,
which hand out work units through one, on every captured call of phases 2
and 10: each must give the same bits each time.

Output, in order: the card's name and power limit, versions, build time,
one line per phase, the kernels JSON line, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits nonzero when no GPU is visible, and when run outside the repository.
"""

import contextlib
import ctypes
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

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
    """Render the first 1080p stress frame, capturing the inputs of every
    raster-kernel call (Raster, RasterPhase2, MaskedLayer, Transparent's
    layers) and of the sun-shadow call."""
    seen = {"k1": []}
    k1_orig, k4_orig = rk.raster_resolve_tiles, beamops.beam_any_hit_tiles

    def k1_spy(records, work_tile, work_slot, **kw):
        seen["k1"].append((records, work_tile, work_slot, kw))
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
    assert seen["k1"] and "k4" in seen, "first frame did not reach both kernels"
    return seen


def kernel_us(calls, name, reps=20, attempts=3):
    """Median device time in us of each of ``calls`` (functions that launch
    one kernel whose name holds ``name``) over ``reps`` rounds that
    interleave them, from a torch.profiler (CUPTI) trace: the kernel's own
    run, without the ~3 us a launch adds on the stream. Interleaving keeps
    the calls under one cache and allocation state. A trace that lost
    kernels (seen about once in a hundred traces) is taken again."""
    for f in calls:
        f()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    k = len(calls)
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                for f in calls:
                    f()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name),
                    key=lambda e: e.time_range.start)
        if len(ev) == reps * k:
            return [statistics.median(e.time_range.elapsed_us() for e in ev[i::k])
                    for i in range(k)]
        log(f"  profiler trace held {len(ev)} {name} kernels of {reps * k}: taken again")
    raise AssertionError(f"{attempts} profiler traces lost {name} kernels")


def iters_scaling(fn, name, it):
    """The kernel's own time (ms) at it, it/2 and it/4 iterations, the ratio
    of the first two, and the marginal ratio (t(it) - t(it/2)) / (t(it/2) -
    t(it/4)): 2 when every repeat runs, whatever the kernel's fixed cost."""
    k64, k32, k16 = (t / 1e3 for t in kernel_us(
        [lambda: fn(it), lambda: fn(it // 2), lambda: fn(it // 4)], name))
    return k64, k32, k16, k64 / k32, (k64 - k32) / (k32 - k16)


def k3_check(walk, reps=5):
    """K3 on one captured walk (table, o, d, t_max, any_hit, max_steps,
    t_min): three launches (their outputs must be torch.equal: the rays come
    from an atomic queue), the plain walk with the rows it reads, mismatches
    of every output, kernel and plain ms, ray-steps a second, the bound
    (``bench_k3.walk_bound``: the rays, the outputs and the rows read, or
    432 fp32 operations a step: 16 slab tests of 27) and the launch grid."""
    from hobbyrenderer_tpu_torch import bench_k3, kernels
    from hobbyrenderer_tpu_torch.ops import bvh16 as b16ops
    tab, o, d, tm, any_hit, steps, t_min = walk
    runs = [b16ops.bvh16_walk(tab, o, d, tm, any_hit, steps, t_min) for _ in range(3)]
    pt, ptri, ps, rows = b16ops.bvh16_walk_reference(tab, o, d, tm, any_hit, steps, t_min,
                                                     return_visited=True)
    torch.cuda.synchronize()
    bt, btri, bs = runs[0]
    repeat_equal = all(torch.equal(a, b) for r_ in runs[1:] for a, b in zip(runs[0], r_))
    mis = {k: int((a != b).sum()) for k, a, b in (("tri", btri, ptri), ("t", bt, pt),
                                                  ("steps", bs, ps))}
    ms = cuda_ms(lambda: b16ops.bvh16_walk(tab, o, d, tm, any_hit, steps, t_min), reps)
    pms = cuda_ms(lambda: b16ops.bvh16_walk_reference(tab, o, d, tm, any_hit, steps, t_min),
                  reps=1)
    n_rows, n_steps = int(rows.sum()), int(ps.sum())
    bnd = bench_k3.walk_bound(tab, o.shape[0], rows, n_steps)
    resident = b16ops._resident_ctas(kernels.library(), o.device)
    return dict(out=(bt, btri, bs), ref=(pt, ptri, ps), mis=mis, repeat_equal=repeat_equal,
                ms=ms, plain_ms=pms, bound=bnd, rows=n_rows, steps=n_steps,
                gsteps=n_steps / (ms * 1e-3) / 1e9, err=float((bt - pt).abs().max()),
                plan=f"grid {b16ops.launch_grid(o.shape[0], resident)} CTAs of 256 threads "
                     f"({resident} resident)")


def raster_check(bench_raster, k1, records, work_tile, work_slot, kw, depth_only=True):
    """A tile-raster call, K1 or K5 (``depth_only``), held against its plain
    version by bench_raster.held_call (three launches, the plan, the work
    and the bound), with the kernel's ms beside it."""
    x, line, _ = bench_raster.held_call(k1, records, work_tile, work_slot, kw, depth_only)
    from hobbyrenderer_tpu_torch.ops import raster_kernel as rk
    x["ms"] = cuda_ms(bench_raster.call_fn(rk, k1, records, work_tile, work_slot, kw, depth_only))
    x["line"] = f"{line}; kernel {x['ms']:.4f} ms"
    return x


def raster_summary(x):
    """A raster_check result's numbers for the kernels line."""
    return {k: x[k] for k in ("items", "empty_tiles", "busiest_tile", "units", "split_tiles",
                              "strip_rows", "strip_rows_all", "attr_mismatches", "ms",
                              "plain_ms", "bound_ms", "bound_by")}


def rel_err(got, ref):
    """Largest relative difference of two all-positive tensors."""
    return float(((got - ref).abs() / ref.abs()).max())


PTXAS_KERNELS = ("raster_units_kernel", "beam_any_hit_kernel",
                 "restir_candidates_kernel", "bvh16_walk_kernel", "closest_blocks_kernel",
                 "leaf_gather_kernel", "int_fetch_kernel", "sky_march_kernel")
CHECKSUM_RTOL = 1e-5     # sums in another order; a skipped row or step moves it >= 1/64
K89_GATE_ITERS = 4096    # K8's and K9's scaling gates read at 4,096 / 2,048 / 1,024 steps
ONE_CTA_AN_SM_BYTES = 200_000    # shared bytes a CTA that leave room for one CTA an SM


def phase_wkernels(counters_reset, counts):
    """Phase 16: the step microbenchmarks K7-K9. Their main path is their
    entry point, `python -m hobbyrenderer_tpu_torch.bench_wkernels`, driven
    with the counts reset just before; then each kernel against its plain
    version at the script's shapes, 64 steps (the output bit-exact; the
    checksum of every fetched value, whose sums run in another order,
    within CHECKSUM_RTOL), its time per call (CUDA events around queued
    launches, as the entry point times it), the kernel's own device time at
    64, 32 and 16 iterations, interleaved in one trace, with one step's
    marginal time (t64 - t32) / 32, one step's bytes over the HBM rate, the
    call's bound (K7: every step's rows read, as its spec makes each step's
    gather real, and beside it each distinct row read once; K8 and K9: each
    distinct column read once; outputs written once) and one PyTorch call
    that computes the same
    values (the library figure; K8 and K9 also the last step's row 0 alone).
    No repeat may be elided: the ratio t(n) / t(n/2) and the marginal ratio
    (t(n) - t(n/2)) / (t(n/2) - t(n/4)), which a fixed cost does not touch,
    are gated to 1.8-2.2. K7 reads them at 64 / 32 / 16 steps (the ratio on
    the script's first variant only, where its fixed ~1.5 us weighs least).
    K8 and K9 stage their table into shared memory once, a fixed cost of
    microseconds against steps of tens of nanoseconds, so they read both
    gates at K89_GATE_ITERS (4,096) / 2,048 / 1,024 steps, on every
    variant."""
    from hobbyrenderer_tpu_torch import bench_wkernels as bw
    from hobbyrenderer_tpu_torch import kernels
    from hobbyrenderer_tpu_torch.ops import wkernels as wk
    dev = torch.device("cuda", 0)
    counters_reset()
    bw.main([])
    torch.cuda.synchronize()
    launches = counts()
    log(f"phase16 bench_wkernels entry point: launches {launches}")
    assert launches["K7"] > 0 and launches["K8"] > 0 and launches["K9"] > 0, launches
    x = bw.make_inputs(dev)
    it = bw.ITERS
    rows_out = {}
    for label, rows, kind in bw.K7_VARIANTS:
        idx = x["idx_rand"] if kind == "rand" else x["idx_seq"]
        got, cs = wk.leaf_gather(idx, x["leaf"], rows, it)
        ref, ref_cs = wk.leaf_gather_reference(idx, x["leaf"], rows, it)
        torch.cuda.synchronize()
        mism = int((got != ref).sum())
        cs_err = rel_err(cs, ref_cs)
        ms64 = bw.call_ms(lambda: wk.leaf_gather(idx, x["leaf"], rows, it), dev)
        k64, k32, k16, ratio, marginal = iters_scaling(
            lambda n: wk.leaf_gather(idx, x["leaf"], rows, n), "leaf_gather_kernel", it)
        pms = bw.call_ms(lambda: wk.leaf_gather_reference(idx, x["leaf"], rows, it), dev)
        ids = idx.reshape(-1)[:rows].to(torch.int64)
        ids_all = ids.repeat(it)
        lms = bw.call_ms(lambda: x["leaf"].index_select(0, ids_all), dev)
        step_bytes = rows * wk.LANE * 4 * 2          # one step: each row read and written
        # the call: every step's rows read (the spec makes each step's gather
        # real), ids, out and checksum written once; beside it the earlier
        # count, each distinct row read once
        n_rows = int(torch.unique(ids).numel())
        bnd = bound(it * rows * wk.LANE * 4 + nbytes(idx, got) + rows * 4, 0)
        bnd_distinct = bound(n_rows * wk.LANE * 4 + nbytes(idx, got) + rows * 4, 0)
        rows_out[label] = dict(ms=ms64, kernel_ms=k64, gate_iters=it, ratio=ratio,
                               marginal_ratio=marginal, plain_ms=pms, library_ms=lms, bound=bnd,
                               bound_distinct_rows_ms=bnd_distinct[0],
                               bound_share=bnd[0] / k64,
                               err=float((got - ref).abs().max()), checksum_rel_err=cs_err)
        log(f"phase16 K7 {label}: mismatches vs plain {mism}, checksum rel err {cs_err:.3g}; "
            f"call {ms64:.4f} ms ({ms64 / it * 1e3:.3f} us/step) at {it} iters; kernel "
            f"{k64 * 1e3:.2f} us at {it}, {k32 * 1e3:.2f} us at {it // 2}, {k16 * 1e3:.2f} us at "
            f"{it // 4}, ratio {ratio:.3f}, marginal ratio {marginal:.3f} "
            f"({k64 / it * 1e3:.3f} us/step); "
            f"one step's bytes {step_bytes / HBM_BYTES_PER_S * 1e6:.3f} us; call bound "
            f"{bnd[0] * 1e3:.3f} us ({it} x {rows} rows; the kernel at "
            f"{bnd[0] / k64:.3f} of it), {bnd_distinct[0] * 1e3:.3f} us counting the "
            f"{n_rows} distinct rows once; plain {pms:.3f} ms; "
            f"library index_select of the {it}x{rows} rows {lms:.4f} ms "
            f"({lms / it * 1e3:.3f} us/step)")
        assert mism == 0, f"K7 {label} is not bit-exact with its plain version"
        assert cs_err <= CHECKSUM_RTOL, f"K7 {label}: checksum disagrees with the plain version"
        if label == bw.K7_VARIANTS[0][0]:       # the script's first variant (docstring)
            assert 1.8 <= ratio <= 2.2, f"K7 {label}: time does not scale with iters"
        assert 1.8 <= marginal <= 2.2, f"K7 {label}: marginal time does not scale with iters"

    def max_clusters(hc, cluster, smem):
        n = ctypes.c_int(0)
        kernels.check(kernels.library().hr_wk_int_fetch_max_clusters(
            int(hc), cluster, smem, ctypes.addressof(n)), "hr_wk_int_fetch_max_clusters")
        return n.value

    # the SMs that clusters of C CTAs reach, one CTA an SM
    reach = {C: C * max_clusters(False, C, ONE_CTA_AN_SM_BYTES) for C in (1, 2, 4, 8)}
    log(f"phase16 SMs that K8's clusters of 1/2/4/8 CTAs reach (one CTA an SM): {reach}")
    for key, label, fn, ref_fn, idx, tab, Ip in (
            ("K8", f"Ip={bw.IP}", wk.int_fetch, wk.int_fetch_reference, x["idx_ip"], x["tab"],
             bw.IP),
            ("K8", "Ip=512", wk.int_fetch, wk.int_fetch_reference, x["idx_512"], x["tab512"],
             512),
            ("K9", f"Ip={bw.IP}", wk.int_fetch_hc, wk.int_fetch_hc_reference, x["idx_ip"],
             x["tab_hc"], bw.IP)):
        lay = wk.int_fetch_layout(Ip, key == "K9")
        got, cs = fn(idx, tab, it, Ip)
        ref, ref_cs = ref_fn(idx, tab, it, Ip)
        torch.cuda.synchronize()
        mism = int((got != ref).sum())
        cs_err = rel_err(cs, ref_cs)
        ms64 = bw.call_ms(lambda: fn(idx, tab, it, Ip), dev)
        k64, k32, k16, ratio64, marginal64 = iters_scaling(
            lambda n: fn(idx, tab, n, Ip), "int_fetch_kernel", it)
        # the gates: the table is staged once, a fixed cost of microseconds
        # that 64 steps of tens of nanoseconds would not outweigh
        kl, kl2, kl4, ratio, marginal = iters_scaling(
            lambda n: fn(idx, tab, n, Ip), "int_fetch_kernel", K89_GATE_ITERS)
        step_ns = (kl - kl2) / (K89_GATE_ITERS // 2) * 1e6
        pms = bw.call_ms(lambda: ref_fn(idx, tab, it, Ip), dev)
        steps = torch.remainder(idx.to(torch.int64)[None] + torch.arange(
            it, device=dev)[:, None, None], Ip)                       # (it, 16, 128)
        cols = steps[-1]
        if key == "K8":
            row0 = tab[0]
            last = lambda: row0[cols].sum(0)     # noqa: E731
            all_cols = steps.reshape(-1)
            lib = lambda: tab.index_select(1, all_cols)      # noqa: E731
        else:
            t3 = tab.reshape(Ip // wk.LANE, 96, wk.LANE)
            row0 = t3[:, 0]
            last = lambda: row0[cols // wk.LANE, cols % wk.LANE].sum(0)   # noqa: E731
            hi, lo = steps.reshape(-1) // wk.LANE, steps.reshape(-1) % wk.LANE
            lib = lambda: t3[hi, :, lo]          # noqa: E731
        lms_last = bw.call_ms(last, dev)
        lms = bw.call_ms(lib, dev)
        step_bytes = wk.SUB * wk.LANE * 96 * 2            # 2,048 fetches of 96 bf16 values
        # the call: each distinct column's 96 values read once, ids, out and checksum
        n_cols = int(torch.unique(steps).numel())
        bnd = bound(n_cols * 96 * 2 + nbytes(idx, got) + wk.SUB * wk.LANE * 4, 0)
        rows_out[f"{key} {label}"] = dict(ms=ms64, kernel_ms=k64, gate_iters=K89_GATE_ITERS,
                                          ratio=ratio, marginal_ratio=marginal, ratio_64=ratio64,
                                          marginal_ratio_64=marginal64, step_ns=step_ns,
                                          step_ns_64=(k64 - k32) / (it // 2) * 1e6,
                                          plain_ms=pms, library_ms=lms,
                                          library_last_step_ms=lms_last, bound=bnd,
                                          err=float((got - ref).abs().max()),
                                          checksum_rel_err=cs_err, layout=lay)
        held = max_clusters(key == "K9", lay["cluster"], lay["smem"])
        log(f"phase16 {key} {label}: layout {lay}, clusters the card holds at once {held}; "
            f"mismatches vs plain {mism}, checksum rel err {cs_err:.3g}; call {ms64:.4f} ms "
            f"({ms64 / it * 1e3:.3f} us/step) at {it} iters; kernel {k64 * 1e3:.2f} us at {it}, "
            f"{k32 * 1e3:.2f} us at {it // 2}, "
            f"{k16 * 1e3:.2f} us at {it // 4}, ratio {ratio64:.3f}, marginal ratio "
            f"{marginal64:.3f}, one step (t{it} - t{it // 2}) / {it // 2} "
            f"{(k64 - k32) / (it // 2) * 1e6:.2f} ns; gates at {K89_GATE_ITERS}: kernel "
            f"{kl * 1e3:.2f} us, {kl2 * 1e3:.2f} us at {K89_GATE_ITERS // 2}, {kl4 * 1e3:.2f} us "
            f"at {K89_GATE_ITERS // 4}, ratio {ratio:.3f}, marginal ratio {marginal:.3f}, one "
            f"step {step_ns:.2f} ns; one step's bytes {step_bytes / HBM_BYTES_PER_S * 1e6:.3f} "
            f"us; call bound {bnd[0] * 1e3:.3f} us ({n_cols} distinct columns); plain "
            f"{pms:.3f} ms; library: {lms:.4f} ms (gather of the {it} steps' {it}x2048 "
            f"columns), {lms_last:.4f} ms (last step only: row 0 indexed + sum)")
        assert mism == 0, f"{key} {label} is not bit-exact with its plain version"
        assert cs_err <= CHECKSUM_RTOL, f"{key} {label}: checksum disagrees with the plain version"
        assert 1.8 <= ratio <= 2.2, f"{key} {label}: time does not scale with iters"
        assert 1.8 <= marginal <= 2.2, f"{key} {label}: marginal time does not scale with iters"
    return launches, rows_out


def ldr_within(a, b):
    """Share of pixels whose LDR channels all lie within 2/255, mean, max."""
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
    return float(np.mean(diff <= 2)), float(diff.mean()), int(diff.max())


def _walks_by_pixel(w, R):
    """A spied K3 call's live lanes (t_max > 1e-4) laid out by pixel: (live
    (R,) bool, {field: (R, ...) tensor})."""
    live = torch.zeros((R,), dtype=torch.bool)
    live[w["pix"]] = True
    dense = {}
    for k in ("o", "d", "tm", "t", "tri", "steps"):
        v = w[k]
        dense[k] = torch.zeros((R,) + tuple(v.shape[1:]), dtype=v.dtype)
        dense[k][w["pix"]] = v
    return live, dense


def _walk_diff(wg, wc, R):
    """Lane masks (R,) of one K3 call on the GPU against the same call on the
    CPU, matched by pixel: live on one side only, inputs (o, d, t_max) not
    bit-equal, outputs (t, tri, steps) not bit-equal, another triangle hit."""
    lg, g = _walks_by_pixel(wg, R)
    lc, c = _walks_by_pixel(wc, R)
    both = lg & lc
    in_diff = both & ((g["o"] != c["o"]).any(1) | (g["d"] != c["d"]).any(1)
                      | (g["tm"] != c["tm"]))
    out_diff = both & ((g["t"] != c["t"]) | (g["tri"] != c["tri"]) | (g["steps"] != c["steps"]))
    return dict(only=lg ^ lc, in_diff=in_diff, out_diff=out_diff,
                tri_diff=both & (g["tri"] != c["tri"]), g=g, c=c, lg=lg, lc=lc)


def phase_pt_cuda_vs_cpu(Renderer, Config, W=256, H=192, frames=3):
    """Phase 17: the path tracer on the GPU (kernels) against the CPU (plain
    versions), stress:4, a few accumulated frames. 256x192 = 49,152 lanes,
    over COMPACT_MIN_LANES: the compacted wavefront, as on the main path.

    Every K3 walk of both renderers is spied on. Each CUDA walk is held bit
    for bit against the plain walk on its own inputs. The two runs' walks
    are matched call for call and, inside a call, lane for lane by pixel
    (a walk's lanes carry its bounce's pixel ids; compaction reorders
    them), and the phase reports where the runs part: per call the live
    lanes whose inputs (o, d, t_max) differ, whose outputs differ, and
    whose outputs differ on bit-equal inputs (a K3 fault: none may), and
    the walks where the runs part (a lane live on one side only, or another
    triangle hit); and for each pixel off by more than 2/255, the first walk
    where its lane's inputs differ and the walk where it parts, and how."""
    from hobbyrenderer_tpu_torch.models import pathtracer as ptmod
    from hobbyrenderer_tpu_torch.ops import bvh16 as b16ops
    assert W * H >= ptmod.COMPACT_MIN_LANES
    R = W * H
    k3_orig, bounce_orig = b16ops.bvh16_walk, ptmod._bounce
    current = {}                  # device type -> (bounce, the bounce's pixel per lane)
    walks = {"cuda": [], "cpu": []}
    k3_mism = []

    def bounce_spy(*a, **kw):
        p, b = a[5], a[6]
        current[p.pix.device.type] = (b, p.pix)
        return bounce_orig(*a, **kw)

    def k3_spy(table, o, d, t_max, any_hit, max_steps=b16ops.UNCAPPED_STEPS, t_min=1e-4):
        out = k3_orig(table, o, d, t_max, any_hit, max_steps, t_min)
        dt = o.device.type
        if dt == "cuda":
            ref = b16ops.bvh16_walk_reference(table, o, d, t_max, any_hit, max_steps, t_min)
            k3_mism.append(sum(int((x != y).sum()) for x, y in zip(out, ref)))
        b, pix = current[dt]
        live = t_max > 1e-4
        walks[dt].append(dict(bounce=b, any_hit=any_hit, lanes=o.shape[0],
                              pix=pix[live].cpu(), o=o[live].cpu(), d=d[live].cpu(),
                              tm=t_max[live].cpu(), t=out[0][live].cpu(),
                              tri=out[1][live].cpu(), steps=out[2][live].cpu()))
        return out

    cfg = Config(scene="stress:4", width=W, height=H, mode="path_tracer",
                 cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke4pt"))
    t0 = time.perf_counter()
    rg = Renderer(cfg, device="cuda")
    rc = Renderer(cfg, device="cpu")
    b16ops.bvh16_walk, ptmod._bounce = k3_spy, bounce_spy
    try:
        for _ in range(frames):
            lg = rg.render_frame().cpu().numpy()
            lc = rc.render_frame().numpy()
    finally:
        b16ops.bvh16_walk, ptmod._bounce = k3_orig, bounce_orig
    sg, sc_ = rg.stats(), rc.stats()
    rg.shutdown()
    rc.shutdown()
    within, mean, mx = ldr_within(lg, lc)
    log(f"phase17 path tracer stress:4 {W}x{H} x{frames} frames cuda vs cpu: "
        f"{within * 100:.3f}% of LDR pixels within 2/255, mean |d| {mean:.4f}, max {mx}; stats "
        f"cuda {json.dumps(sg)} cpu {json.dumps(sc_)} ({time.perf_counter() - t0:.1f} s)")
    n_calls = len(walks["cuda"])
    assert n_calls == len(walks["cpu"]) and n_calls > 0, (n_calls, len(walks["cpu"]))
    per_frame = n_calls // frames
    diffs = [_walk_diff(wg, wc, R) for wg, wc in zip(walks["cuda"], walks["cpu"])]
    eq_in_fault, parted = 0, 0
    for k, (w, x) in enumerate(zip(walks["cuda"], diffs)):
        n_only, n_in = int(x["only"].sum()), int(x["in_diff"].sum())
        n_out, n_bad = int(x["out_diff"].sum()), int((x["out_diff"] & ~x["in_diff"]).sum())
        n_tri = int(x["tri_diff"].sum())
        eq_in_fault += n_bad
        parted += bool(n_only or n_tri)
        if (n_only or n_tri) and parted <= 6:          # the first walks where the runs part
            log(f"  phase17 walk {k} (frame {k // per_frame}, bounce {w['bounce']}, "
                f"{'NEE any hit' if w['any_hit'] else 'closest hit'}, {w['lanes']} lanes, live "
                f"cuda {int(x['lg'].sum())} cpu {int(x['lc'].sum())}): live on one side only "
                f"{n_only}, inputs differ {n_in}, outputs differ {n_out}, another triangle "
                f"{n_tri}, outputs differ on bit-equal inputs {n_bad}")
    log(f"phase17 K3 walks: {n_calls} a device; CUDA kernel vs the plain walk on its own inputs: "
        f"{sum(k3_mism)} mismatches; walks where the runs part {parted}; live lanes whose inputs "
        f"differ between the runs {sum(int(x['in_diff'].sum()) for x in diffs)}, whose outputs "
        f"differ {sum(int(x['out_diff'].sum()) for x in diffs)}, on bit-equal inputs "
        f"{eq_in_fault}")
    diff_px = np.abs(lg.astype(np.int32) - lc.astype(np.int32)).max(-1)
    for y, xx in list(zip(*np.nonzero(diff_px > 2)))[:10]:
        q = int(y) * W + int(xx)
        first_in = next((k for k, x in enumerate(diffs) if x["in_diff"][q]), None)
        part = next((k for k, x in enumerate(diffs) if x["only"][q] or x["tri_diff"][q]), None)
        head = (f"  phase17 pixel ({y}, {xx}) off by {diff_px[y, xx]}: its lane's walk inputs "
                + ("never differ" if first_in is None else f"first differ in walk {first_in}"))
        if part is None:
            log(f"{head}; no walk of its lane differs in liveness or triangle (the runs part "
                f"in the shading)")
            continue
        x, w = diffs[part], walks["cuda"][part]
        g, c = x["g"], x["c"]
        if x["only"][q]:
            what = "live on the " + ("GPU" if x["lg"][q] else "CPU") + " only"
        elif x["in_diff"][q]:
            what = (f"another triangle, on inputs that differ (|do| "
                    f"{float((g['o'][q] - c['o'][q]).abs().max()):.3g}, |dd| "
                    f"{float((g['d'][q] - c['d'][q]).abs().max()):.3g}, |dt_max| "
                    f"{float((g['tm'][q] - c['tm'][q]).abs()):.3g})")
        else:
            what = "another triangle on bit-equal inputs"
        log(f"{head}; the runs part in walk {part} (frame {part // per_frame}, bounce "
            f"{w['bounce']}, {'NEE any hit' if w['any_hit'] else 'closest hit'}): {what}; tri "
            f"cuda {int(g['tri'][q])} cpu {int(c['tri'][q])}, t cuda {float(g['t'][q]):.9g} cpu "
            f"{float(c['t'][q]):.9g}, steps cuda {int(g['steps'][q])} cpu {int(c['steps'][q])}")
        hist = []                           # its lane in that frame's walks up to the part
        for kk in range(part - part % per_frame, part + 1):
            xk, wk_ = diffs[kk], walks["cuda"][kk]
            gk, ck = xk["g"], xk["c"]
            hist.append(f"{wk_['bounce']}{'n' if wk_['any_hit'] else 'c'}:"
                        f"live {int(xk['lg'][q])}/{int(xk['lc'][q])} "
                        f"|do| {float((gk['o'][q] - ck['o'][q]).abs().max()):.3g} "
                        f"|dd| {float((gk['d'][q] - ck['d'][q]).abs().max()):.3g} "
                        f"|dt_max| {float((gk['tm'][q] - ck['tm'][q]).abs()):.3g} "
                        f"tri {int(gk['tri'][q])}/{int(ck['tri'][q])}")
        log(f"  phase17 pixel ({y}, {xx}), its lane in frame {part // per_frame}'s walks "
            f"(bounce, c closest / n NEE; cuda/cpu): {'; '.join(hist)}")
    assert sum(k3_mism) == 0, "K3 is not bit-exact with the plain walk on phase 17's inputs"
    assert eq_in_fault == 0, "the CUDA and CPU walks differ on bit-equal inputs"
    assert within >= 0.99, within
    return within


def phase_pt_main(Renderer, Config, reset_counts, counts, n_frames=8):
    """Phase 18: the path tracer's main path, bench.py's PT configuration:
    stress at 960x540, 1 spp a frame, 8 bounces, RR from bounce 2 (518,400
    lanes: the compacted wavefront). trace_paths runs under
    torch.cuda.set_sync_debug_mode("error"): a host sync inside it raises.
    The first frame's K3 calls are spied on: its full-width closest-hit walk
    (bounce 0) and its first compacted NEE any-hit walk (bounce 3) are then
    held bit for bit against the plain walk on the same inputs, after the
    main path's counts are read."""
    from hobbyrenderer_tpu_torch.models import pathtracer as ptmod
    from hobbyrenderer_tpu_torch.ops import atmosphere as atm
    from hobbyrenderer_tpu_torch.ops import bvh16 as b16ops
    RS = 960 * 540
    walks = {}
    k3_orig = b16ops.bvh16_walk

    def k3_spy(table, o, d, t_max, any_hit, max_steps, t_min=1e-4):
        n = o.shape[0]
        key = ("closest full width" if not any_hit and n == RS else
               "NEE compacted" if any_hit and n < RS else None)
        if key is not None and key not in walks:
            walks[key] = (table, o.clone(), d.clone(), t_max.clone(), any_hit, max_steps, t_min)
        return k3_orig(table, o, d, t_max, any_hit, max_steps, t_min)

    t0 = time.perf_counter()
    r = Renderer(Config(scene="stress", width=960, height=540, mode="path_tracer",
                        cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke_pt_main")),
                 device="cuda")
    setup = time.perf_counter() - t0
    assert r.config.settings.max_bounces == 8 and r.config.settings.rr_start_bounce == 2
    orig = ptmod.trace_paths

    def strict(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    ptmod.trace_paths = strict
    reset_counts()
    sky0 = atm.launches
    frame_ms, stats, per_frame = [], [], []
    try:
        for i in range(n_frames):
            c0 = counts()
            b16ops.bvh16_walk = k3_spy if i == 0 else k3_orig
            f0 = time.perf_counter()
            r.render_frame()
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - f0) * 1e3)
            stats.append(r.stats())
            per_frame.append({k: v - c0[k] for k, v in counts().items() if v - c0[k]})
    finally:
        ptmod.trace_paths = orig
        b16ops.bvh16_walk = k3_orig
    launches = counts()
    sky_launches = atm.launches - sky0
    ldr = r.last_frame
    accum = r._model.accum
    png = os.path.join(tempfile.gettempdir(), "chip_smoke_stress_pt_540p.png")
    r.save_screenshot(png)
    r.shutdown()
    med = statistics.median(frame_ms[1:])
    msamples = 960 * 540 * r._model.spp / (med / 1e3) / 1e6

    def share(lanes_key, capped_key):
        lanes_ = sum(s_[lanes_key] for s_ in stats)
        capped_ = sum(s_[capped_key] for s_ in stats)
        return f"{capped_}/{lanes_} ({capped_ / max(lanes_, 1):.6f})"
    log(f"phase18 path tracer main path stress 960x540 spp 1 x{n_frames}: setup {setup:.1f} s "
        f"(BVH+beam table+bvh16+light pool {r.bvh_seconds:.1f} s), frame ms "
        f"{[round(x, 2) for x in frame_ms]}, median frames 2-{n_frames} {med:.2f} ms, "
        f"{msamples:.4f} Msamples/s, launches {launches}, per frame {per_frame}, sky kernel "
        f"launches {sky_launches}, "
        f"pt_dropped_lanes per frame {[s_['pt_dropped_lanes'] for s_ in stats]}, K3 steps "
        f"budget ({ptmod.traceops.b16ops.UNCAPPED_STEPS}) spent: closest hit "
        f"{share('rt_k3_lanes_pt', 'rt_k3_capped_pt')}, NEE "
        f"{share('rt_k3_lanes_pt_nee', 'rt_k3_capped_pt_nee')}; png {png}")
    assert tuple(ldr.shape) == (540, 960, 3) and ldr.dtype == torch.uint8
    assert bool(torch.isfinite(accum).all()), "non-finite accumulation"
    assert float(accum.mean()) > 0, "black accumulation"
    assert launches["K3"] >= 2 * 8 * n_frames and all(f.get("K3", 0) > 0 for f in per_frame), \
        per_frame
    assert sum(v for k, v in launches.items() if k != "K3") == 0, launches
    assert sky_launches == 8 * n_frames, f"{sky_launches} sky launches: one a bounce expected"
    assert sorted(walks) == ["NEE compacted", "closest full width"], sorted(walks)
    k3_rows = []
    for name, walk in sorted(walks.items()):
        tab, o, d, tm, any_hit, steps, t_min = walk
        x = k3_check(walk)
        _, ptri, ps = x["ref"]
        live = tm > 1e-4            # the masked lanes walk with t_max 1e-4
        k3_rows.append(dict(name=f"pt {name}", rays=o.shape[0], ms=x["ms"],
                            plain_ms=x["plain_ms"], bound=x["bound"], err=x["err"],
                            gsteps=x["gsteps"]))
        log(f"phase18 K3 {name} rays={o.shape[0]} (live {int(live.sum())}) any_hit={any_hit} "
            f"max_steps={steps}: mismatches vs plain {x['mis']}, three launches equal "
            f"{x['repeat_equal']}, hit share of live "
            f"{float((ptri >= 0)[live].float().mean()):.3f}, mean steps of live "
            f"{float(ps[live].float().mean()):.2f}, of all {x['steps'] / o.shape[0]:.2f}, max "
            f"{int(ps.max())}, rows read {x['rows']} of {tab.shape[0]}; {x['plan']}; kernel "
            f"{x['ms']:.4f} ms ({x['gsteps']:.2f} G ray-steps/s), plain {x['plain_ms']:.3f} ms, "
            f"bound {x['bound'][0]:.4f} ms ({x['bound'][1]})")
        assert not any(x["mis"].values()), f"K3 {name} is not bit-exact with its plain version"
        assert x["repeat_equal"], f"three K3 launches on {name} gave different outputs"
    return dict(setup=setup, ms=med, msamples=msamples, launches=launches,
                sky_launches=sky_launches, dropped=[s_["pt_dropped_lanes"] for s_ in stats],
                k3_rows=k3_rows)


def _ldr01(ldr):
    return ldr.cpu().numpy().astype(np.float32) / 255.0


def _rmse_corr(ref, got):
    return (float(np.sqrt(np.mean((ref - got) ** 2))),
            float(np.corrcoef(ref.ravel(), got.ravel())[0, 1]))


def phase_golden(Renderer, Config, frames=24, spp=(192, 96)):
    """Phase 19: ROADMAP item 18 on the card. The port's PT reference at
    stress:4, 96x64 at 192 spp and 256x192 at 96 spp (jitter off, dt=0, as
    tests/golden_ref.py renders it; pt_spp batches 16 samples a frame), and
    the port's flagship after 24 frames held to tests/test_golden.py's three
    gates with RTXDI's straggler caps lifted (straggler_steps=None, the
    exact path the gates were calibrated on); the default route's RMSE and
    correlation are printed beside them."""
    import functools
    from hobbyrenderer_tpu_torch.models import pathtracer as ptmod
    from hobbyrenderer_tpu_torch.ops import culling
    from hobbyrenderer_tpu_torch.ops import restir as trestir
    tmp = tempfile.gettempdir()
    t0 = time.perf_counter()

    def pt_renderer(W, H):
        r = Renderer(Config(scene="stress:4", width=W, height=H, mode="path_tracer", pt_spp=16,
                            cache_dir=os.path.join(tmp, "hr_smoke_golden")), device="cuda")
        r.camera.jitter_enabled = False
        return r

    def pt_ref(W, H, spp):
        r = pt_renderer(W, H)
        for i in range(spp // 16):
            ldr = r.render_frame(dt=0.0)
            if i == 0:
                first = r._model.accum.clone()
        assert r._model.num_accum == spp
        r.shutdown()
        if W * H * 16 >= ptmod.COMPACT_MIN_LANES:
            # the same compacted 16-spp frame again, in a new renderer: bit-identical
            r2 = pt_renderer(W, H)
            r2.render_frame(dt=0.0)
            again = r2._model.accum
            same = torch.equal(again, first)
            n_bits = int((again.view(torch.int32) != first.view(torch.int32)).sum())
            log(f"phase19 PT {W}x{H} 16 spp ({W * H * 16} lanes, compacted): first frame "
                f"rendered twice bit-identical: {same}" + ("" if same else
                f" (values differing {n_bits}, non-finite {int((~torch.isfinite(first)).sum())}"
                f" / {int((~torch.isfinite(again)).sum())}, max |d| "
                f"{float((again - first).abs().nan_to_num(0.0).max()):.3g})"))
            r2.shutdown()
            assert same, "the compacted spp > 1 frame is not deterministic"
        return _ldr01(ldr)

    def flagship(W, H, lod0=False):
        old = culling.LOD_TARGET_PIXEL_ERROR
        if lod0:
            culling.LOD_TARGET_PIXEL_ERROR = 1e-6
        try:
            r = Renderer(Config(scene="stress:4", width=W, height=H, direct_mode="restir",
                                indirect_mode="restir",
                                cache_dir=os.path.join(tmp, "hr_smoke_golden")), device="cuda")
            r.camera.jitter_enabled = False
            for _ in range(frames):
                ldr = r.render_frame(dt=0.0)
            r.shutdown()
        finally:
            culling.LOD_TARGET_PIXEL_ERROR = old
        return _ldr01(ldr)

    refs = {(96, 64): pt_ref(96, 64, spp[0]), (256, 192): pt_ref(256, 192, spp[1])}
    gates = (("flagship vs PT 96x64", 96, 64, False, 0.14, 0.73),
             ("flagship(LOD0) vs PT 96x64", 96, 64, True, 0.118, 0.78),
             ("flagship vs PT 256x192", 256, 192, False, 0.152, 0.70))
    out, failed = {}, []
    for label, W, H, lod0, g_rmse, g_corr in gates:
        restir_di = trestir.restir_di
        trestir.restir_di = functools.partial(restir_di, straggler_steps=None)
        try:
            rm, co = _rmse_corr(refs[(W, H)], flagship(W, H, lod0))
        finally:
            trestir.restir_di = restir_di
        rm_d, co_d = _rmse_corr(refs[(W, H)], flagship(W, H, lod0))
        out[label] = dict(rmse=rm, corr=co, default_route_rmse=rm_d, default_route_corr=co_d)
        ok = rm < g_rmse and co > g_corr
        log(f"phase19 {label}: caps lifted RMSE {rm:.4f} corr {co:.4f} (gate < {g_rmse} / > "
            f"{g_corr}: {'pass' if ok else 'FAIL'}); default route (reference caps) RMSE "
            f"{rm_d:.4f} corr {co_d:.4f}")
        if not ok:
            failed.append(label)
    log(f"phase19 took {time.perf_counter() - t0:.1f} s")
    assert not failed, f"ROADMAP item 18 gates failed: {failed}"
    return out


IBL_COMBINED_PASSES = ["Culling", "Raster", "HZBBuild", "RasterPhase2", "ResolveGBuffer",
                       "MaskedLayer", "IBL", "RTXDI", "Denoise", "SHARC", "SharcIndirectQuery",
                       "SpecularIndirect", "DeferredLighting", "Sky", "Transparent", "TAA",
                       "AutoExposure", "Bloom", "Tonemap"]
# the K3 walks a frame of the IBL + combined path reports: (name, lanes key, capped key)
IBL_COMBINED_WALKS = [(w, f"rt_k3_lanes_{w}", f"rt_k3_capped_{w}")
                      for w in ("di", "sharc", "sharc_nee", "sharcq", "sharcq_nee", "spec",
                                "spec_nee")]
SHARC_RAD_RTOL = 1e-6    # CUDA against CPU: the same elementwise f32 operations in one order


def span_syncs(frames, names=None):
    """{span: host syncs} of the spans named (every span with a sync, and
    "(outside spans)", when ``names`` is None), summed over the tracer's
    records of traced frames (utils/timing.py::FrameRecord)."""
    out = {}
    for f in frames:
        spans = [(s_.name, s_.syncs) for s_ in f.spans] + [("(outside spans)",
                                                           f.syncs_outside)]
        for name, n in spans:
            if (n if names is None else name in names):
                out[name] = out.get(name, 0) + n
    return out


def traced_frame(render_frame):
    """Render one frame traced by the port's tracer (host syncs by span,
    utils/timing.py) -> its FrameRecord."""
    from hobbyrenderer_tpu_torch.utils.timing import PROFILER
    PROFILER.enabled = True
    try:
        render_frame()
    finally:
        PROFILER.enabled = False
    return PROFILER.frames[-1]


def phase_ibl_combined(Renderer, Config, reset_counts, counts, time_passes, median_ms, rko,
                       card, n_frames, scene="stress", W=1920, H=1080):
    """Phase 20: the slice's main path, Renderer(Config(scene="stress",
    1920x1080, mode="ibl", direct_mode="restir", indirect_mode="combined",
    regir=True, regir_mode="onion"), device="cuda") for n_frames frames:
    the JAX graph's passes, K1-K4 launched every frame (K5, K6 never), a
    finite HDR, SHARC's occupied slots nonzero after frame 1 and never
    fewer. RTXDI and Denoise run under set_sync_debug_mode("error"); the
    host syncs of SHARC, SharcIndirectQuery and SpecularIndirect are
    counted (the tracer's spans of traced frames), and the two SHARC passes
    must have none. Captures the first frame's K2 call and the second
    frame's sharc_update inputs."""
    from hobbyrenderer_tpu_torch.ops import sharc as sharcops
    cap = {}
    k2_orig, upd_orig = rko.restir_candidates, sharcops.sharc_update

    def k2_spy(*a, **kw):
        cap.setdefault("k2", (a, kw))
        return k2_orig(*a, **kw)

    def upd_spy(*a):
        cap.setdefault("updates", []).append(a)
        return upd_orig(*a)

    t0 = time.perf_counter()
    r = Renderer(Config(scene=scene, width=W, height=H, mode="ibl",
                        direct_mode="restir", indirect_mode="combined", regir=True,
                        regir_mode="onion",
                        cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke_ibl_main")),
                 device="cuda")
    setup_s = time.perf_counter() - t0
    r._model.keep = ("hdr",)
    events = time_passes(r.graph, strict=("RTXDI", "Denoise"))
    rko.restir_candidates, sharcops.sharc_update = k2_spy, upd_spy
    try:
        reset_counts()
        frame_ms, stats, per_frame, occupied, finite, traced = [], [], [], [], True, []
        for _ in range(n_frames):
            c0 = counts()
            f0 = time.perf_counter()
            traced.append(traced_frame(r.render_frame))
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - f0) * 1e3)
            per_frame.append({k: v - c0[k] for k, v in counts().items()})
            stats.append(r.stats())
            occupied.append(int((r._model.state["sharc_cache"].key != 0).sum()))
            finite = finite and bool(torch.isfinite(r._model.last_resources["hdr"]).all())
        launches = counts()
    finally:
        rko.restir_candidates, sharcops.sharc_update = k2_orig, upd_orig
    syncs = span_syncs(traced, ("SHARC", "SharcIndirectQuery", "SpecularIndirect"))
    ldr = r.last_frame
    png = os.path.join(tempfile.gettempdir(), "chip_smoke_stress_ibl_combined_1080p.png")
    r.save_screenshot(png)
    passes = [p.name for p in r.graph.passes if p.enabled]
    r.shutdown()
    pass_ms = {k: median_ms(v) for k, v in events.items()}
    med = statistics.median(frame_ms[1:])
    walks = {}
    for name, lk, ck in IBL_COMBINED_WALKS:
        lanes, capped = sum(x[lk] for x in stats), sum(x[ck] for x in stats)
        walks[name] = f"{capped}/{lanes} ({capped / max(lanes, 1):.5f})"
    log(f"phase20 ibl + restir (ReGIR onion) + combined main path {scene} {W}x{H} "
        f"x{n_frames} on {card}: setup {setup_s:.1f} s (BVH+beam table+bvh16+light pool "
        f"{r.bvh_seconds:.1f} s), passes {passes}, frame ms {[round(x, 2) for x in frame_ms]}, "
        f"median frames 2-{n_frames} {med:.2f} ms, launches {launches}, per frame {per_frame}, "
        f"SHARC occupied slots per frame {occupied}, K3 capped lanes per walk {walks}, "
        f"rt_overflow_di per frame {[x['rt_overflow_di'] for x in stats]}, host syncs in "
        f"SHARC / SharcIndirectQuery / SpecularIndirect over the {n_frames} frames {syncs}; "
        f"png {png}")
    log(f"phase20 per-pass stream ms (CUDA events, median of frames 2-{n_frames}): "
        f"{json.dumps(pass_ms)}")
    assert tuple(ldr.shape) == (H, W, 3) and ldr.dtype == torch.uint8
    assert finite, "non-finite HDR"
    assert passes == IBL_COMBINED_PASSES, passes
    for i, c in enumerate(per_frame):
        assert c["K1"] >= 3 and c["K2"] >= 1 and c["K3"] >= 4 and c["K4"] >= 1, (i, c)
        assert c["K5"] == 0 and c["K6"] == 0, (i, c)
    assert occupied[0] > 0 and all(b >= a for a, b in zip(occupied, occupied[1:])), occupied
    assert syncs.get("SHARC", 0) == 0 and syncs.get("SharcIndirectQuery", 0) == 0, syncs
    assert "k2" in cap and len(cap["updates"]) >= 2, "phase 20 did not reach K2 and SHARC"
    return dict(launches=launches, k2=cap["k2"], sharc_update=cap["updates"][1])


def phase_k2_regir(call, rko, bench_k2k4):
    """Phase 21: K2 on the first phase-20 frame's RTXDI call, whose tile
    table is the 1,080 ReGIR onion cells: all five outputs torch.equal to
    the plain version over three launches; ms (CUDA events, median of 5),
    plain ms, and bench_k2k4.k2_bound at this T."""
    a, kw = call
    flat3, tsel = a[0], a[1]
    T = flat3.shape[0]
    got3 = [rko.restir_candidates(*a, **kw) for _ in range(3)]
    ref = rko.restir_candidates_reference(*a, **kw)
    torch.cuda.synchronize()
    exact = all(torch.equal(g, r_) for got in got3 for g, r_ in zip(got, ref))
    err = max(float((g - r_).abs().max()) for g, r_ in zip(got3[0], ref))
    ms = cuda_ms(lambda: rko.restir_candidates(*a, **kw))
    plain_ms = cuda_ms(lambda: rko.restir_candidates_reference(*a, **kw), reps=3)
    bnd = bench_k2k4.k2_bound(a, got3[0], kw["num_candidates"])
    cells = int(torch.unique(tsel).numel())
    drawn = float((ref[0] >= 0).float().mean())
    log(f"phase21 K2 on the ReGIR onion table T={T} tsel={tuple(tsel.shape)} (cells read "
        f"{cells}) planes={tuple(a[2].shape)}: five outputs equal to the plain version over "
        f"three launches {exact}, max|d| {err:.3g}, pixels with a winner {drawn:.3f}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    assert T == 1080, T        # (5 + 10) shells x 12 azimuth x 6 elevation
    assert exact, "K2 on the ReGIR table is not bit-exact with its plain version"
    assert drawn > 0.3, drawn
    return dict(tiles=T, cells_read=cells, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bnd[0], bound_by=bnd[1])


def phase_sharc_update(args):
    """Phase 22: one phase-20 sharc_update (480x270 = 129,600 samples into
    the 2^20-entry cache, its second frame) twice on the card, which must
    give the same bits, and once on the CPU: keys and ages equal, radiance
    within SHARC_RAD_RTOL."""
    from hobbyrenderer_tpu_torch.ops import sharc as sharcops
    cache = args[0]
    c1, c2 = sharcops.sharc_update(*args), sharcops.sharc_update(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(c1, c2))
    cpu = sharcops.sharc_update(*[type(a)(*(t.cpu() for t in a)) if isinstance(a, tuple)
                                  else a.cpu() for a in args])
    keys_eq = torch.equal(c1.key.cpu(), cpu.key)
    ages_eq = torch.equal(c1.age.cpu(), cpu.age)
    ref = cpu.radiance
    rad_err = float(((c1.radiance.cpu() - ref).abs() / ref.abs().clamp(min=1e-30)).max())
    bits_eq = torch.equal(c1.radiance.cpu(), ref)
    ms = cuda_ms(lambda: sharcops.sharc_update(*args))
    log(f"phase22 sharc_update samples={args[1].shape[0]} (valid {int(args[4].sum())}) into "
        f"{cache.key.shape[0]} entries ({int((cache.key != 0).sum())} occupied before, "
        f"{int((c1.key != 0).sum())} after): two CUDA runs torch.equal {same}; against the CPU "
        f"keys equal {keys_eq}, ages equal {ages_eq}, radiance max rel err {rad_err:.3g} (bits "
        f"equal {bits_eq}); {ms:.3f} ms on the card (CUDA events, median of 5)")
    assert same, "sharc_update gave other bits on a second run"
    assert keys_eq and ages_eq, "sharc_update's keys or ages differ between CUDA and the CPU"
    assert rad_err <= SHARC_RAD_RTOL, rad_err


def phase_new_configs_cuda_vs_cpu(Renderer, Config, W=256, H=192, frames=3):
    """Phase 23: stress:4 at 256x192, 3 frames, CUDA (kernels) against the
    CPU (plain versions), for (ibl, restir, combined, ReGIR onion),
    (normal, restir, sharc) and (normal, simple, ddgi): >= 99% of LDR pixels
    within 2/255, phase 14's gate."""
    for name, kw in (("ibl+restir+combined+regir", dict(mode="ibl", direct_mode="restir",
                                                        indirect_mode="combined", regir=True,
                                                        regir_mode="onion")),
                     ("normal+restir+sharc", dict(direct_mode="restir", indirect_mode="sharc")),
                     ("normal+simple+ddgi", dict(indirect_mode="ddgi"))):
        cfg = Config(scene="stress:4", width=W, height=H,
                     cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke4new"), **kw)
        t0 = time.perf_counter()
        rg = Renderer(cfg, device="cuda")
        rc = Renderer(cfg, device="cpu")
        for _ in range(frames):
            lg = rg.render_frame().cpu().numpy()
            lc = rc.render_frame().numpy()
        rg.shutdown()
        rc.shutdown()
        diff = np.abs(lg.astype(np.int32) - lc.astype(np.int32)).max(-1)
        within = float(np.mean(diff <= 2))
        log(f"phase23 {name} stress:4 {W}x{H} x{frames} frames cuda vs cpu: "
            f"{within * 100:.3f}% of LDR pixels within 2/255, mean |d| {float(diff.mean()):.4f}, "
            f"max {int(diff.max())} ({time.perf_counter() - t0:.1f} s)")
        assert within >= 0.99, (name, within)


ENV_LIGHTS = 64
ENV_W, ENV_H = 2048, 1024
REFIT_REL = 2.0 ** -20   # refit CUDA against CPU: tests/test_torch_refit.py's bound


def _to_device(x, dev):
    """A SceneRT (nested NamedTuples of tensors and ints), or a dict of
    such values, on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_device(v, dev) for v in x))
    if isinstance(x, dict):
        return {k: _to_device(v, dev) for k, v in x.items()}
    return x


def _tensors(x, prefix=""):
    """{dotted name: tensor} of a SceneRT's tensors."""
    if isinstance(x, torch.Tensor):
        return {prefix: x}
    out = {}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        for k, v in zip(x._fields, x):
            out.update(_tensors(v, f"{prefix}.{k}" if prefix else k))
    return out


def write_sky(seed=7):
    """Phases 24-26's environment: scene/workload.py's seeded sky at
    2048x1024 (a gradient and a bright lobe), written as .hdr to a
    temporary directory."""
    from hobbyrenderer_tpu_torch.ops import envmap as envops
    from hobbyrenderer_tpu_torch.scene.workload import sky_envmap
    path = os.path.join(tempfile.mkdtemp(prefix="hr_smoke_env"), "sky.hdr")
    with open(path, "wb") as f:
        f.write(envops.encode_hdr(sky_envmap(ENV_H, ENV_W, seed=seed)))
    return path


def env_anim_renderer(Renderer, Config, env_path, W, H, device="cuda", grid=None, **kw):
    """Phase 24's configuration: the flagship frame (restir + restir,
    specular on) on the stress scene with every 8th node animated (a 2 s
    rise and turn) and the env map as ENV_LIGHTS directional lights."""
    from hobbyrenderer_tpu_torch.scene.procedural import make_stress_scene
    from hobbyrenderer_tpu_torch.scene.workload import animate_nodes
    scene = animate_nodes(make_stress_scene() if grid is None else make_stress_scene(grid=grid))
    cfg = dict(scene="stress" if grid is None else f"stress:{grid}", width=W, height=H,
               direct_mode="restir", indirect_mode="restir", envmap=env_path,
               env_lights=ENV_LIGHTS,
               cache_dir=os.path.join(tempfile.gettempdir(), f"hr_smoke_envanim_{W}"))
    cfg.update(kw)
    return Renderer(Config(**cfg), scene=scene, device=device)


def phase_env_anim(Renderer, Config, reset_counts, counts, time_passes, median_ms, card,
                   env_path, n_frames, W=1920, H=1080, grid=None):
    """Phase 24: the slice's main path at 1920x1080, n_frames frames:
    set-up s, frame ms (median of frames 2-n), per-pass stream ms and
    Frame/RTRefit's, K1-K4 launches a frame, the host syncs of each frame
    by span (the port's tracer), the power-CDF refreshes; then three more
    frames under torch.profiler (kernels a frame, the device's busy
    share: the union of its operations over its window). Captures
    frame 3's K3 walks and K4 calls (the refitted tables), its K2 call (the
    pool holding the environment's lights) and its refit's inputs."""
    from hobbyrenderer_tpu_torch import renderer as rmod
    from hobbyrenderer_tpu_torch.ops import beam as beamops
    from hobbyrenderer_tpu_torch.ops import bvh16 as b16ops
    from hobbyrenderer_tpu_torch.ops import restir_kernel as rko
    from hobbyrenderer_tpu_torch.profile_frame import device_busy, is_range, traced_frames
    t0 = time.perf_counter()
    r = env_anim_renderer(Renderer, Config, env_path, W, H, grid=grid)
    setup_s = time.perf_counter() - t0
    r._model.keep = ("hdr",)
    events = time_passes(r.graph)
    cap = {"k3": [], "k4": []}
    refit_orig, k2_orig = rmod.refit_scene_rt, rko.restir_candidates
    k3_orig, k4_orig = b16ops.bvh16_walk, beamops.beam_any_hit_tiles
    refit_ev = []

    def refit_spy(rt, inst_transform):
        if r.frame_index == 2:
            cap["refit"] = (rt, inst_transform.clone())
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")     # the refit must not wait for the device
        try:
            out = refit_orig(rt, inst_transform)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        e1.record()
        refit_ev.append((e0, e1))
        return out

    def k2_spy(*a, **kw):
        if r.frame_index == 2:
            cap.setdefault("k2", (a, kw))
        return k2_orig(*a, **kw)

    def k3_spy(table, o, d, t_max, any_hit, max_steps, t_min=1e-4):
        if r.frame_index == 2:
            cap["k3"].append((table, o, d, t_max, any_hit, max_steps, t_min))
        return k3_orig(table, o, d, t_max, any_hit, max_steps, t_min)

    def k4_spy(btable, rays):
        if r.frame_index == 2:
            cap["k4"].append((btable, rays.clone()))
        return k4_orig(btable, rays)

    rmod.refit_scene_rt, rko.restir_candidates = refit_spy, k2_spy
    b16ops.bvh16_walk, beamops.beam_any_hit_tiles = k3_spy, k4_spy
    try:
        reset_counts()
        frame_ms, per_frame, traced, stats = [], [], [], []
        for _ in range(n_frames):
            c0 = counts()
            f0 = time.perf_counter()
            traced.append(traced_frame(r.render_frame))
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - f0) * 1e3)
            per_frame.append({k: v - c0[k] for k, v in counts().items()})
            stats.append(r.stats())
        launches = counts()
    finally:
        rmod.refit_scene_rt, rko.restir_candidates = refit_orig, k2_orig
        b16ops.bvh16_walk, beamops.beam_any_hit_tiles = k3_orig, k4_orig
    syncs, by_pass = [f.host_syncs for f in traced], span_syncs(traced)
    finite = bool(torch.isfinite(r._model.last_resources["hdr"]).all())
    ldr = r.last_frame
    png = os.path.join(tempfile.gettempdir(), "chip_smoke_stress_env_anim_1080p.png")
    r.save_screenshot(png)
    passes = [p.name for p in r.graph.passes if p.enabled]
    n_lights = r.gpu.meta["light_count"]
    dev, _ = traced_frames(r, 3)
    busy = device_busy([e for e in dev if not is_range(e.name, passes)], 3)
    r.shutdown()
    pass_ms = {k: median_ms(v) for k, v in events.items()}
    pass_ms["Frame/RTRefit"] = median_ms(refit_ev)
    med = statistics.median(frame_ms[1:])
    k3_share = {w: f"{sum(x[f'rt_k3_capped_{w}'] for x in stats)}/"
                   f"{sum(x[f'rt_k3_lanes_{w}'] for x in stats)}"
                for w in ("di", "gi", "gi_nee", "spec", "spec_nee")}
    log(f"phase24 env + animated flagship main path stress {W}x{H} x{n_frames} on {card}: "
        f"setup {setup_s:.1f} s (BVH+beam table+bvh16+light pool {r.bvh_seconds:.1f} s), "
        f"{n_lights} analytic lights ({n_lights - 9} from the env map), passes {passes}, "
        f"frame ms {[round(x, 2) for x in frame_ms]}, median frames 2-{n_frames} {med:.2f} ms, "
        f"launches {launches}, per frame {per_frame}, host syncs per frame {syncs} (over the "
        f"{n_frames} frames by pass {json.dumps(by_pass)}; the refit ran under sync-debug "
        f"'error'), power-CDF "
        f"refreshes {stats[-1]['pool_cdf_host_syncs']}, K3 capped/lanes over the frames "
        f"{k3_share}, rt_overflow_di per frame {[x['rt_overflow_di'] for x in stats]}, "
        f"profiled frames {json.dumps(busy)}; png {png}")
    log(f"phase24 per-pass stream ms (CUDA events, median of frames 2-{n_frames}) on {card}: "
        f"{json.dumps(pass_ms)}")
    assert tuple(ldr.shape) == (H, W, 3) and ldr.dtype == torch.uint8
    assert finite, "non-finite HDR"
    assert passes == ["Culling", "Raster", "HZBBuild", "RasterPhase2", "ResolveGBuffer",
                      "MaskedLayer", "IBL", "RTXDI", "RTXDIGI", "Denoise", "SpecularIndirect",
                      "DeferredLighting", "Sky", "Transparent", "TAA", "AutoExposure", "Bloom",
                      "Tonemap"], passes
    assert n_lights > 9 + ENV_LIGHTS // 2, n_lights
    assert len(refit_ev) == n_frames, "a frame did not refit the RT scene"
    for i, c in enumerate(per_frame):
        assert c["K1"] >= 3 and c["K2"] >= 1 and c["K3"] >= 2 and c["K4"] >= 2, (i, c)
        assert c["K5"] == 0 and c["K6"] == 0, (i, c)
    assert stats[-1]["pool_cdf_host_syncs"] == 1, "a frame after the first refreshed the pool"
    assert "k2" in cap and cap["k3"] and cap["k4"] and "refit" in cap, \
        "frame 3 did not reach K2, K3, K4 and the refit"
    return dict(launches=launches, cap=cap, ms=med, pass_ms=pass_ms, setup_s=setup_s,
                syncs=syncs, syncs_by_pass=by_pass, busy=busy, k3_capped=k3_share)


def phase_env_anim_kernels(cap, bench_k2k4, card):
    """Phase 24's checks: frame 3's K3 walks and K4 calls (on the refitted
    16-wide table and beam table) and its K2 call (the pool with the env
    lights), each held against its plain version with three launches equal;
    the refit twice on the card (the same bits) and once on the CPU
    (within REFIT_REL; it adds and multiplies in a fixed order, so the bits
    are expected equal too), its ms and its kernel launches."""
    from hobbyrenderer_tpu_torch.models.scene_rt import refit_scene_rt
    from hobbyrenderer_tpu_torch.ops import beam as beamops
    from hobbyrenderer_tpu_torch.ops import restir_kernel as rko
    out = {"k3": [], "k4": []}
    for i, walk in enumerate(cap["k3"]):
        x = k3_check(walk)
        tab, o, d, tm, any_hit, steps, _ = walk
        ps = x["ref"][2]
        out["k3"].append(dict(name=f"frame3[{i}]", rays=o.shape[0], any_hit=any_hit,
                              max_steps=steps, ms=x["ms"], plain_ms=x["plain_ms"],
                              bound_ms=x["bound"][0], bound_by=x["bound"][1], err=x["err"],
                              capped=int((ps >= steps).sum())))
        log(f"phase24 K3 frame-3 walk {i} on the refitted bvh16 ({tuple(tab.shape)}) rays="
            f"{o.shape[0]} any_hit={any_hit} max_steps={steps}: mismatches {x['mis']}, three "
            f"launches equal {x['repeat_equal']}, lanes at the budget "
            f"{out['k3'][-1]['capped']}; kernel {x['ms']:.4f} ms, plain {x['plain_ms']:.3f} "
            f"ms, bound {x['bound'][0]:.4f} ms ({x['bound'][1]}) on {card}")
        assert not any(x["mis"].values()), f"K3 frame-3 walk {i} differs from its plain version"
        assert x["repeat_equal"], f"three K3 launches on frame-3 walk {i} differ"
    for i, (btable, rays) in enumerate(cap["k4"]):
        x, line = bench_k2k4.held_k4(btable, rays)
        x["ms"] = cuda_ms(lambda: beamops.beam_any_hit_tiles(btable, rays))
        out["k4"].append(dict(name=f"frame3[{i}]", ms=x["ms"], plain_ms=x["plain_ms"],
                              bound_ms=x["bound_ms"], bound_by=x["bound_by"],
                              active_lanes=x["active"], mismatches=x["mismatches"],
                              max_abs_err=x["max_abs_err"]))
        log(f"phase24 K4 frame-3 call {i} on the refitted beam table {tuple(btable.shape)} "
            f"rays={tuple(rays.shape)}: {line}; kernel {x['ms']:.4f} ms on {card}")
        assert x["mismatches"] <= 1e-4 * max(x["active"], 1), (i, x["mismatches"])
        assert x["replay_mismatches"] == 0, (i, x["replay_mismatches"])
        assert x["repeat_equal"], f"three K4 launches on frame-3 call {i} differ"
    a, kw = cap["k2"]
    row, line, _ = bench_k2k4.held_k2(a, kw)
    slots = a[0]                     # (T, 18, 128): a packed row, inv_pdf, id a slot
    dir_slots = float(((slots[:, 13] < 0.5) & (slots[:, 0] == 0)
                       & (slots[:, 17] >= 0)).float().mean())
    row["ms"] = cuda_ms(lambda: rko.restir_candidates(*a, **kw))
    row["directional_slots"] = dir_slots
    out["k2"] = row
    log(f"phase24 K2 frame-3 call on the env-light pool: {line}; directional slots "
        f"{dir_slots:.4f}; kernel {row['ms']:.4f} ms on {card}")
    assert all(row["equal"].values()), f"K2 on the env-light pool differs: {row['equal']}"
    assert row["repeat_equal"], "three K2 launches on the env-light pool differ"
    assert dir_slots > 0.05, dir_slots
    rt, T = cap["refit"]
    r1, r2 = refit_scene_rt(rt, T), refit_scene_rt(rt, T)
    torch.cuda.synchronize()
    t1, t2 = _tensors(r1), _tensors(r2)
    same = all(torch.equal(t1[k], t2[k]) for k in t1)
    rc = _tensors(refit_scene_rt(_to_device(rt, "cpu"), T.cpu()))
    worst, bits = 0.0, True
    for k, v in t1.items():
        g, c = v.cpu(), rc[k]
        bits = bits and torch.equal(g, c)
        if g.is_floating_point():
            worst = max(worst, float(((g - c).abs() / c.abs().clamp(min=1.0)).max()))
    ms = cuda_ms(lambda: refit_scene_rt(rt, T))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        refit_scene_rt(rt, T)
        torch.cuda.synchronize()
    launched = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels_n = sum(1 for e in launched if "memcpy" not in e.name.lower()
                    and "memset" not in e.name.lower())
    nbytes_out = sum(v.numel() * v.element_size() for v in t1.values())
    out["refit"] = dict(ms=ms, kernels=kernels_n, same_bits_twice=same, cpu_bits_equal=bits,
                        cpu_max_rel=worst, bytes_out=nbytes_out)
    log(f"phase24 refit (4-wide tree + beam table + bvh16 + light pool, "
        f"{rt.split_world0.shape[0]} split triangles) on {card}: {ms:.3f} ms (CUDA events, "
        f"median of 5), {kernels_n} kernels a refit; twice on the card torch.equal {same}; "
        f"against the CPU: bits equal {bits}, max rel err {worst:.3g} (bound {REFIT_REL:.3g})")
    assert same, "the refit gave other bits on a second run"
    assert worst <= REFIT_REL, worst
    return out


def phase_taau(Renderer, Config, counts, time_passes, median_ms, card, env_path, n_frames,
               flag_ms, bench_raster, W=1920, H=1080, grid=None):
    """Phase 25: phase 24's configuration at render_scale 0.5 (K1 rasters
    at 960x540; TAA, exposure, bloom and tonemap at 1920x1080), its frames
    taken in turns with a second renderer of phase 24's configuration (so
    that both see the same host and allocator state): frame ms of both and
    against phase 24's, per-pass stream ms of both, K1 launches of the
    upscaled path, and the first K1 call of its frame 2 (at the internal
    size) held against its plain version."""
    from hobbyrenderer_tpu_torch.ops import raster_kernel as rk
    cap = []
    k1_orig = rk.raster_resolve_tiles
    rs = {"0.5": env_anim_renderer(Renderer, Config, env_path, W, H, grid=grid,
                                   render_scale=0.5),
          "1.0": env_anim_renderer(Renderer, Config, env_path, W, H, grid=grid)}
    r = rs["0.5"]
    rendering = [None]

    def k1_spy(records, work_tile, work_slot, **kw):
        if rendering[0] == "0.5" and r.frame_index == 1 and not cap:
            cap.append((records, work_tile, work_slot, kw))
        return k1_orig(records, work_tile, work_slot, **kw)

    events = {k: time_passes(x.graph) for k, x in rs.items()}
    frame_ms = {k: [] for k in rs}
    launches = dict.fromkeys(counts(), 0)      # the upscaled renderer's
    rk.raster_resolve_tiles = k1_spy
    try:
        for _ in range(n_frames):
            for k, x in rs.items():
                rendering[0] = k
                c0 = counts()
                f0 = time.perf_counter()
                x.render_frame()
                torch.cuda.synchronize()
                frame_ms[k].append((time.perf_counter() - f0) * 1e3)
                if k == "0.5":
                    for n, v in counts().items():
                        launches[n] += v - c0[n]
    finally:
        rk.raster_resolve_tiles = k1_orig
    ldr = r.last_frame
    hist = r._model.state["taa_history"]
    size = (r._model.width, r._model.height)
    for x in rs.values():
        x.shutdown()
    med = {k: statistics.median(v[1:]) for k, v in frame_ms.items()}
    x = raster_check(bench_raster, True, *cap[0])
    log(f"phase25 TAA upscaling, phase 24's configuration at render_scale 0.5 (render "
        f"{size[0]}x{size[1]}, output {W}x{H}) x{n_frames}, in turns with render_scale 1.0, "
        f"on {card}: frame ms 0.5 {[round(v, 2) for v in frame_ms['0.5']]}, 1.0 "
        f"{[round(v, 2) for v in frame_ms['1.0']]}; median frames 2-{n_frames} "
        f"{med['0.5']:.2f} ms against {med['1.0']:.2f} ms in turns "
        f"({med['0.5'] / med['1.0']:.3f}x) and phase 24's {flag_ms:.2f} ms; launches "
        f"{launches}; K1 frame-2 call tiles={cap[0][3]['tiles']}: {x['line']}")
    for k, ev in events.items():
        log(f"phase25 render_scale {k} per-pass stream ms (CUDA events, median of frames "
            f"2-{n_frames}) on {card}: {json.dumps({n: median_ms(v) for n, v in ev.items()})}")
    assert size == (W // 2, H // 2), size
    # the captured call rasters the internal size's tiles
    assert cap[0][3]["tiles"] == -(-size[0] // rk.TILE) * -(-size[1] // rk.TILE), cap[0][3]
    assert tuple(ldr.shape) == (H, W, 3) and tuple(hist.shape) == (H, W, 3)
    assert launches["K1"] >= 3 * n_frames, launches
    assert x["exact"], "K1 at the internal size: depth or visid differs from its plain version"
    assert x["repeat_equal"], "K1 at the internal size: three launches gave different outputs"
    assert x["plan_equal"] and x["attr_max_err"] <= 1e-4, x["attr_max_err"]
    return dict(ms=med["0.5"], ms_full_in_turns=med["1.0"], launches=launches,
                k1=raster_summary(x), k1_err=x["attr_max_err"])


def phase_env_anim_cuda_vs_cpu(Renderer, Config, env_path, card, W=256, H=192, frames=3):
    """Phase 26: stress:4 at 256x192, 3 frames, CUDA (kernels) against the
    CPU (plain versions): (a) phase 24's configuration (nodes 8 and 16
    animated, 64 env lights), (b) NormalBasic + DDGI at render_scale 0.5,
    (c) the path tracer with the env map and the animation. Gate: >= 99% of
    LDR pixels within 2/255 (phase 14's; for the path tracer phase 17's,
    whose cause is in ROADMAP Queue 3: ulps in the plain shading flip a
    light sample)."""
    from hobbyrenderer_tpu_torch.scene.procedural import make_stress_scene
    from hobbyrenderer_tpu_torch.scene.workload import animate_nodes
    cases = (("env+anim flagship", dict(direct_mode="restir", indirect_mode="restir",
                                        envmap=env_path, env_lights=ENV_LIGHTS), True),
             ("normal_basic+ddgi scale 0.5", dict(mode="normal_basic", indirect_mode="ddgi",
                                                  render_scale=0.5), False),
             ("path tracer env+anim", dict(mode="path_tracer", envmap=env_path), True))
    for name, kw, animated in cases:
        cfg = Config(scene="stress:4", width=W, height=H,
                     cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke4env"), **kw)
        t0 = time.perf_counter()
        rs = [Renderer(cfg, scene=animate_nodes(make_stress_scene(grid=4)) if animated else None,
                       device=dev) for dev in ("cuda", "cpu")]
        for _ in range(frames):
            lg = rs[0].render_frame().cpu().numpy()
            lc = rs[1].render_frame().numpy()
        for r_ in rs:
            r_.shutdown()
        diff = np.abs(lg.astype(np.int32) - lc.astype(np.int32)).max(-1)
        within = float(np.mean(diff <= 2))
        log(f"phase26 {name} stress:4 {W}x{H} x{frames} frames cuda vs cpu: "
            f"{within * 100:.3f}% of LDR pixels within 2/255, mean |d| {float(diff.mean()):.4f}, "
            f"max {int(diff.max())} ({time.perf_counter() - t0:.1f} s on {card} and the host)")
        assert lg.shape == (H, W, 3), lg.shape
        assert within >= 0.99, (name, within)


STREAM_FRAMES = 24        # phase 27: feedback fetched after frames 8, 16 and 24
STREAM_HOLD_FRAME = 12    # phase 27: the streamed frame whose K1-K4 calls are held
FLAGSHIP = dict(direct_mode="restir", indirect_mode="restir")


def hold_captured(cap, bench_raster, bench_k2k4, card, tag, emit=log):
    """A frame's captured K1 calls, K2 call, K3 walks and K4 calls, each
    held against its plain version as phases 2, 6, 7 and 3 hold them:
    K1 depth and visid torch.equal (attributes within 1e-4), K2 all five
    outputs torch.equal, K3 every output torch.equal, K4 within phase 3's
    allowance of the plain version and equal to its replayed walk; three
    launches equal for each. Its lines go to ``emit``. Returns a summary
    for the kernels line."""
    log = emit
    from hobbyrenderer_tpu_torch.ops import beam as beamops
    out = {"k1": [], "k3": [], "k4": []}
    for i, (records, work_tile, work_slot, kw) in enumerate(cap["k1"]):
        x, line, _ = bench_raster.held_call(True, records, work_tile, work_slot, kw, False)
        out["k1"].append(dict(exact=x["exact"], repeat_equal=x["repeat_equal"],
                              attr_max_err=x["attr_max_err"], items=x["items"]))
        log(f"{tag} K1 call {i} tiles={kw['tiles']}: {line} on {card}")
        assert x["exact"] and x["repeat_equal"] and x["plan_equal"], f"{tag} K1 call {i}"
        assert x["attr_max_err"] <= 1e-4, x["attr_max_err"]
    a, kw = cap["k2"]
    row, line, _ = bench_k2k4.held_k2(a, kw)
    out["k2"] = dict(equal=row["equal"], repeat_equal=row["repeat_equal"],
                     max_abs_err=row["max_abs_err"])
    log(f"{tag} K2: {line} on {card}")
    assert all(row["equal"].values()) and row["repeat_equal"], f"{tag} K2: {row['equal']}"
    for i, walk in enumerate(cap["k3"]):
        x = k3_check(walk)
        out["k3"].append(dict(rays=walk[1].shape[0], mis=x["mis"], ms=x["ms"],
                              repeat_equal=x["repeat_equal"]))
        log(f"{tag} K3 walk {i} rays={walk[1].shape[0]} any_hit={walk[4]}: mismatches "
            f"{x['mis']}, three launches equal {x['repeat_equal']}; kernel {x['ms']:.4f} ms, "
            f"plain {x['plain_ms']:.3f} ms on {card}")
        assert not any(x["mis"].values()) and x["repeat_equal"], f"{tag} K3 walk {i}"
    for i, (btable, rays) in enumerate(cap["k4"]):
        x, line = bench_k2k4.held_k4(btable, rays)
        out["k4"].append(dict(active=x["active"], mismatches=x["mismatches"],
                              replay_mismatches=x["replay_mismatches"],
                              repeat_equal=x["repeat_equal"]))
        log(f"{tag} K4 call {i} rays={tuple(rays.shape)}: {line} on {card}")
        assert x["mismatches"] <= 1e-4 * max(x["active"], 1), (tag, i, x["mismatches"])
        assert x["replay_mismatches"] == 0 and x["repeat_equal"], (tag, i)
    return out


def phase_streamed_flagship(Renderer, Config, reset_counts, counts, time_passes, median_ms,
                            card, bench_raster, bench_k2k4, W=1920, H=1080):
    """Phase 27: the flagship frame at 1920x1080 on the stress scene with
    texture streaming (the default 64 MB pool: 4,096 pages; the streamer's
    worker thread, feedback fetched every 8th frame), STREAM_FRAMES
    frames, each in turns with a frame of the plain flagship: frame ms
    (medians after the first), per-pass stream ms with Frame/TexStreaming,
    tiles uploaded a frame, the frame on which the resident mips stop
    changing, host syncs by pass, K1-K4 launches a frame (the counts set to
    0 just before each streamed frame and read just after). Frame
    STREAM_HOLD_FRAME's K1-K4 calls are captured and held against their
    plain versions; every textured material the fetched feedback demands
    finer than its tail must have left the tail."""
    from hobbyrenderer_tpu_torch.ops import beam as beamops
    from hobbyrenderer_tpu_torch.ops import bvh16 as b16ops
    from hobbyrenderer_tpu_torch.ops import raster_kernel as rk
    from hobbyrenderer_tpu_torch.ops import restir_kernel as rko
    t0 = time.perf_counter()
    r = Renderer(Config(scene="stress", width=W, height=H, tex_streaming=True,
                        cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke_stream"),
                        **FLAGSHIP), device="cuda")
    setup_s = time.perf_counter() - t0
    rp = Renderer(Config(scene="stress", width=W, height=H,
                         cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke_stream_p"),
                         **FLAGSHIP), device="cuda")
    st = r.streamer
    assert st.budget_pages == 4096 and st._worker is not None, (st.budget_pages, st._worker)
    r._model.keep = ("hdr",)
    events = time_passes(r.graph)
    stream_ev, apply_host_ms, published = [], [], []
    apply_orig, publish_orig = st.apply_updates, st.publish_feedback

    def apply_spy(tables):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        e0.record()
        out = apply_orig(tables)
        e1.record()
        apply_host_ms.append((time.perf_counter() - h0) * 1e3)
        stream_ev.append((e0, e1))
        return out

    def publish_spy(fb):
        published.append(np.array(fb))
        publish_orig(fb)

    st.apply_updates, st.publish_feedback = apply_spy, publish_spy
    cap = {"k1": [], "k3": [], "k4": []}
    hold = [False]
    k1_orig, k2_orig = rk.raster_resolve_tiles, rko.restir_candidates
    k3_orig, k4_orig = b16ops.bvh16_walk, beamops.beam_any_hit_tiles

    def k1_spy(records, work_tile, work_slot, **kw):
        if hold[0]:
            cap["k1"].append((records, work_tile, work_slot, kw))
        return k1_orig(records, work_tile, work_slot, **kw)

    def k2_spy(*a, **kw):
        if hold[0]:
            cap.setdefault("k2", (a, kw))
        return k2_orig(*a, **kw)

    def k3_spy(table, o, d, t_max, any_hit, max_steps, t_min=1e-4):
        if hold[0]:
            cap["k3"].append((table, o, d, t_max, any_hit, max_steps, t_min))
        return k3_orig(table, o, d, t_max, any_hit, max_steps, t_min)

    def k4_spy(btable, rays):
        if hold[0]:
            cap["k4"].append((btable, rays.clone()))
        return k4_orig(btable, rays)

    rk.raster_resolve_tiles, rko.restir_candidates = k1_spy, k2_spy
    b16ops.bvh16_walk, beamops.beam_any_hit_tiles = k3_spy, k4_spy
    frame_ms, plain_ms, per_frame, traced, tiles, resident = [], [], [], [], [], []
    launches = {}
    try:
        for f in range(STREAM_FRAMES):
            hold[0] = f == STREAM_HOLD_FRAME
            up0 = st.tiles_uploaded
            reset_counts()
            f0 = time.perf_counter()
            traced.append(traced_frame(r.render_frame))
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - f0) * 1e3)
            c = counts()
            per_frame.append({k: c[k] for k in ("K1", "K2", "K3", "K4")})
            for k, v in c.items():
                launches[k] = launches.get(k, 0) + v
            hold[0] = False
            tiles.append(st.tiles_uploaded - up0)
            resident.append(r.stats()["stream_resident_mips"])
            f0 = time.perf_counter()
            rp.render_frame()
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - f0) * 1e3)
    finally:
        rk.raster_resolve_tiles, rko.restir_candidates = k1_orig, k2_orig
        b16ops.bvh16_walk, beamops.beam_any_hit_tiles = k3_orig, k4_orig
    syncs, by_pass = [f.host_syncs for f in traced], span_syncs(traced)
    stats = r.stats()
    finite = bool(torch.isfinite(r._model.last_resources["hdr"]).all())
    ldr = r.last_frame
    png = os.path.join(tempfile.gettempdir(), "chip_smoke_stress_streamed_1080p.png")
    r.save_screenshot(png)
    passes = [p.name for p in r.graph.passes if p.enabled]
    tail = st.tail_mip.copy()
    r.shutdown()
    rp.shutdown()
    pass_ms = {k: median_ms(v) for k, v in events.items()}
    pass_ms["Frame/TexStreaming"] = median_ms(stream_ev)
    # the frames that applied a batch: stream ms and the host's ms of the call
    applied = [(round(e0.elapsed_time(e1), 3), round(h, 3))
               for (e0, e1), h, n in zip(stream_ev, apply_host_ms, tiles) if n]
    settled = next(f for f in range(STREAM_FRAMES)
                   if all(x == resident[f] for x in resident[f:]))
    med, med_p = statistics.median(frame_ms[1:]), statistics.median(plain_ms[1:])
    textured = [m for m in range(len(tail)) if tail[m] > 0]
    demanded = sorted({m for fb in published for m in textured
                       if fb[m, :tail[m]].sum() > 0})
    log(f"phase27 streamed flagship stress {W}x{H} x{STREAM_FRAMES} on {card}: setup "
        f"{setup_s:.1f} s, pool {st.budget_pages} pages ({st.pool_base} tail rows), passes "
        f"{passes}, frame ms {[round(x, 2) for x in frame_ms]}, median frames 2-{STREAM_FRAMES} "
        f"{med:.2f} ms; the plain flagship in turns {[round(x, 2) for x in plain_ms]}, median "
        f"{med_p:.2f} ms; tiles uploaded a frame {tiles} (total {st.tiles_uploaded}; the "
        f"applying frames' Frame/TexStreaming stream / host ms {applied}); resident "
        f"mips settle from frame {settled + 1} on: {resident[-1]} (tail {tail.tolist()}); "
        f"feedback fetched {stats['tex_feedback_host_syncs']} times; host syncs per frame "
        f"{syncs} (by pass {json.dumps(by_pass)}); launches per frame {per_frame}; materials "
        f"the feedback demands finer than the tail {demanded}; png {png}")
    log(f"phase27 per-pass stream ms (CUDA events, median of frames 2-{STREAM_FRAMES}) on "
        f"{card}: {json.dumps(pass_ms)}")
    assert tuple(ldr.shape) == (H, W, 3) and ldr.dtype == torch.uint8
    assert finite, "non-finite HDR"
    assert passes == ["Culling", "Raster", "HZBBuild", "RasterPhase2", "ResolveGBuffer",
                      "MaskedLayer", "IBL", "RTXDI", "RTXDIGI", "Denoise", "SpecularIndirect",
                      "DeferredLighting", "Sky", "Transparent", "TAA", "AutoExposure", "Bloom",
                      "Tonemap"], passes
    assert stats["tex_feedback_host_syncs"] == STREAM_FRAMES // 8, stats
    for i, c in enumerate(per_frame):
        assert c["K1"] >= 3 and c["K2"] >= 1 and c["K3"] >= 2 and c["K4"] >= 2, (i, c)
    assert launches["K5"] == 0 and launches["K6"] == 0, launches
    assert demanded, "the feedback demanded no streamed mip"
    off_tail = {m: resident[-1][m] for m in demanded}
    assert all(resident[-1][m] < tail[m] for m in demanded), off_tail
    held = hold_captured(cap, bench_raster, bench_k2k4, card, f"phase27 frame {STREAM_HOLD_FRAME + 1}")
    return dict(launches=launches, ms=med, plain_ms=med_p, pass_ms=pass_ms, setup_s=setup_s,
                tiles=tiles, applied_ms=applied, settled_frame=settled + 1, syncs=syncs, syncs_by_pass=by_pass,
                held=held, per_frame=per_frame)


DEBUG_CONFIGS = (
    ("normal_basic+ssgi ssgi_hit_mask", dict(mode="normal_basic", indirect_mode="ssgi",
                                             debug_view="ssgi_hit_mask"), "DebugView"),
    ("normal_basic+ddgi csm_debug ddgi_debug csm_cascade_splits",
     dict(mode="normal_basic", indirect_mode="ddgi", csm_debug=True, ddgi_debug=True,
          debug_view="csm_cascade_splits"), "DebugView"),
    ("normal+restir+sharc sharc_heatmap", dict(direct_mode="restir", indirect_mode="sharc",
                                               debug_view="sharc_heatmap"), "DebugView"),
    ("streamed flagship tex_debug", dict(FLAGSHIP, tex_streaming=True, tex_debug=True),
     "TexResidencyDebug"),
)


def phase_debug_views(Renderer, Config, reset_counts, counts, card, W=1920, H=1080, frames=3):
    """Phase 28: the debug views at 1920x1080 on the stress scene, four
    renderers of ``frames`` frames: frame ms, the passes, launches, and an
    image that is not constant (tests/test_debugview.py's check)."""
    out = {}
    for name, kw, last in DEBUG_CONFIGS:
        t0 = time.perf_counter()
        r = Renderer(Config(scene="stress", width=W, height=H,
                            cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke_dbg"), **kw),
                     device="cuda")
        setup_s = time.perf_counter() - t0
        reset_counts()
        ms = []
        for _ in range(frames):
            f0 = time.perf_counter()
            ldr = r.render_frame()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - f0) * 1e3)
        launches = counts()
        passes = [p.name for p in r.graph.passes if p.enabled]
        std = float(ldr.float().std())
        png = os.path.join(tempfile.gettempdir(), f"chip_smoke_debug_{len(out)}_1080p.png")
        r.save_screenshot(png)
        r.shutdown()
        out[name] = dict(ms=statistics.median(ms[1:]), launches=launches)
        log(f"phase28 {name} stress {W}x{H} x{frames} on {card}: setup {setup_s:.1f} s, frame "
            f"ms {[round(x, 2) for x in ms]}, passes {passes}, launches {launches}, LDR std "
            f"{std:.2f}, png {png}")
        assert tuple(ldr.shape) == (H, W, 3) and ldr.dtype == torch.uint8
        assert passes[-1] == last, passes
        if "ddgi_debug" in kw:
            assert passes[-3:] == ["DDGIDebug", "CSMDebug", "DebugView"], passes
        assert std > 0, f"{name}: the debug image is constant"
    return out


def _lockstep_streamers(rs, clock):
    """Give each of Renderers ``rs`` a sync-mode streamer on one injected
    clock in place of its worker thread (the same tables: nothing has been
    applied yet)."""
    from hobbyrenderer_tpu_torch.scene.streaming import TextureStreamer
    for r_ in rs:
        pages = r_.streamer.budget_pages
        r_.streamer.stop()
        r_.streamer = TextureStreamer(r_.scene, budget_pages=pages, sync_mode=True,
                                      now_fn=lambda: clock["t"])


def _scripted_feedback(st, f):
    """Frame ``f``'s demand histogram for streamer ``st``: every textured
    material asks for mip 1 in frames 0-2 (more than a 128-page pool
    holds); from frame 3 on, the two halves of them take turns asking for
    mip 1 and for their tail, so that each turn downgrades one half: some
    of its pages recycled LRU for the other half's upgrades, the rest
    freed."""
    fb = np.zeros((st.n_mats, st.tail_off.shape[1]), np.int64)
    textured = [m for m in range(st.n_mats) if st.tail_mip[m] > 0]
    for i, m in enumerate(textured):
        up = f < 3 or (i < len(textured) // 2) == (f % 2 == 0)
        fb[m, 1 if up else st.tail_mip[m]] = 100
    return fb


def phase_streaming_cuda_vs_cpu(Renderer, Config, card, W=256, H=192, frames=8):
    """Phase 29, CUDA (kernels) against the CPU (plain versions) at 256x192
    on stress:4: (1) the streamed flagship in a 2 MB pool (128 pages) with
    sync-mode streamers in lockstep, driven by one scripted feedback
    sequence (``_scripted_feedback``; the clock 0.6 s a frame past a 0.5 s
    hysteresis: upgrades, downgrades that free pages, LRU recycling), the
    streaming tables equal after every apply and the frames >= 99% within
    2/255; (2) every name in ALL_VIEWS on one frame's captured DebugView
    inputs per family, CUDA against the same inputs on the CPU, >= 99%
    within 2/255; (3) the streamed path tracer in lockstep, phase 17's
    gate (>= 99% within 2/255)."""
    from hobbyrenderer_tpu_torch.models import deferred as dmod
    from hobbyrenderer_tpu_torch.ops import debugview as dvops
    t0 = time.perf_counter()
    cfg = Config(scene="stress:4", width=W, height=H, tex_streaming=True, tex_budget_mb=2,
                 cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke4stream"), **FLAGSHIP)
    rs = [Renderer(cfg, device=dev) for dev in ("cuda", "cpu")]
    clock = {"t": 0.0}
    _lockstep_streamers(rs, clock)
    for r_ in rs:
        r_.streamer.hysteresis_s = 0.5
    applies, freed, worst = 0, 0, 1.0
    for f in range(frames):
        pend = rs[0].streamer._pending
        lg = rs[0].render_frame().cpu().numpy()
        lc = rs[1].render_frame().numpy()
        if pend is not None:
            applies += 1
            freed += bool(pend.freed)
            tg, tc = rs[0].gpu.tex_stream, rs[1].gpu.tex_stream
            for k in ("mat_resident", "page_table", "tex_pool"):
                assert torch.equal(getattr(tg, k).cpu(), getattr(tc, k)), (f, k)
        diff = np.abs(lg.astype(np.int32) - lc.astype(np.int32)).max(-1)
        within = float(np.mean(diff <= 2))
        worst = min(worst, within)
        assert within >= 0.99, (f, within)
        clock["t"] += 0.6
        fb = _scripted_feedback(rs[0].streamer, f)
        for r_ in rs:
            r_.streamer.publish_feedback(fb.copy())
            r_.streamer.poll()
    res = rs[0].stats()["stream_resident_mips"]
    for r_ in rs:
        r_.shutdown()
    log(f"phase29 streamed flagship stress:4 {W}x{H} x{frames} frames cuda vs cpu, 128-page "
        f"pool in lockstep: {applies} applies ({freed} freeing pages: the whole page table "
        f"re-uploaded), mat_resident / page_table / tex_pool equal after every apply, the "
        f"worst frame {worst * 100:.3f}% of LDR pixels within 2/255; last resident mips {res} "
        f"({time.perf_counter() - t0:.1f} s on {card} and the host)")
    assert applies >= frames - 3 and freed >= 1, (applies, freed)

    # (2) every view, CUDA against CPU on one frame's captured inputs
    families = (("csm", dict(mode="normal_basic", debug_view="csm_cascade_splits"),
                 dvops.CSM_VIEWS),
                ("ssgi", dict(mode="normal_basic", indirect_mode="ssgi",
                              debug_view="ssgi_hit_mask"), dvops.SSGI_VIEWS),
                ("sharc", dict(direct_mode="restir", indirect_mode="sharc",
                               debug_view="sharc_heatmap"), dvops.SHARC_VIEWS))
    for fam, kw, names in families:
        t0 = time.perf_counter()
        r = Renderer(Config(scene="stress:4", width=W, height=H,
                            cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke4dv"), **kw),
                     device="cuda")
        seen = {}
        ps = r.graph.get("DebugView")
        fn = ps.fn

        def spy(ctx, res_, fn=fn):
            seen["ctx"] = ctx
            seen["res"] = {k: res_[k] for k in ps.reads}
            fn(ctx, res_)
        ps.fn = spy
        for _ in range(2):
            r.render_frame()
        r.shutdown()
        ctx, res_g = seen["ctx"], seen["res"]
        res_c = {k: _to_device(v, "cpu") for k, v in res_g.items()}
        # the CSM views read the material table's alpha modes from the scene
        ctx_c = type(ctx)(gpu=types.SimpleNamespace(mat_i=ctx.gpu.mat_i.cpu()),
                          vc=_to_device(ctx.vc, "cpu"), settings=ctx.settings)
        rows = {}
        for name in names:
            ig = dmod.to_ldr8(dmod.debug_view_image(ctx, res_g, res_g["gbuffer"], name, H, W))
            ic = dmod.to_ldr8(dmod.debug_view_image(ctx_c, res_c, res_c["gbuffer"], name, H, W))
            d = (ig.cpu().to(torch.int32) - ic.to(torch.int32)).abs().amax(-1)
            rows[name] = float((d <= 2).float().mean())
        log(f"phase29 {fam} views cuda vs cpu on one stress:4 {W}x{H} frame's DebugView "
            f"inputs: share of pixels within 2/255 {json.dumps(rows)} "
            f"({time.perf_counter() - t0:.1f} s on {card} and the host)")
        assert all(v >= 0.99 for v in rows.values()), rows

    # (3) the streamed path tracer in lockstep
    t0 = time.perf_counter()
    cfg = Config(scene="stress:4", width=W, height=H, mode="path_tracer", tex_streaming=True,
                 tex_budget_mb=2, cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke4pts"))
    rs = [Renderer(cfg, device=dev) for dev in ("cuda", "cpu")]
    clock = {"t": 0.0}
    _lockstep_streamers(rs, clock)
    fb = np.zeros((rs[0].streamer.n_mats, rs[0].streamer.tail_off.shape[1]), np.int64)
    for m in range(fb.shape[0]):
        if rs[0].streamer.tail_mip[m] > 0:
            fb[m, 1] = 100                                   # mips 2 and 1: 20 tiles each
    for r_ in rs:
        for _ in range(3):
            r_.streamer.publish_feedback(fb.copy())
            r_.streamer.poll()
            r_.gpu = dataclasses.replace(
                r_.gpu, tex_stream=r_.streamer.apply_updates(r_.gpu.tex_stream),
                meta=r_.gpu.meta)
    paged = int((rs[0].gpu.tex_stream.page_table >= 0).sum())
    assert torch.equal(rs[0].gpu.tex_stream.page_table.cpu(), rs[1].gpu.tex_stream.page_table)
    for _ in range(3):
        lg = rs[0].render_frame().cpu().numpy()
        lc = rs[1].render_frame().numpy()
    for r_ in rs:
        r_.shutdown()
    diff = np.abs(lg.astype(np.int32) - lc.astype(np.int32)).max(-1)
    within = float(np.mean(diff <= 2))
    log(f"phase29 streamed path tracer stress:4 {W}x{H} x3 frames cuda vs cpu ({paged} pages "
        f"resident): {within * 100:.3f}% of LDR pixels within 2/255, mean |d| "
        f"{float(diff.mean()):.4f}, max {int(diff.max())} ({time.perf_counter() - t0:.1f} s on "
        f"{card} and the host)")
    assert paged > 0
    assert within >= 0.99, within


# ---- phases 30-32: the multi-GPU layer (parallel/) --------------------------
# The machine has one card. NCCL takes one GPU a rank, so it runs at world
# size 1; 2 and 4 ranks are gloo ranks that share cuda:0, and their times
# measure the ranks' contention for the card, not scaling.

SHARD_CONFIGS = ((1, "nccl"), (2, "gloo"), (4, "gloo"))   # phase 31: (ranks, backend)
SHARD_FRAMES = 8
SHARD_HOLD_FRAME = 2        # the frame whose K1-K4 calls rank 1 holds (GI traced)
SHARD_SYNC_FRAME = 3        # the frame whose host syncs are counted by stage
SHARD_LIFTED_FRAMES = 3     # frames with the straggler caps lifted (n = 2 against n = 1)
SHARD_INDIRECT_FRAMES = 3   # frames of each of the flagship's other indirect modes (n = 2)
HALOS = (1, 8, 32)


SKY_PT_LANES = 1920 * 1080 * 4      # pt.still's wavefront: 1080p at 4 samples a pixel
SKY_FN_A_STEP = 11     # full-precision functions a march step: 8 expf, powf, acosf, sqrtf
SFU_A_CLOCK = 132 * 16                # H100 SXM: 16 special-function results a clock an SM


def sky_bound(n, clock_mhz, masked=False):
    """(bound_ms, by) of the sky kernel on n lanes: its bytes (a direction
    in, a radiance out, a mask byte) over 3.35 TB/s against its 32 steps'
    full-precision functions, each at least one special-function result,
    at 132 x 16 a clock."""
    from hobbyrenderer_tpu_torch.ops.atmosphere import MARCH_STEPS
    tb = n * (24 + (1 if masked else 0)) / HBM_BYTES_PER_S * 1e3
    tf = n * MARCH_STEPS * SKY_FN_A_STEP / (SFU_A_CLOCK * clock_mhz * 1e6) * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "transcendentals")


def phase_sky_kernel(card, clock_mhz):
    """Phase 33: the sky's march (csrc/sky_march.cu) against its plain
    version on the card: pt.still's 8,294,400 lanes (the primary bounce,
    with the sun disk; and the same lanes under a mask keeping ~40%, as the
    path tracer passes its missed lanes), and sky_radiance_fast's 480x270
    grid of a 1080p direction image (every 4th pixel, a strided view, no
    disk). Mismatched lanes (any bit), the largest relative difference,
    and ms a call (CUDA events, median of 5) of the kernel and the plain
    march; a second launch must give the same bits."""
    from hobbyrenderer_tpu_torch.config import Config
    from hobbyrenderer_tpu_torch.ops import atmosphere as atm
    settings = Config().settings
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(33)
    sun = torch.tensor(settings.sun_direction, dtype=torch.float32, device=dev)
    img = torch.randn((1080, 1920, 3), generator=gen, device=dev)
    cases = [("pt 8294400 lanes, disk", torch.randn((SKY_PT_LANES, 3), generator=gen,
                                                    device=dev), True, None),
             ("sky_radiance_fast 480x270 grid", img[::4, ::4][:270, :480], False, None)]
    keep = torch.rand((SKY_PT_LANES,), generator=gen, device=dev) < 0.4
    cases.append(("pt 8294400 lanes, disk, ~40% masked", cases[0][1], True, keep))
    rows = {}
    for name, d, disk, mask in cases:
        def kernel():
            return atm.sky_radiance_lut(d, sun, settings, with_sun_disk=disk, mask=mask)

        def plain():
            return atm.sky_radiance_lut_reference(d, sun, settings, with_sun_disk=disk,
                                                  mask=mask)
        got, again, ref = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        mis = int((got != ref).any(-1).sum())
        rel = float(((got - ref).abs() / ref.abs().clamp(min=1e-30)).max())
        n = d.reshape(-1, 3).shape[0]
        lanes = n if mask is None else int(mask.sum())
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        bnd = sky_bound(n, clock_mhz, masked=mask is not None)
        log(f"phase33 sky kernel, {name} on {card}: mismatched lanes {mis} of {n} (marched "
            f"{lanes}), largest relative difference {rel:.3g}, two launches equal "
            f"{torch.equal(got, again)}; kernel {ms:.4f} ms, plain march {plain_ms:.2f} ms, "
            f"bound {bnd[0]:.4f} ms ({bnd[1]})")
        assert torch.equal(got, again), f"sky kernel {name}: two launches differ"
        assert mis == 0, f"sky kernel {name}: {mis} lanes differ from the plain march"
        if mask is not None:
            assert not got[~mask].any(), f"sky kernel {name}: a lane outside the mask is not 0"
        rows[name] = dict(lanes=n, marched=lanes, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
                          bound_by=bnd[1], mismatched=mis, max_rel_err=rel)
        del got, again, ref
    torch.cuda.empty_cache()
    return rows


def kernel_counters():
    """Each kernel's launch count: {name: (module, attribute)}."""
    from hobbyrenderer_tpu_torch.ops import beam as beamops
    from hobbyrenderer_tpu_torch.ops import bvh16 as b16ops
    from hobbyrenderer_tpu_torch.ops import raster_kernel as rk
    from hobbyrenderer_tpu_torch.ops import restir_kernel as rko
    from hobbyrenderer_tpu_torch.ops import trace_kernel as tk
    from hobbyrenderer_tpu_torch.ops import wkernels as wk
    return {"K1": (rk, "launches"), "K2": (rko, "launches"), "K3": (b16ops, "launches"),
            "K4": (beamops, "launches"), "K5": (rk, "tiles_launches"), "K6": (tk, "launches"),
            "K7": (wk, "leaf_launches"), "K8": (wk, "int_launches"), "K9": (wk, "hc_launches")}


def _read_counts(counters):
    return {k: getattr(m, a) for k, (m, a) in counters.items()}


def collective_checks(mesh):
    """Phase 30 on one rank: extend_rows (halos 1, 8, 32), all_gather_rows,
    psum_int (int and float32 counts) and sum_ordered on the rank's device,
    each held against the same call on CPU tensors of the same ranks (a
    gloo group beside the mesh's), and each one's ms on the card (20 calls
    back to back, synchronised). Under gloo also which collectives it takes
    on CUDA tensors."""
    import torch.distributed as dist
    from hobbyrenderer_tpu_torch.ops import shard_utils as shu
    from hobbyrenderer_tpu_torch.parallel.mesh import Mesh
    cpu = Mesh(mesh.rank, mesh.n, "cpu", "gloo", group=dist.new_group(backend="gloo"))
    h = 8
    rng = np.random.default_rng(30)
    full = rng.random((mesh.n * h, 1920, 3), dtype=np.float32)
    counts_ = rng.integers(0, 1 << 20, 256) * (mesh.rank + 1)
    got, fns = [], []
    for m in (mesh, cpu):
        x = torch.as_tensor(full[mesh.rank * h:(mesh.rank + 1) * h]).to(m.device)
        c = torch.as_tensor(counts_).to(m.device)
        sh = shu.make_row_shard(m, h)
        calls = {f"extend_rows halo {k}": (lambda k=k: shu.extend_rows(x, k, sh)) for k in HALOS}
        calls.update({"all_gather_rows": lambda: m.all_gather_rows(x),
                      "psum_int": lambda: m.psum_int(c),
                      "psum_int f32": lambda: m.psum_int(c.float()),
                      "sum_ordered": lambda: m.sum_ordered(x)})
        got.append({k: f().cpu() for k, f in calls.items()})
        fns.append(calls)
    equal = {k: torch.equal(got[0][k], got[1][k]) for k in got[1]}
    ms = {}
    for k, f in fns[0].items():
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            f()
        torch.cuda.synchronize()
        ms[k] = (time.perf_counter() - t0) / 20 * 1e3
    takes = None
    if mesh.backend == "gloo":
        y = torch.ones((4, 3), device=mesh.device)
        probes = {"all_gather (list)": lambda: dist.all_gather([torch.empty_like(y)] * mesh.n, y),
                  "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                      torch.empty((4 * mesh.n, 3), device=mesh.device), y),
                  "all_reduce": lambda: dist.all_reduce(y.clone()),
                  "broadcast": lambda: dist.broadcast(y.clone(), 0)}
        takes = {}
        for k, f in probes.items():
            try:
                f()
                takes[k] = "takes"
            except RuntimeError as e:
                takes[k] = f"refuses ({str(e)[:80]})"
    return dict(equal=equal, ms=ms, gloo_cuda=takes, stats=mesh.stats.as_dict())


@contextlib.contextmanager
def reference_deltas_lifted(fill=True, bloom=True):
    """Phase 31's comparison of the n-rank frame with the one-rank frame,
    with the two sharded-frame semantics of the JAX package that the port
    reproduces lifted, as the straggler caps are: with ``fill``
    extend_rows replicates the edge row past the frame's top and bottom
    (where the reference leaves ppermute's zeros, which the A-trous,
    spatial-reuse and TAA taps read), with ``bloom`` the banded bloom is
    bloom() on the gathered frame (where the reference's pyramid stops at
    the first odd band height). With both, what remains are the seams: the
    halos between bands, the per-band K4 ray tiles, the band raster and the
    global RNG keys. In this process only."""
    from hobbyrenderer_tpu_torch.ops import post, restir, taa, upsample, warp
    from hobbyrenderer_tpu_torch.ops import shard_utils as shu
    ext_orig, bloom_orig = shu.extend_rows, post.bloom_sharded
    users = (post, restir, taa, upsample, warp, shu)

    def extend_rows(x, halo, shard=None):
        ext = ext_orig(x, halo, shard)
        if shard is None or shard.n == 1 or halo == 0:
            return ext
        if shard.mesh.rank == 0:
            ext = torch.cat([x[:1].expand_as(ext[:halo]), ext[halo:]], 0)
        if shard.mesh.rank == shard.n - 1:
            ext = torch.cat([ext[:-halo], x[-1:].expand_as(ext[-halo:])], 0)
        return ext

    def bloom_sharded(hdr, settings, shard, full_h):
        y0 = shard.y0
        return post.bloom(shard.mesh.all_gather_rows(hdr), settings)[y0:y0 + hdr.shape[0]]
    for m in users if fill else ():
        m.extend_rows = extend_rows
    if bloom:
        post.bloom_sharded = bloom_sharded
    try:
        yield
    finally:
        for m in users:
            m.extend_rows = ext_orig
        post.bloom_sharded = bloom_orig


def sharded_rank(mesh, job):
    """Phases 30 and 31 on one rank: the collectives, then the sharded
    flagship (bench.py's configuration: stress, 1920 wide, traced specular,
    transparency): ``SHARD_FRAMES`` frames at the default caps, each
    frame's ms, K1-K4 launches, collectives and host syncs by stage (a
    gloo collective of CUDA tensors is one more host sync each), one more
    frame with the collectives timed alone; rank 1 holds frame
    SHARD_HOLD_FRAME's K1, K2, K3 and K4 calls against their plain versions
    and times its Raster call (K1 with the band's ty0); every rank keeps
    frame 1's Raster call's depth and visid. Then SHARD_LIFTED_FRAMES frames
    with the straggler caps lifted (their LDR frames), at n = 2 also with
    the reference's sharded-frame deltas lifted, both and each alone
    (reference_deltas_lifted);
    with ``csm`` one
    DeferredShardedRenderer(with_csm=True) frame, K5's atlas call held.
    Returns the numbers and the lines to print (a rank prints nothing)."""
    import warnings
    from hobbyrenderer_tpu_torch import bench_k2k4, bench_raster
    from hobbyrenderer_tpu_torch import bench_parallel as bp
    from hobbyrenderer_tpu_torch.ops import beam as beamops
    from hobbyrenderer_tpu_torch.ops import bvh16 as b16ops
    from hobbyrenderer_tpu_torch.ops import raster as rasterops
    from hobbyrenderer_tpu_torch.ops import raster_kernel as rk
    from hobbyrenderer_tpu_torch.ops import restir_kernel as rko
    from hobbyrenderer_tpu_torch.parallel import DeferredShardedRenderer
    lines = []
    out = {"lines": lines, "collectives": collective_checks(mesh)}
    W, H = job["width"], job["height"]
    t0 = time.perf_counter()
    fjob = dict(job, kind="flagship")
    r = bp.make_renderer(fjob, mesh.device)
    fr = bp.make_sharded(fjob, r, mesh)
    out["setup_s"] = time.perf_counter() - t0
    settings = r.config.settings
    counters = kernel_counters()

    cap = {"k1": [], "k3": [], "k4": []}
    hold = [False]
    first_raster = {}
    k1_orig, k2_orig = rk.raster_resolve_tiles, rko.restir_candidates
    k3_orig, k4_orig = b16ops.bvh16_walk, beamops.beam_any_hit_tiles
    ras_orig = rasterops.rasterize

    def k1_spy(records, work_tile, work_slot, **kw):
        if hold[0]:
            cap["k1"].append((records, work_tile, work_slot, kw))
        return k1_orig(records, work_tile, work_slot, **kw)

    def k2_spy(*a, **kw):
        if hold[0]:
            cap.setdefault("k2", (a, kw))
        return k2_orig(*a, **kw)

    def k3_spy(table, o, d, t_max, any_hit, max_steps, t_min=1e-4):
        if hold[0]:
            cap["k3"].append((table, o, d, t_max, any_hit, max_steps, t_min))
        return k3_orig(table, o, d, t_max, any_hit, max_steps, t_min)

    def k4_spy(btable, rays):
        if hold[0]:
            cap["k4"].append((btable, rays.clone()))
        return k4_orig(btable, rays)

    def ras_spy(*a, **kw):
        ro, attr = ras_orig(*a, **kw)
        if not first_raster:
            first_raster.update(depth=ro.depth.cpu().numpy(), visid=ro.visid.cpu().numpy())
        return ro, attr

    stage = ["outside"]
    syncs = {}

    @contextlib.contextmanager
    def named(name):
        stage[0] = name
        try:
            yield
        finally:
            stage[0] = "outside"

    def on_warning(message, *a, **kw):
        if "synchroniz" in str(message):
            syncs[stage[0]] = syncs.get(stage[0], 0) + 1

    fr.stage_hook = named
    if mesh.rank == 1:
        rk.raster_resolve_tiles, rko.restir_candidates = k1_spy, k2_spy
        b16ops.bvh16_walk, beamops.beam_any_hit_tiles = k3_spy, k4_spy
    rasterops.rasterize = ras_spy
    frame_ms, per_frame, coll, host_syncs = [], [], [], None
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = on_warning
            for i in range(SHARD_FRAMES + 1):
                timed = i == SHARD_FRAMES
                hold[0] = i == SHARD_HOLD_FRAME
                vc, vp = bp.view_constants(r, i)
                for m_, a_ in counters.values():
                    setattr(m_, a_, 0)
                mesh.stats.reset()
                mesh.timed = timed
                n0 = sum(syncs.values())
                # the host syncs counted on one frame (each also prints a line)
                torch.cuda.set_sync_debug_mode("warn" if i == SHARD_SYNC_FRAME else "default")
                f0 = time.perf_counter()
                ldr = fr.render(r.gpu, vc, settings, 1 / 60, vp)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - f0) * 1e3
                torch.cuda.set_sync_debug_mode("default")
                mesh.timed = False
                if timed:
                    out["collective_ms_timed"] = mesh.stats.ms
                    continue
                frame_ms.append(ms)
                per_frame.append(_read_counts(counters))
                coll.append(mesh.stats.as_dict())
                if i == SHARD_SYNC_FRAME:
                    host_syncs = sum(syncs.values()) - n0 + mesh.stats.host_syncs
                rasterops.rasterize = ras_orig
    finally:
        rk.raster_resolve_tiles, rko.restir_candidates = k1_orig, k2_orig
        b16ops.bvh16_walk, beamops.beam_any_hit_tiles = k3_orig, k4_orig
        rasterops.rasterize = ras_orig
    out.update(frame_ms=frame_ms, per_frame=per_frame, coll=coll, host_syncs=host_syncs,
               syncs_by_stage=dict(syncs), first_raster=first_raster,
               ldr_shape=tuple(ldr.shape), ldr_dtype=str(ldr.dtype))
    card = job["card"]
    if mesh.rank == 1:
        tag = f"phase31 n={mesh.n} rank 1 frame {SHARD_HOLD_FRAME + 1}"
        out["held"] = hold_captured(cap, bench_raster, bench_k2k4, card, tag, emit=lines.append)
        x = raster_check(bench_raster, True, *cap["k1"][0])
        out["k1_band"] = {k: x[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "items",
                                            "exact", "repeat_equal", "attr_max_err")}
        out["k1_band"]["ty0"] = cap["k1"][0][3]["ty0"]
        out["k2_y0"] = cap["k2"][0][5]
        lines.append(f"{tag} Raster call (K1, ty0 {out['k1_band']['ty0']}): {x['line']}")
    del cap

    # the caps lifted: every straggler traced, uncapped (n = 1 and 2 compared)
    def lifted_frames():
        fl = bp.make_sharded(dict(fjob, straggler_steps=None), r, mesh)
        ldrs = []
        for i in range(SHARD_LIFTED_FRAMES):
            vc, vp = bp.view_constants(r, i)
            ldr = fl.render(r.gpu, vc, settings, 1 / 60, vp)
            if mesh.rank == 0:
                ldrs.append(ldr.cpu().numpy())
        return ldrs
    out["lifted"] = lifted_frames() if mesh.n <= 2 else []
    if mesh.n == 2:
        for key, fill, bloom in (("lifted_seams", True, True), ("lifted_fill", True, False),
                                 ("lifted_bloom", False, True)):
            with reference_deltas_lifted(fill, bloom):
                out[key] = lifted_frames()

    # the flagship's other indirect modes (ROADMAP item 10's last bands)
    for mode in job.get("indirects", ()):
        fi = bp.make_sharded(dict(fjob, indirect=mode), r, mesh)
        ms = []
        for i in range(SHARD_INDIRECT_FRAMES):
            vc, vp = bp.view_constants(r, i)
            f0 = time.perf_counter()
            ldr = fi.render(r.gpu, vc, settings, 1 / 60, vp)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - f0) * 1e3)
        x = dict(ms=ms, finite=bool(torch.isfinite(fi.state["taa_history"]).all()),
                 ldr_std=float(ldr.float().std()))
        if mode == "sharc":
            x["cache"] = fi.state["sharc_cache"]
        out.setdefault("indirects", {})[mode] = x
        del fi

    if job.get("csm"):
        ds = DeferredShardedRenderer(r.gpu, W, H, mesh=mesh, with_csm=True)
        k5 = []
        k5_orig = rk.raster_tiles

        def k5_spy(records, work_tile, work_slot, **kw):
            k5.append((records, work_tile, work_slot, kw))
            return k5_orig(records, work_tile, work_slot, **kw)
        for m_, a_ in counters.values():
            setattr(m_, a_, 0)
        rk.raster_tiles = k5_spy
        try:
            vc, vp = bp.view_constants(r, 0)
            ldr = ds.render(r.gpu, vc, settings)
            torch.cuda.synchronize()
        finally:
            rk.raster_tiles = k5_orig
        out["csm_launches"] = _read_counts(counters)
        out["csm_ldr_ok"] = tuple(ldr.shape) == (H, W, 3)
        if mesh.rank == 0:
            records, wt, ws, kw = k5[0]
            kw = dict(kw)
            x = raster_check(bench_raster, False, records, wt, ws, kw, kw.pop("depth_only"))
            out["k5"] = {k: x[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "items",
                                           "exact", "repeat_equal", "attr_max_err")}
            out["k5"]["ty0"] = kw.get("ty0", 0)
            lines.append(f"phase31 n={mesh.n} DeferredShardedRenderer(with_csm=True) K5 atlas "
                         f"call: {x['line']}")
    r.shutdown()
    return out


def phase_sharded_flagship(card, scene="stress", width=1920, height=1080):
    """Phases 30 and 31 (sharded_rank) at n = 1 (NCCL), 2 and 4 (gloo ranks
    sharing cuda:0): 1920 x 1088, 1088 and 1152 rows. Holds: the collectives
    equal on the card and on CPU tensors; rank 1's K1-K4 calls (ty0 = 17 at
    n = 2) bit-exact, three launches equal (inside the rank); rank 1's Raster
    depth and visid at n = 2 equal to rows 544-1087 of the n = 1 frame's;
    the n = 2 LDR frames with the caps lifted >= 99% within 2/255 of the
    n = 1 frames; K1-K4 launched every frame on every rank; K5's atlas call
    bit-exact."""
    from hobbyrenderer_tpu_torch import bench_parallel as bp
    from hobbyrenderer_tpu_torch.parallel.launch import run_ranks
    res, size = {}, {}
    for n, backend in SHARD_CONFIGS:
        H = size[n] = bp.sharded_height(height, n)
        job = dict(scene=scene, width=width, height=H, frames=SHARD_FRAMES, csm=n == 2,
                   card=card, indirects=("ssgi", "sharc", "ddgi") if n == 2 else ())
        t0 = time.perf_counter()
        ranks = run_ranks(sharded_rank, n, backend=backend, devices=["cuda:0"] * n, args=(job,),
                          deadline_s=900)
        wall = time.perf_counter() - t0
        res[n] = ranks
        c0 = ranks[0]["collectives"]
        log(f"phase30 n={n} {backend} on cuda:0 ({'one rank' if n == 1 else f'{n} ranks sharing '
            'one card'}) on {card}: equal to the same calls on CPU tensors {c0['equal']}; ms a "
            f"call on the card {json.dumps({k: round(v, 4) for k, v in c0['ms'].items()})}"
            + (f"; gloo on CUDA tensors: {c0['gloo_cuda']}" if c0["gloo_cuda"] else ""))
        for rank, x in enumerate(ranks):
            for ln in x["lines"]:
                log(ln)
            med = statistics.median(x["frame_ms"][1:])
            log(f"phase31 sharded flagship {scene} {width}x{H} n={n} {backend} rank {rank} "
                f"({'one rank on' if n == 1 else f'{n} ranks sharing'} {card}): setup "
                f"{x['setup_s']:.1f} s, frame ms {[round(v, 2) for v in x['frame_ms']]}, median "
                f"frames 2-{SHARD_FRAMES} {med:.2f} ms; collectives a frame {x['coll'][-1]}, "
                f"their ms (one frame timed alone) {x['collective_ms_timed']:.3f}; host syncs "
                f"in frame {SHARD_SYNC_FRAME + 1} {x['host_syncs']} (by stage "
                f"{x['syncs_by_stage']}, plus {x['coll'][-1]['host_syncs']} gloo collectives "
                f"of CUDA tensors); K1-K4 launches "
                f"a frame {[{k: c[k] for k in ('K1', 'K2', 'K3', 'K4')} for c in x['per_frame']]}"
                f"; run wall {wall:.1f} s")
            assert all(c0["equal"].values()) and all(x["collectives"]["equal"].values()), \
                x["collectives"]["equal"]
            assert x["ldr_shape"] == (H, width, 3) and x["ldr_dtype"] == "torch.uint8"
            for i, c in enumerate(x["per_frame"]):
                assert c["K1"] >= 2 and c["K2"] >= 1 and c["K3"] >= 2 and c["K4"] >= 2, \
                    (n, rank, i, c)
    r1, h = res[2][1], size[2] // 2
    assert r1["k1_band"]["ty0"] == h // 32 and r1["k2_y0"] == h, (r1["k1_band"], r1["k2_y0"])
    full = res[1][0]["first_raster"]
    rows_eq = {k: bool(np.array_equal(r1["first_raster"][k], full[k][h:2 * h]))
               for k in ("depth", "visid")}
    log(f"phase31 rank 1 of 2 (ty0 {h // 32}, y0 {h}): its Raster call's depth and visid equal "
        f"rows {h}-{2 * h - 1} of the one rank frame's: {rows_eq}")
    assert all(rows_eq.values()), rows_eq
    k5 = res[2][0]["k5"]
    assert k5["exact"] and k5["repeat_equal"], k5
    assert all(x["csm_launches"]["K5"] >= 1 and x["csm_ldr_ok"] for x in res[2]), \
        [x["csm_launches"] for x in res[2]]
    ind = {m: [x["indirects"][m] for x in res[2]] for m in ("ssgi", "sharc", "ddgi")}
    caches_equal = all(np.array_equal(a, b) for a, b in zip(*[x["cache"] for x in ind["sharc"]]))
    log(f"phase32 the flagship's other indirect modes, {width}x{size[2]}, 2 ranks sharing {card}, "
        f"{SHARD_INDIRECT_FRAMES} frames each: frame ms per rank "
        f"{ {m: [[round(v, 2) for v in x['ms']] for x in xs] for m, xs in ind.items()} }, HDR "
        f"finite {[x['finite'] for xs in ind.values() for x in xs]}, LDR std "
        f"{ {m: [round(x['ldr_std'], 2) for x in xs] for m, xs in ind.items()} }; the SHARC "
        f"caches of the two ranks equal: {caches_equal} "
        f"({int((ind['sharc'][0]['cache'].key != 0).sum())} occupied slots)")
    assert all(x["finite"] and x["ldr_std"] > 1.0 for xs in ind.values() for x in xs), ind
    assert caches_equal and (ind["sharc"][0]["cache"].key != 0).any()
    def against_one_rank(key):
        within = []
        for a, b in zip(res[1][0]["lifted"], res[2][0][key]):
            d = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
            bad_rows = np.nonzero((d > 2).any(1))[0]
            within.append((float(np.mean(d <= 2)), int(d.max()), float(d.mean()),
                           [int(bad_rows[0]), int(bad_rows[-1])] if len(bad_rows) else None))
        return within
    ref = against_one_rank("lifted")
    log(f"phase31 caps lifted, n=2 against n=1, {width}x{size[2]}, frames "
        f"1-{SHARD_LIFTED_FRAMES}, the reference's sharded semantics (zero halo rows past the "
        f"frame, the band-limited bloom pyramid): share of LDR pixels within 2/255, max |d|, "
        f"mean |d|, first and last row off by more {ref}; below 99% on "
        f"{sum(w[0] < 0.99 for w in ref)} of {len(ref)} frames: measured, not gated (a held "
        f"reference delta, ROADMAP Queue 3)")
    log(f"phase31 caps lifted, n=2 against n=1, frames 1-{SHARD_LIFTED_FRAMES}, one reference "
        f"delta lifted: edge rows past the frame (the bloom pyramid remains) "
        f"{against_one_rank('lifted_fill')}; bloom() on the gathered frame (the zero rows "
        f"remain) {against_one_rank('lifted_bloom')}")
    seams = against_one_rank("lifted_seams")
    log(f"phase31 caps lifted, n=2 against n=1, frames 1-{SHARD_LIFTED_FRAMES}, with the "
        f"reference's two sharded-frame deltas also lifted (edge rows past the frame, bloom() "
        f"on the gathered frame; the seams remain): {seams} (gate >= 99%)")
    assert all(w[0] >= 0.99 for w in seams), seams
    return res


def pt_rank(mesh, job):
    """Phase 32: PathTracerShardedRenderer at job's size, ``calls`` calls:
    each call's accumulation and ms."""
    from hobbyrenderer_tpu_torch import bench_parallel as bp
    r = bp.make_renderer(dict(job, kind="pt"), mesh.device)
    pr = bp.make_sharded(dict(job, kind="pt"), r, mesh)
    vc, vp = bp.view_constants(r, 0)
    accum, ms = [], []
    for _ in range(job["calls"]):
        f0 = time.perf_counter()
        pr.render(r.gpu, vc, r.config.settings, 1 / 60, vp)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - f0) * 1e3)
        accum.append(pr.accum.cpu().numpy())
    r.shutdown()
    return dict(accum=accum, ms=ms)


def small_rank(mesh, job):
    """Phase 32 at 256x192 on CUDA or CPU ranks: the sharded flagship's and
    the sharded path tracer's LDR frames, and the streamed flagship's first
    feedback."""
    from hobbyrenderer_tpu_torch import bench_parallel as bp
    if mesh.device.type == "cpu":     # the host's cores, shared by the CPU ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // mesh.n))
    out = {}
    for kind in ("flagship", "pt"):
        j = dict(job, kind=kind)
        r = bp.make_renderer(j, mesh.device)
        sr = bp.make_sharded(j, r, mesh)
        ldr = []
        for i in range(job["frames"]):
            vc, vp = bp.view_constants(r, i)
            ldr.append(sr.render(r.gpu, vc, r.config.settings, 1 / 60, vp).cpu().numpy())
        out[kind] = ldr
        r.shutdown()
    if mesh.device.type == "cuda":
        j = dict(job, kind="flagship", tex_streaming=True)
        r = bp.make_renderer(j, mesh.device)
        sr = bp.make_sharded(j, r, mesh)
        vc, vp = bp.view_constants(r, 0)
        sr.render(r.gpu, vc, r.config.settings, 1 / 60, vp)
        out["feedback"] = sr.last_tex_feedback.cpu().numpy()
        r.shutdown()
    return out


def phase_sharded_rest(card):
    """Phase 32: the sample-parallel path tracer at bench.py's size (960x540,
    2 gloo ranks sharing cuda:0, 2 calls), each call's accumulation equal
    bit for bit to this process's single-device path tracer at 2 samples a
    frame (trace_paths(spp=2)); the streamed flagship's feedback summed over
    2 ranks equal to the whole frame's; and at 256x192 on stress:4, 2 CUDA
    ranks against 2 CPU ranks: the sharded flagship >= 99% of LDR pixels
    within 2/255, the sharded path tracer under phase 17's gate (>= 99%)."""
    from hobbyrenderer_tpu_torch import bench_parallel as bp
    from hobbyrenderer_tpu_torch.config import Config
    from hobbyrenderer_tpu_torch.ops import culling as cullops
    from hobbyrenderer_tpu_torch.ops import raster as rasterops
    from hobbyrenderer_tpu_torch.parallel.launch import run_ranks
    from hobbyrenderer_tpu_torch.renderer import Renderer
    W, H, calls = 960, 540, 2
    job = dict(scene="stress", width=W, height=H, calls=calls)
    t0 = time.perf_counter()
    ranks = run_ranks(pt_rank, 2, backend="gloo", devices=["cuda:0"] * 2, args=(job,),
                      deadline_s=600)
    r = Renderer(Config(scene="stress", width=W, height=H, mode="path_tracer", pt_spp=2,
                        cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke_pt_spp2")),
                 device="cuda")
    vc, vp = bp.view_constants(r, 0)
    equal = []
    for c in range(calls):
        r._model.render(r.gpu, vc, r.config.settings, 1 / 60, vp)
        ref = r._model.accum.cpu().numpy()
        equal.append([bool(np.array_equal(x["accum"][c], ref)) for x in ranks])
    r.shutdown()
    call_ms = [max(x["ms"][c] for x in ranks) for c in range(calls)]
    msamples = [2 * W * H / ms / 1e3 for ms in call_ms]
    log(f"phase32 sharded path tracer stress {W}x{H}, 2 gloo ranks sharing {card} (their "
        f"contention, not scaling), {calls} calls: accumulation equal to the single-device "
        f"spp=2 path tracer's {equal}; call ms per rank {[x['ms'] for x in ranks]}, Msamples/s "
        f"over both ranks {[round(v, 3) for v in msamples]} ({time.perf_counter() - t0:.1f} s)")
    assert all(all(e) for e in equal), equal

    small = dict(scene="stress:4", width=256, height=192, frames=3)
    t0 = time.perf_counter()
    cu = run_ranks(small_rank, 2, backend="gloo", devices=["cuda:0"] * 2, args=(small,),
                   deadline_s=600)
    t1 = time.perf_counter()
    cp = run_ranks(small_rank, 2, backend="gloo", devices=["cpu"] * 2, args=(small,),
                   deadline_s=600)
    t2 = time.perf_counter()
    rs = Renderer(Config(scene="stress:4", width=256, height=192, tex_streaming=True,
                         direct_mode="restir", indirect_mode="restir",
                         cache_dir=os.path.join(tempfile.gettempdir(), "hr_smoke_fb")),
                  device="cuda")
    vc, _ = bp.view_constants(rs, 0)
    cull = cullops.cull_pairs(rs.gpu, vc, alpha_mask=(True, True, False))
    slots, _ = cullops.compact_mask(cull["mask"], max(int(rs.gpu.lod0_pair_capacity), 1))
    ro, attr = rasterops.rasterize(rs.gpu, vc, slots, 256, 192)
    fb1 = rasterops.resolve_gbuffer(rs.gpu, vc, ro, attr, want_feedback=True)[1].cpu().numpy()
    rs.shutdown()
    fb_eq = bool(np.array_equal(cu[0]["feedback"], fb1)) and bool(
        np.array_equal(cu[1]["feedback"], fb1))
    res = {}
    for kind in ("flagship", "pt"):
        d = [np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
             for a, b in zip(cu[0][kind], cp[0][kind])]
        res[kind] = [(float(np.mean(x <= 2)), int(x.max())) for x in d]
    log(f"phase32 streamed flagship stress:4 256x192: the feedback summed over 2 ranks equals the "
        f"whole frame's: {fb_eq} ({int(fb1.sum())} samples); 2 CUDA ranks against 2 CPU ranks, "
        f"share of LDR pixels within 2/255 and max |d| per frame: flagship {res['flagship']}, "
        f"path tracer {res['pt']} (CUDA ranks {t1 - t0:.1f} s, CPU ranks {t2 - t1:.1f} s)")
    assert fb_eq and fb1.sum() > 0
    assert all(w >= 0.99 for w, _ in res["flagship"] + res["pt"]), res
    return dict(msamples=msamples, call_ms=call_ms)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from hobbyrenderer_tpu_torch import bench_k2k4
    from hobbyrenderer_tpu_torch import bench_k3
    from hobbyrenderer_tpu_torch import bench_k6
    from hobbyrenderer_tpu_torch import bench_raster
    from hobbyrenderer_tpu_torch import bench_wkernels as bw
    from hobbyrenderer_tpu_torch import kernels
    from hobbyrenderer_tpu_torch.config import Config
    from hobbyrenderer_tpu_torch.ops import beam as beamops
    from hobbyrenderer_tpu_torch.ops import bvh16 as b16ops
    from hobbyrenderer_tpu_torch.ops import raster_kernel as rk
    from hobbyrenderer_tpu_torch.ops import restir_kernel as rko
    from hobbyrenderer_tpu_torch.ops import sky as skyops
    from hobbyrenderer_tpu_torch.ops import trace as traceops
    from hobbyrenderer_tpu_torch.ops import trace_kernel as tk
    from hobbyrenderer_tpu_torch.ops import wkernels as wk
    from hobbyrenderer_tpu_torch.profile_frame import median_ms, time_passes
    from hobbyrenderer_tpu_torch.renderer import Renderer
    t_start = time.perf_counter()
    late_failures = []
    # each kernel's launch count: (module, attribute)
    counters = kernel_counters()

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
    clock_mhz = bench_k2k4.card_line()[1]
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    kernels.library()
    log(f"phase1 build: kernels built+loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kernels.build_seconds if kernels.build_seconds is not None else 'cached'} s)")
    # -Xptxas -v: each kernel's registers, static shared memory and spills (K3's
    # top-level rows are dynamic shared memory: phase 7 prints their bytes)
    ptxas = [p for p in os.listdir(kernels.BUILD_DIR) if p.endswith(".ptxas.txt")]
    for p in ptxas:
        with open(os.path.join(kernels.BUILD_DIR, p)) as f:
            for line in f:
                if "Compiling entry function" in line:
                    name = line.split("'")[1]
                    log("  ptxas: " + next((k + name[name.index(k) + len(k):][:8]
                                            for k in PTXAS_KERNELS if k in name), name))
                elif "registers" in line or "spill" in line:
                    log("  ptxas:   " + line.strip())

    # ---- phase 33: the sky's march against its plain version ----------------
    sky = phase_sky_kernel(smi.stdout.strip().splitlines()[0], clock_mhz)

    # ---- capture the first 1080p stress frame's kernel inputs ---------------
    t0 = time.perf_counter()
    seen = capture_first_frame(Renderer, Config, rk, beamops)
    log(f"captured first 1080p stress frame in {time.perf_counter() - t0:.1f} s")

    # ---- phase 2: K1 against its plain version ------------------------------
    # every K1 call of the first frame: depth and visid equal to the plain
    # version, three launches equal; the Raster call's time is K1's
    k1_rows = []
    for i, (records, work_tile, work_slot, kw) in enumerate(seen["k1"]):
        x = raster_check(bench_raster, True, records, work_tile, work_slot, kw)
        k1_rows.append(x)
        log(f"phase2 K1 call {i} tiles={kw['tiles']} records={tuple(records.shape)}: "
            f"{x['line']}")
        assert x["exact"], f"K1 call {i}: depth or visid differs from its plain version"
        assert x["repeat_equal"], f"K1 call {i}: three launches gave different outputs"
        assert x["plan_equal"], f"K1 call {i}: the kernels' plan differs from split_units"
        assert x["attr_max_err"] <= 1e-4, x["attr_max_err"]
    k1_first = k1_rows[0]
    n_pix = k1_first["pixels"]
    assert k1_first["drawn"] > n_pix // 2, "first frame drew too little"
    attr_err = max(x["attr_max_err"] for x in k1_rows)
    k1_ms, k1_plain_ms = k1_first["ms"], k1_first["plain_ms"]
    k1_bound = (k1_first["bound_ms"], k1_first["bound_by"])

    # ---- phase 3: K4 against its plain version, every captured call -------
    # the first simple frame's SunShadow call and the first flagship frame's
    # RTXDI (two) and RTXDIGI calls: occlusion against the plain version on
    # the active lanes (the allowance: 1e-4 of them) and against the
    # kernel's walk replayed in plain PyTorch (every lane), three launches
    # equal; bound and work from bench_k2k4.held_k4
    k4_calls = dict(SunShadow=seen["k4"])
    k4_calls.update(bench_k2k4.capture(Renderer, Config, frames=("flagship",))[0])
    k4_rows = {}
    for name, (btable, rays) in k4_calls.items():
        x, line = bench_k2k4.held_k4(btable, rays)
        x["ms"] = cuda_ms(lambda: beamops.beam_any_hit_tiles(btable, rays))
        k4_rows[name] = x
        log(f"phase3 K4 {name} rays={tuple(rays.shape)} btable={tuple(btable.shape)}: {line}; "
            f"kernel {x['ms']:.4f} ms")
        assert x["active"] > 0, name
        assert x["mismatches"] <= 1e-4 * x["active"], (name, x["mismatches"])
        assert x["replay_mismatches"] == 0, (name, x["replay_mismatches"])
        assert x["repeat_equal"], f"three K4 launches on {name} gave different outputs"
        assert x["ovf_nonzero"] == 0, name
    k4_main = k4_rows["SunShadow"]
    k4_err = max(x["max_abs_err"] for x in k4_rows.values())
    del k4_calls

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
    got3 = [rko.restir_candidates(*a, **kw) for _ in range(3)]
    ref = rko.restir_candidates_reference(*a, **kw)
    torch.cuda.synchronize()
    got = got3[0]
    k2_repeat = all(torch.equal(x, y) for g in got3[1:] for x, y in zip(got, g))
    del got3
    flat3, tsel, planes = a[0], a[1], a[2]
    y_same = got[0] == ref[0]
    id_share = float(y_same.float().mean())
    w_rel = float(((got[3] - ref[3]).abs() / ref[3].abs().clamp(min=1e-30))[y_same].max())
    k2_err = max(float((g - r_).abs().max()) for g, r_ in zip(got, ref))   # y/u/v/w_sum/row
    k2_ms = cuda_ms(lambda: rko.restir_candidates(*a, **kw))
    k2_plain_ms = cuda_ms(lambda: rko.restir_candidates_reference(*a, **kw), reps=3)
    Hp, Wp = planes.shape[1:]
    n_cand = kw["num_candidates"]
    k2_bound = bench_k2k4.k2_bound(a, got, n_cand)[:2]
    # the issue-rate estimate: the kernel's SASS instructions over the
    # card's 132 x 4 warp schedulers at its maximum SM clock
    k2_sass = bench_k2k4.sass_counts(kernels.library()._name)
    k2_issue_ms = bench_k2k4.k2_issue(k2_sass, Hp * Wp, n_cand, clock_mhz)[0]
    assert k2_issue_ms is not None, f"K2's SASS gave no candidate loop: {k2_sass}"
    drawn = float((ref[0] >= 0).float().mean())
    log(f"phase6 K2 planes={tuple(planes.shape)} tiles={tuple(flat3.shape)} "
        f"candidates={n_cand}: id agreement {id_share:.6f}, w_sum max rel err {w_rel:.3g} "
        f"where ids agree, max|d| all outputs {k2_err:.3g}, three launches equal {k2_repeat}, "
        f"pixels with a winner {drawn:.3f}; SASS {json.dumps(k2_sass)}; kernel {k2_ms:.3f} ms, "
        f"plain {k2_plain_ms:.3f} ms, bound {k2_bound[0]:.4f} ms ({k2_bound[1]}), issue-rate "
        f"estimate {k2_issue_ms:.4f} ms at {clock_mhz} MHz")
    assert id_share >= 0.999, id_share
    assert w_rel <= 1e-5, w_rel
    assert k2_err == 0.0, "K2 is not bit-exact with its plain version"
    assert k2_repeat, "three K2 launches gave different outputs"
    assert drawn > 0.3, drawn

    # ---- phase 7: K3 against its plain version ------------------------------
    # the captured any-hit walks (stragglers, reduced-rate mismatches) and 64k
    # closest-hit rays from G-buffer points, cosine-distributed about the normal
    walks = [(f"any[{i}]", c) for i, c in enumerate(cap["k3"])]
    walks.append(("closest64k", (table16, *bench_k3.gbuffer_rays(gb), False,
                                 b16ops.UNCAPPED_STEPS, 1e-4)))
    k3_rows = []
    for name, walk in walks:
        tab, o, d, tm, any_hit, steps, t_min = walk
        x = k3_check(walk)
        bt, btri, bs = x["out"]
        pt, ptri, ps = x["ref"]
        hit = ptri >= 0
        occ_mis = int((((btri >= 0) & (bt < tm)) != (hit & (pt < tm))).sum())
        capped = float(((ps >= steps) & ~hit).float().mean())
        k3_rows.append(dict(name=name, rays=o.shape[0], ms=x["ms"], plain_ms=x["plain_ms"],
                            bound=x["bound"], err=x["err"], gsteps=x["gsteps"]))
        log(f"phase7 K3 {name} rays={o.shape[0]} any_hit={any_hit} max_steps={steps}: "
            f"tri mismatch {x['mis']['tri']}, t mismatch {x['mis']['t']}, occlusion mismatch "
            f"{occ_mis}, steps mismatch {x['mis']['steps']}, three launches equal "
            f"{x['repeat_equal']}, hit share {float(hit.float().mean()):.3f}, capped share "
            f"{capped:.4f}, mean steps {x['steps'] / o.shape[0]:.2f}, rows read {x['rows']} of "
            f"{tab.shape[0]}; {x['plan']}; kernel {x['ms']:.4f} ms ({x['gsteps']:.2f} G "
            f"ray-steps/s), plain {x['plain_ms']:.3f} ms, bound {x['bound'][0]:.4f} ms "
            f"({x['bound'][1]})")
        assert not any(x["mis"].values()) and occ_mis == 0, \
            f"K3 {name} is not bit-exact with its plain version"
        assert x["repeat_equal"], f"three K3 launches on {name} gave different outputs"
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
    assert kw5.pop("depth_only"), "the atlas call is depth only"
    tiles5 = kw5["tiles"]
    log(f"captured first 1080p stress NormalBasic frame in {time.perf_counter() - t0:.1f} s")
    k5_runs = {}
    for depth_only in (True, False):
        x = raster_check(bench_raster, False, records5, wt5, ws5, kw5, depth_only)
        k5_runs[depth_only] = x
        log(f"phase10 K5 depth_only={depth_only} tiles={tiles5} records={tuple(records5.shape)}: "
            f"{x['line']}, covered texels {x['drawn'] / x['pixels']:.3f}")
        assert x["exact"], "K5 is not bit-exact with its plain version"
        assert x["repeat_equal"], "three K5 launches gave different outputs"
        assert x["plan_equal"], "K5's plan differs from split_units"
        assert depth_only or x["drawn"] > 0
    k5_main = k5_runs[True]
    del records5, wt5, ws5

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
        runs6 = [tk.closest_hit_blocks(btab, rays6, t_min) for _ in range(3)]
        got = runs6[0]
        work6 = {}
        tk.closest_hit_blocks(btab, rays6, t_min, work=work6)
        repeat6 = all(torch.equal(a, b) for run in runs6[1:] for a, b in zip(got, run))
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
        bnd = bench_k6.k6_bound(btab, rays6, got, st6, work6)[:2]
        bnd_all = bench_k6.k6_bound(btab, rays6, got, st6)[0]
        C6 = tk.CLUSTER
        k6_rows.append(dict(name=name, blocks=T6, lanes=int(act.sum()), ms=ms, plain_ms=pms,
                            k3_ms=ms3, bound=bnd, err=max(float((g - x).abs().max())
                                                          for g, x in zip(got[:5], ref[:5])),
                            ovf_blocks=n_ovf6, cluster=C6, repeat_equal=repeat6,
                            bound_all_tests=bnd_all, work=work6))
        log(f"phase13 K6 {name} blocks={T6} active lanes={int(act.sum())}: cluster {C6} "
            f"(grid {T6 * C6} CTAs of {tk.PIX // C6} threads; the card holds "
            f"{tk.max_clusters()} such clusters at once); mismatches vs plain "
            f"(t, tri, u, v, front, ovf) {mism}; three launches equal {repeat6}; levels "
            f"{st6['levels']}, slowest block {st6['max_block_rows']} rows "
            f"({st6['max_block_leaf_rows']} leaf); overflowed blocks {n_ovf6}/{T6} "
            f"({n_ovf6 / T6:.3f}); rows read {st6['rows']} (leaf {st6['leaf_rows']}); hit share "
            f"K6 {float((tri6 >= 0).float().mean()):.4f} "
            f"K3 {float((btri3 >= 0).float().mean()):.4f}; K6 vs K3 ({steps3} steps) on {n_clean} lanes outside overflowed blocks and "
            f"K3-capped lanes: tri agree {int((clean & agree).sum())}, t ties "
            f"{int((clean & ties).sum())}, other {bad}; K3-capped lanes {int(capped3.sum())}; "
            f"hits K6 missed in overflowed blocks {missed}; kernel {ms:.3f} ms, K3 {ms3:.3f} ms, "
            f"plain {pms:.1f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}; on the {work6['record_tests']} "
            f"lane record tests run, {work6['records_culled']} skipped by the warp cull; "
            f"{bnd_all:.4f} ms counting every leaf-lane record test)")
        assert all(m == 0 for m in mism), f"K6 {name} is not bit-exact with its plain version"
        assert repeat6, f"K6 {name}: three launches differ"
        assert work6["record_tests"] + work6["records_culled"] == 4 * st6["leaf_lane_rows"], \
            (work6, st6["leaf_lane_rows"])
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
    events = time_passes(r.graph, strict=("RTXDI", "Denoise"))
    reset_counts()
    frame_fl, stats_fl, per_frame, traced = [], [], [], []
    for _ in range(n_frames):
        c0 = counts()
        f0 = time.perf_counter()
        traced.append(traced_frame(r.render_frame))
        torch.cuda.synchronize()
        frame_fl.append((time.perf_counter() - f0) * 1e3)
        stats_fl.append(r.stats())
        per_frame.append({k: v - c0[k] for k, v in counts().items()})
    syncs = span_syncs(traced, ("RTXDIGI", "SpecularIndirect"))
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

    # ---- phase 20: the IBL + ReSTIR DI (ReGIR onion) + combined main path --
    # the first frame's K2 call (phase 21) and the second frame's SHARC
    # update (phase 22) are captured on the way
    ib = phase_ibl_combined(Renderer, Config, reset_counts, counts, time_passes, median_ms,
                            rko, smi.stdout.strip().splitlines()[0], n_frames)
    launches_ib = ib["launches"]

    # ---- phase 21: K2 on the ReGIR cell table (T = 1,080) ------------------
    k2_regir = phase_k2_regir(ib["k2"], rko, bench_k2k4)

    # ---- phase 22: SHARC's update on the card: the same bits twice, the CPU
    phase_sharc_update(ib["sharc_update"])
    del ib

    # ---- phase 23: the new configurations, CUDA against CPU at 256x192 ----
    phase_new_configs_cuda_vs_cpu(Renderer, Config)

    # ---- phases 16-19: the step microbenchmarks K7-K9, the path tracer -----
    launches_wk, wk_rows = phase_wkernels(reset_counts, counts)
    phase_pt_cuda_vs_cpu(Renderer, Config)
    pt = phase_pt_main(Renderer, Config, reset_counts, counts)
    launches_pt = pt["launches"]
    phase_golden(Renderer, Config)

    # phases 24-26 come last: their torch.profiler traces must not precede
    # phase 16's, which read kernel times from traces of their own
    # ---- phase 24: env lights + animated scene, the flagship at 1080p ------
    card = smi.stdout.strip().splitlines()[0]
    env_path = write_sky()
    ea = phase_env_anim(Renderer, Config, reset_counts, counts, time_passes, median_ms, card,
                        env_path, n_frames)
    launches_ea = ea["launches"]
    ea_k = phase_env_anim_kernels(ea.pop("cap"), bench_k2k4, card)

    # ---- phase 25: TAA upscaling at full width ----------------------------
    tu = phase_taau(Renderer, Config, counts, time_passes, median_ms, card, env_path, n_frames,
                    ea["ms"], bench_raster)

    # ---- phase 26: this slice's configurations, CUDA against CPU ----------
    phase_env_anim_cuda_vs_cpu(Renderer, Config, env_path, card)

    # ---- phase 27: the streamed flagship at 1080p, the plain one in turns --
    sf = phase_streamed_flagship(Renderer, Config, reset_counts, counts, time_passes,
                                 median_ms, card, bench_raster, bench_k2k4)
    launches_sf = sf["launches"]

    # ---- phase 28: the debug views and overlays at 1080p ------------------
    dvs = phase_debug_views(Renderer, Config, reset_counts, counts, card)

    # ---- phase 29: streaming and the views, CUDA against CPU --------------
    phase_streaming_cuda_vs_cpu(Renderer, Config, card)

    # ---- phases 30-32: the multi-GPU layer, ranks sharing this card --------
    sharded = phase_sharded_flagship(card)
    pt_sharded = phase_sharded_rest(card)

    def sharded_launches(key):
        """Each rank's launches over phase 31's frames, by world size (and
        the with_csm frame's at n = 2)."""
        out = {f"n{n}": [sum(c[key] for c in x["per_frame"]) for x in sharded[n]]
               for n, _ in SHARD_CONFIGS}
        out["n2_deferred_with_csm"] = [x["csm_launches"][key] for x in sharded[2]]
        return out

    assert not late_failures, late_failures
    jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    assert not jax_mods, f"the port loaded jax: {jax_mods[:5]}"
    ref_mods = sorted(m for m in sys.modules
                      if m == "hobbyrenderer_tpu" or m.startswith("hobbyrenderer_tpu."))
    assert not ref_mods, f"the port loaded the JAX package: {ref_mods[:5]}"

    def entry(name, source, replaces, key, err, ms, plain_ms, bnd, main=None, library_ms=None,
              **extra):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=(main or launches_fl)[key], max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=library_ms,
                    launches_simple_path=launches[key], launches_restir_path=launches_rx[key],
                    launches_normal_basic=launches_nb[key],
                    launches_flagship_path=launches_fl[key],
                    launches_flagship_k6_route=launches_k6[key],
                    launches_ibl_combined_regir_path=launches_ib[key],
                    launches_env_anim_path=launches_ea[key], launches_taau_path=tu["launches"][key],
                    launches_pt=launches_pt[key], launches_bench_wkernels=launches_wk[key],
                    launches_streamed_path=launches_sf[key],
                    launches_sharded=sharded_launches(key), **extra)

    def wk_entry(name, key, replaces, variants):
        # ms: the kernel's own device time (CUPTI); call_ms adds the launch
        x = wk_rows[variants[0]]          # the script's first variant of the kernel
        keep = ("ms", "kernel_ms", "gate_iters", "ratio", "marginal_ratio", "ratio_64",
                "marginal_ratio_64", "step_ns", "step_ns_64", "checksum_rel_err", "plain_ms",
                "library_ms", "library_last_step_ms", "layout", "bound_distinct_rows_ms",
                "bound_share")
        return entry(name, "hobbyrenderer_tpu_torch/csrc/wkernels.cu", replaces, key, x["err"],
                     x["kernel_ms"], x["plain_ms"], x["bound"], main=launches_wk,
                     library_ms=x["library_ms"], iters=64, call_ms=x["ms"],
                     gate_iters=x["gate_iters"], kernel_ratio=x["ratio"],
                     kernel_marginal_ratio=x["marginal_ratio"],
                     checksum_rel_err=x["checksum_rel_err"],
                     variants={k: dict({f: wk_rows[k][f] for f in keep if f in wk_rows[k]},
                                       bound_ms=wk_rows[k]["bound"][0]) for k in variants})

    kernels_line = {"kernels": [
        entry("raster_resolve_tiles", "hobbyrenderer_tpu_torch/csrc/raster_resolve.cu",
              "hobbyrenderer_tpu/ops/raster_pallas.py:212", "K1", attr_err, k1_ms, k1_plain_ms,
              k1_bound, unit_items=rk.UNIT_ITEMS, calls=[raster_summary(x) for x in k1_rows],
              taau_internal_call=tu["k1"], streamed_frame=sf["held"]["k1"],
              band_call_n2_rank1=sharded[2][1]["k1_band"],
              band_call_n4_rank1=sharded[4][1]["k1_band"]),
        entry("restir_candidates", "hobbyrenderer_tpu_torch/csrc/restir_candidates.cu",
              "hobbyrenderer_tpu/ops/restir_pallas.py:65", "K2", k2_err, k2_ms, k2_plain_ms,
              k2_bound, issue_ms=k2_issue_ms, issue_clock_mhz=clock_mhz,
              sass_per_candidate=k2_sass.get("per_candidate"), regir_table=k2_regir,
              env_light_pool={k: ea_k["k2"][k] for k in ("equal", "repeat_equal", "ms",
                                                         "plain_ms", "bound_ms", "bound_by",
                                                         "max_abs_err", "directional_slots")},
              streamed_frame=sf["held"]["k2"]),
        entry("bvh16_walk", "hobbyrenderer_tpu_torch/csrc/bvh16_walk.cu",
              "hobbyrenderer_tpu/ops/wtrace.py:71", "K3", k3_main["err"], k3_main["ms"],
              k3_main["plain_ms"], k3_main["bound"], rays=k3_main["rays"],
              walks={x["name"]: [x["rays"], x["ms"], x["plain_ms"], x["bound"][0]]
                     for x in k3_rows + pt["k3_rows"]},
              gsteps_per_s={x["name"]: x["gsteps"] for x in k3_rows + pt["k3_rows"]},
              refitted_walks=ea_k["k3"], streamed_frame=sf["held"]["k3"]),
        entry("beam_any_hit_tiles", "hobbyrenderer_tpu_torch/csrc/beam_any_hit.cu",
              "hobbyrenderer_tpu/ops/beam.py:68", "K4", k4_err, k4_main["ms"],
              k4_main["plain_ms"], (k4_main["bound_ms"], k4_main["bound_by"]),
              calls={k: dict(ms=x["ms"], plain_ms=x["plain_ms"], bound_ms=x["bound_ms"],
                             bound_by=x["bound_by"], active_lanes=x["active"],
                             live_lanes=x["live"], max_steps=x["max_steps"],
                             mismatches=x["mismatches"])
                     for k, x in k4_rows.items()}, refitted_calls=ea_k["k4"],
              streamed_frame=sf["held"]["k4"]),
        entry("raster_tiles", "hobbyrenderer_tpu_torch/csrc/raster_resolve.cu",
              "hobbyrenderer_tpu/ops/raster_pallas.py:148", "K5", k5_main["attr_max_err"],
              k5_main["ms"], k5_main["plain_ms"], (k5_main["bound_ms"], k5_main["bound_by"]),
              main=launches_nb, unit_items=rk.UNIT_ITEMS, work=raster_summary(k5_main),
              depth_visid=raster_summary(k5_runs[False]),
              sharded_atlas_n2=sharded[2][0]["k5"]),
        entry("closest_hit_blocks", "hobbyrenderer_tpu_torch/csrc/closest_blocks.cu",
              "hobbyrenderer_tpu/ops/trace.py:64", "K6", k6_main["err"], k6_main["ms"],
              k6_main["plain_ms"], k6_main["bound"], main=launches_k6,
              ray_sets={x["name"]: dict(blocks=x["blocks"], lanes=x["lanes"], ms=x["ms"],
                                        plain_ms=x["plain_ms"], k3_ms=x["k3_ms"],
                                        bound_ms=x["bound"][0], overflowed=x["ovf_blocks"],
                                        cluster=x["cluster"], repeat_equal=x["repeat_equal"],
                                        bound_all_tests_ms=x["bound_all_tests"], work=x["work"],
                                        lanes_checked_against_k3=x["clean"])
                        for x in k6_rows}),
        wk_entry("leaf_gather", "K7", "scripts/bench_wkernels.py:33",
                 [v[0] for v in bw.K7_VARIANTS]),
        wk_entry("int_fetch", "K8", "scripts/bench_wkernels.py:72", ["K8 Ip=4480", "K8 Ip=512"]),
        wk_entry("int_fetch_hc", "K9", "scripts/bench_wkernels.py:100", ["K9 Ip=4480"]),
        dict(name="sky_march", route="cuda", source="hobbyrenderer_tpu_torch/csrc/sky_march.cu",
             replaces=None, launches_pt=pt["sky_launches"], calls=sky)]}
    log("path tracer 960x540: " + json.dumps({k: pt[k] for k in ("setup", "ms", "msamples")}))
    log(f"env + animated flagship 1080p on {card}: " + json.dumps(
        {"setup_s": ea["setup_s"], "ms": ea["ms"], "taau_ms": tu["ms"], "busy": ea["busy"],
         "host_syncs": ea["syncs"], "refit": ea_k["refit"]}))
    log(f"streamed flagship 1080p on {card}: " + json.dumps(
        {k: sf[k] for k in ("setup_s", "ms", "plain_ms", "settled_frame", "tiles", "applied_ms",
                            "syncs", "syncs_by_pass")}
        | {"frame_tex_streaming_ms": sf["pass_ms"]["Frame/TexStreaming"],
           "debug_views_ms": {k: v["ms"] for k, v in dvs.items()}}))
    log(f"sharded flagship on {card} (n > 1: ranks sharing the card): " + json.dumps(
        {f"n{n}": {"size": [1920, sharded[n][0]["ldr_shape"][0]],
                   "median_ms": [statistics.median(x["frame_ms"][1:]) for x in sharded[n]],
                   "collective_ms_timed": [x["collective_ms_timed"] for x in sharded[n]],
                   "collectives_a_frame": sharded[n][0]["coll"][-1]}
         for n, _ in SHARD_CONFIGS} | {"pt_960x540_n2": pt_sharded}))
    log(f"chip_smoke total seconds: {time.perf_counter() - t_start:.1f}")
    log(json.dumps(kernels_line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
