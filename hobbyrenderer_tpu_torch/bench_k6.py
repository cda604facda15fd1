"""K6, the sorted-block closest hit (csrc/closest_blocks.cu), on the calls
of chip_smoke.py's phase 13, timed on one GPU, optionally in turns against
another build.

    python -m hobbyrenderer_tpu_torch.bench_k6 [--baseline CHECKOUT] [--reps N]

The calls: the first 1080p stress flagship frame's two
``closest_hit_counted`` ray sets (the GI bounce and the reflection rays),
captured on the frame's default route, and a coherent control set, the
camera rays of every other pixel; each packed into 1,024-ray blocks by
``pack_rays_sorted`` as ``closest_hit_auto(..., force_kernel=True)`` packs
them (t_max TMAX_CAP, every lane active).

Each call is held against the plain version (all six outputs
``torch.equal``) and launched three times (equal bits); its line prints the
blocks, the active lanes, the levels, the interior and leaf rows read, the
leaf-lane-rows (leaf rows times the block's active lanes), the slowest
block's rows, the overflowed blocks, the cluster size, the kernel's work
counts (lane record tests run and skipped by its warp cull, which must add
up to four a leaf-lane-row), the bound (``k6_bound``, on the tests the
kernel runs, and beside it on every leaf-lane record test) and the plain
version's time. The SASS of one record test of the
fold (``record_sass``: the instructions of the innermost loop, cuobjdump)
is printed for this build and the baseline's. ``--baseline`` takes the
root of another checkout of the repo (e.g. the parent commit unpacked with
``git archive`` into the git-ignored ``build/``), imports that checkout's
``ops/trace_kernel.py`` with its own kernel library, whatever C interface
it has, and times both on the same inputs, in turns: baseline, this, this,
baseline. Every kernel time is a median over ``--reps`` CUDA-event timings
of 10 calls back to back (the plain version's: one run of one call), on the
card named in the first line (name, power limit and maximum SM clock as
nvidia-smi prints them). The last line is one JSON object with every
number printed."""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
CALLS = ("gi_bounce", "specular", "camera_control")


def k6_bound(btable, rays, outs, stats, work=None):
    """(bound_ms, bound_by, bytes, operations) of a K6 call on the work its
    data needs (the plain version's ``stats``): bytes, every (block, row)
    visit's 512 B row, the rays and the outputs; operations, BOX_OPS a
    child-box test and MT_OPS a record test: with ``work`` (the kernel's
    counts) the lane record tests left after its warp cull, and IV_OPS a
    record bound of the cull; without, every leaf-lane record test (the
    count before the cull)."""
    from hobbyrenderer_tpu_torch.ops import trace_kernel as tk
    nbytes = (stats["rows"] * btable.shape[1] * 4 + rays.numel() * 4
              + sum(o.numel() * o.element_size() for o in outs))
    ops = stats["box_tests"] * tk.BOX_OPS + (
        stats["leaf_lane_rows"] * 4 * tk.MT_OPS if work is None
        else work["record_tests"] * tk.MT_OPS + work["record_bounds"] * tk.IV_OPS)
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes", nbytes, ops) if tb >= tf else (tf, "operations", nbytes, ops)


def record_sass(lib_path, kernel="closest_blocks_kernel"):
    """Static SASS counts of one record test of K6's fold: of the innermost
    loops (a backward branch's span) that hold exactly one MUFU.RCP, the
    IEEE division of 1/det that each record test makes once, the longest
    (the shorter one recomputes a hit's attributes). Returns its
    instructions, their MUFU / FCHK / CALL counts and local-memory (spill)
    loads and stores, and the kernel's local-memory instructions."""
    from hobbyrenderer_tpu_torch.bench_k2k4 import sass_of
    instrs, labels = sass_of(lib_path, kernel)
    addrs = [a for a, _ in instrs]
    op = lambda t: t.split()[1] if t.startswith("@") else t.split()[0]   # noqa: E731
    spans = []
    for i, (a, text) in enumerate(instrs):
        m = re.search(r"\bBRA\s+(?:!?U?P\w+,\s*)?(?:`?\(?(\.L_x_\d+)\)?`?|(0x[0-9a-f]+))", text)
        if not m:
            continue
        tgt = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if tgt is None or tgt > a or tgt not in addrs:
            continue
        j = addrs.index(tgt)
        if sum(op(t).startswith("MUFU.RCP") for _, t in instrs[j:i + 1]) == 1:
            spans.append((j, i + 1))
    # the innermost of them: no other such loop inside; of those the longest
    inner = [(j, k) for j, k in spans
             if not any(j <= j2 and k2 <= k and (j2, k2) != (j, k) for j2, k2 in spans)]
    best = None
    for j, k in inner:
        if best is None or k - j > len(best):
            best = [t for _, t in instrs[j:k]]
    if best is None:
        return dict(total=len(instrs), per_record=None)
    return dict(total=len(instrs), per_record=len(best),
                mufu=sum(op(t).startswith("MUFU") for t in best),
                fchk=sum(op(t) == "FCHK" for t in best),
                call=sum(op(t).startswith("CALL") for t in best),
                local=sum(op(t).startswith(("LDL", "STL")) for t in best),
                local_kernel=sum(op(t).startswith(("LDL", "STL")) for _, t in instrs))


def capture(Renderer, Config):
    """{name: (btable, rays)}: the first 1080p stress flagship frame's GI
    bounce and reflection rays (its two ``closest_hit_counted`` calls) and
    the camera rays of every other pixel, packed as the sorted-block route
    packs them."""
    from hobbyrenderer_tpu_torch.ops import sky as skyops
    from hobbyrenderer_tpu_torch.ops import trace as traceops
    seen = []
    counted = traceops.closest_hit_counted

    def spy(rt, o, d, active, max_steps=None):
        seen.append((o, d, active))
        return counted(rt, o, d, active, max_steps=max_steps)

    traceops.closest_hit_counted = spy
    try:
        r = Renderer(Config(scene="stress", width=1920, height=1080, direct_mode="restir",
                            indirect_mode="restir",
                            cache_dir=os.path.join(tempfile.gettempdir(), "hr_bench_k6")),
                     device="cuda")
        r.render_frame()
        torch.cuda.synchronize()
    finally:
        traceops.closest_hit_counted = counted
    if len(seen) != 2:
        raise RuntimeError(f"expected the GI bounce and reflection calls, got {len(seen)}")
    rt = r._model.rt
    root = torch.as_tensor(rt.bvh.root_box, device="cuda")
    vc = r.view_constants()
    d_cam = skyops.view_dirs_from_pixels(vc, 1080, 1920)[::2, ::2].reshape(-1, 3)
    o_cam = vc["camera_pos"][None, :].expand_as(d_cam)
    sets = seen + [(o_cam, d_cam, torch.ones((d_cam.shape[0],), dtype=torch.bool,
                                               device="cuda"))]
    calls = {}
    for name, (o, d, active) in zip(CALLS, sets):
        tm = traceops._block_t_max(None, o.shape[0], o.device)
        rays, _ = traceops.pack_rays_sorted(o, d, tm, active, root)
        calls[name] = (rt.btable, rays)
    r.shutdown()
    return calls


def held(btable, rays):
    """A call of this build held against the plain version: (row, line,
    outputs). ``row`` has the work (the plain version's stats), whether the
    six outputs are ``torch.equal`` and three launches equal, the cluster
    size, the bound and the plain version's ms."""
    from hobbyrenderer_tpu_torch.ops import trace_kernel as tk
    got = [tk.closest_hit_blocks(btable, rays) for _ in range(3)]
    work = {}
    tk.closest_hit_blocks(btable, rays, work=work)
    st = {}
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    ref = tk.closest_hit_blocks_reference(btable, rays, stats=st)
    e1.record()
    torch.cuda.synchronize()
    names = ("t", "tri", "u", "v", "front", "ovf")
    T = rays.shape[0]
    bnd = k6_bound(btable, rays, got[0], st, work)
    bnd_all = k6_bound(btable, rays, got[0], st)
    row = dict(blocks=T, active_lanes=int((rays[:, 7] > 0.5).sum()), levels=st["levels"],
               interior_rows=st["rows"] - st["leaf_rows"], leaf_rows=st["leaf_rows"],
               leaf_lane_rows=st["leaf_lane_rows"], box_tests=st["box_tests"],
               max_block_rows=st["max_block_rows"],
               max_block_leaf_rows=st["max_block_leaf_rows"],
               overflowed=int((ref[5] > 0.5).sum()), cluster=tk.CLUSTER,
               equal={k: torch.equal(g, r) for k, g, r in zip(names, got[0], ref)},
               repeat_equal=all(torch.equal(a, b) for g in got[1:] for a, b in zip(got[0], g)),
               hit_share=float((ref[1] >= 0).float().mean()), work=work,
               work_adds_up=work["record_tests"] + work["records_culled"]
               == 4 * st["leaf_lane_rows"],
               bound_ms=bnd[0], bound_by=bnd[1], bound_bytes=bnd[2], bound_ops=bnd[3],
               bound_all_tests_ms=bnd_all[0],
               plain_ms=e0.elapsed_time(e1))
    line = (f"blocks {T} (cluster {row['cluster']}), active lanes {row['active_lanes']}, "
            f"levels {row['levels']}, rows {row['interior_rows']} interior + "
            f"{row['leaf_rows']} leaf, leaf-lane-rows {row['leaf_lane_rows']}, slowest block "
            f"{row['max_block_rows']} rows ({row['max_block_leaf_rows']} leaf), overflowed "
            f"blocks {row['overflowed']}/{T}, hit share {row['hit_share']:.4f}; equal to plain "
            f"{row['equal']}, three launches equal {row['repeat_equal']}; lane record tests "
            f"run {work['record_tests']}, skipped by the warp cull {work['records_culled']} "
            f"({work['records_culled'] / max(4 * st['leaf_lane_rows'], 1):.4f}; adds up to "
            f"4 x leaf-lane-rows {row['work_adds_up']}), record bounds "
            f"{work['record_bounds']}; plain {row['plain_ms']:.1f} ms, bound {bnd[0]:.4f} ms "
            f"({bnd[1]}; {bnd[2]} B, {bnd[3]} ops; {bnd_all[0]:.4f} ms counting every "
            f"leaf-lane record test)")
    return row, line, got[0]


def main(argv=None):
    from hobbyrenderer_tpu_torch import bench_k3
    from hobbyrenderer_tpu_torch.bench_k2k4 import card_line, ptxas_lines, turns
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", default=None,
                    help="the root of another checkout whose K6 is timed in turns")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_k6 times the CUDA kernel: it needs an NVIDIA GPU")
    from hobbyrenderer_tpu_torch import kernels
    from hobbyrenderer_tpu_torch.config import Config
    from hobbyrenderer_tpu_torch.ops import beam as beamops
    from hobbyrenderer_tpu_torch.ops import trace_kernel as tk
    from hobbyrenderer_tpu_torch.renderer import Renderer

    card, clock = card_line()
    print(f"{card}, max SM clock {clock} MHz", flush=True)
    t0 = time.perf_counter()
    lib = kernels.library()
    base_tk = base_lib = None
    if args.baseline:
        base_tk = bench_k3.load_baseline(args.baseline, "ops.trace_kernel")
        base_lib = base_tk.kernels.library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    print("\n".join(ptxas_lines(kernels.BUILD_DIR, "closest_blocks.cu", "closest_blocks")),
          flush=True)
    sass = {}
    for who, path in (("new", lib._name), ("baseline", base_lib and base_lib._name)):
        if path:
            try:
                sass[who] = record_sass(path)
            except Exception as e:       # noqa: BLE001
                sass[who] = {"error": repr(e)}
    placeable = tk.max_clusters()
    print(f"K6 SASS of one record test: {json.dumps(sass)}; clusters of {tk.CLUSTER} CTAs the "
          f"card holds at once {placeable}", flush=True)

    t0 = time.perf_counter()
    calls = capture(Renderer, Config)
    print(f"captured {len(calls)} calls in {time.perf_counter() - t0:.1f} s", flush=True)
    rows, failures = {}, []
    for name, (btable, rays) in calls.items():
        N = btable.shape[0]
        marker_ok = torch.equal(btable[:, 127] > 0.5,
                                torch.arange(N, device=btable.device) >= beamops._leaf_start(N))
        row, line, out = held(btable, rays)
        row["marker_equals_id_rule"] = marker_ok
        new = lambda: tk.closest_hit_blocks(btable, rays)   # noqa: E731
        if base_tk is not None:
            old = lambda: base_tk.closest_hit_blocks(btable, rays)   # noqa: E731
            bo = old()
            row["baseline_equal"] = all(torch.equal(a, b) for a, b in zip(bo, out))
            row["turns"], row["baseline_ms"], row["ms"] = turns(args.reps, old, new)
        else:
            row["ms"] = bench_k3.cuda_ms(new, args.reps)
        rows[name] = row
        print(f"K6 {name}: {line}; kernel {row['ms']:.4f} ms"
              + (f", baseline {row['baseline_ms']:.4f} ms (equal to this "
                 f"{row['baseline_equal']}; turns {[(w, round(t, 4)) for w, t in row['turns']]})"
                 if base_tk is not None else ""), flush=True)
        if not all(row["equal"].values()) or not row["repeat_equal"] or not marker_ok \
                or not row["work_adds_up"]:
            failures.append(f"K6 {name}: equal {row['equal']}, repeat {row['repeat_equal']}, "
                            f"marker {marker_ok}, work adds up {row['work_adds_up']}")
        if base_tk is not None and not row["baseline_equal"]:
            failures.append(f"K6 {name}: the baseline differs from this build")
    print(json.dumps({"card": card, "max_sm_clock_mhz": clock, "sass_record_test": sass,
                      "max_clusters": placeable, "calls": rows, "failures": failures}),
          flush=True)
    if failures:
        raise SystemExit("K6 failed: " + "; ".join(failures))


if __name__ == "__main__":
    sys.exit(main())
