"""K1 and K5, the tile rasters (csrc/raster_resolve.cu), on the main paths'
calls, timed on one GPU, optionally in turns against another build.

    python -m hobbyrenderer_tpu_torch.bench_raster [--baseline CHECKOUT] [--reps N]

The calls are captured from the paths that make them: the five K1 calls of
the first 1080p stress flagship frame (Raster, RasterPhase2, MaskedLayer
and Transparent's two layers) and K5's shadow-atlas call of the first
1080p stress NormalBasic frame, run depth only (as the frame runs it) and
with visid.

Each call is held against its plain version (depth and visid bit-equal;
K1's attribute planes bit-equal, or where not within 1e-4, the count
printed) and launched three times (equal bits). ``--baseline`` takes the
root of another checkout of the repo (e.g. the parent commit unpacked with
``git archive`` into the git-ignored ``build/``), imports that checkout's
``ops/raster_kernel.py`` with its own kernel library, whatever C interface
it has, and times it against this one on the same inputs, in turns:
baseline, this, this, baseline. Every kernel time is a median over ``--reps``
CUDA-event timings of 10 calls back to back (the plain version's: a
median of three runs of one call), on the card named in the first line
(name and power limit as nvidia-smi prints them). ``held_call``, which
chip_smoke.py uses too, holds a call against its plain version and
counts its work and bound (``raster_bound``), whatever implements it. The
last line is one JSON object with every number printed."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
OPS_A_PIXEL_ROW = 13      # 3 planes x (2 mul + 2 add) and l1 + l2
OPS_A_RESOLVE = 76        # 16 planes x 4, a division and 11 products a drawn pixel
K1_CALLS = ("Raster", "RasterPhase2", "MaskedLayer", "Transparent 1", "Transparent 2")


def kept_strip_rows(records, work_tile, work_slot, *, tiles, tx):
    """The (row, pixel row) pairs of the live items that the strip test
    (ops/raster_kernel._rows_outside_strips) keeps: the rows the kernels
    evaluate, each at the 32 pixels of its pixel row."""
    from hobbyrenderer_tpu_torch.ops import raster_kernel as rk
    n = int((work_tile < tiles).sum())
    kept = 0
    for b0 in range(0, n, 2048):
        t = work_tile[b0:min(n, b0 + 2048)].long()
        A = records[work_slot[b0:b0 + t.shape[0]].long()][..., 0:9]
        oxf = ((t % tx) * rk.TILE).to(torch.float32)[:, None, None] + 0.5
        oyf = ((t // tx) * rk.TILE).to(torch.float32)[:, None, None] + 0.5
        kept += int((~rk._rows_outside_strips(A, oxf, oyf)).sum())
    return kept


def call_stats(records, work_tile, work_slot, *, tiles, tx):
    """What a call gives the kernel to do: its live items, the work units
    and split tiles (ops/raster_kernel.split_units at UNIT_ITEMS), and the
    (row, pixel row) pairs the kernel evaluates against all of them
    (items x 32 x 32)."""
    from hobbyrenderer_tpu_torch.ops.raster_kernel import UNIT_ITEMS as unit_items
    n = int((work_tile < tiles).sum())
    per_tile = torch.bincount(work_tile[:n].long(), minlength=tiles)
    units = int(((per_tile + unit_items - 1) // unit_items).sum())
    return dict(items=n, tiles=tiles, busiest_tile=int(per_tile.max()) if n else 0,
                empty_tiles=int((per_tile == 0).sum()), units=units,
                split_tiles=int((per_tile > unit_items).sum()),
                strip_rows=kept_strip_rows(records, work_tile, work_slot, tiles=tiles, tx=tx),
                strip_rows_all=n * 32 * 32)


def raster_bound(records, work_tile, work_slot, visid, *, tiles, tx, k1):
    """(bound_ms, bound_by, bytes, operations) of a K1 (``k1``) or K5 call,
    counted on the work, whatever implements it. Bytes: the 9 raster-plane
    lanes of the 32 rows of each distinct chunk slot on the worklist, the
    live items' tile and slot (4 B each) and the tile starts; for K1 the 48
    attribute-plane lanes of each distinct winner row; and the outputs,
    written once (depth and visid; K1's 16 attribute planes). Operations:
    13 fp32 a pixel of each (row, pixel row) pair that the strip test keeps
    (``kept_strip_rows``), and for K1 76 a drawn pixel."""
    n = int((work_tile < tiles).sum())
    slots = torch.unique(work_slot[:n]).numel()
    nbytes = slots * 32 * 9 * 4 + n * 8 + (tiles + 1) * 4 + tiles * 1024 * 8
    ops = kept_strip_rows(records, work_tile, work_slot, tiles=tiles, tx=tx) * 32 * OPS_A_PIXEL_ROW
    if k1:
        drawn = visid[visid >= 0]
        nbytes += torch.unique(drawn).numel() * 48 * 4 + tiles * 16 * 1024 * 4
        ops += drawn.numel() * OPS_A_RESOLVE
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes", nbytes, ops) if tb >= tf else (tf, "operations", nbytes, ops)


def capture(Renderer, Config):
    """{name: (k1, records, work_tile, work_slot, kw)}: the first flagship
    frame's K1 calls and the first NormalBasic frame's K5 call."""
    from hobbyrenderer_tpu_torch.ops import raster_kernel as rk
    calls = {}
    k1_orig, k5_orig = rk.raster_resolve_tiles, rk.raster_tiles
    k1_seen = []

    def k1_spy(records, work_tile, work_slot, **kw):
        k1_seen.append((True, records, work_tile, work_slot, kw))
        return k1_orig(records, work_tile, work_slot, **kw)

    def k5_spy(records, work_tile, work_slot, *, depth_only, **kw):
        if depth_only:
            calls.setdefault("K5 atlas", (False, records, work_tile, work_slot, kw))
        return k5_orig(records, work_tile, work_slot, depth_only=depth_only, **kw)

    for kw_cfg, cache in ((dict(direct_mode="restir", indirect_mode="restir"), "fl"),
                          (dict(mode="normal_basic"), "nb")):
        r = Renderer(Config(scene="stress", width=1920, height=1080,
                            cache_dir=os.path.join(tempfile.gettempdir(), "hr_bench_raster_" + cache),
                            **kw_cfg), device="cuda")
        rk.raster_resolve_tiles, rk.raster_tiles = k1_spy, k5_spy
        try:
            r.render_frame()
            torch.cuda.synchronize()
        finally:
            rk.raster_resolve_tiles, rk.raster_tiles = k1_orig, k5_orig
            r.shutdown()
        if cache == "fl":
            if len(k1_seen) != len(K1_CALLS):
                raise RuntimeError(f"the flagship frame made {len(k1_seen)} K1 calls, "
                                   f"not {len(K1_CALLS)}")
            calls.update(zip(K1_CALLS, k1_seen))
            k1_seen.clear()
    if "K5 atlas" not in calls:
        raise RuntimeError("the NormalBasic frame made no depth-only K5 call")
    return calls


def device_ms(fn, reps=10):
    """The card's time for one fn() (ms): every kernel it launches, summed
    from a torch.profiler (CUPTI) trace of reps calls, / reps, whatever
    pace the host sets for the calls; and the same split by kernel: this
    build's plan and raster launches, and the rest."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = next((k for k in ("plan_kernel", "raster_units_kernel") if k in e.name), "other")
            parts[key] = parts.get(key, 0.0) + e.time_range.elapsed_us() / reps / 1e3
    return sum(parts.values()), parts


def plan_equal(rk, work_tile, *, tiles):
    """The kernels' plan of a call (their first launch) equals its plain
    version, split_units on the CPU."""
    got = rk.plan_units(work_tile, tiles=tiles)
    want = rk.plan_units(work_tile.cpu(), tiles=tiles)
    return all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def call_fn(mod, k1, records, work_tile, work_slot, kw, depth_only, plain=False):
    """One call of mod's K1 (``k1``) or K5 kernel, or of its plain version,
    on these inputs, as a function of no arguments."""
    if k1:
        fn = mod.raster_resolve_tiles_reference if plain else mod.raster_resolve_tiles
        return lambda: fn(records, work_tile, work_slot, **kw)
    fn = mod.raster_tiles_reference if plain else mod.raster_tiles
    return lambda: fn(records, work_tile, work_slot, depth_only=depth_only, **kw)


def check(run, k1, ref):
    """Three launches of run(): (depth and visid equal to the plain
    version's ``ref``, the three equal, K1's attribute mismatches and max
    |d|)."""
    got = [run() for _ in range(3)]
    torch.cuda.synchronize()
    exact = torch.equal(got[0][0], ref[0]) and torch.equal(got[0][1], ref[1])
    repeat = all(torch.equal(a, b) for g in got[1:] for a, b in zip(got[0], g))
    attr_mis, attr_err = 0, 0.0
    if k1:
        attr_mis = int((got[0][2] != ref[2]).sum())
        attr_err = float((got[0][2] - ref[2]).abs().max())
    return exact, repeat, attr_mis, attr_err


def held_call(k1, records, work_tile, work_slot, kw, depth_only=True):
    """A K1 (``k1``) or K5 call of this build held against its plain
    version: (row, line, ref). ``row`` has the work (``call_stats``),
    whether depth and visid equal the plain version's, three launches are
    equal and the plan equals split_units, K1's attribute mismatches and
    max |d|, the drawn pixels, the bound (``raster_bound``) and the plain
    version's ms (median of three runs of one call); ``line`` says them in
    words; ``ref`` is the plain version's output. The caller adds its
    times and decides what fails."""
    from hobbyrenderer_tpu_torch import bench_k3
    from hobbyrenderer_tpu_torch.ops import raster_kernel as rk
    plain = call_fn(rk, k1, records, work_tile, work_slot, kw, depth_only, plain=True)
    ref = plain()
    torch.cuda.synchronize()
    exact, repeat, attr_mis, attr_err = check(
        call_fn(rk, k1, records, work_tile, work_slot, kw, depth_only), k1, ref)
    plan_ok = plan_equal(rk, work_tile, tiles=kw["tiles"])
    st = call_stats(records, work_tile, work_slot, **kw)
    bnd = raster_bound(records, work_tile, work_slot, ref[1], k1=k1, **kw)
    pixels, drawn = ref[0].numel(), int((ref[0] > 0).sum())
    row = dict(st, exact=exact, repeat_equal=repeat, plan_equal=plan_ok,
               attr_mismatches=attr_mis, attr_max_err=attr_err, pixels=pixels, drawn=drawn,
               bound_ms=bnd[0], bound_by=bnd[1], bound_bytes=bnd[2], bound_ops=bnd[3],
               unit_items=rk.UNIT_ITEMS, plain_ms=bench_k3.cuda_ms(plain, 3, 1))
    line = (f"items {st['items']} over {st['tiles']} tiles ({st['empty_tiles']} empty, busiest "
            f"{st['busiest_tile']}), units {st['units']} at {rk.UNIT_ITEMS} items (plan equal "
            f"to split_units {plan_ok}), split tiles {st['split_tiles']}, rows evaluated "
            f"{st['strip_rows']} of {st['strip_rows_all']} "
            f"({st['strip_rows'] / max(st['strip_rows_all'], 1):.4f}); depth and visid equal "
            f"to plain {exact}, three launches equal {repeat}"
            + (f", attrs not equal {attr_mis} (max |d| {attr_err:.3g})" if k1 else "")
            + f", drawn {drawn}/{pixels}; plain {row['plain_ms']:.2f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}; {bnd[2]} B, {bnd[3]} ops)")
    return row, line, ref


def main(argv=None):
    from hobbyrenderer_tpu_torch import bench_k3
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", default=None,
                    help="the root of another checkout whose rasters are timed in turns")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_raster times the CUDA kernels: it needs an NVIDIA GPU")
    from hobbyrenderer_tpu_torch import kernels
    from hobbyrenderer_tpu_torch.config import Config
    from hobbyrenderer_tpu_torch.ops import raster_kernel as rk
    from hobbyrenderer_tpu_torch.renderer import Renderer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card, flush=True)
    t0 = time.perf_counter()
    kernels.library()
    base = bench_k3.load_baseline(args.baseline, "ops.raster_kernel") if args.baseline else None
    if base is not None:
        base.kernels.library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for p in os.listdir(kernels.BUILD_DIR):
        if p.endswith(".ptxas.txt"):
            with open(os.path.join(kernels.BUILD_DIR, p)) as f:
                text = f.read()
            part = text[text.index("== raster_resolve.cu"):].split("\n== ")[0]
            print("\n".join("  ptxas: " + x.strip() for x in part.splitlines()
                            if "Compiling entry" in x or "registers" in x or "spill" in x))

    t0 = time.perf_counter()
    calls = capture(Renderer, Config)
    print(f"captured {len(calls)} calls in {time.perf_counter() - t0:.1f} s", flush=True)
    runs = [(name, False) for name in K1_CALLS] + [("K5 atlas", True), ("K5 atlas", False)]
    rows, failures = {}, []
    for name, depth_only in runs:
        k1, records, wt, ws, kw = calls[name]
        label = name if k1 else f"{name} depth_only={depth_only}"
        row, line, ref = held_call(k1, records, wt, ws, kw, depth_only)
        new = call_fn(rk, k1, records, wt, ws, kw, depth_only)
        if base is not None:
            old = call_fn(base, k1, records, wt, ws, kw, depth_only)
            row["baseline_exact"] = check(old, k1, ref)[0]
            turns = [(who, bench_k3.cuda_ms(old if who == "baseline" else new, args.reps))
                     for who in ("baseline", "new", "new", "baseline")]
            row["turns"] = turns
            row["baseline_ms"] = statistics.mean(t for w, t in turns if w == "baseline")
            row["ms"] = statistics.mean(t for w, t in turns if w == "new")
            row["baseline_device_ms"] = device_ms(old)[0]
        else:
            row["ms"] = bench_k3.cuda_ms(new, args.reps)
        row["device_ms"], row["device_parts_ms"] = device_ms(new)
        rows[label] = row
        print(f"{label}: {line}"
              + (f", baseline equal to plain {row['baseline_exact']}" if base is not None else "")
              + f"; kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in row["device_parts_ms"].items()) + ")"
              + (f", baseline {row['baseline_ms']:.4f} ms (device {row['baseline_device_ms']:.4f};"
                 f" turns {[(w, round(t, 4)) for w, t in row['turns']]})"
                 if base is not None else ""), flush=True)
        if not (row["exact"] and row["repeat_equal"] and row["plan_equal"]
                and row["attr_max_err"] <= 1e-4):
            failures.append(f"{label}: exact {row['exact']}, repeat equal {row['repeat_equal']}, "
                            f"plan {row['plan_equal']}, attrs {row['attr_max_err']}")
        if base is not None and not row["baseline_exact"]:
            failures.append(f"{label}: the baseline differs from the plain version")
    print(json.dumps({"card": card, "calls": rows, "failures": failures}), flush=True)
    if failures:
        raise SystemExit("the tile rasters failed: " + "; ".join(failures))


if __name__ == "__main__":
    main()
