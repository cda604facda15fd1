"""K4, the any-hit walk (csrc/beam_any_hit.cu), and K2, the ReSTIR
candidates (csrc/restir_candidates.cu), on the main paths' calls, timed on
one GPU, optionally in turns against another build.

    python -m hobbyrenderer_tpu_torch.bench_k2k4 [--baseline CHECKOUT] [--reps N]

The calls are captured from the frames that make them: K4's SunShadow call
of the first 1080p stress simple frame; the first 1080p stress flagship
frame's three K4 calls (RTXDI's two tile-majority winner calls, the second
masked to each tile's second-most-common winner, and RTXDIGI's visibility
call, whose rays go to per-pixel sample points) and its one K2 call.

Each K4 call is held against its plain version (occlusion equal on the
active lanes) and against the kernel's walk replayed in plain PyTorch
(``ops/beam.py::beam_walk``: equal on every lane), and launched three
times (equal bits); each line prints the tiles, the active and live lanes,
the tiles with a live lane, the live lanes per live warp under a thread a
lane (the earlier kernel's layout: a warp is 32 neighbouring lanes of a
tile), the occluded share, the rows the walk reads, the rows its lanes pop
and the longest lane's, the bound (``k4_bound``) and the plain version's
time. K2's five outputs must be
``torch.equal`` to its plain version's, three launches too; its line
prints the pixels, the candidates, the bound (``k2_bound``) and the
issue-rate estimate (``k2_issue``: the kernel's SASS instructions, counted
from ``cuobjdump -sass`` of the built library, over the card's schedulers).
``--baseline`` takes the root of another checkout of the repo (e.g. the
parent commit unpacked with ``git archive`` into the git-ignored
``build/``), imports that checkout's ``ops/beam.py`` and
``ops/restir_kernel.py`` with its own kernel library, whatever C interface
it has, and times both against this build on the same inputs, in turns:
baseline, this, this, baseline. Every kernel time is a median over
``--reps`` CUDA-event timings of 10 calls back to back (the plain
versions': a median of three runs of one call), on the card named in the
first line (name, power limit and maximum SM clock as nvidia-smi prints
them). The last line is one JSON object with every number printed."""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SMS, SCHEDULERS = 132, 4          # H100 SXM: warp schedulers an SM, each issues 1 a cycle
BOX_OPS = 27                      # a padded slab test of one box, 3 axes
INTERIOR_ROW_BYTES = 24 * 4       # the 4 child boxes of an interior row
LEAF_ROW_BYTES = 4 * 10 * 4       # the 4 records' v0 e1 e2 tid of a leaf row
K4_CALLS = ("SunShadow", "RTXDI 1", "RTXDI 2", "RTXDIGI")
# K2: per pixel ~40 fp32 ops of set-up, per candidate 189 (light 34 +
# emissive 57 + GGX p-hat 92 + RIS 3 + uniforms 3), counted from the kernel
# source, an IEEE divide or square root counted as one
K2_PIXEL_OPS, K2_CANDIDATE_OPS = 40, 189


def k4_stats(rays):
    """What a K4 call gives the kernel: tiles, active lanes (act > 0.5),
    live lanes (active and t_max > 1e-4), tiles with a live lane, and the
    live lanes per live warp of a thread a lane (32 neighbouring lanes)."""
    act = rays[:, 7] > 0.5
    live = act & (rays[:, 6] > 1e-4)
    per_warp = live.reshape(-1, 32).sum(1)
    live_warps = int((per_warp > 0).sum())
    return dict(tiles=rays.shape[0], active=int(act.sum()), live=int(live.sum()),
                live_tiles=int(live.any(1).sum()), live_warps=live_warps,
                live_per_live_warp=int(live.sum()) / max(live_warps, 1))


def k4_bound(btable, rays, visited, work):
    """(bound_ms, bound_by, bytes, operations) of a K4 call, on the work its
    walk needs (``beam_walk``'s visited rows and counts). Bytes: each
    row the walk reads once (an interior row's 4 boxes, 96 B; a leaf row's 4
    records without padding, 160 B), act and t_max of every lane, the other
    6 floats of each live lane, and the outputs. Operations: 27 fp32 a lane
    box test and trace_kernel.MT_OPS a lane record test."""
    from hobbyrenderer_tpu_torch.ops import beam as beamops
    from hobbyrenderer_tpu_torch.ops.trace_kernel import MT_OPS
    I = beamops._leaf_start(btable.shape[0])
    n_int, n_leaf = int(visited[:I].sum()), int(visited[I:].sum())
    live = int(((rays[:, 7] > 0.5) & (rays[:, 6] > 1e-4)).sum())
    lanes = rays.shape[0] * rays.shape[2]
    nbytes = (n_int * INTERIOR_ROW_BYTES + n_leaf * LEAF_ROW_BYTES + lanes * 8 + live * 24
              + lanes * 4 + rays.shape[0] * 4)
    ops = work["box_tests"] * BOX_OPS + work["record_tests"] * MT_OPS
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes", nbytes, ops) if tb >= tf else (tf, "operations", nbytes, ops)


def k2_bound(args, outs, num_candidates):
    """(bound_ms, bound_by, bytes, operations) of a K2 call: its inputs read
    once and its five outputs written once, or K2_PIXEL_OPS a pixel and
    K2_CANDIDATE_OPS a candidate."""
    flat3, tsel, planes, cam = args[:4]
    Hp, Wp = planes.shape[1:]
    nbytes = sum(t.numel() * t.element_size() for t in (flat3, tsel, planes, cam, *outs))
    ops = Hp * Wp * (K2_PIXEL_OPS + K2_CANDIDATE_OPS * num_candidates)
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes", nbytes, ops) if tb >= tf else (tf, "operations", nbytes, ops)


def _cuobjdump() -> str:
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(path):
        raise RuntimeError("cuobjdump not found: it comes with the CUDA toolkit")
    return path


def sass_of(lib_path, kernel):
    """The SASS of the kernel whose mangled name holds ``kernel`` in the
    shared library at lib_path: [(address, text)] in address order, the
    labels of a listing that has them mapped to the next address."""
    out = subprocess.run([_cuobjdump(), "-sass", lib_path], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    parts = re.split(r"\n\s*Function : ", out)
    body = next(p for p in parts[1:] if kernel in p.splitlines()[0])
    instrs, labels, pending = [], {}, []
    for line in body.splitlines()[1:]:
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            instrs.append((addr, m.group(2)))
    return instrs, labels


def _is_marker(text):
    """The RIS update's fmaxf(w_sum, 1e-20f): once a candidate."""
    return "FMNMX" in text and ("e-21" in text or "e-20" in text)


def sass_counts(lib_path, kernel="restir_candidates_kernel"):
    """Static SASS counts of K2: the candidate loop is the backward branch
    whose span holds the most copies of the RIS update's fmaxf(w_sum,
    1e-20f) (once a candidate, so the copies give the unroll factor). Returns instructions a candidate (the loop's span over the
    copies: every branch of the body counted, as a warp whose lanes go both
    ways issues both), MUFU / FCHK / CALL a candidate, the instructions
    before the loop (the per-pixel set-up) and after it up to the first
    EXIT (the write-back), and the kernel's total."""
    instrs, labels = sass_of(lib_path, kernel)
    addrs = [a for a, _ in instrs]
    best = None
    for i, (a, text) in enumerate(instrs):
        m = re.search(r"\bBRA\s+(?:!?U?P\w+,\s*)?(?:`?\(?(\.L_x_\d+)\)?`?|(0x[0-9a-f]+))",
                      text)
        if not m:
            continue
        tgt = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if tgt is None or tgt > a:
            continue
        j = addrs.index(tgt) if tgt in addrs else None
        if j is None:
            continue
        span = instrs[j:i + 1]
        copies = sum(_is_marker(t) for _, t in span)
        if copies and (best is None or copies > best[2]
                       or (copies == best[2] and len(span) > best[1] - best[0])):
            best = (j, i + 1, copies)
    if best is None:
        return dict(total=len(instrs), per_candidate=None)
    j, k, copies = best
    span = [t for _, t in instrs[j:k]]
    op = lambda t: t.split()[1] if t.startswith("@") else t.split()[0]
    exit_at = next((n for n in range(k, len(instrs)) if op(instrs[n][1]) == "EXIT"), len(instrs))
    return dict(total=len(instrs), loop_span=len(span), unroll=copies,
                per_candidate=len(span) / copies,
                mufu_per_candidate=sum(op(t).startswith("MUFU") for t in span) / copies,
                fchk_per_candidate=sum(op(t) == "FCHK" for t in span) / copies,
                call_per_candidate=sum(op(t).startswith("CALL") for t in span) / copies,
                before_loop=j, after_loop=exit_at + 1 - k)


def k2_issue(counts, pixels, num_candidates, clock_mhz):
    """(ms, warp instructions): the least time the card's 132 x 4 warp
    schedulers take to issue K2's SASS for ``pixels`` pixels at ``clock_mhz``,
    from ``sass_counts``: a warp of 32 pixels issues the set-up, the
    write-back and num_candidates candidates."""
    if not counts or not counts.get("per_candidate"):
        return None, None
    per_warp = counts["before_loop"] + counts["after_loop"] + counts["per_candidate"] * num_candidates
    warp_instr = pixels / 32 * per_warp
    return warp_instr / (SMS * SCHEDULERS * clock_mhz * 1e6) * 1e3, warp_instr


def capture(Renderer, Config, frames=("simple", "flagship")):
    """{name: (btable, rays)} of K4's calls and the K2 call's (args, kw):
    the first simple frame's SunShadow call, the first flagship frame's
    RTXDI and RTXDIGI calls (named by the function that makes them) and its
    K2 call; ``frames`` picks the frames rendered."""
    from hobbyrenderer_tpu_torch.ops import beam as beamops
    from hobbyrenderer_tpu_torch.ops import restir_kernel as rko
    calls, k2 = {}, {}
    k4_orig, k2_orig = beamops.beam_any_hit_tiles, rko.restir_candidates
    names = {"_sun_shadow": "SunShadow", "_winner_occlusion": "RTXDI", "restir_gi": "RTXDIGI"}

    def k4_spy(btable, rays):
        who = names.get(sys._getframe(2).f_code.co_name, sys._getframe(2).f_code.co_name)
        if who == "RTXDI":
            who = "RTXDI 2" if "RTXDI 1" in calls else "RTXDI 1"
        calls.setdefault(who, (btable, rays.clone()))
        return k4_orig(btable, rays)

    def k2_spy(*a, **kw):
        k2.setdefault("k2", (a, kw))
        return k2_orig(*a, **kw)

    cfgs = {"simple": dict(), "flagship": dict(direct_mode="restir", indirect_mode="restir")}
    for cache in frames:
        kw_cfg = cfgs[cache]
        r = Renderer(Config(scene="stress", width=1920, height=1080,
                            cache_dir=os.path.join(tempfile.gettempdir(), "hr_bench_k2k4_" + cache),
                            **kw_cfg), device="cuda")
        beamops.beam_any_hit_tiles, rko.restir_candidates = k4_spy, k2_spy
        try:
            r.render_frame()
            torch.cuda.synchronize()
        finally:
            beamops.beam_any_hit_tiles, rko.restir_candidates = k4_orig, k2_orig
            r.shutdown()
    want = (list(K4_CALLS[:1]) if "simple" in frames else []) + \
        (list(K4_CALLS[1:]) if "flagship" in frames else [])
    missing = [n for n in want if n not in calls]
    if missing or ("flagship" in frames and "k2" not in k2):
        raise RuntimeError(f"the frames did not make these calls: {missing or 'K2'}")
    return {n: calls[n] for n in want}, k2.get("k2")


def held_k4(btable, rays):
    """A K4 call of this build held against its plain version and its
    replayed walk: (row, line). ``row`` has ``k4_stats``, the walk's
    counts, the occluded share of the live lanes, mismatches on the active
    lanes (against the plain version) and on all lanes (against the replay), whether three launches are equal, the bound and the plain
    version's ms. The caller adds its times and decides what fails."""
    from hobbyrenderer_tpu_torch import bench_k3
    from hobbyrenderer_tpu_torch.ops import beam as beamops
    got = [beamops.beam_any_hit_tiles(btable, rays) for _ in range(3)]
    ref, _ = beamops.beam_any_hit_tiles_reference(btable, rays)
    walk, visited, work = beamops.beam_walk(btable, rays)
    torch.cuda.synchronize()
    occ, ovf = got[0]
    act = rays[:, 7] > 0.5
    live = act & (rays[:, 6] > 1e-4)
    st = k4_stats(rays)
    bnd = k4_bound(btable, rays, visited, work)
    row = dict(st, **work, rows_read=int(visited.sum()), table_rows=btable.shape[0],
               occluded_share=float(ref[live].mean()) if st["live"] else 0.0,
               mismatches=int(((occ != ref) & act).sum()), max_abs_err=float(
                   (occ - ref)[act].abs().max()) if st["active"] else 0.0,
               replay_mismatches=int((walk != occ).sum()),
               repeat_equal=all(torch.equal(occ, g[0]) and torch.equal(ovf, g[1])
                                for g in got[1:]),
               ovf_nonzero=int((ovf != 0).sum()), bound_ms=bnd[0], bound_by=bnd[1],
               bound_bytes=bnd[2], bound_ops=bnd[3],
               plain_ms=bench_k3.cuda_ms(
                   lambda: beamops.beam_any_hit_tiles_reference(btable, rays), 3, 1))
    line = (f"tiles {st['tiles']}, active lanes {st['active']}, live {st['live']} in "
            f"{st['live_tiles']} tiles, live lanes per live warp (a thread a lane) "
            f"{st['live_per_live_warp']:.2f}, occluded share "
            f"{row['occluded_share']:.4f}; mismatches vs plain {row['mismatches']}/"
            f"{st['active']} active, vs the replayed walk {row['replay_mismatches']}, three "
            f"launches equal {row['repeat_equal']}, ovf nonzero {row['ovf_nonzero']}; rows read "
            f"{row['rows_read']} of {btable.shape[0]}, rows popped {work['interior_rows']} "
            f"interior + {work['leaf_rows']} leaf, the longest lane {work['max_steps']}, lane tests {work['box_tests']} box + "
            f"{work['record_tests']} record; plain {row['plain_ms']:.2f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}; {bnd[2]} B, {bnd[3]} ops)")
    return row, line


def held_k2(args, kw):
    """The K2 call of this build held against its plain version: (row,
    line, outputs). ``row`` has the pixels, candidates, whether each output
    is ``torch.equal`` and three launches are equal, max |d|, the winner
    share, the bound and the plain version's ms."""
    from hobbyrenderer_tpu_torch import bench_k3
    from hobbyrenderer_tpu_torch.ops import restir_kernel as rko
    got = [rko.restir_candidates(*args, **kw) for _ in range(3)]
    ref = rko.restir_candidates_reference(*args, **kw)
    torch.cuda.synchronize()
    names = ("y", "u", "v", "w_sum", "row")
    Hp, Wp = args[2].shape[1:]
    n = kw["num_candidates"]
    bnd = k2_bound(args, got[0], n)
    em = args[0][:, 13] > 0.5                                    # (T, 128) emissive slots
    mixed = []
    for c in range(n):                      # candidate c of 32 neighbouring pixels
        e = em[:, (torch.arange(128, device=em.device) + 17 * c) % 128].reshape(-1, 4, 32)
        mixed.append(float((e.any(-1) & ~e.all(-1)).float().mean()))
    row = dict(pixels=Hp * Wp, candidates=n, emissive_slots=float(em.float().mean()),
               mixed_warps=statistics.mean(mixed),
               equal={k: torch.equal(g, r) for k, g, r in zip(names, got[0], ref)},
               max_abs_err=max(float((g - r).abs().max()) for g, r in zip(got[0], ref)),
               repeat_equal=all(torch.equal(a, b) for g in got[1:] for a, b in zip(got[0], g)),
               winners=float((ref[0] >= 0).float().mean()), bound_ms=bnd[0], bound_by=bnd[1],
               bound_bytes=bnd[2], bound_ops=bnd[3],
               plain_ms=bench_k3.cuda_ms(lambda: rko.restir_candidates_reference(*args, **kw),
                                         3, 1))
    line = (f"pixels {Hp}x{Wp} = {Hp * Wp}, candidates {n}, tiles {tuple(args[0].shape)}; "
            f"outputs equal to plain {row['equal']}, three launches equal {row['repeat_equal']}, "
            f"pixels with a winner {row['winners']:.4f}, emissive slots "
            f"{row['emissive_slots']:.4f}, warps of a tile's slots holding both kinds "
            f"{row['mixed_warps']:.4f}; plain {row['plain_ms']:.2f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}; {bnd[2]} B, {bnd[3]} ops)")
    return row, line, got[0]


def card_line():
    """(name and power limit as nvidia-smi prints them, max SM clock MHz)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    if not smi:
        return "nvidia-smi gave nothing", None
    name, power, clock = (x.strip() for x in smi[0].split(","))
    return f"{name}, {power} W", float(clock)


def turns(reps, base_fn, new_fn):
    """Baseline, this, this, baseline: ([(who, ms)], mean baseline, mean this)."""
    from hobbyrenderer_tpu_torch import bench_k3
    t = [(who, bench_k3.cuda_ms(base_fn if who == "baseline" else new_fn, reps))
         for who in ("baseline", "new", "new", "baseline")]
    return (t, statistics.mean(x for w, x in t if w == "baseline"),
            statistics.mean(x for w, x in t if w == "new"))


def ptxas_lines(build_dir, source, kernel):
    """The -Xptxas -v lines of ``kernel`` in ``source``'s part of the build log."""
    lines = []
    for p in os.listdir(build_dir):
        if p.endswith(".ptxas.txt"):
            with open(os.path.join(build_dir, p)) as f:
                text = f.read()
            part = text[text.index(f"== {source}"):].split("\n== ")[0]
            keep = False
            for x in part.splitlines():
                if "Compiling entry" in x:
                    keep = kernel in x
                if keep and ("Compiling entry" in x or "registers" in x or "spill" in x):
                    lines.append("  ptxas: " + x.strip())
    return lines


def main(argv=None):
    from hobbyrenderer_tpu_torch import bench_k3
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", default=None,
                    help="the root of another checkout whose K2 and K4 are timed in turns")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_k2k4 times the CUDA kernels: it needs an NVIDIA GPU")
    from hobbyrenderer_tpu_torch import kernels
    from hobbyrenderer_tpu_torch.config import Config
    from hobbyrenderer_tpu_torch.ops import beam as beamops
    from hobbyrenderer_tpu_torch.ops import restir_kernel as rko
    from hobbyrenderer_tpu_torch.renderer import Renderer

    card, clock = card_line()
    print(f"{card}, max SM clock {clock} MHz", flush=True)
    t0 = time.perf_counter()
    lib = kernels.library()
    base_beam = base_rk = base_lib = None
    if args.baseline:
        base_beam = bench_k3.load_baseline(args.baseline, "ops.beam")
        base_rk = bench_k3.load_baseline(args.baseline, "ops.restir_kernel")
        base_lib = base_beam.kernels.library()
        base_rk.kernels.library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for src, k in (("beam_any_hit.cu", "beam"), ("restir_candidates.cu", "restir_candidates")):
        print("\n".join(ptxas_lines(kernels.BUILD_DIR, src, k)), flush=True)
    sass = {}
    for who, path, name in (("new", lib._name, "restir_candidates_kernel"),
                            ("baseline", base_lib and base_lib._name, "restir_candidates_kernel")):
        if path:
            try:
                sass[who] = sass_counts(path, name)
            except Exception as e:       # noqa: BLE001
                sass[who] = {"error": repr(e)}
    print(f"K2 SASS: {json.dumps(sass)}", flush=True)

    t0 = time.perf_counter()
    k4_calls, (k2_args, k2_kw) = capture(Renderer, Config)
    print(f"captured {len(k4_calls)} K4 calls and the K2 call in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rows, failures = {"K4": {}, "K2": {}}, []
    for name, (btable, rays) in k4_calls.items():
        row, line = held_k4(btable, rays)
        new = lambda: beamops.beam_any_hit_tiles(btable, rays)
        if base_beam is not None:
            old = lambda: base_beam.beam_any_hit_tiles(btable, rays)
            bo = old()[0]
            ref = beamops.beam_any_hit_tiles(btable, rays)[0]
            row["baseline_mismatches"] = int(((bo != ref) & (rays[:, 7] > 0.5)).sum())
            row["turns"], row["baseline_ms"], row["ms"] = turns(args.reps, old, new)
        else:
            row["ms"] = bench_k3.cuda_ms(new, args.reps)
        rows["K4"][name] = row
        print(f"K4 {name}: {line}; kernel {row['ms']:.4f} ms"
              + (f", baseline {row['baseline_ms']:.4f} ms (mismatches vs this "
                 f"{row['baseline_mismatches']}; turns "
                 f"{[(w, round(t, 4)) for w, t in row['turns']]})"
                 if base_beam is not None else ""), flush=True)
        if row["mismatches"] > 1e-4 * row["active"] or row["replay_mismatches"] \
                or not row["repeat_equal"] or row["ovf_nonzero"]:
            failures.append(f"K4 {name}: mismatches {row['mismatches']}, replay "
                            f"{row['replay_mismatches']}, repeat {row['repeat_equal']}")

    row, line, out = held_k2(k2_args, k2_kw)
    row["issue_ms"], row["issue_warp_instructions"] = k2_issue(
        sass["new"], row["pixels"], row["candidates"], clock)
    new = lambda: rko.restir_candidates(*k2_args, **k2_kw)
    if base_rk is not None:
        bo = base_rk.restir_candidates(*k2_args, **k2_kw)
        row["baseline_equal"] = all(torch.equal(a, b) for a, b in zip(bo, out))
        row["baseline_issue_ms"] = k2_issue(sass["baseline"], row["pixels"],
                                            row["candidates"], clock)[0]
        row["turns"], row["baseline_ms"], row["ms"] = turns(
            args.reps, lambda: base_rk.restir_candidates(*k2_args, **k2_kw), new)
    else:
        row["ms"] = bench_k3.cuda_ms(new, args.reps)
    rows["K2"] = row
    fmt = lambda x: "n/a" if x is None else f"{x:.4f}"
    print(f"K2: {line}, issue-rate estimate {fmt(row['issue_ms'])} ms at {clock} MHz; kernel "
          f"{row['ms']:.4f} ms"
          + (f", baseline {row['baseline_ms']:.4f} ms (equal {row['baseline_equal']}, issue "
             f"estimate {fmt(row['baseline_issue_ms'])} ms; turns "
             f"{[(w, round(t, 4)) for w, t in row['turns']]})" if base_rk is not None else ""),
          flush=True)
    if not all(row["equal"].values()) or not row["repeat_equal"]:
        failures.append(f"K2: equal {row['equal']}, repeat {row['repeat_equal']}")
    if base_rk is not None and not row["baseline_equal"]:
        failures.append("K2: the baseline differs from this build")
    print(json.dumps({"card": card, "max_sm_clock_mhz": clock, "sass_k2": sass, "calls": rows,
                      "failures": failures}), flush=True)
    if failures:
        raise SystemExit("K2 / K4 failed: " + "; ".join(failures))


if __name__ == "__main__":
    main()
