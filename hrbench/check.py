"""The comparison that decides ``correct``.

What the armed frame captured (``capture.py``) is held against the plain
reference on the world it works out itself from the scene snapshot: the
triangles of ``reference.py`` for the walks, and for the path tracer the
configuration's reference module (``ref_path.py`` by default), handed in
as ``ref``, which offers ``World``, ``T_MIN``, ``rand3``,
``primary_dirs``, ``bounce``, ``finish``, ``capacity_keep`` and
``tonemap``:

- ``closest_bad_share`` / ``shadow_bad_share``: of the sampled K3 walks'
  closest-hit and any-hit rays, the share whose hit or miss (occlusion)
  differs from the reference's, or whose distance differs by more than
  ``T_TOL`` x max(t, 1). A ray is judged where its walk gave it a live
  interval (t_max > t_min) and did not spend the walk's step budget (those
  report what they found, by design; their share is printed, not judged).
- ``shade_bad_share``: of the sampled pixels' live lanes at every bounce,
  the share whose state after the bounce (alive, direction, origin,
  throughput, medium, pdf, and the radiance the bounce added) departs from
  the reference's bounce run on the same state going in. Followed step by
  step from the program's own state.
- ``chain_bad_share``: of the same lanes, the share whose state going
  into a bounce is not what the step before handed on: bounce 0 against
  the reference's primary rays; later bounces against the previous
  bounce's output, through the wavefront's capacity roulette (a lane kept
  where its uniform is under p_keep, its throughput over p_keep). Where the
  program's count of frames accumulated before the armed one is not the
  harness's (``frames_before``), every lane is counted bad.
- ``pixel_bad_share``: of the sampled pixels, the share whose frame
  radiance is not the mean over samples of what the bounces added, whose
  running average is not the last one blended with it at weight 1 / (n +
  1), or whose LDR value is off the tonemapped average by more than 1.
- ``primary_lane_shortfall``: over the window's frames, the most primary
  lanes (W x H x spp a frame) that the first closest-hit walk did not walk.
- ``*_rays``, ``shade_lanes``: how many were compared; too few is a frame
  that did not walk or shade, and fails.

``control=True`` puts the reference, computed in bfloat16, in the
program's place: the walks, the bounces, the hand-over between bounces
(the primary rays, the compacted state) and the frame's sums, running
average and tonemap. Each number must then read over its limit."""

from __future__ import annotations

import numpy as np
import torch

from hrbench import reference

T_TOL = 1e-4
TMAX_CAP = 1e30             # a closest-hit walk's interval: (T_MIN, TMAX_CAP)
SHADE_RTOL = 1e-3           # a bounce's outputs: relative to their size
DIR_ATOL = 1e-3             # unit vectors' components
CHAIN_RTOL = 1e-6           # hand-over between bounces: the same bits, or p_keep's rounding
PRIMARY_ATOL = 1e-4         # bounce 0's directions against the reference's camera
PIXEL_RTOL = 1e-4           # sums over a pixel's lanes, the running average

# limits: set from the readings in PERF.md (sound runs: lower; the bfloat16
# control and the planted faults: upper)
LIMITS = {"closest_bad_share": 0.01, "shadow_bad_share": 0.005, "shade_bad_share": 0.05,
          "chain_bad_share": 0.005, "pixel_bad_share": 0.01, "primary_lane_shortfall": 0}
MIN_COUNTS = {"closest_rays": 1000, "shadow_rays": 1000, "shade_lanes": 1000}


def _cat(walks, key):
    return torch.cat([w[key] for w in walks])


def compare_walks(walks, tris, control: bool = False) -> dict:
    """``*_bad_share``, ``*_rays`` and ``capped_share`` of the sampled K3
    walks against the triangles (T, 3, 3)."""
    dev = tris.device
    out = {}
    capped_total = seen_total = 0
    for kind, name in (("closest", "closest"), ("any", "shadow")):
        ws = [w for w in walks if w["kind"] == kind]
        if not ws:
            out[name + "_bad_share"], out[name + "_rays"] = 1.0, 0
            continue
        o, d = _cat(ws, "o").to(dev), _cat(ws, "d").to(dev)
        t_max, t_min = _cat(ws, "t_max").to(dev), _cat(ws, "t_min").to(dev)
        t, tri = _cat(ws, "t").to(dev), _cat(ws, "tri").to(dev)
        live = t_max > t_min
        capped = _cat(ws, "capped").to(dev) & live
        if kind == "any":
            capped = capped & (tri < 0)      # a found occluder is an answer
        keep = live & ~capped
        seen_total += int(live.sum())
        capped_total += int(capped.sum())
        o, d, t_min, t_max, t, tri = (x[keep] for x in (o, d, t_min, t_max, t, tri))
        any_hit = kind == "any"
        ref_t = reference.trace(tris, o, d, t_min, t_max, any_hit=any_hit)
        if control:
            prog_t = reference.trace(tris, o, d, t_min, t_max, any_hit=any_hit,
                                     dtype=torch.bfloat16)
            prog_hit = torch.isfinite(prog_t)
        else:
            prog_t = t
            prog_hit = (tri >= 0) & (t < t_max)
        ref_hit = torch.isfinite(ref_t)
        bad = prog_hit != ref_hit
        if not any_hit:
            both = prog_hit & ref_hit
            gap = torch.where(both, (prog_t - ref_t).abs() / torch.clamp(ref_t, min=1.0), 0.0)
            bad = bad | (gap > T_TOL)
        n = int(keep.sum())
        out[name + "_bad_share"] = float(bad.sum()) / max(n, 1)
        out[name + "_rays"] = n
    out["capped_share"] = capped_total / max(seen_total, 1)
    return out


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _close(a, b, rtol, atol):
    """(N,) True where every component of a is within rtol |b| + atol of b."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    if a.dim() == 1:
        a, b = a[:, None], b[:, None]
    ok = (a - b).abs() <= rtol * b.abs() + atol
    ok = ok | ((a == b) & torch.isfinite(b))
    return ok.all(-1)


def shade_lanes(ref, W, rec: dict, camera: dict, rr_start: int, control: bool):
    """(compared, bad) lanes of one captured bounce against the
    reference ``ref``'s bounce run on the same state going in."""
    sel = torch.nonzero(rec["found"]).reshape(-1)
    if sel.numel() == 0:
        return 0, 0
    inp = {k: v[sel] for k, v in rec["inp"].items()}
    prog = {k: v[sel] for k, v in rec["out"].items()}
    n = int(sel.numel())
    t, tri = reference.trace(W.tris, inp["o"], inp["d"], torch.full((n,), ref.T_MIN,
                                                                    device=W.device),
                             torch.full((n,), TMAX_CAP, device=W.device), with_tri=True)
    u, v = reference.barycentrics(W.tris, tri, inp["o"], inp["d"])
    lanes = dict(inp, radiance=torch.zeros_like(inp["radiance"]))

    def run(dtype):
        out, sh = ref.bounce(W, lanes, rec["b"], (t, tri, u, v), camera["proj11"],
                             camera["height"], rr_start, dtype=dtype)
        occ = torch.zeros((n,), dtype=torch.bool, device=W.device)
        live = torch.nonzero(sh["live"]).reshape(-1)
        if live.numel():
            occ[live] = torch.isfinite(reference.trace(
                W.tris, sh["o"][live], sh["d"][live],
                torch.full((live.numel(),), ref.T_MIN, device=W.device),
                sh["t_max"][live], any_hit=True))
        return ref.finish(out, occ)
    want = run(torch.float32)
    if control:
        prog = run(torch.bfloat16)
        prog_inc = prog["radiance"]
    else:
        prog_inc = prog["radiance"] - inp["radiance"]
    # the bounce's own radiance: the subtraction leaves a few ulps of what came in
    rad_ok = _close(prog_inc, want["radiance"], SHADE_RTOL,
                    1e-6 + 4.0 * float(np.finfo(np.float32).eps) * inp["radiance"].abs())
    both = prog["active"] & want["active"]
    scale = torch.clamp(want["o"].abs().amax(-1, keepdim=True), min=1.0)
    live_ok = (_close(prog["d"], want["d"], 0.0, DIR_ATOL)
               & _close(prog["o"], want["o"], 0.0, SHADE_RTOL * scale)
               & _close(prog["throughput"], want["throughput"], SHADE_RTOL, 1e-6)
               & _close(prog["sigma_t"], want["sigma_t"], SHADE_RTOL, 1e-6)
               & _close(prog["prev_pdf"], want["prev_pdf"], SHADE_RTOL, 1e-6)
               & (prog["inside"] == want["inside"]))
    ok = rad_ok & (prog["active"] == want["active"]) & (~both | live_ok)
    return n, int((~ok).sum())


def compare_paths(ref, W, path: dict, camera: dict, rr_start: int,
                  control: bool = False) -> dict:
    """``shade_*``, ``chain_bad_share`` and ``pixel_bad_share`` of the path
    tracer's armed frame against the reference module ``ref`` on its world
    ``W``. ``camera``: pos, target, fov_y, proj11, height, width,
    frame_index, frames_before (frames since the accumulation restarted,
    by the traffic mix)."""
    if path is None or not path["bounces"] or "ldr" not in path:
        return {"shade_bad_share": 1.0, "shade_lanes": 0, "chain_bad_share": 1.0,
                "pixel_bad_share": 1.0}
    dev = W.device
    spp, K = path["spp"], path["pix"].shape[0]
    pix_l = path["pix"].repeat_interleave(spp)
    s_l = torch.arange(spp, device=dev).repeat(K)
    frame_l = path["accum_index"] * spp + s_l
    recs = path["bounces"]

    # bounce 0: every sample's primary ray
    r0 = recs[0]
    ju, jv, _ = ref.rand3(pix_l, frame_l, 0)
    d_ref = ref.primary_dirs(np.asarray([0.0, 1.0, 0.0]), camera["pos"], camera["target"],
                             camera["fov_y"], camera["width"], camera["height"],
                             camera["frame_index"], pix_l, ju, jv)
    i0 = dict(r0["inp"])
    found0 = r0["found"]
    cam = torch.as_tensor(np.asarray(camera["pos"], np.float32), device=dev)
    if control:
        i0.update(d=_bf16(d_ref), o=_bf16(cam.expand_as(i0["o"])))
        found0 = torch.ones_like(found0)
    ok0 = (found0 & (r0["b"] == 0) & _close(i0["d"], d_ref, 0.0, PRIMARY_ATOL)
           & _close(i0["o"], cam.expand_as(i0["o"]), 1e-6, 1e-6)
           & (i0["throughput"] == 1).all(-1) & (i0["radiance"] == 0).all(-1)
           & ~i0["inside"] & (i0["sigma_t"] == 0).all(-1) & (i0["prev_pdf"] == 0))
    chain_n, chain_bad = K * spp, int((~ok0).sum())

    # hand-over from bounce b to b + 1
    for a, z in zip(recs, recs[1:]):
        alive = a["found"] & a["out"]["active"]
        if z["size"] != a["size"]:
            u_c, p_keep = ref.capacity_keep(pix_l, frame_l, z["b"], z["size"],
                                            int(a["n_out"]))
            expect = alive & (u_c < p_keep)
        else:
            p_keep, expect = 1.0, alive
        ao, zi, found = a["out"], z["inp"], z["found"]
        if control:
            zi = dict(zi, **{k: _bf16(ao[k]) for k in ("o", "d", "sigma_t", "prev_pdf")},
                      throughput=_bf16(ao["throughput"] / np.float32(p_keep)))
            found = expect
        carried = (_close(zi["o"], ao["o"], CHAIN_RTOL, 0.0)
                   & _close(zi["d"], ao["d"], CHAIN_RTOL, 0.0)
                   & _close(zi["sigma_t"], ao["sigma_t"], CHAIN_RTOL, 0.0)
                   & _close(zi["prev_pdf"], ao["prev_pdf"], CHAIN_RTOL, 0.0)
                   & (zi["inside"] == ao["inside"])
                   & _close(zi["throughput"], ao["throughput"] / np.float32(p_keep),
                            CHAIN_RTOL, 0.0)
                   & (zi["pix"] == pix_l) & (zi["frame"] == frame_l))
        bad = (expect != found) | (found & ~carried)
        chain_n += int((alive | found).sum())
        chain_bad += int(bad.sum())
        if z["b"] != a["b"] + 1:
            chain_bad += K * spp
    if path["accum_index"] != camera["frames_before"]:
        chain_bad = chain_n

    # the bounces themselves
    shade_n = shade_bad = 0
    for rec in recs:
        n, nb = shade_lanes(ref, W, rec, camera, rr_start, control)
        shade_n += n
        shade_bad += nb

    # the frame: the mean over samples, the running average, the LDR value
    added = torch.zeros((K * spp, 3), device=dev)
    carry = torch.zeros((K * spp, 3), device=dev)
    for rec in recs:
        inc = rec["out"]["radiance"] - rec["inp"]["radiance"]
        added = added + torch.where(rec["found"][:, None], inc, 0.0)
        carry = torch.maximum(carry, torch.where(rec["found"][:, None],
                                                 rec["out"]["radiance"].abs(), 0.0))
    rad_ref = added.reshape(K, spp, 3).sum(1) / spp
    slack = 1e-6 + 16.0 * float(np.finfo(np.float32).eps) * carry.reshape(K, spp, 3).sum(1)
    n_before = camera["frames_before"] * spp
    w = np.float32(spp) / (np.float32(n_before) + np.float32(spp))

    def blend(before, rad):
        return before * float(np.float32(1.0) - w) + rad * float(w)
    rad, acc, ldr = path["rad"], path["accum_after"], path["ldr"]
    if control:
        lo = torch.bfloat16
        rad = (added.to(lo).reshape(K, spp, 3).sum(1) / spp).float()
        acc = blend(path["accum_before"].to(lo), rad.to(lo)).float()
        ldr = ref.tonemap(acc.to(lo), path["exposure"].to(lo))
    ok_rad = _close(rad, rad_ref, PIXEL_RTOL, slack)
    ok_acc = _close(acc, blend(path["accum_before"], rad), PIXEL_RTOL, 1e-7)
    ldr_ref = ref.tonemap(acc, path["exposure"])
    ok_ldr = ((ldr.to(torch.int32) - ldr_ref.to(torch.int32)).abs() <= 1).all(-1)
    pixel_bad = int((~(ok_rad & ok_acc & ok_ldr)).sum())
    return {"shade_bad_share": shade_bad / max(shade_n, 1), "shade_lanes": shade_n,
            "chain_bad_share": chain_bad / max(chain_n, 1), "pixel_bad_share": pixel_bad / K}


def judge(numbers: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) from the compared numbers."""
    checks = {}
    ok = True
    for k, lim in LIMITS.items():
        checks[k] = {"value": numbers[k], "limit": lim}
        ok &= numbers[k] <= lim
    for k, lo in MIN_COUNTS.items():
        checks[k] = {"value": numbers[k], "limit": lo}
        ok &= numbers[k] >= lo
    return bool(ok), checks
