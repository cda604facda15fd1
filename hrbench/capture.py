"""What the harness observes of the program, without a host sync.

``Capture.install`` wraps entry points that the program looks up in their
modules at each call, so the wrappers see every call of the timed path:
``ops.bvh16.bvh16_walk`` (K3: every closest-hit and any-hit walk), and the
path tracer's ``models.pathtracer.trace_paths``, ``_bounce`` and
``PathTracerRenderer.render``.

- In every window frame (``frame_no`` >= 0) the first closest-hit walk is
  the primary wavefront: the lanes it walks live (t_max > t_min) are
  counted on the device (``primary``).
- While ``armed`` (one frame of the window, drawn from the seed), each walk
  keeps a seeded sample of its rays and answers, and the path tracer keeps,
  for a seeded sample of pixels, every sample's lane at every bounce (its
  state going in and coming out), the frame's radiance, the running
  average before and after, the exposure and the LDR frame at those
  pixels: device-side gathers, no copy to the host. Set-up arms its last
  warm-up frame too and then ``reset``s, so that the window's armed frame
  finds its sizes already allocated and its kernels loaded.
- While ``shapes`` is on (the traced frames), each K3 call records its
  sizes, from which ``roofline.py`` counts the bytes.

``uninstall`` puts the program's functions back."""

from __future__ import annotations

import torch

SAMPLE_RAYS = 4096          # rays kept from each walk of the armed frame
SAMPLE_PIXELS = 256         # pixels whose every sample is followed


class Capture:
    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.seed = seed
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed % (1 << 63))
        self.armed = False
        self.shapes = False
        self.frame_no = -1
        self.primary = {}      # window frame -> live lanes of its primary walk (device)
        self.walks = []        # armed frame: dicts of sampled rays and answers
        self.calls = []        # traced frames: (kernel, sizes)
        self.path = None       # armed frame: the path tracer's sampled lanes
        self._saved = []

    def install(self):
        from hobbyrenderer_tpu_torch.models import pathtracer
        from hobbyrenderer_tpu_torch.ops import bvh16
        self._wrap(bvh16, "bvh16_walk", post=self._walk)
        self._wrap(pathtracer, "trace_paths", pre=self._paths_in, post=self._paths_out)
        self._wrap(pathtracer, "_bounce", post=self._bounce)
        self._wrap(pathtracer.PathTracerRenderer, "render", pre=self._render_in,
                   post=self._render_out)
        return self

    def uninstall(self):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved = []

    def reset(self):
        """Forget what an armed frame kept, and start the seeded draws over."""
        self.walks, self.path, self._before = [], None, None
        self.gen.manual_seed(self.seed % (1 << 63))

    def _wrap(self, owner, name, pre=None, post=None):
        real = getattr(owner, name)
        self._saved.append((owner, name, real))

        def wrapped(*args, **kwargs):
            if pre is not None:
                pre(args, kwargs)
            out = real(*args, **kwargs)
            if post is not None:
                post(args, kwargs, out)
            return out
        setattr(owner, name, wrapped)

    def _pick(self, n: int):
        return torch.randint(0, n, (min(SAMPLE_RAYS, n),), generator=self.gen,
                             device=self.device)

    # -- K3 --------------------------------------------------------------------

    def _walk(self, args, kwargs, out):
        names = ("table", "o", "d", "t_max", "any_hit", "max_steps", "t_min")
        a = dict(zip(names, args))
        a.update(kwargs)
        R = int(a["o"].shape[0])
        t_min = float(a.get("t_min", 1e-4))
        if self.shapes:
            self.calls.append(("k3", {"rays": R, "table_rows": int(a["table"].shape[0])}))
        if not a["any_hit"] and self.frame_no >= 0 and self.frame_no not in self.primary:
            self.primary[self.frame_no] = (a["t_max"] > t_min).sum()
        if not self.armed or R == 0:
            return
        best_t, best_tri, steps = out
        idx = self._pick(R)
        self.walks.append(dict(
            kind="any" if a["any_hit"] else "closest",
            o=a["o"][idx], d=a["d"][idx], t_max=a["t_max"][idx],
            t_min=torch.full((idx.shape[0],), t_min, device=self.device),
            t=best_t[idx], tri=best_tri[idx],
            capped=steps[idx] >= int(a.get("max_steps", 1 << 30))))

    # -- the path tracer ---------------------------------------------------------

    def _paths_in(self, args, kwargs):
        if not self.armed:
            return
        names = ("gpu", "rt", "vc", "settings", "height", "width", "accum_index")
        a = dict(zip(names, args))
        a.update(kwargs)
        H, W, spp = int(a["height"]), int(a["width"]), int(a.get("spp", 1))
        R = H * W
        pix = torch.randperm(R, generator=self.gen, device=self.device)[:SAMPLE_PIXELS]
        slot = torch.full((R,), -1, dtype=torch.int64, device=self.device)
        slot[pix] = torch.arange(pix.shape[0], device=self.device)
        self.path = dict(height=H, width=W, spp=spp, accum_index=int(a["accum_index"]),
                         pix=pix, slot=slot, bounces=[])

    def _lanes(self, p):
        """Each sampled (pixel, sample)'s live lane of the wavefront p, or
        -1: (K * spp,) int64."""
        P = self.path
        K, spp = P["pix"].shape[0], P["spp"]
        key = P["slot"][p.pix]
        s = p.frame - P["accum_index"] * spp
        ok = (key >= 0) & p.active & (s >= 0) & (s < spp)
        tgt = torch.where(ok, key * spp + s, K * spp)
        n = p.active.shape[0]
        return torch.full((K * spp + 1,), -1, dtype=torch.int64, device=self.device).scatter_(
            0, tgt, torch.arange(n, dtype=torch.int64, device=self.device))[:K * spp]

    @staticmethod
    def _state(p, li):
        return {k: getattr(p, k)[li] for k in ("o", "d", "radiance", "throughput", "active",
                                               "inside", "sigma_t", "prev_pdf", "pix",
                                               "frame")}

    def _bounce(self, args, kwargs, out):
        if not self.armed or self.path is None:
            return
        p, b = args[5], int(args[6])
        lanes = self._lanes(p)
        li = torch.clamp(lanes, min=0)
        self.path["bounces"].append(dict(
            b=b, size=int(p.active.shape[0]), found=lanes >= 0,
            inp=self._state(p, li), out=self._state(out, li), n_out=out.active.sum()))

    def _paths_out(self, args, kwargs, out):
        if not self.armed or self.path is None:
            return
        rad = out[0] if isinstance(out, tuple) else out
        self.path["rad"] = rad.reshape(-1, 3)[self.path["pix"]]

    def _render_in(self, args, kwargs):
        if not self.armed:
            return
        self._before = args[0].accum.reshape(-1, 3).clone()

    def _render_out(self, args, kwargs, out):
        if not self.armed or self.path is None:
            return
        r = args[0]
        pix = self.path["pix"]
        self.path.update(accum_before=self._before[pix],
                         accum_after=r.accum.reshape(-1, 3)[pix],
                         exposure=r.exposure.clone(), ldr=out.reshape(-1, 3)[pix])
        self._before = None
