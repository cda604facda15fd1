"""K3's live rays a second: the lanes live into the path tracer's
closest-hit and NEE any-hit walks (the program's counters ``pt_live_b`` and
``pt_nee_b`` of the traced frames, kept by its tracer) over the device time
of the bvh16 walk kernels in the same frames' trace, in millions. None
where the program keeps no such counters."""
import re


def read(ctx):
    from hobbyrenderer_tpu_torch.utils.timing import PROFILER
    if ctx.trace is None:
        return None
    rays = sum(v for f in getattr(PROFILER, "frames", ()) if f.profiled
               for k, v in f.counts().items() if re.fullmatch(r"pt_(live|nee)_\d+", k))
    busy_s = sum(e - s for n, s, e in ctx.trace.kernels if "bvh16_walk" in n) / 1e6
    if not rays or busy_s <= 0:
        return None
    return rays / busy_s / 1e6
