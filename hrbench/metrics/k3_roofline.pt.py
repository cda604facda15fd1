"""K3 (the bvh16 walk) in the path tracer: its byte bound (rays in, hits
out, the table read once a walk: roofline.k3_bytes over the HBM peak) over
its device time in the traced frames, %."""
from hrbench.roofline import k3_bytes


def read(ctx):
    if ctx.trace is None:
        return None
    calls = [c for k, c in ctx.calls if k == "k3"]
    busy = sum(e - s for n, s, e in ctx.trace.kernels if "bvh16_walk" in n) / 1e6
    if not calls or busy <= 0:
        return None
    bound = sum(k3_bytes(c["rays"], c["table_rows"]) for c in calls) \
        / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * bound / busy
