"""100 x (1 - the union of the device's operations / the traced window), %."""
from hrbench.devtrace import union_us


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - union_us(ctx.trace.ops) / 1e6 / ctx.trace.window_s)
