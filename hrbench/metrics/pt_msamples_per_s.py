"""Samples (W x H x spp) of every completed frame over the window's time,
in millions a second."""
from hrbench.window import rate_per_s


def read(ctx):
    return rate_per_s(ctx.window) / 1e6
