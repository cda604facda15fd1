"""Process start to the first timed frame (scene build, upload, BVH, kernel
library, warm-up frames), s."""


def read(ctx):
    return ctx.setup_s
