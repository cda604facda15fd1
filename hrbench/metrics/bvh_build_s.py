"""The program's host time of the BVH build at set-up
(Renderer.bvh_seconds), s."""


def read(ctx):
    return ctx.bvh_seconds or None
