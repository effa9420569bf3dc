"""Megapixels per second: the pixels (B x H x W / 1e6) of every call
completed in the window, over the window's seconds (host clock, from its
start to the last call's completion)."""


def read(ctx):
    done = sum(1 for c in ctx.window.calls if c.ok)
    return done * ctx.pixels_per_call / 1e6 / ctx.window.seconds
