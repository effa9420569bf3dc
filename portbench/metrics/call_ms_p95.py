"""The 95th percentile of every call's time in the window, from entering
the timed call (``blur_u8``, or ``blur`` and its backward) to the end of its
synchronize (host clock), in ms."""

from portbench.harness import p95


def read(ctx):
    return p95((c.t_done - c.t_enter) * 1e3 for c in ctx.window.calls)
