"""Mean host time inside the timed call until it returns (``blur_u8``, or
``blur`` and its backward: routing, plans, wrappers, launches), in ms, from
the benchmark's own span around the call; over the traced run's calls
outside the profiled part, whose host time the profiler inflates."""


def read(ctx):
    if ctx.trace is None:
        return None
    spans = [c.t_return - c.t_enter for c in ctx.window.calls if c.ok and not c.profiled]
    return 1e3 * sum(spans) / len(spans) if spans else None
