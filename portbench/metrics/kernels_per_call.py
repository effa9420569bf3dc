"""Device kernels launched per call, the port's and PyTorch's, counted by
the profiler over the traced window."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.trace.calls
