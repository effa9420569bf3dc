"""Device ms per call of every operation that is not one of the port's own
kernels: PyTorch's layout copies, conversions and rounding, cuFFT, copies
and sets (the profiler's trace)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return 1e3 * ctx.trace.torch_device_s() / ctx.trace.calls
