"""Device ms per call of the port's own kernels: the ``__global__``
functions of ``blur_algorithms_tpu_torch/csrc/*.cu``, read from the sources
at the start of the run (the profiler's trace)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return 1e3 * ctx.trace.port_kernel_s() / ctx.trace.calls
