"""The port's kernels' share of their bytes roofline, in %: the bytes the
port's launches pass a call, at 3.35 TB/s, over the device ms a call of
the port's own kernels in the traced window (the ``__global__`` names of
``csrc/*.cu``). The bytes are the port's own count
(``blur_algorithms_tpu_torch.utils.trace.counters()``: each tensor a launch
passes a pointer to, once), summed over every call of the run, the warm-up
calls and the window's, over their number: a cell's calls are alike. None
where the port counts no bytes or the trace holds none of its kernels."""

from portbench import peaks


def read(ctx):
    if ctx.trace is None or ctx.trace.port_kernel_s() <= 0:
        return None
    try:
        from blur_algorithms_tpu_torch.utils.trace import counters
    except ImportError:
        return None
    total = sum(c["bytes"] for c in counters().values())
    calls = int(ctx.cell.traffic["warmup_calls"]) + len(ctx.window.calls)
    if total <= 0:
        return None
    return 100.0 * peaks.bound_s(total / calls) / (ctx.trace.port_kernel_s() / ctx.trace.calls)
