"""The whole call's share of its bytes roofline, in %: the blur's least
bytes (each uint8 value read once and written once) over the published
3.35 TB/s, divided by the device's busy time per call in the traced window.
It counts the blur's own work, so it reads the same whatever kernels
implement it, and cannot pass 100%."""

from portbench import peaks


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    least = peaks.bound_s(peaks.blur_u8_least_bytes(ctx.values_per_call))
    return 100.0 * least / (ctx.trace.busy_s / ctx.trace.calls)
