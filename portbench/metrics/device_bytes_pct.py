"""The whole call's share of its bytes roofline, in %: the call's least
bytes at the published 3.35 TB/s, divided by the device's busy time per call
in the traced window. The least bytes: for ``blur_u8``, each uint8 value read
once and written once (2 bytes a value); for ``blur``, each float32 value
read once and written once (8), and with the backward the cotangent read and
the gradient written too (16). It counts the blur's own work, so it reads the
same whatever kernels implement it, and cannot pass 100%."""

from portbench import peaks


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    traffic = ctx.cell.traffic
    if traffic.get("entry", "blur_u8") == "blur":
        nbytes = peaks.blur_f32_least_bytes(ctx.values_per_call, traffic.get("backward", False))
    else:
        nbytes = peaks.blur_u8_least_bytes(ctx.values_per_call)
    return 100.0 * peaks.bound_s(nbytes) / (ctx.trace.busy_s / ctx.trace.calls)
