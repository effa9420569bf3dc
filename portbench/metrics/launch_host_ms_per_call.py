"""Mean host ms a profiled call spends in the port's ``launch.*`` spans
(the kernel wrappers' checks, tables, allocations and launches), from the
program's spans in the traced window (``ctx.program``,
``portbench/program_trace.py``); None without them."""


def read(ctx):
    program = getattr(ctx, "program", None)
    if program is None:
        return None
    return 1e3 * program.host_in("launch.") / program.calls
