"""Device ms a call of the layout moves: the ops whose innermost span of the
port's is ``layout.*`` (a move the port dispatches to PyTorch) or
``launch.layout_*`` (the port's layout kernels, launched inside
``layout.*``), from the program's spans in the traced window
(``ctx.program``, ``portbench/program_trace.py``); None without them, or
where the window holds no such span (a call that moves no layout)."""

PREFIXES = ("layout.", "launch.layout_")


def read(ctx):
    program = getattr(ctx, "program", None)
    if program is None or not any(name.startswith(PREFIXES) for name in program.host_s):
        return None
    return 1e3 * sum(program.device_in(p) for p in PREFIXES) / program.calls
