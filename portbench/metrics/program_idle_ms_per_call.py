"""Device idle ms a call while the host's innermost span was one of the
port's (``api.*``, ``layout.*``, ``launch.*``), from the program's spans in
the traced window (``ctx.program``, ``portbench/program_trace.py``); None
without them."""


def read(ctx):
    program = getattr(ctx, "program", None)
    if program is None:
        return None
    return 1e3 * program.idle_in_port() / program.calls
