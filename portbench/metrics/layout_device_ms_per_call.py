"""Device ms a call of the ops launched inside the port's ``layout.*``
spans (the layout copies), from the program's spans in the traced window
(``ctx.program``, ``portbench/program_trace.py``); None without them."""


def read(ctx):
    program = getattr(ctx, "program", None)
    if program is None:
        return None
    return 1e3 * program.device_in("layout.") / program.calls
