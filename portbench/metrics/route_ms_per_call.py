"""Mean host ms a profiled call spends in the port's ``api.route`` span
(its checks and routing), from the program's spans in the traced window
(``ctx.program``, ``portbench/program_trace.py``); None without them."""


def read(ctx):
    program = getattr(ctx, "program", None)
    if program is None:
        return None
    return 1e3 * program.host_in("api.route") / program.calls
