"""Seconds from the process's start to the window's first call: importing
torch, starting CUDA, loading the built library (building it in a
checkout's first run), making the input pool and the warm-up calls."""


def read(ctx):
    return ctx.window.setup_s
