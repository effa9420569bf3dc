"""``torch.cuda.max_memory_allocated()`` over the window (reset at its
start, so the resident input pool counts), less the answers that the
reservoir keeps for the judgement (the benchmark's, not the program's), in
GiB."""


def read(ctx):
    if ctx.window.peak_bytes <= 0:
        return None
    return (ctx.window.peak_bytes - ctx.window.kept_bytes) / 2**30
