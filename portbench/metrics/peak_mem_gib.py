"""``torch.cuda.max_memory_allocated()`` over the window (reset at its
start), in GiB; the inputs the pool holds are part of it."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 2**30
