"""From the start of ``run.py`` to the window's first request: imports,
inputs from the seed, the kernels' build or load, the warm-up."""


def read(ctx):
    return ctx.setup_s
