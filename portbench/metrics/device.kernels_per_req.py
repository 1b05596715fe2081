"""Kernel records of the traced rounds (copies and fills left out) over
the requests they answered."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels or not t.requests:
        return None
    return t.kernels / t.requests
