"""Host time of the sparse Sinkhorn loops a dispatch: the
``solver.sinkhorn`` spans (one an outer step, around the whole inner
loop) under each of the window's ``serve.dispatch`` or
``solve.dispatch`` spans, from its roll-up, averaged over them."""
from portbench.dispatch_spans import SECONDS, mean_sub


def read(ctx):
    return mean_sub(ctx, "solver.sinkhorn", SECONDS)
