"""Blocking reads of the card a dispatch: the number of
``solver.host_read`` spans under each of the window's ``serve.dispatch``
or ``solve.dispatch`` spans, from its roll-up, averaged over them."""
from portbench.dispatch_spans import COUNT, mean_sub


def read(ctx):
    return mean_sub(ctx, "solver.host_read", COUNT)
