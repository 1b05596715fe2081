"""Host time of the health loop's bookkeeping a dispatch: the
``solver.check`` spans (one an outer step: mass, finiteness, marginal
error, the iterate's update, the verdict's read) under each of the
window's ``serve.dispatch`` or ``solve.dispatch`` spans, from its
roll-up, averaged over them."""
from portbench.dispatch_spans import SECONDS, mean_sub


def read(ctx):
    return mean_sub(ctx, "solver.check", SECONDS)
