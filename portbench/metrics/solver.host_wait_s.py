"""Host time in blocking reads of the card a dispatch: the
``solver.host_read`` spans (the health verdicts, the last marginal
error, the support's range check, a flush's values) under each of the
window's ``serve.dispatch`` or ``solve.dispatch`` spans, from its
roll-up, averaged over them."""
from portbench.dispatch_spans import SECONDS, mean_sub


def read(ctx):
    return mean_sub(ctx, "solver.host_read", SECONDS)
