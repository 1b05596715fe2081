"""Host time of the cost evaluations a dispatch: the ``solver.cost`` spans
(one an outer step: the log-kernel's offset and one K1 or K2 launch)
under each of the window's ``serve.dispatch`` or ``solve.dispatch``
spans, from its roll-up, averaged over them."""
from portbench.dispatch_spans import SECONDS, mean_sub


def read(ctx):
    return mean_sub(ctx, "solver.cost", SECONDS)
