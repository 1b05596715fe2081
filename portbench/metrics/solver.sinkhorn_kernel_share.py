"""Share of the sparse Sinkhorn loops a dispatch that ran on the card's
half-step kernel (K7): under each of the window's ``serve.dispatch`` or
``solve.dispatch`` spans holding ``solver.sinkhorn`` spans, the count of
``solver.sinkhorn_kernel`` spans over the count of ``solver.sinkhorn``,
from its roll-up, averaged over those dispatches. Nothing to read where no
dispatch holds a ``solver.sinkhorn_kernel`` span."""
import statistics

from portbench.dispatch_spans import COUNT, dispatches


def read(ctx):
    ds = [r["sub"] for r in dispatches(ctx) if "solver.sinkhorn" in r["sub"]]
    if not any("solver.sinkhorn_kernel" in sub for sub in ds):
        return None
    return statistics.fmean(
        sub.get("solver.sinkhorn_kernel", (0, 0.0))[COUNT]
        / sub["solver.sinkhorn"][COUNT] for sub in ds)
