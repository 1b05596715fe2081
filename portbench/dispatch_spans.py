"""What the readers of the program's solver spans share: the window's
dispatch records and the roll-up each carries.

A dispatch is a ``serve.dispatch`` (the server's worker running one
flush) or a ``solve.dispatch`` (the front door running one solver). Its
record's ``sub`` holds ``[count, seconds]`` of every span that closed
under it, by name, so a reader needs neither the child records nor a
tree walk. A program whose spans carry no ``sub`` gives nothing to read.
"""
import statistics

DISPATCHES = ("serve.dispatch", "solve.dispatch")
COUNT, SECONDS = 0, 1


def dispatches(ctx) -> list:
    """The window's dispatch records that carry a roll-up."""
    return [r for r in ctx.spans if r["name"] in DISPATCHES and "sub" in r]


def mean_sub(ctx, name: str, field: int):
    """Mean over the window's dispatches of ``sub[name][field]``
    (``COUNT`` or ``SECONDS``), a dispatch without the span counting 0;
    ``None`` where no dispatch holds the span."""
    ds = dispatches(ctx)
    if not any(name in r["sub"] for r in ds):
        return None
    return statistics.fmean(r["sub"].get(name, (0, 0.0))[field] for r in ds)
