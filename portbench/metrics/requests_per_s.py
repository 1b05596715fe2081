"""Requests completed in the window over the time from its start to the
last of them: all the work over all the time (host clock)."""
from portbench import stats


def read(ctx):
    return stats.rate([r.done_s for r in ctx.records], ctx.start_s,
                      ctx.end_s)
