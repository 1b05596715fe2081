"""Share of the traced rounds in which no device operation ran (none read
where no device operation was recorded at all). The profiler slows the
host, so this is an upper bound of the unprofiled share."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
