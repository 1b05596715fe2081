"""Mean host time of the front door's ``solve.dispatch`` spans (one
solver run, its loop's host reads included) that began in the window."""
import statistics


def read(ctx):
    d = ctx.span_durations("solve.dispatch")
    return statistics.fmean(d) if d else None
