"""Mean host time of a flush: the ``serve.dispatch`` spans (the server's
worker running one lane-batched flush, values read on the host) that
began in the window."""
import statistics


def read(ctx):
    d = ctx.span_durations("serve.dispatch")
    return statistics.fmean(d) if d else None
