"""Mean time a flush waited in the server's queue for its one worker
thread: the ``queued_s`` of the window's ``serve.dispatch`` spans, from
the bucket's flush to the worker's start of it (how long it stood behind
earlier flushes)."""
import statistics


def read(ctx):
    waits = [r["queued_s"] for r in ctx.spans
             if r["name"] == "serve.dispatch" and "queued_s" in r]
    return statistics.fmean(waits) if waits else None
