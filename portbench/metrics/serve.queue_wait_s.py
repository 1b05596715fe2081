"""Median submit-to-dispatch wait of the window's requests, as the
server's ``ServeMetrics`` counts it after ``reset_stats()`` at the
window's start."""


def read(ctx):
    return ctx.counters.get("queue_wait_p50_s")
