"""The nearest-rank 95th percentile of the client-side latency, from just
before the request is built to its answer on the host, over every request
sent in the window (those in flight at its close are waited for). A
closed loop at the server's capacity sets this tail by how the clients'
jobs happen to interleave, so it is read per layer, beside the rate."""
from portbench import stats


def read(ctx):
    return stats.percentile([r.latency_s for r in ctx.records], 95)
