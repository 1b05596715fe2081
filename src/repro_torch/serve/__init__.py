"""GW-as-a-service: batched, cached, observable solving (counterpart of
``repro.serve``).

The serving front door over ``repro_torch.solve``: size-bucketed request
batching (one lane-batched solve a flush, ``serve/lanes.py``), a
content-hash-keyed geometry artifact cache, asynchronous dispatch to one
worker thread, and per-request health/fallback semantics.

    from repro_torch.serve import GWServer, ServeConfig

    server = GWServer(ServeConfig(max_batch=8))     # on the CUDA card
    rids = [server.submit(p, solver="dense_gw") for p in problems]
    for res in server.results(rids):
        print(res.rid, res.value, res.status_name, res.latency_s)
    print(server.stats())
    server.close()

The reference's ``enable_compilation_cache`` has no counterpart: the
port compiles nothing per shape (see ``ServeConfig``).
"""
from repro_torch.serve.batching import (
    DEFAULT_BUCKETS,
    PAD_WEIGHT,
    batch_signature,
    bucket_for,
    next_pow2,
    pad_geometry,
    pad_problem,
)
from repro_torch.serve.cache import GeometryCache
from repro_torch.serve.metrics import ServeMetrics, percentiles
from repro_torch.serve.server import GWServer, RequestResult, ServeConfig

__all__ = [
    "GWServer",
    "ServeConfig",
    "RequestResult",
    "GeometryCache",
    "ServeMetrics",
    "percentiles",
    "bucket_for",
    "next_pow2",
    "pad_geometry",
    "pad_problem",
    "batch_signature",
    "DEFAULT_BUCKETS",
    "PAD_WEIGHT",
]
