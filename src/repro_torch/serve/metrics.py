"""Server observability — request/batch counters and latency percentiles
(counterpart of ``repro.serve.metrics``).

One ``ServeMetrics`` instance rides on each :class:`~repro_torch.serve.
server.GWServer`; every counter is host-side bookkeeping (no device
syncs), and :meth:`summary` flattens everything — including the geometry
cache's hit/miss/eviction stats — into one JSON-ready dict with the
reference's keys.

Latency samples live in bounded :class:`~repro_torch.obs.registry.
Reservoir` stores (exact percentiles up to ``sample_cap`` = 8192 samples,
uniform reservoir sampling beyond). Every counter and latency is also
mirrored into the process-wide obs registry under the reference's
``repro_serve_*`` names, so the Prometheus exporter
(``GWServer.metrics_text()`` / ``launch/serve.py --metrics-port``) sees
server traffic. ``percentiles`` is re-exported from
``repro_torch.obs.registry`` as in the reference.
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.obs.registry import (  # noqa: F401 — re-exported
    DEFAULT_QS,
    DEFAULT_RESERVOIR_CAP,
    Reservoir,
    percentiles,
    registry,
)


class ServeMetrics:
    """Counters + bounded latency recorder for one server instance.

    sample_cap — reservoir size for latency/queue-wait samples: exact
    percentiles up to this many completed requests, a uniform sample of
    the full history beyond (default 8192; memory stays O(cap) forever).
    """

    def __init__(self, sample_cap: int = DEFAULT_RESERVOIR_CAP):
        self.n_submitted = 0
        self.n_completed = 0
        self.n_failed = 0        # unhealthy after the batched attempt
        self.n_fallbacks = 0     # per-request fallback re-solves taken
        self.n_batches = 0
        self.n_lanes = 0         # total dispatched lanes incl. filler
        self.n_filler_lanes = 0
        self.sample_cap = sample_cap
        self.latencies_s = Reservoir(sample_cap)
        self.queue_waits_s = Reservoir(sample_cap)
        self._t0 = time.perf_counter()

    # -- recording ----------------------------------------------------------

    def record_submit(self) -> float:
        self.n_submitted += 1
        registry().counter("repro_serve_requests_total",
                           "requests submitted to GWServer").inc()
        return time.perf_counter()

    def record_batch(self, n_real: int, n_lanes: int) -> None:
        self.n_batches += 1
        self.n_lanes += n_lanes
        self.n_filler_lanes += n_lanes - n_real
        reg = registry()
        reg.counter("repro_serve_batches_total",
                    "vmapped batches dispatched").inc()
        reg.counter("repro_serve_lanes_total",
                    "dispatched lanes incl. filler").inc(n_lanes)
        reg.counter("repro_serve_filler_lanes_total",
                    "pow2-padding filler lanes dispatched").inc(
                        n_lanes - n_real)

    def record_result(self, submitted_at: float, dispatched_at: float,
                      failed: bool, fell_back: bool) -> float:
        now = time.perf_counter()
        latency = now - submitted_at
        queue_wait = dispatched_at - submitted_at
        self.n_completed += 1
        self.latencies_s.add(latency)
        self.queue_waits_s.add(queue_wait)
        if failed:
            self.n_failed += 1
        if fell_back:
            self.n_fallbacks += 1
        reg = registry()
        reg.histogram("repro_serve_latency_seconds",
                      "submit-to-result request latency").observe(latency)
        reg.histogram("repro_serve_queue_wait_seconds",
                      "submit-to-dispatch queue wait").observe(queue_wait)
        if failed:
            reg.counter("repro_serve_failed_total",
                        "requests unhealthy after the batched attempt").inc()
        if fell_back:
            reg.counter("repro_serve_fallbacks_total",
                        "per-request solo fallback re-solves").inc()
        return latency

    # -- reporting ----------------------------------------------------------

    def summary(self, cache_stats: Optional[dict] = None) -> dict:
        elapsed = time.perf_counter() - self._t0
        lat = percentiles(self.latencies_s)
        out = {
            "n_submitted": self.n_submitted,
            "n_completed": self.n_completed,
            "n_failed": self.n_failed,
            "n_fallbacks": self.n_fallbacks,
            "n_batches": self.n_batches,
            "mean_batch_lanes": (self.n_lanes / self.n_batches
                                 if self.n_batches else 0.0),
            "filler_lane_frac": (self.n_filler_lanes / self.n_lanes
                                 if self.n_lanes else 0.0),
            "throughput_rps": (self.n_completed / elapsed
                               if elapsed > 0 else 0.0),
            "latency_p50_ms": lat["p50"] * 1e3,
            "latency_p95_ms": lat["p95"] * 1e3,
            "latency_p99_ms": lat["p99"] * 1e3,
            "queue_wait_p50_ms": percentiles(
                self.queue_waits_s, (50,))["p50"] * 1e3,
        }
        if cache_stats is not None:
            out.update({f"cache_{k}": v for k, v in cache_stats.items()})
        return out
