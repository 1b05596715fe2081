"""Telemetry of the port (counterpart of ``repro.obs``).

Three instruments, one report:

* **convergence traces** — :class:`ConvergenceTrace` buffers on the
  solve's device that the health loop fills per outer iteration (opt-in
  via ``solver.trace=True``; ``None`` and bitwise-identical outputs when
  off);
* **solve-lifecycle spans** — :func:`span`, host-side nestable timing
  scopes over the stages of ``solve()``;
* **process-wide metrics** — :func:`registry`, counters/gauges/histograms
  every subsystem registers into, exported as JSON (:meth:`MetricsRegistry.
  snapshot` / ``write_jsonl``) and Prometheus text
  (:meth:`MetricsRegistry.prometheus_text`, served by
  :func:`serve_metrics_http`).

:func:`report` assembles all three into one JSON document.
"""
from repro_torch.obs.http import serve_metrics_http
from repro_torch.obs.registry import (
    DEFAULT_QS,
    DEFAULT_RESERVOIR_CAP,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Reservoir,
    percentiles,
    registry,
    validate_exposition,
)
from repro_torch.obs.report import note_solve, report
from repro_torch.obs.span import (
    MAX_SPANS,
    clear_spans,
    configure,
    span,
    span_breakdown,
    spans,
)
from repro_torch.obs.trace import (
    ConvergenceTrace,
    empty_trace,
    n_valid,
    trace_to_dict,
)

__all__ = [
    "ConvergenceTrace",
    "Counter",
    "DEFAULT_QS",
    "DEFAULT_RESERVOIR_CAP",
    "Gauge",
    "Histogram",
    "MAX_SPANS",
    "MetricsRegistry",
    "Reservoir",
    "clear_spans",
    "configure",
    "empty_trace",
    "n_valid",
    "note_solve",
    "percentiles",
    "registry",
    "report",
    "serve_metrics_http",
    "span",
    "span_breakdown",
    "spans",
    "trace_to_dict",
    "validate_exposition",
]
