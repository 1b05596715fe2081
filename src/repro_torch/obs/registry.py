"""Process-wide metrics registry: counters, gauges, histograms, exporters
(counterpart of ``repro.obs.registry``, ported nearly verbatim).

One :class:`MetricsRegistry` per process (the module-level default,
reachable via :func:`registry`) that every subsystem registers into; in
the port so far the solve front door (per-status solve counts, rescue,
failure and fallback totals). Two exporters read it:

* :meth:`MetricsRegistry.snapshot` — a JSON-safe nested dict
  (``json.dumps`` round-trips it losslessly), with :meth:`write_jsonl`
  appending one snapshot per line for trajectory logging;
* :meth:`MetricsRegistry.prometheus_text` — Prometheus text exposition
  format (0.0.4), served by :func:`repro_torch.obs.serve_metrics_http`.

Histograms keep a bounded :class:`Reservoir` (exact percentiles up to
``DEFAULT_RESERVOIR_CAP`` = 8192 samples, uniform reservoir sampling
past the cap) alongside fixed Prometheus buckets, so both exporters get
faithful tails without unbounded memory.

All metric objects are thread-safe (one lock per metric; the registry
lock only guards creation), and everything here is plain host-side
Python and numpy: importing this module never touches a device.
"""
from __future__ import annotations

import json
import math
import random
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_QS = (50, 95, 99)

# exact percentiles up to this many samples; uniform reservoir beyond
DEFAULT_RESERVOIR_CAP = 8192

# latency-flavored default buckets (seconds) — Prometheus convention,
# +Inf is implicit
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def percentiles(samples: Sequence[float],
                qs: Sequence[int] = DEFAULT_QS) -> Dict[str, float]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` of ``samples`` (linear
    interpolation; empty input yields NaNs so callers can't mistake "no
    data" for "zero latency")."""
    if len(samples) == 0:
        return {f"p{q}": float("nan") for q in qs}
    arr = np.asarray(list(samples), dtype=np.float64)
    return {f"p{q}": float(np.percentile(arr, q)) for q in qs}


class Reservoir:
    """Bounded sample store: exact below ``cap``, uniform sampling after.

    Behaves as a sequence (``len`` / iteration / indexing) over the
    retained samples so it drops into :func:`percentiles` wherever a
    plain list used to be; ``n_seen`` counts every ``add`` ever made.
    Percentiles are exact while ``n_seen <= cap`` and an unbiased
    estimate (Vitter's algorithm R) beyond it.
    """

    def __init__(self, cap: int = DEFAULT_RESERVOIR_CAP, seed: int = 0):
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        self.cap = cap
        self.n_seen = 0
        self._items: List[float] = []
        self._rng = random.Random(seed)

    def add(self, value: float) -> None:
        self.n_seen += 1
        if len(self._items) < self.cap:
            self._items.append(float(value))
            return
        j = self._rng.randrange(self.n_seen)
        if j < self.cap:
            self._items[j] = float(value)

    append = add        # list-compatible spelling

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, i):
        return self._items[i]


# ---------------------------------------------------------------------------
# Metric primitives
# ---------------------------------------------------------------------------

class Counter:
    """Monotone counter."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self.value += amount


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Histogram:
    """Cumulative-bucket histogram + bounded reservoir for exact tails."""

    __slots__ = ("buckets", "bucket_counts", "count", "sum", "reservoir",
                 "_lock")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS,
                 reservoir_cap: int = DEFAULT_RESERVOIR_CAP):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.bucket_counts = [0] * len(self.buckets)
        self.count = 0
        self.sum = 0.0
        self.reservoir = Reservoir(reservoir_cap)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.sum += value
            for k, ub in enumerate(self.buckets):
                if value <= ub:
                    self.bucket_counts[k] += 1
            self.reservoir.add(value)

    def percentiles(self, qs: Sequence[int] = DEFAULT_QS) -> Dict[str, float]:
        with self._lock:
            items = list(self.reservoir)
        return percentiles(items, qs)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """All label-series of one metric name (one TYPE line per family)."""

    def __init__(self, name: str, kind: str, help: str):
        self.name = name
        self.kind = kind
        self.help = help
        self.series: "Dict[Tuple[Tuple[str, str], ...], object]" = {}


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt_labels(key: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Get-or-create registry of named, optionally labeled metrics."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()
        self._t0 = time.time()

    # -- creation -----------------------------------------------------------

    def _get(self, name: str, kind: str, help: str, factory):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(name, kind, help)
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"requested {kind}")
            if help and not fam.help:
                fam.help = help
            return fam

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        fam = self._get(name, "counter", help, Counter)
        key = _label_key(labels)
        with self._lock:
            if key not in fam.series:
                fam.series[key] = Counter()
            return fam.series[key]

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        fam = self._get(name, "gauge", help, Gauge)
        key = _label_key(labels)
        with self._lock:
            if key not in fam.series:
                fam.series[key] = Gauge()
            return fam.series[key]

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  reservoir_cap: int = DEFAULT_RESERVOIR_CAP,
                  **labels) -> Histogram:
        fam = self._get(name, "histogram", help, Histogram)
        key = _label_key(labels)
        with self._lock:
            if key not in fam.series:
                fam.series[key] = Histogram(buckets, reservoir_cap)
            return fam.series[key]

    def clear(self) -> None:
        """Drop every registered metric (tests / fresh measurement runs)."""
        with self._lock:
            self._families.clear()
            self._t0 = time.time()

    # -- exporters ----------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-safe nested dict of every metric (round-trips through
        ``json.dumps``/``loads`` losslessly — NaN-valued gauges are
        exported as ``None``)."""
        def _num(v: float):
            v = float(v)
            return v if math.isfinite(v) else None

        out: dict = {"uptime_s": time.time() - self._t0, "metrics": {}}
        with self._lock:
            families = {n: (f.kind, f.help, dict(f.series))
                        for n, f in self._families.items()}
        for name, (kind, help_, series) in sorted(families.items()):
            rows = []
            for key, metric in sorted(series.items()):
                row: dict = {"labels": {k: v for k, v in key}}
                if kind == "histogram":
                    pcts = metric.percentiles()
                    row.update({
                        "count": metric.count,
                        "sum": _num(metric.sum),
                        "p50": _num(pcts["p50"]),
                        "p95": _num(pcts["p95"]),
                        "p99": _num(pcts["p99"]),
                        "retained": len(metric.reservoir),
                        "n_seen": metric.reservoir.n_seen,
                    })
                else:
                    row["value"] = _num(metric.value)
                rows.append(row)
            out["metrics"][name] = {"type": kind, "help": help_,
                                    "series": rows}
        return out

    def jsonl_line(self, extra: Optional[dict] = None) -> str:
        """One JSON object line: the snapshot plus caller context."""
        doc = self.snapshot()
        doc["ts"] = time.time()
        if extra:
            doc.update(extra)
        return json.dumps(doc)

    def write_jsonl(self, path, extra: Optional[dict] = None) -> None:
        """Append one snapshot line to ``path`` (JSON-lines sink)."""
        with open(path, "a") as f:
            f.write(self.jsonl_line(extra) + "\n")

    def prometheus_text(self) -> str:
        """The registry in Prometheus text exposition format (0.0.4)."""
        lines: List[str] = []
        with self._lock:
            families = {n: (f.kind, f.help, dict(f.series))
                        for n, f in self._families.items()}
        for name, (kind, help_, series) in sorted(families.items()):
            lines.append(f"# HELP {name} {help_ or name}")
            lines.append(f"# TYPE {name} {kind}")
            for key, metric in sorted(series.items()):
                if kind == "histogram":
                    for ub, c in zip(metric.buckets, metric.bucket_counts):
                        le = 'le="%s"' % _fmt_value(ub)
                        lines.append(
                            f"{name}_bucket{_fmt_labels(key, le)} {c}")
                    inf = 'le="+Inf"'
                    lines.append(
                        f"{name}_bucket{_fmt_labels(key, inf)}"
                        f" {metric.count}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(key)}"
                        f" {_fmt_value(metric.sum)}")
                    lines.append(
                        f"{name}_count{_fmt_labels(key)} {metric.count}")
                else:
                    lines.append(f"{name}{_fmt_labels(key)}"
                                 f" {_fmt_value(metric.value)}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Exposition-format validation (tests and chip_smoke.py)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^{}]*\})?"
    r"\s+(?P<value>[+-]?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|Inf|NaN))"
    r"(?:\s+[+-]?\d+)?$")
_LABELPAIR_RE = re.compile(
    r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"$')


def validate_exposition(text: str) -> int:
    """Validate Prometheus text exposition format; returns the sample
    count. Raises ``ValueError`` on the first malformed line."""
    if not text.endswith("\n"):
        raise ValueError("exposition text must end with a newline")
    n_samples = 0
    for lineno, line in enumerate(text.split("\n"), start=1):
        if not line:
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 3 or not _NAME_RE.match(parts[2]):
                raise ValueError(f"line {lineno}: bad comment: {line!r}")
            if parts[1] == "TYPE" and parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {lineno}: bad TYPE: {line!r}")
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: bad sample: {line!r}")
        labels = m.group("labels")
        if labels:
            body = labels[1:-1]
            if body:
                for pair in re.split(r',(?=[a-zA-Z_])', body):
                    if pair and not _LABELPAIR_RE.match(pair):
                        raise ValueError(
                            f"line {lineno}: bad label {pair!r}")
        n_samples += 1
    return n_samples


# ---------------------------------------------------------------------------
# Process-wide default
# ---------------------------------------------------------------------------

_GLOBAL = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry every subsystem shares."""
    return _GLOBAL
