"""``obs.report()``: one JSON document tying the telemetry together
(counterpart of ``repro.obs.report``).

After a traced solve::

    solver = dataclasses.replace(get_solver("spar_gw").default_config(n),
                                 trace=True)
    out = repro_torch.solve(problem, solver, generator=gen)
    doc = repro_torch.obs.report(out)

``doc`` is JSON-serializable and carries:

``solve``     the outcome (value, n_iters, status, rescues) plus the full
              per-iteration convergence trace (trimmed to ``n_iters``)
``spans``     every completed lifecycle span, in start order
``breakdown`` per-stage aggregate (count, total_s) with the headline
              ``compile_s`` / ``dispatch_s`` / ``rescue_s`` /
              ``fallback_s`` splits derived from the span names
``metrics``   a snapshot of the process-wide registry

``repro_torch.solve`` calls :func:`note_solve` on every output, so
``report()`` with no argument describes the most recent solve.

The port has no compilation cache in front of a solve (the reference
jits ``solve`` and marks the dispatches that compiled), so no dispatch
span is ever marked ``compiled`` and ``compile_s`` counts only explicit
``bench.compile`` spans: every ``solve.dispatch`` is dispatch time.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.obs.registry import registry
from repro_torch.obs.span import span_breakdown, spans
from repro_torch.obs.trace import trace_to_dict

_last_solve: Optional[dict] = None


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _solve_section(out: Any, solver: Optional[str] = None) -> dict:
    sec: Dict[str, Any] = {"solver": solver}
    v = _host(out.value)
    sec["value"] = float(v) if v.ndim == 0 else v.astype(float).tolist()
    n_iters = int(out.n_iters)
    sec["n_iters"] = n_iters
    sec["converged"] = bool(out.converged)
    status = getattr(out, "status", None)
    if status is not None:
        sec["status"] = status.describe()
        sec["n_rescues"] = int(status.n_rescues)
    sec["trace"] = trace_to_dict(getattr(out, "trace", None), n_iters)
    return sec


def note_solve(out: Any, solver: Optional[str] = None) -> None:
    """Stash a completed solve for argument-less report()."""
    global _last_solve
    try:
        _last_solve = _solve_section(out, solver)
    except Exception:  # noqa: BLE001 — reporting must never break a solve
        _last_solve = None


def report(out: Any = None, solver: Optional[str] = None) -> dict:
    """One JSON document: solve outcome + trace + spans + metrics."""
    if out is not None:
        solve_sec: Optional[dict] = _solve_section(out, solver)
    else:
        solve_sec = _last_solve
    records = spans()
    agg = span_breakdown(records)

    def _total(*names: str) -> float:
        return sum(agg[n]["total_s"] for n in names if n in agg)

    # dispatches marked compiled=True would be compile time; the port
    # marks none (module docstring)
    compile_s = _total("bench.compile") + sum(
        r["duration_s"] for r in records
        if r["name"] in ("solve.dispatch", "serve.dispatch")
        and r.get("compiled"))
    dispatch_s = sum(
        r["duration_s"] for r in records
        if r["name"] in ("solve.dispatch", "serve.dispatch")
        and not r.get("compiled"))
    breakdown = {
        "by_name": agg,
        "compile_s": compile_s,
        "dispatch_s": dispatch_s,
        "rescue_s": _total("solve.rescue"),
        "fallback_s": _total("solve.fallback", "serve.fallback"),
    }
    doc = {
        "solve": solve_sec,
        "spans": records,
        "breakdown": breakdown,
        "metrics": registry().snapshot(),
    }
    # the contract is "one JSON document": fail here, not in the caller
    json.dumps(doc)
    return doc
