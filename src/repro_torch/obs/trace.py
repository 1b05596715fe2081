"""Convergence traces: fixed-size per-iteration buffers of one solve
(counterpart of ``repro.obs.trace``).

A :class:`ConvergenceTrace` holds ``(max_iters,)`` float32 buffers on the
solve's device that ``health/loop.health_loop`` writes once per outer
iteration:

``err``        marginal violation (the loop's convergence criterion)
``objective``  solver objective value (when the solver supplies an
               ``obj_fn``; NaN otherwise)
``delta``      relative iterate movement ‖T_new − T‖₁ / ‖T‖₁
``mass``       total transported mass ‖T‖₁ after the step
``scale``      ε-rescue step scale in effect (``rescue_factor**n_rescues``)
``rescued``    1.0 at iterations where an ε-rescue restart fired

Entries past ``n_iters`` keep their NaN fill: the trace length *is*
``n_iters`` (``scale`` is written at every consumed iteration and is
always finite, so its non-NaN prefix counts iterations; ``mass`` may
hold inf/NaN *inside* the prefix: it records the unhealthy value that
triggered a rescue). The entries are written on the device, so tracing
adds no host read to the loop. Tracing is opt-in (``solver.trace=True``);
when off the trace is ``None`` and the solve does exactly what it does
without this module.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch


class ConvergenceTrace(NamedTuple):
    """Per-outer-iteration history of one solve."""
    err: Any          # (max_iters,) marginal violation per iteration
    objective: Any    # (max_iters,) objective value (NaN if no obj_fn)
    delta: Any        # (max_iters,) relative L1 movement of the iterate
    mass: Any         # (max_iters,) total mass ||T||_1 after the step
    scale: Any        # (max_iters,) rescue step scale in effect
    rescued: Any      # (max_iters,) 1.0 where an eps-rescue fired


def empty_trace(max_iters: int, device=None,
                dtype=torch.float32) -> ConvergenceTrace:
    """NaN-filled trace buffers for a loop of at most ``max_iters``."""
    return ConvergenceTrace(*(torch.full((max_iters,), math.nan, dtype=dtype,
                                         device=device)
                              for _ in ConvergenceTrace._fields))


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def n_valid(trace: ConvergenceTrace) -> int:
    """Number of recorded iterations (non-NaN prefix of ``scale``)."""
    return int(np.sum(np.isfinite(_numpy(trace.scale))))


def trace_to_dict(trace: Optional[ConvergenceTrace],
                  n_iters: Optional[int] = None) -> Optional[dict]:
    """JSON-safe dict of the trace, trimmed to the recorded prefix.

    ``n_iters`` trims explicitly; otherwise the non-NaN prefix of
    ``scale`` is used. Non-finite values inside the prefix (e.g.
    ``objective`` with no ``obj_fn``, or the exploded ``mass`` at a
    rescue iteration) become ``None`` so the result survives strict JSON.
    """
    if trace is None:
        return None
    n = int(n_iters) if n_iters is not None else n_valid(trace)

    def _col(x):
        vals = _numpy(x)[:n].astype(np.float64)
        return [float(v) if np.isfinite(v) else None for v in vals]

    return {"n_iters": n, **{name: _col(getattr(trace, name))
                             for name in ConvergenceTrace._fields}}
