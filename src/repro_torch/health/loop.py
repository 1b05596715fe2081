"""The health-instrumented outer loop (counterpart of repro.health.loop).

After every step the new iterate is checked for non-finite entries, mass
collapse (total ℓ1 below ``mass_floor``) and mass explosion (above
``mass_ceil``); an unhealthy iterate is never kept. An unhealthy step
consumes one of ``max_rescues`` restarts: the loop resumes from its last
healthy iterate with the step escalation ``scale = rescue_factor **
n_rescues``, which the solver maps onto ε. When rescue is exhausted the
solve ends DIVERGED at the iteration of first failure. A tolerance-met
solve whose last marginal error exceeds ``stall_err`` is STALLED.

The iterate is a tensor or a tuple of tensors (the low-rank solver's
``(Q, R, g)``); the verdict, the mass and the ``tol`` delta are taken over
all of its leaves, as the reference's ``_tree_l1`` / ``tree_finite`` do.

An optional :class:`~repro_torch.health.faults.FaultSpec` poisons the
iterate at configured iterations, as in the reference: ``site="cost"``
the step's input (the fault transits the cost evaluation and the inner
Sinkhorn), ``"iterate"`` its output. With no fault the loop does exactly
what it did without the hook.

The loop runs on the host, one step at a time: the health verdict of each
step is read on the host (one synchronisation per outer iteration), so no
lane masking is needed.

With ``trace=True`` the loop also fills a
:class:`~repro_torch.obs.trace.ConvergenceTrace`: per iteration the
marginal error, the objective (``obj_fn``, evaluated only then), the
relative movement, the mass, the step scale and the rescue flag, written
into NaN-filled buffers on the iterate's device, so the trace adds no
host read. As in the reference, err/objective/delta describe an accepted
step and mass/scale/rescued every attempt, so a rescued iteration keeps
the exploded mass that triggered it. With ``trace=False`` nothing of this
runs.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.health.faults import FaultSpec
from repro_torch.health.status import (
    CONVERGED,
    DIVERGED,
    MAXITER,
    STALLED,
    SolveStatus,
)
from repro_torch.obs.trace import ConvergenceTrace, empty_trace

_TINY = 1e-30

# iterates with total ℓ1 mass below this are "collapsed" (every entry
# underflowed); above the ceiling they are an overflow in progress
DEFAULT_MASS_FLOOR = 1e-20
DEFAULT_MASS_CEIL = 1e20

# a tolerance-met solve with final marginal ℓ1 violation above this is
# STALLED, not CONVERGED
DEFAULT_STALL_ERR = 0.25


class LoopResult(NamedTuple):
    """What the loop hands back to a solver."""
    iterate: Any            # last healthy iterate
    errors: Any             # (max_iters,) float32 diagnostic, NaN-padded
    n_iters: int            # iterations consumed (including rescue attempts)
    converged: bool         # tolerance met (False under tol=0)
    status: SolveStatus
    trace: Optional[ConvergenceTrace] = None    # None unless trace=True


def _leaves(T):
    return T if isinstance(T, (tuple, list)) else (T,)


def _tree_l1(T):
    return sum(torch.sum(torch.abs(x)) for x in _leaves(T))


def tree_finite(T):
    """0-d bool tensor: every leaf of ``T`` is everywhere finite."""
    return torch.stack([torch.isfinite(x).all() for x in _leaves(T)]).all()


def health_loop(step_fn: Callable, err_fn: Callable, T0, max_iters: int,
                tol: float, *, scaled_step: bool = False,
                max_rescues: int = 0, rescue_factor: float = 2.0,
                mass_floor: float = DEFAULT_MASS_FLOOR,
                mass_ceil: float = DEFAULT_MASS_CEIL,
                stall_err: float = DEFAULT_STALL_ERR,
                fault: Optional[Any] = None,
                trace: bool = False,
                obj_fn: Optional[Callable] = None) -> LoopResult:
    """Iterate ``T <- step_fn(T[, scale])`` with health instrumentation.

    step_fn     — one outer solver step; with ``scaled_step`` it receives
                  ``(T, scale)``, ``scale = rescue_factor**n_rescues``
    err_fn      — per-iteration diagnostic (marginal ℓ1 violation)
    T0          — the first iterate: a tensor or a tuple of tensors
    tol         — stop when sum|T_new - T| / sum|T| (summed over the
                  leaves) <= tol; 0 runs the fixed budget (``converged``
                  stays False)
    max_rescues — divergence restarts before the solve ends DIVERGED
    fault       — optional FaultSpec (see health/faults.py)
    trace       — fill and return a ConvergenceTrace (``result.trace``;
                  None when False)
    obj_fn      — per-iteration objective ``obj_fn(T_new) -> scalar`` for
                  the trace; evaluated only when ``trace=True``
    """
    if fault is not None and not isinstance(fault, FaultSpec):
        raise TypeError(f"fault must be a FaultSpec or None, got "
                        f"{type(fault).__name__}")
    device = _leaves(T0)[0].device
    errors = torch.full((max(max_iters, 0),), math.nan, dtype=torch.float32,
                        device=device)
    tr = empty_trace(max(max_iters, 0), device) if trace else None
    if max_iters <= 0:
        return LoopResult(T0, errors, 0, False, SolveStatus.healthy(MAXITER),
                          tr)

    T = T0
    last_err = None
    fail_iter, n_rescues, conv, dead, i = -1, 0, False, False, 0
    while i < max_iters and not (conv or dead):
        T_in = fault.apply(T, i) if fault is not None and \
            fault.site == "cost" else T
        scale = rescue_factor ** n_rescues
        if scaled_step:
            T_new = step_fn(T_in, scale)
        else:
            T_new = step_fn(T_in)
        if fault is not None and fault.site == "iterate":
            T_new = fault.apply(T_new, i)
        l1 = _tree_l1(T_new)
        healthy = bool(tree_finite(T_new) & (l1 > mass_floor)
                       & (l1 < mass_ceil))
        if trace:
            tr.mass[i] = l1
            tr.scale[i] = scale
            tr.rescued[i] = float(not healthy and n_rescues < max_rescues)
        if healthy:
            err = err_fn(T_new).float()
            errors[i] = err
            last_err = err
            if tol > 0 or trace:
                num = _tree_l1(tuple(x - y for x, y in
                                     zip(_leaves(T_new), _leaves(T))))
                delta = num / torch.clamp_min(_tree_l1(T), _TINY)
            if tol > 0:
                conv = bool(delta <= tol)
            if trace:
                tr.err[i] = err
                tr.delta[i] = delta
                if obj_fn is not None:
                    tr.objective[i] = obj_fn(T_new)
            T = T_new
        else:
            # restart from the current, still-healthy T with escalated
            # scale, or end the solve
            if fail_iter < 0:
                fail_iter = i
            if n_rescues < max_rescues:
                n_rescues += 1
            else:
                dead = True
        i += 1      # rescues consume budget too

    last = math.nan if last_err is None else float(last_err)
    if dead:
        code = DIVERGED
    elif conv and last > stall_err:
        code = STALLED
    elif conv:
        code = CONVERGED
    else:
        code = MAXITER
    return LoopResult(T, errors, i, conv,
                      SolveStatus(code, fail_iter, last, n_rescues), tr)
