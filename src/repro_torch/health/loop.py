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

:func:`health_loop_lanes` is the same loop over the B lanes of a server
flush (the counterpart of the reference's ``vmap`` of this loop): each
step runs on all lanes at once, the verdicts of all lanes are read in one
host read per outer iteration, and a lane that converged, died or ran out
of budget keeps its bits from then on, as the reference's lane freeze
does. Each lane gets the status that :func:`health_loop` gives it solo.

Spans (``repro_torch.obs``): ``solver.check`` over each step's
bookkeeping after ``step_fn`` (fault hook, mass, finiteness, ``err_fn``,
delta, trace writes, the iterate's update, the verdict), and
``solver.host_read`` around each blocking read of the device, with its
``site``: ``"health"`` (the verdict, inside ``solver.check``), ``"tol"``
(the tolerance test of :func:`health_loop`) and ``"last_err"`` (the
last marginal error, once after the loop).

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

import dataclasses
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
from repro_torch.obs.span import span
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
        with span("solver.check"):
            if fault is not None and fault.site == "iterate":
                T_new = fault.apply(T_new, i)
            l1 = _tree_l1(T_new)
            verdict = (tree_finite(T_new) & (l1 > mass_floor)
                       & (l1 < mass_ceil))
            with span("solver.host_read", site="health"):
                healthy = bool(verdict)
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
                    met = delta <= tol
                    with span("solver.host_read", site="tol"):
                        conv = bool(met)
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

    if last_err is None:
        last = math.nan
    else:
        with span("solver.host_read", site="last_err"):
            last = float(last_err)
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


def _poison_lanes(fault: FaultSpec, at_iters, T, i: int):
    """T (B, ...) with the lanes whose fault fires at iteration ``i``
    poisoned; decided on the host from the lanes' ``at_iter``."""
    fires = [dataclasses.replace(fault, at_iter=at).fires(i)
             for at in at_iters]
    if not any(fires):
        return T
    mask = torch.tensor(fires, device=T.device).view(-1, *(1,) * (T.ndim - 1))
    return torch.where(mask, fault._poison(T), T)


def health_loop_lanes(step_fn: Callable, err_fn: Callable, T0,
                      max_iters: int, tol: float, *, max_rescues: int = 0,
                      rescue_factor: float = 2.0,
                      mass_floor: float = DEFAULT_MASS_FLOOR,
                      mass_ceil: float = DEFAULT_MASS_CEIL,
                      stall_err: float = DEFAULT_STALL_ERR,
                      fault: Optional[FaultSpec] = None, at_iters=None,
                      trace: bool = False,
                      obj_fn: Optional[Callable] = None) -> list:
    """:func:`health_loop` over B lanes; returns one LoopResult per lane.

    T0          — (B, ...) the lanes' first iterates, lane first
    step_fn     — ``step_fn(T, scale) -> T_new`` on all lanes at once;
                  ``scale`` is a (B,) float64 tensor, lane b's
                  ``rescue_factor ** n_rescues[b]`` (the step always takes
                  it: a lane's ε-rescue is its own)
    err_fn      — ``err_fn(T_new) -> (B,)`` marginal violations
    obj_fn      — ``obj_fn(T_new) -> (B,)`` objectives, for the trace
    fault       — a FaultSpec whose ``kind``, ``site`` and ``persistent``
                  all lanes share; ``at_iters`` (one int per lane) says
                  when it fires in each lane (default: ``fault.at_iter``
                  in every lane)

    Each iteration computes every lane, keeps the new iterate of the lanes
    that are active and healthy, and reads all lanes' verdicts (health and,
    with ``tol > 0``, the tolerance test) in one host read. The lanes'
    masks and scales go back to the device only when they change (a lane
    finished or took a rescue), since a copy to the device waits for the
    device as a read does. A lane's values are computed on its own data
    only, so its bits do not depend on its mates.
    """
    if fault is not None and not isinstance(fault, FaultSpec):
        raise TypeError(f"fault must be a FaultSpec or None, got "
                        f"{type(fault).__name__}")
    B, dev = T0.shape[0], T0.device
    if fault is not None and at_iters is None:
        at_iters = [int(fault.at_iter)] * B
    red = tuple(range(1, T0.ndim))
    n_max = max(max_iters, 0)
    errors = torch.full((B, n_max), math.nan, dtype=torch.float32,
                        device=dev)
    tr = (ConvergenceTrace(*(torch.full((B, n_max), math.nan,
                                        dtype=torch.float32, device=dev)
                             for _ in ConvergenceTrace._fields))
          if trace else None)

    def lanes(mask):
        return mask.view(-1, *(1,) * (T0.ndim - 1))

    def on_device(values, dtype=torch.bool):
        return torch.tensor(values, dtype=dtype, device=dev)

    def rescue_state():
        return (on_device([rescue_factor ** k for k in n_rescues],
                          torch.float64),
                on_device([k < max_rescues for k in n_rescues]))

    T = T0
    last_err = torch.full((B,), math.nan, dtype=torch.float32, device=dev)
    fail_iter, n_rescues = [-1] * B, [0] * B
    conv, dead, n_iters, accepted_any = ([False] * B for _ in range(4))
    active = [max_iters > 0] * B
    act = on_device(active)
    scale, can_rescue = rescue_state()
    i = 0
    while i < max_iters and any(active):
        T_in = (_poison_lanes(fault, at_iters, T, i)
                if fault is not None and fault.site == "cost" else T)
        T_new = step_fn(T_in, scale)
        with span("solver.check"):
            if fault is not None and fault.site == "iterate":
                T_new = _poison_lanes(fault, at_iters, T_new, i)
            l1 = torch.sum(torch.abs(T_new), dim=red)
            healthy = (torch.isfinite(T_new).flatten(1).all(dim=1)
                       & (l1 > mass_floor) & (l1 < mass_ceil))
            err = err_fn(T_new).float()
            if tol > 0 or trace:
                delta = (torch.sum(torch.abs(T_new - T), dim=red)
                         / torch.clamp_min(torch.sum(torch.abs(T), dim=red),
                                           _TINY))
            met = delta <= tol if tol > 0 else torch.zeros_like(healthy)
            acc = act & healthy
            if trace:
                rescued = (act & ~healthy & can_rescue).float()
                for buf, val in ((tr.mass, l1), (tr.scale, scale.float()),
                                 (tr.rescued, rescued)):
                    buf[:, i] = torch.where(act, val, buf[:, i])
                tr.err[:, i] = torch.where(acc, err, tr.err[:, i])
                tr.delta[:, i] = torch.where(acc, delta, tr.delta[:, i])
                if obj_fn is not None:
                    tr.objective[:, i] = torch.where(
                        acc, obj_fn(T_new).float(), tr.objective[:, i])
            errors[:, i] = torch.where(acc, err, errors[:, i])
            last_err = torch.where(acc, err, last_err)
            T = torch.where(lanes(acc), T_new, T)
            verdicts = torch.stack([healthy, met])
            with span("solver.host_read", site="health"):   # one read
                healthy_h, met_h = verdicts.tolist()
            rescues = 0
            for b in range(B):
                if not active[b]:
                    continue
                n_iters[b] = i + 1      # rescues consume budget too
                if healthy_h[b]:
                    accepted_any[b] = True
                    conv[b] = tol > 0 and bool(met_h[b])
                else:
                    if fail_iter[b] < 0:
                        fail_iter[b] = i
                    if n_rescues[b] < max_rescues:
                        n_rescues[b] += 1
                        rescues += 1
                    else:
                        dead[b] = True
            i += 1
            still = [a and not (c or d) and i < max_iters
                     for a, c, d in zip(active, conv, dead)]
            if still != active and any(still):
                act = on_device(still)
            active = still
            if rescues and any(active):
                scale, can_rescue = rescue_state()

    with span("solver.host_read", site="last_err"):
        last_h = last_err.tolist()
    results = []
    for b in range(B):
        last = last_h[b] if accepted_any[b] else math.nan
        if dead[b]:
            code = DIVERGED
        elif conv[b] and last > stall_err:
            code = STALLED
        elif conv[b]:
            code = CONVERGED
        else:
            code = MAXITER
        results.append(LoopResult(
            T[b], errors[b], n_iters[b], conv[b],
            SolveStatus(code, fail_iter[b], last, n_rescues[b]),
            None if tr is None else ConvergenceTrace(*(x[b] for x in tr))))
    return results
