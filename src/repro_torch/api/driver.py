"""Shared outer-loop driver for the port's solvers.

``pga_loop`` is the solver-facing name of the health-instrumented loop
(:func:`repro_torch.health.loop.health_loop`) with the Danskin envelope
of :mod:`repro_torch.diff.fixed_point` around it, as the reference's
``repro.api.driver.pga_loop`` is: the loop runs without autograd and its
result is locally constant in the problem data, so the gradient of a
solver's post-loop value recomputation is the implicit (envelope)
gradient, in one cost contraction and with no graph through the
iterations.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.diff.fixed_point import envelope_loop
from repro_torch.health.loop import LoopResult, health_loop

__all__ = ["pga_loop", "LoopResult", "health_loop"]


def pga_loop(step_fn: Callable, err_fn: Callable, T0, max_iters: int,
             tol: float, **health_kw) -> LoopResult:
    """Iterate ``T <- step_fn(T)`` up to ``max_iters`` times.

    Keyword arguments (``scaled_step``, ``max_rescues``, ``rescue_factor``,
    ``mass_floor``, ``mass_ceil``, ``stall_err``, ``fault``, ``trace``,
    ``obj_fn``) go to :func:`repro_torch.health.loop.health_loop`.

    Autograd treats the whole result as locally constant (the Danskin
    envelope, :func:`repro_torch.diff.fixed_point.envelope_loop`), which
    is the implicit gradient once the caller recomputes its value from
    live data at the returned fixed point.
    """
    return envelope_loop(step_fn, err_fn, T0, max_iters, tol, **health_kw)
