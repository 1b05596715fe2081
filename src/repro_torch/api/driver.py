"""Shared outer-loop driver for the port's solvers.

``pga_loop`` is the solver-facing name of
:func:`repro_torch.health.loop.health_loop`. The reference wraps its loop
in a Danskin-envelope ``custom_vjp`` (``repro/diff``); that gradient
comes with the port of ``diff/``.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.health.loop import LoopResult, health_loop

__all__ = ["pga_loop", "LoopResult", "health_loop"]


def pga_loop(step_fn: Callable, err_fn: Callable, T0, max_iters: int,
             tol: float, **health_kw) -> LoopResult:
    """Iterate ``T <- step_fn(T)`` up to ``max_iters`` times.

    Keyword arguments (``scaled_step``, ``max_rescues``, ``rescue_factor``,
    ``mass_floor``, ``mass_ceil``, ``stall_err``, ``fault``, ``trace``)
    go to :func:`repro_torch.health.loop.health_loop`.
    """
    return health_loop(step_fn, err_fn, T0, max_iters, tol, **health_kw)
