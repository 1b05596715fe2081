"""Envelope (Danskin) differentiation of the fixed-point driver
(counterpart of ``repro.diff.fixed_point``).

Every solver computes its reported ``value`` *after* the loop, from live
(differentiable) problem data and the returned coupling, e.g.
``gw_objective(Cx, Cy, T*, loss)`` for dense, ``Σ T*·cost(T*)`` on the
COO support for spar, ``gw_lr_value(Q, R, g, fx, fy)`` for low rank. At
a converged proximal / mirror-descent fixed point, ``T*`` is a
stationary point of the objective ``F`` over the coupling polytope, so
by Danskin's theorem

    dV/dθ = ∂F(θ, T)/∂θ |_{T = T*}          (T* locally constant in θ)

and the coupling's own sensitivity ``dT*/dθ`` contributes nothing. The
loop is therefore declared **locally constant**: :func:`locally_constant`
runs it under ``torch.no_grad()`` and returns detached results, so
autograd builds no graph through the iterations (O(1) memory in the
iteration count, where unrolling costs O(iterations)) and the gradient
flows only through the post-loop value recomputation. That single
contraction *is* the Danskin gradient.

The reference needs ``_closure_convert_all`` and a ``_StaticFn`` wrapper
because a ``jax.custom_vjp`` cannot see through tracers that the
solvers' closures capture. Eager autograd has no tracers: a closure
that captures a tensor requiring grad builds no graph under
``torch.no_grad()``, so the port needs no counterpart of either.

Health semantics (ε-rescues, fault injection, ``trace=True``) pass
through untouched: the envelope wraps the health-instrumented loop, and
a rescue that fires inside the loop changes which fixed point is
reached, never how it is differentiated. Forward-mode differentiation
through the loop is cut along with reverse mode, as in the reference.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.health.loop import LoopResult, health_loop

__all__ = ["envelope_loop", "locally_constant"]


def _detached(x):
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, tuple) and hasattr(x, "_fields"):      # NamedTuple
        return type(x)(*(_detached(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_detached(v) for v in x)
    return x


def locally_constant(fn: Callable, *operands):
    """Run ``fn(*operands)`` declaring the result locally constant in
    every operand: the values are unchanged, autograd sees no path from
    any input (operand or captured tensor) to any output. Tensors in the
    result (nested in tuples, lists and NamedTuples) come back
    detached."""
    with torch.no_grad():
        return _detached(fn(*operands))


def envelope_loop(step_fn: Callable, err_fn: Callable, T0, max_iters: int,
                  tol: float, **health_kw) -> LoopResult:
    """Drop-in ``pga_loop`` with the Danskin envelope installed.

    Same contract as :func:`repro_torch.health.loop.health_loop`; the
    returned :class:`LoopResult` is identical but every field of it
    (iterate, errors, status, trace) is locally constant in the problem
    data. Solvers that recompute their value from live data after the
    loop (all of them) become differentiable; see the module docstring
    for why that gradient is the right one at a converged fixed point.
    """
    return locally_constant(functools.partial(health_loop, **health_kw),
                            step_fn, err_fn, T0, max_iters, tol)
