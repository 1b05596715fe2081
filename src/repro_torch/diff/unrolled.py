"""Unrolled-autograd reference: differentiate *through* the iterations
(counterpart of ``repro.diff.unrolled``).

The correctness and cost baseline for the envelope gradient
(fixed_point.py). Each solver family's outer loop is replayed for its
fixed budget with grad enabled, so autograd records every iteration:
O(iterations) backward time and memory, against the envelope's O(1).
The tests hold the two gradients together at converged fixed points.

Faithfulness contract: given the same config and random inputs, the
unrolled forward pass reproduces the solver's fixed-budget trajectory
(same step math, sampling and init: spar reuses the solver's
``_spar_pga_step``, low rank its ``_md_step`` and init functions),
restricted to what differentiating through the loop allows:

* ``tol = 0`` semantics: the loop has no early stop; the outer ``tol``
  is ignored;
* ``inner_tol = 0`` required: a tolerance-stopped inner solve would make
  the trajectory depend on a host read of the iterates, and the
  reference (whose tolerance-stopped inner solve is a ``while_loop``)
  raises too;
* no health instrumentation: rescues and faults do not exist here.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import torch

from repro_torch.core import sampling
from repro_torch.core.gw import dense_cost, gw_objective
from repro_torch.core.sinkhorn import sinkhorn_log
from repro_torch.core.utils import flush_subnormal, log_floor
from repro_torch.kernels import dispatch
from repro_torch.kernels.spar_cost.ops import make_spar_cost_fn

__all__ = ["unrolled_value"]


def _check_inner_tol(solver):
    if getattr(solver, "inner_tol", 0.0):
        raise ValueError(
            "unrolled_value needs inner_tol=0 (a tolerance-stopped inner "
            "solve is not differentiable through its stop); rebuild the "
            f"config: {type(solver).__name__}(..., inner_tol=0.0)")


def _fused_parts(problem, linear):
    """(α, the linear term) of a fused problem, (1.0, None) otherwise."""
    if not problem.is_fused:
        return 1.0, None
    return problem.fused_penalty, linear()


def _dense_value(problem, solver):
    Cx, a = problem.geom_x.cost_matrix, problem.geom_x.weights
    Cy, b = problem.geom_y.cost_matrix, problem.geom_y.weights
    loss = problem.loss
    alpha, M = _fused_parts(problem, problem.linear_cost_dense)
    T = flush_subnormal(a[:, None] * b[None, :])
    for _ in range(solver.outer_iters):
        C = dense_cost(Cx, Cy, T, loss)
        if M is not None:
            C = alpha * C + (1 - alpha) * M
        logK = -C / solver.epsilon
        if solver.reg == "prox":
            logK = logK + log_floor(T)
        T = sinkhorn_log(a, b, logK, solver.inner_iters, differentiable=True)
    quad = gw_objective(Cx, Cy, T, loss)
    if M is not None:
        return alpha * quad + (1 - alpha) * torch.sum(M * T)
    return quad


def _spar_value(problem, solver, generator, support):
    from repro_torch.api.solvers import _injected_support, _spar_pga_step

    Cx, a = problem.geom_x.cost_matrix, problem.geom_x.weights
    Cy, b = problem.geom_y.cost_matrix, problem.geom_y.weights
    m, n = a.shape[0], b.shape[0]
    probs = sampling.balanced_probs(a, b, solver.shrink)
    if support is None:
        rows, cols = sampling.sample_pairs(generator, probs, solver.s)
    else:
        rows, cols = _injected_support(support, ((solver.s,), (solver.s,)),
                                       m, n, a.device)
    w = 1.0 / (solver.s * probs.pair_prob(rows, cols))
    T = flush_subnormal(a[rows] * b[cols])
    cost_fn = make_spar_cost_fn(Cx, Cy, rows, cols, problem.loss,
                                impl=solver.cost_impl,
                                chunk=solver.cost_chunk)
    alpha, lin = _fused_parts(problem,
                              lambda: problem.linear_cost_at(rows, cols))
    step = partial(_spar_pga_step, cost_fn=cost_fn, a=a, b=b, rows=rows,
                   cols=cols, w=w, logw=torch.log(w), m=m, n=n,
                   epsilon=solver.epsilon, inner_iters=solver.inner_iters,
                   inner_tol=0.0, reg=solver.reg, stable=solver.stable,
                   alpha=alpha, lin=0.0 if lin is None else lin)
    for _ in range(solver.outer_iters):
        T = step(T, 1.0)
    quad = torch.sum(T * cost_fn(T))
    if lin is not None:
        return alpha * quad + (1.0 - alpha) * torch.sum(lin * T)
    return quad


def _lowrank_value(problem, solver, generator, draws):
    from repro_torch.lowrank.factorize import factor_ground
    from repro_torch.lowrank.gradients import gw_lr_value
    from repro_torch.lowrank.init import anchor_init, random_init
    from repro_torch.lowrank.solver import _resolve_draws

    a = problem.geom_x.weights
    b = problem.geom_y.weights
    m, n = problem.shape
    rank, cost_rank = solver._resolve(m, n)
    d = _resolve_draws(draws, generator, problem, solver.init, rank,
                       cost_rank)
    fx = factor_ground(problem.geom_x, problem.loss, "x", d.omega_x)
    fy = factor_ground(problem.geom_y, problem.loss, "y", d.omega_y)
    if solver.init == "anchors":
        state = anchor_init((d.start_x, d.start_y), problem, rank,
                            blend=solver.init_blend)
    else:
        state = random_init(a, b, d.zq, d.zr)
    # Dykstra's tolerance rides on the solver config, not the step
    # signature: enforce the fixed budget here
    md = partial(dataclasses.replace(solver, inner_tol=0.0,
                                     fault=None)._md_step,
                 a=a, b=b, hx=fx.h, hy=fy.h)
    for _ in range(solver.outer_iters):
        state = md(state, 1.0)
    return gw_lr_value(*state, fx, fy)


def unrolled_value(problem, solver, generator=None, *, support=None,
                   draws=None, device=None):
    """Solve ``problem`` with ``solver``'s fixed budget, differentiably,
    by unrolling the outer loop; returns the scalar plug-in value.

    Balanced problems only. Dispatches on the config type:
    DenseGWSolver; SparGWSolver (``generator`` or ``support``);
    LowRankGWSolver (``generator`` or ``draws``). Runs on the card unless
    ``device`` says otherwise.
    """
    from repro_torch.api.solvers import DenseGWSolver, SparGWSolver
    from repro_torch.lowrank.solver import LowRankGWSolver

    if problem.is_unbalanced:
        raise NotImplementedError(
            "unrolled_value covers balanced problems only")
    _check_inner_tol(solver)
    problem = problem.to(dispatch.resolve_device(device))
    if isinstance(solver, DenseGWSolver):
        return _dense_value(problem, solver)
    if isinstance(solver, SparGWSolver):
        if generator is None and support is None:
            raise ValueError("unrolled spar_gw needs the solver's generator "
                             "or its support")
        return _spar_value(problem, solver, generator, support)
    if isinstance(solver, LowRankGWSolver):
        if generator is None and draws is None:
            raise ValueError("unrolled lowrank_gw needs a generator or its "
                             "draws")
        return _lowrank_value(problem, solver, generator, draws)
    raise NotImplementedError(
        f"no unrolled reference for {type(solver).__name__}")
