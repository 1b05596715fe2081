"""Lane-batched execution of one server flush (port-only).

The counterpart of the reference's ``jax.jit(jax.vmap(_run_lane))``
(``repro/serve/server.py``): a flush's lanes run as one batched solve, so
each kernel launch, each step and each host read serves every lane at
once. On the card the GW solves of serving-size problems are
launch-bound, so this is what the serving layer is for there.

An explicit table by solver family (:func:`lane_route`):

* ``dense_gw`` and ``spar_gw`` on balanced problems (fused included: the
  linear term is one more stacked tensor) run lane-batched:
  :func:`repro_torch.health.loop.health_loop_lanes` around a batched
  step, one host read per outer iteration for the whole flush;
  - dense: ``core/gw.dense_cost_lanes`` over (B, m, n) stacks, the inner
    loop ``core/sinkhorn.sinkhorn_log_batched`` (or ``sinkhorn_batched``);
  - spar: each lane draws its own support from its own generator (one
    ``s`` a bucket, since ``s`` is part of the signature); the cost is
    ``ops.make_spar_cost_fn_lanes`` (materialized lanes: one matvec
    launch, K1, a step for the flush), the inner loop the sparse
    Sinkhorn over one segment space of B·m rows and B·n columns;
* every other family (grid, low rank, quantized) and every unbalanced
  problem runs its lanes one after another through ``solver.run`` on the
  server's device.

A lane's ``epsilon``, ``fused_penalty`` and fault ``at_iter`` are its own
(the reference's pytree leaves); every other knob is shared by the
bucket's signature. This is a dispatch, not a ``try``/``except``: a
kernel that fails to build or launch raises, nothing falls back to the
CPU or to a plain version. Flushes run without autograd: a served value
is a number, not a differentiable loss.

The spar lanes record the solo path's spans (``api/solvers.py``):
``solver.sample``, ``solver.cost_build``, one ``solver.cost`` and one
``solver.sinkhorn`` an outer step for the whole flush, ``solver.value``.
"""
from __future__ import annotations

import torch

from repro_torch.api.output import GWOutput, SparseCoupling
from repro_torch.api.solvers import (
    DenseGWSolver,
    SparGWSolver,
    _fused_value,
)
from repro_torch.core import sampling
from repro_torch.core.gw import dense_cost_lanes
from repro_torch.core.sinkhorn import (
    _lane_flat,
    sinkhorn_batched,
    sinkhorn_log_batched,
    sparse_sinkhorn_lanes,
    sparse_sinkhorn_logdomain_lanes,
)
from repro_torch.core.utils import flush_subnormal, log_floor, scalar
from repro_torch.health.loop import health_loop_lanes
from repro_torch.kernels.spar_cost.ops import (
    kernel_route,
    make_spar_cost_fn_lanes,
)
from repro_torch.obs.span import span
from repro_torch.serve.batching import LaneStack

# solver families whose lanes run as one batched solve (balanced problems)
_BATCHED = {DenseGWSolver: "dense", SparGWSolver: "spar"}


def lane_route(problem, solver) -> str:
    """``"dense"`` or ``"spar"`` (one lane-batched solve) or
    ``"sequential"`` (``solver.run`` lane by lane)."""
    if problem.is_unbalanced:
        return "sequential"
    return _BATCHED.get(type(solver), "sequential")


def run_lanes(stack: LaneStack) -> list:
    """One ``GWOutput`` per lane of ``stack`` (all lanes share one batch
    signature, so one route)."""
    route = lane_route(stack.problems[0], stack.solvers[0])
    with torch.no_grad():
        if route == "dense":
            return _dense_lanes(stack)
        if route == "spar":
            return _spar_lanes(stack)
        return [solver.run(problem, generator=gen)
                for problem, solver, gen in zip(*stack)]


def _health_kw(stack: LaneStack) -> dict:
    sv = stack.solvers[0]
    at_iters = (None if sv.fault is None
                else [int(s.fault.at_iter) for s in stack.solvers])
    return dict(max_rescues=sv.max_rescues, rescue_factor=sv.rescue_factor,
                fault=sv.fault, at_iters=at_iters, trace=sv.trace)


def _per_lane(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)


def _plain_kernel_lanes(C, w, T, eps, reg: str):
    """The plain-domain kernel of each lane (``_plain_kernel`` of the solo
    solvers): ``eps`` (B, 1, ...) broadcasts over a lane's entries."""
    Cs = C - torch.amin(C, dim=tuple(range(1, C.ndim)), keepdim=True)
    K = flush_subnormal(flush_subnormal(torch.exp(-Cs / eps)) * w)
    if reg == "prox":
        K = flush_subnormal(K * T)
    return K


def _outputs(results, values, couplings):
    return [GWOutput(value=v, coupling=c, errors=r.errors,
                     converged=r.converged, n_iters=r.n_iters,
                     status=r.status, trace=r.trace)
            for r, v, c in zip(results, values, couplings)]


def _dense_lanes(stack: LaneStack) -> list:
    problems, solvers = stack.problems, stack.solvers
    sv, p0 = solvers[0], problems[0]
    dev, loss, fused = p0.geom_x.weights.device, p0.loss, p0.is_fused
    Cx = torch.stack([p.geom_x.cost_matrix for p in problems])
    Cy = torch.stack([p.geom_y.cost_matrix for p in problems])
    a = torch.stack([p.geom_x.weights for p in problems])
    b = torch.stack([p.geom_y.weights for p in problems])
    eps = _per_lane([float(s.epsilon) for s in solvers], torch.float64, dev)
    if fused:
        alphas = [scalar(p.fused_penalty) for p in problems]
        alpha = _per_lane(alphas, torch.float32, dev)
        rest = _per_lane([1.0 - x for x in alphas], torch.float32, dev)
        M = torch.stack([p.linear_cost_dense() for p in problems])
    T0 = flush_subnormal(a[:, :, None] * b[:, None, :])

    def step(T, scale):
        e = (eps * scale).float()[:, None, None]
        C = dense_cost_lanes(Cx, Cy, T, loss)
        if fused:
            C = alpha[:, None, None] * C + rest[:, None, None] * M
        if sv.stable:
            logK = -C / e
            if sv.reg == "prox":
                logK = logK + log_floor(T)
            return sinkhorn_log_batched(a, b, logK, sv.inner_iters,
                                        tol=sv.inner_tol)
        return sinkhorn_batched(a, b, _plain_kernel_lanes(C, 1.0, T, e,
                                                          sv.reg),
                                sv.inner_iters, tol=sv.inner_tol)

    def err_fn(T):
        return (torch.sum(torch.abs(T.sum(dim=2) - a), dim=1)
                + torch.sum(torch.abs(T.sum(dim=1) - b), dim=1))

    def quad(T):
        return torch.sum(dense_cost_lanes(Cx, Cy, T, loss) * T, dim=(1, 2))

    def obj_fn(T):
        if fused:
            return alpha * quad(T) + rest * torch.sum(M * T, dim=(1, 2))
        return quad(T)

    results = health_loop_lanes(step, err_fn, T0, sv.outer_iters, sv.tol,
                                obj_fn=obj_fn, **_health_kw(stack))
    T = torch.stack([r.iterate for r in results])
    values = list(quad(T))
    if fused:
        values = [_fused_value(q, torch.sum(M_k * T_k), p.fused_penalty)
                  for p, q, M_k, T_k in zip(problems, values, M, T)]
    return _outputs(results, values, [r.iterate for r in results])


def _spar_lanes(stack: LaneStack) -> list:
    problems, solvers, gens = stack
    sv, p0 = solvers[0], problems[0]
    s, loss, fused = sv.s, p0.loss, p0.is_fused
    if s <= 0:
        raise ValueError(
            "SparGWSolver.s (sampled support size) must be > 0; the "
            "paper's default is SparGWSolver(s=16 * n), or use "
            "SparGWSolver.default_config(n)")
    if any(g is None for g in gens):
        raise ValueError("SparGWSolver draws a random support: every lane "
                         "needs a generator")
    dev = p0.geom_x.weights.device
    with span("solver.sample"):
        a = torch.stack([p.geom_x.weights for p in problems])
        b = torch.stack([p.geom_y.weights for p in problems])
        m, n = a.shape[1], b.shape[1]
        rows, cols, w = [], [], []
        for a_k, b_k, gen in zip(a, b, gens):      # each lane draws its own
            probs = sampling.balanced_probs(a_k, b_k, sv.shrink)
            r, c = sampling.sample_pairs(gen, probs, s)
            rows.append(r)
            cols.append(c)
            w.append(1.0 / (s * probs.pair_prob(r, c)))
        rows, cols, w = torch.stack(rows), torch.stack(cols), torch.stack(w)
        logw = torch.log(w)
        T0 = flush_subnormal(torch.gather(a, 1, rows)
                             * torch.gather(b, 1, cols))
    lin = (torch.stack([p.linear_cost_at(r, c)
                        for p, r, c in zip(problems, rows, cols)])
           if fused else 0.0)
    alphas = [scalar(p.fused_penalty) if fused else 1.0 for p in problems]
    alpha64 = _per_lane(alphas, torch.float64, dev)
    alpha = alpha64.float()[:, None]
    rest = _per_lane([1.0 - x for x in alphas], torch.float32, dev)[:, None]
    eps = _per_lane([float(x.epsilon) for x in solvers], torch.float64, dev)
    with span("solver.cost_build", route=kernel_route(sv.cost_impl, s, dev)):
        cost_fn = make_spar_cost_fn_lanes(
            [p.geom_x.cost_matrix for p in problems],
            [p.geom_y.cost_matrix for p in problems], rows, cols, loss,
            impl=sv.cost_impl, chunk=sv.cost_chunk)

    def step(T, scale):
        e = eps * scale
        if sv.stable:
            with span("solver.cost"):
                off = logw - ((1.0 - alpha64) / e).float()[:, None] * lin
                if sv.reg == "prox":
                    off = off + log_floor(T)
                logK = cost_fn((-alpha64 / e).float()[:, None] * T, off)
            with span("solver.sinkhorn"):
                return sparse_sinkhorn_logdomain_lanes(
                    a, b, rows, cols, logK, sv.inner_iters, tol=sv.inner_tol)
        with span("solver.cost"):
            C = cost_fn(alpha * T, rest * lin)
            K = _plain_kernel_lanes(C, w, T, e.float()[:, None], sv.reg)
        with span("solver.sinkhorn"):
            return sparse_sinkhorn_lanes(a, b, rows, cols, K, sv.inner_iters,
                                         tol=sv.inner_tol)

    r_flat, c_flat = _lane_flat(rows, m), _lane_flat(cols, n)
    B = len(problems)

    def err_fn(T):
        t = T.reshape(-1)
        mu = torch.zeros(B * m, dtype=T.dtype, device=dev).index_add_(
            0, r_flat, t).view(B, m)
        nu = torch.zeros(B * n, dtype=T.dtype, device=dev).index_add_(
            0, c_flat, t).view(B, n)
        return (torch.sum(torch.abs(mu - a), dim=1)
                + torch.sum(torch.abs(nu - b), dim=1))

    def obj_fn(T):
        quad = torch.sum(T * cost_fn(T), dim=1)
        if fused:
            return alpha[:, 0] * quad + rest[:, 0] * torch.sum(lin * T, dim=1)
        return quad

    results = health_loop_lanes(step, err_fn, T0, sv.outer_iters, sv.tol,
                                obj_fn=obj_fn, **_health_kw(stack))
    with span("solver.value"):
        T = torch.stack([r.iterate for r in results])
        values = list(torch.sum(T * cost_fn(T), dim=1))    # step 8, all lanes
        if fused:
            values = [_fused_value(q, torch.sum(lin_k * T_k), p.fused_penalty)
                      for p, q, lin_k, T_k in zip(problems, values, lin, T)]
    return _outputs(results, values,
                    [SparseCoupling(r, c, res.iterate)
                     for r, c, res in zip(rows, cols, results)])
