"""Solver configurations + runners (counterpart of repro.api.solvers).

Each solver is a frozen dataclass registered in a name registry
(``get_solver`` / ``available_solvers``); ``run(problem, generator,
support)`` dispatches on the problem's structure: ``lam`` set → the
unbalanced variant, a linear term → the fused one. The outer loop goes
through :func:`repro_torch.api.driver.pga_loop`, which runs it without
autograd (the Danskin envelope); each solver then recomputes its value
from the live problem data (costs, ``M`` / features, ``fused_penalty``,
``lam``, marginals) at the returned fixed point, so the value's gradient
is the envelope gradient. Each passes the reference's per-iteration
objective as ``obj_fn``, which the loop evaluates for ``trace=True``
only.

Both ``spar_gw`` paths record the spans ``solver.sample``,
``solver.cost_build`` (attribute ``route``: K1, K2 or plain), one
``solver.cost`` and one ``solver.sinkhorn`` an outer step, and
``solver.value`` (``repro_torch.obs``); the unbalanced one (Alg. 3) opens
``solver.ugw_init`` first, around its dense rank-one init and log-kernel.
The loop adds ``solver.check`` and ``solver.host_read``
(``health/loop.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import torch

from repro_torch.api.driver import pga_loop
from repro_torch.api.output import GridCoupling, GWOutput, SparseCoupling
from repro_torch.core import sampling
from repro_torch.core.grid_gw import _dedup_marginal, grid_cost
from repro_torch.core.gw import dense_cost, gw_objective
from repro_torch.core.sinkhorn import (
    sinkhorn,
    sinkhorn_log,
    sinkhorn_unbalanced_log,
    sparse_sinkhorn,
    sparse_sinkhorn_logdomain,
    sparse_sinkhorn_unbalanced_log,
)
from repro_torch.core.spar_ugw import _marginal_penalty
from repro_torch.core.utils import (
    flush_subnormal,
    log_floor,
    quadratic_kl,
    scalar,
)
from repro_torch.kernels.spar_cost.ops import kernel_route, make_spar_cost_fn
from repro_torch.obs.span import span

_REGISTRY: dict = {}


def register_solver(name: str):
    """Class decorator: register a solver config under a CLI-friendly name."""
    def deco(cls):
        if name in _REGISTRY:
            raise ValueError(f"solver name {name!r} already registered")
        _REGISTRY[name] = cls
        cls.name = name
        return cls
    return deco


def get_solver(name: str):
    """Look up a solver class by registry name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown solver {name!r}; available: "
            f"{', '.join(available_solvers())}") from None


def available_solvers():
    return tuple(sorted(_REGISTRY))


def _coo_marginals(T, rows, cols, m: int, n: int):
    mu = torch.zeros(m, dtype=T.dtype, device=T.device).index_add_(0, rows, T)
    nu = torch.zeros(n, dtype=T.dtype, device=T.device).index_add_(0, cols, T)
    return mu, nu


def _coo_marginal_err(T, rows, cols, a, b):
    mu, nu = _coo_marginals(T, rows, cols, a.shape[0], b.shape[0])
    return torch.sum(torch.abs(mu - a)) + torch.sum(torch.abs(nu - b))


def _dense_marginal_err(T, a, b):
    return (torch.sum(torch.abs(T.sum(dim=1) - a))
            + torch.sum(torch.abs(T.sum(dim=0) - b)))


def _injected_support(support, shapes, m: int, n: int, device):
    """The caller's ``(rows, cols)`` as int64 tensors on ``device``, held to
    the expected ``shapes`` and to the index ranges [0, m) and [0, n)."""
    rows, cols = (torch.as_tensor(x, dtype=torch.int64, device=device)
                  for x in support)
    got = (tuple(rows.shape), tuple(cols.shape))
    if got != tuple(shapes):
        raise ValueError(f"support must be index arrays of shapes "
                         f"{shapes[0]} and {shapes[1]}, got {got[0]} and "
                         f"{got[1]}")
    lo_r, hi_r, lo_c, hi_c = torch.stack(
        [*torch.aminmax(rows), *torch.aminmax(cols)]).tolist()
    if lo_r < 0 or hi_r >= m or lo_c < 0 or hi_c >= n:
        raise ValueError(
            f"support indices out of range: rows in [{lo_r}, {hi_r}] for "
            f"m={m}, cols in [{lo_c}, {hi_c}] for n={n}")
    return rows, cols


def _spar_pga_step(T, scale, cost_fn, a, b, rows, cols, w, logw, m: int,
                   n: int, epsilon, inner_iters: int, inner_tol: float,
                   reg: str, stable: bool, alpha=1.0, lin=0.0):
    """One proximal/entropic PGA outer step on the COO support.

    The iteration cost is C = α·(L @ T̃) + (1-α)·lin; in the stable path
    the cost function writes logK = -C/ε + log w (+ log T̃) directly.
    ``scale`` is the loop's ε-rescue escalation (1.0 until a rescue).
    Spans: ``solver.cost`` (the kernel's assembly, one cost launch) and
    ``solver.sinkhorn`` (the whole inner loop).
    """
    epsilon = epsilon * scale
    if stable:
        with span("solver.cost"):
            off = logw - ((1.0 - alpha) / epsilon) * lin
            if reg == "prox":
                off = off + log_floor(T)
            logK = cost_fn((-alpha / epsilon) * T, off)
        with span("solver.sinkhorn"):
            return sparse_sinkhorn_logdomain(a, b, rows, cols, logK, m, n,
                                             inner_iters, tol=inner_tol)
    with span("solver.cost"):
        C = cost_fn(alpha * T, (1.0 - alpha) * lin)
        Cs = C - torch.min(C)          # constant shift — Sinkhorn-invariant
        K = flush_subnormal(flush_subnormal(torch.exp(-Cs / epsilon)) * w)
        if reg == "prox":
            K = flush_subnormal(K * T)
    with span("solver.sinkhorn"):
        return sparse_sinkhorn(a, b, rows, cols, K, m, n, inner_iters,
                               tol=inner_tol)


def _health_kw(solver):
    """Loop keywords wiring a config's rescue/fault knobs into pga_loop."""
    return dict(scaled_step=True, max_rescues=solver.max_rescues,
                rescue_factor=solver.rescue_factor, fault=solver.fault,
                trace=solver.trace)


def _fused_value(quad, lin_term, alpha):
    """α·quad + (1 - α)·lin_term, the fused objective."""
    return alpha * quad + (1.0 - alpha) * lin_term


def _rescaled(T_new, mT):
    """Alg. 3 step 10: T_new rescaled to the geometric mean of its own
    mass and the previous iterate's, sqrt(m(T) / m(T_new))·T_new."""
    return flush_subnormal(
        torch.sqrt(mT / torch.clamp_min(torch.sum(T_new), 1e-30)) * T_new)


def _ugw_value(quad, mu, nu, a, b, lam):
    """Alg. 3 step 11: ⟨C(T), T⟩ + λ KL⊗(μ||a) + λ KL⊗(ν||b)."""
    return quad + lam * quadratic_kl(mu, a) + lam * quadratic_kl(nu, b)


@register_solver("spar_gw")
@dataclass(frozen=True)
class SparGWSolver:
    """Importance-sparsified GW — the paper's contribution.

    Covers Alg. 2 (GW), Alg. 4 (fused, the problem carries a linear term)
    and Alg. 3 (unbalanced, the problem carries ``lam``). ``s`` is the
    sampled support size (the paper uses s = 16n);
    ``cost_impl`` selects the O(s²) cost-assembly backend
    (kernels/spar_cost). ``max_rescues`` / ``rescue_factor`` bound the
    ε-rescue restarts on detected divergence. ``fault`` takes a
    :class:`~repro_torch.health.faults.FaultSpec` that the loop injects;
    ``trace=True`` fills ``GWOutput.trace`` (a
    :class:`~repro_torch.obs.trace.ConvergenceTrace`, objective included).
    """
    s: int = 0
    reg: str = "prox"
    epsilon: Any = 1e-2
    outer_iters: int = 20
    inner_iters: int = 50
    tol: float = 0.0
    inner_tol: float = 0.0
    shrink: float = 0.0
    cost_chunk: int = 1024
    stable: bool = True
    cost_impl: str = "auto"
    max_rescues: int = 2
    rescue_factor: float = 2.0
    fault: Any = None
    trace: bool = False

    requires_key = True

    @classmethod
    def default_config(cls, n: int):
        return cls(s=16 * n)

    def run(self, problem, generator=None, support=None) -> GWOutput:
        """Solve ``problem`` on its device.

        ``support=(rows, cols)`` fixes the sampled support (int indices on
        the problem's device); otherwise ``generator`` draws it.
        """
        if self.s <= 0:
            raise ValueError(
                "SparGWSolver.s (sampled support size) must be > 0; the "
                "paper's default is SparGWSolver(s=16 * n), or use "
                "SparGWSolver.default_config(n)")
        if generator is None and support is None:
            raise ValueError(
                "SparGWSolver draws a random support: pass generator="
                "torch.Generator(...) or support=(rows, cols)")
        if problem.is_unbalanced:
            if problem.is_fused:
                raise NotImplementedError(
                    "fused + unbalanced GW is not implemented")
            return self._run_unbalanced(problem, generator, support)
        return self._run_balanced(problem, generator, support)

    def _run_balanced(self, problem, generator, support) -> GWOutput:
        Cx, a = problem.geom_x.cost_matrix, problem.geom_x.weights
        Cy, b = problem.geom_y.cost_matrix, problem.geom_y.weights
        m, n = a.shape[0], b.shape[0]
        with span("solver.sample"):
            probs = sampling.balanced_probs(a, b, self.shrink)
            if support is None:
                rows, cols = sampling.sample_pairs(generator, probs, self.s)
            else:
                rows, cols = _injected_support(
                    support, ((self.s,), (self.s,)), m, n, a.device)
            p = probs.pair_prob(rows, cols)                 # (s,)
            w = 1.0 / (self.s * p)                          # importance adj.
            logw = torch.log(w)
            T0 = flush_subnormal(a[rows] * b[cols])         # step 4 init on S
        with span("solver.cost_build",
                  route=kernel_route(self.cost_impl, self.s, a.device)):
            cost_fn = make_spar_cost_fn(Cx, Cy, rows, cols, problem.loss,
                                        impl=self.cost_impl,
                                        chunk=self.cost_chunk)
        fused = problem.is_fused
        alpha = scalar(problem.fused_penalty) if fused else 1.0
        lin = problem.linear_cost_at(rows, cols) if fused else 0.0
        step = partial(_spar_pga_step, cost_fn=cost_fn, a=a, b=b, rows=rows,
                       cols=cols, w=w, logw=logw, m=m, n=n,
                       epsilon=self.epsilon, inner_iters=self.inner_iters,
                       inner_tol=self.inner_tol, reg=self.reg,
                       stable=self.stable, alpha=alpha, lin=lin)
        err_fn = partial(_coo_marginal_err, rows=rows, cols=cols, a=a, b=b)

        def obj_fn(t):          # the step-8 plug-in objective, per iteration
            quad_t = torch.sum(t * cost_fn(t))
            if fused:
                return _fused_value(quad_t, torch.sum(lin * t), alpha)
            return quad_t

        T, errors, n_iters, converged, status, trace = pga_loop(
            step, err_fn, T0, self.outer_iters, self.tol, obj_fn=obj_fn,
            **_health_kw(self))
        # Step 8: plug-in objective on the sparse support, O(s²), from the
        # live data (fused_penalty too: α may carry a gradient)
        with span("solver.value"):
            quad = torch.sum(T * cost_fn(T))
            if fused:
                value = _fused_value(quad, torch.sum(lin * T),
                                     problem.fused_penalty)
            else:
                value = quad
        return GWOutput(value=value, coupling=SparseCoupling(rows, cols, T),
                        errors=errors, converged=converged, n_iters=n_iters,
                        status=status, trace=trace)

    def _run_unbalanced(self, problem, generator, support) -> GWOutput:
        Cx, a = problem.geom_x.cost_matrix, problem.geom_x.weights
        Cy, b = problem.geom_y.cost_matrix, problem.geom_y.weights
        lam, loss, eps = scalar(problem.lam), problem.loss, self.epsilon
        m, n = a.shape[0], b.shape[0]
        scale = torch.sqrt(torch.sum(a) * torch.sum(b))

        # steps 2-3: dense rank-one init and its (log-)kernel, once
        with span("solver.ugw_init"):
            Td = flush_subnormal(flush_subnormal(a[:, None] * b[None, :])
                                 / scale)
            m0 = torch.sum(Td)
            C0 = dense_cost(Cx, Cy, Td, loss) + _marginal_penalty(
                Td.sum(1), Td.sum(0), a, b, lam)
            logK0 = -C0 / (eps * m0) + log_floor(Td)

        # steps 4-5: sampling probability (eq. 9) and index set
        with span("solver.sample"):
            P = sampling.unbalanced_probs(a, b, logK0, lam, eps, self.shrink)
            if support is None:
                rows, cols = sampling.sample_pairs_2d(generator, P, self.s)
            else:
                rows, cols = _injected_support(
                    support, ((self.s,), (self.s,)), m, n, a.device)
            # log(s·max(p, 1e-38)) as XLA evaluates it: the floor flushes to 0
            logw = -torch.log(self.s * flush_subnormal(P[rows, cols]))
            T0 = flush_subnormal(flush_subnormal(a[rows] * b[cols]) / scale)
        with span("solver.cost_build",
                  route=kernel_route(self.cost_impl, self.s, a.device)):
            cost_fn = make_spar_cost_fn(Cx, Cy, rows, cols, loss,
                                        impl=self.cost_impl,
                                        chunk=self.cost_chunk)

        def step(T, rescue):
            with span("solver.cost"):
                mT = torch.sum(T)
                # rescue: the loop's ε escalation
                eps_bar = eps * rescue * mT
                lam_bar = lam * mT
                mu, nu = _coo_marginals(T, rows, cols, m, n)
                # logK = -(L@T̃ + penalty)/ε̄ + log T̃ + log w in one cost call
                off = (-_marginal_penalty(mu, nu, a, b, lam) / eps_bar
                       + log_floor(T) + logw)
                logK = cost_fn((-1.0 / eps_bar) * T, off)
            with span("solver.sinkhorn"):
                T_new = sparse_sinkhorn_unbalanced_log(
                    a, b, rows, cols, logK, lam_bar, eps_bar, m, n,
                    self.inner_iters, tol=self.inner_tol)
            return _rescaled(T_new, mT)

        err_fn = partial(_coo_marginal_err, rows=rows, cols=cols, a=a, b=b)

        def obj_fn(t):          # Alg. 3 step-11 UGW objective, per iteration
            mu_t, nu_t = _coo_marginals(t, rows, cols, m, n)
            return _ugw_value(torch.sum(t * cost_fn(t)), mu_t, nu_t, a, b,
                              lam)

        T, errors, n_iters, converged, status, trace = pga_loop(
            step, err_fn, T0, self.outer_iters, self.tol, obj_fn=obj_fn,
            **_health_kw(self))
        # Alg. 3 step 11: UGW objective on the sparse coupling, from the
        # live data (λ and the marginals carry gradients through the KLs)
        with span("solver.value"):
            mu, nu = _coo_marginals(T, rows, cols, m, n)
            value = _ugw_value(torch.sum(T * cost_fn(T)), mu, nu, a, b,
                               problem.lam)
        return GWOutput(value=value, coupling=SparseCoupling(rows, cols, T),
                        errors=errors, converged=converged, n_iters=n_iters,
                        status=status, trace=trace)


@register_solver("dense_gw")
@dataclass(frozen=True)
class DenseGWSolver:
    """Dense EGW (reg='ent') / PGA-GW (reg='prox') — the paper's benchmark
    (Alg. 1), O(n³) a step for decomposable losses, O(n⁴) for the others.

    Handles the fused (problem linear term) and unbalanced (problem
    ``lam``) variants; the unbalanced path always runs in the log domain.
    Deterministic: it draws nothing, so ``solve`` needs no generator.
    ``fault`` takes a ``FaultSpec`` that the loop injects; ``trace=True``
    fills ``GWOutput.trace``.
    """
    reg: str = "prox"
    epsilon: Any = 1e-2
    outer_iters: int = 20
    inner_iters: int = 50
    tol: float = 0.0
    inner_tol: float = 0.0
    stable: bool = True
    max_rescues: int = 2
    rescue_factor: float = 2.0
    fault: Any = None
    trace: bool = False

    requires_key = False

    @classmethod
    def default_config(cls, n: int):
        return cls()

    def run(self, problem, generator=None, support=None) -> GWOutput:
        """Solve ``problem`` on its device; ``generator`` is accepted for a
        uniform interface and unused."""
        if support is not None:
            raise ValueError("DenseGWSolver samples no support; "
                             "support= does not apply")
        if problem.is_unbalanced:
            if problem.is_fused:
                raise NotImplementedError(
                    "fused + unbalanced GW is not implemented")
            return self._run_unbalanced(problem)
        return self._run_balanced(problem)

    def _run_balanced(self, problem) -> GWOutput:
        Cx, a = problem.geom_x.cost_matrix, problem.geom_x.weights
        Cy, b = problem.geom_y.cost_matrix, problem.geom_y.weights
        loss = problem.loss
        fused = problem.is_fused
        alpha = scalar(problem.fused_penalty) if fused else 1.0
        M = problem.linear_cost_dense() if fused else None
        T0 = flush_subnormal(a[:, None] * b[None, :])

        def step(T, rescue):
            eps = self.epsilon * rescue     # rescue: the loop's ε escalation
            C = dense_cost(Cx, Cy, T, loss)
            if fused:
                C = alpha * C + (1 - alpha) * M
            if self.stable:
                logK = -C / eps
                if self.reg == "prox":
                    logK = logK + log_floor(T)
                return sinkhorn_log(a, b, logK, self.inner_iters,
                                    tol=self.inner_tol)
            return sinkhorn(a, b, _plain_kernel(C, 1.0, T, eps, self.reg),
                            self.inner_iters, tol=self.inner_tol)

        err_fn = partial(_dense_marginal_err, a=a, b=b)

        def obj_fn(t):
            quad_t = gw_objective(Cx, Cy, t, loss)
            if fused:
                return _fused_value(quad_t, torch.sum(M * t), alpha)
            return quad_t

        T, errors, n_iters, converged, status, trace = pga_loop(
            step, err_fn, T0, self.outer_iters, self.tol, obj_fn=obj_fn,
            **_health_kw(self))
        value = gw_objective(Cx, Cy, T, loss)
        if fused:
            value = _fused_value(value, torch.sum(M * T),
                                 problem.fused_penalty)
        return GWOutput(value=value, coupling=T, errors=errors,
                        converged=converged, n_iters=n_iters, status=status,
                        trace=trace)

    def _run_unbalanced(self, problem) -> GWOutput:
        Cx, a = problem.geom_x.cost_matrix, problem.geom_x.weights
        Cy, b = problem.geom_y.cost_matrix, problem.geom_y.weights
        lam, loss, eps = scalar(problem.lam), problem.loss, self.epsilon
        T0 = flush_subnormal(flush_subnormal(a[:, None] * b[None, :])
                             / torch.sqrt(torch.sum(a) * torch.sum(b)))

        def step(T, rescue):
            mT = torch.sum(T)
            eps_bar = eps * rescue * mT     # rescue: the loop's ε escalation
            lam_bar = lam * mT
            C = dense_cost(Cx, Cy, T, loss) + _marginal_penalty(
                T.sum(1), T.sum(0), a, b, lam)
            logK = -C / eps_bar + log_floor(T)
            T_new = sinkhorn_unbalanced_log(a, b, logK, lam_bar, eps_bar,
                                            self.inner_iters,
                                            tol=self.inner_tol)
            return _rescaled(T_new, mT)

        err_fn = partial(_dense_marginal_err, a=a, b=b)

        def obj_fn(t):
            return _ugw_value(torch.sum(t * dense_cost(Cx, Cy, t, loss)),
                              t.sum(1), t.sum(0), a, b, lam)

        T, errors, n_iters, converged, status, trace = pga_loop(
            step, err_fn, T0, self.outer_iters, self.tol, obj_fn=obj_fn,
            **_health_kw(self))
        value = _ugw_value(torch.sum(T * dense_cost(Cx, Cy, T, loss)),
                           T.sum(1), T.sum(0), a, b, problem.lam)
        return GWOutput(value=value, coupling=T, errors=errors,
                        converged=converged, n_iters=n_iters, status=status,
                        trace=trace)


def _grid_block_data(problem, R, C, shrink: float):
    """What a grid solve keeps for its support R × C: the sub-blocks
    CxR (s_r, s_r) and CyC (s_c, s_c), the deduplicated and renormalized
    marginals aR and bC, and the importance weights w (s_r, s_c)."""
    Cx, a = problem.geom_x.cost_matrix, problem.geom_x.weights
    Cy, b = problem.geom_y.cost_matrix, problem.geom_y.weights
    probs = sampling.balanced_probs(a, b, shrink)
    CxR = Cx[R][:, R]
    CyC = Cy[C][:, C]
    s = R.shape[0] * C.shape[0]
    w = 1.0 / (s * probs.pa[R][:, None] * probs.pb[C][None, :])
    aR = _dedup_marginal(R, a, a.shape[0])
    bC = _dedup_marginal(C, b, b.shape[0])
    # normalize to unit mass (covered-support renormalization)
    return CxR, CyC, aR / aR.sum(), bC / bC.sum(), w


def _plain_kernel(Cmat, w, T, eps, reg: str):
    """The plain-domain kernel matrix of a dense or grid step
    (stable=False), with importance weights ``w`` (1.0 when dense)."""
    Cs = Cmat - torch.min(Cmat)        # constant shift — Sinkhorn-invariant
    K = flush_subnormal(flush_subnormal(torch.exp(-Cs / eps)) * w)
    if reg == "prox":
        K = flush_subnormal(K * T)
    return K


def _grid_pga_step(T, scale, CxR, CyC, aR, bC, w, logw, loss: str,
                   use_kernel: bool, epsilon, inner_iters: int,
                   inner_tol: float, reg: str, stable: bool):
    """One proximal/entropic PGA outer step on the grid support.

    ``scale`` is the loop's ε-rescue escalation (1.0 until a rescue).
    """
    eps = epsilon * scale
    Cmat = grid_cost(CxR, CyC, T, loss, use_kernel)
    if stable:
        logK = -Cmat / eps + logw
        if reg == "prox":
            logK = logK + log_floor(T)
        return sinkhorn_log(aR, bC, logK, inner_iters, tol=inner_tol)
    return sinkhorn(aR, bC, _plain_kernel(Cmat, w, T, eps, reg),
                    inner_iters, tol=inner_tol)


@register_solver("grid_gw")
@dataclass(frozen=True)
class GridGWSolver:
    """Grid-structured SPAR-GW: support = R × C, dense s_r × s_c block.

    Balanced problems only (no fused/unbalanced grid variant yet).
    ``use_kernel`` routes the arbitrary-loss cost assembly through the
    ``gw_cost`` kernel; decomposable losses (l2, kl) take two matmuls
    either way. ``fault`` takes a ``FaultSpec`` that the loop injects;
    ``trace=True`` fills ``GWOutput.trace``. ``use_kernel=True`` with an
    indecomposable loss refuses a gradient (the kernel has none, as in
    the reference).
    """
    s_r: int = 0
    s_c: int = 0
    reg: str = "prox"
    epsilon: Any = 1e-2
    outer_iters: int = 20
    inner_iters: int = 50
    tol: float = 0.0
    inner_tol: float = 0.0
    shrink: float = 0.0
    use_kernel: bool = False
    stable: bool = True
    max_rescues: int = 2
    rescue_factor: float = 2.0
    fault: Any = None
    trace: bool = False

    requires_key = True

    @classmethod
    def default_config(cls, n: int):
        side = max(8, int(round((16 * n) ** 0.5)))   # equal budget s = 16n
        return cls(s_r=side, s_c=side)

    def run(self, problem, generator=None, support=None) -> GWOutput:
        """Solve ``problem`` on its device.

        ``support=(R, C)`` fixes the row and col sets (int indices of
        shapes (s_r,) and (s_c,)); otherwise ``generator`` draws them.
        """
        if self.s_r <= 0 or self.s_c <= 0:
            raise ValueError(
                "GridGWSolver requires s_r > 0 and s_c > 0 (grid support "
                "side lengths); use GridGWSolver.default_config(n)")
        if generator is None and support is None:
            raise ValueError(
                "GridGWSolver draws a random support: pass generator="
                "torch.Generator(...) or support=(R, C)")
        if problem.is_fused or problem.is_unbalanced:
            raise NotImplementedError(
                "GridGWSolver supports balanced non-fused problems only; "
                "use SparGWSolver for fused/unbalanced variants")
        a, b = problem.geom_x.weights, problem.geom_y.weights
        if support is None:
            probs = sampling.balanced_probs(a, b, self.shrink)
            R, C = sampling.sample_grid(generator, probs, self.s_r, self.s_c)
        else:
            R, C = _injected_support(support, ((self.s_r,), (self.s_c,)),
                                     a.shape[0], b.shape[0], a.device)
        CxR, CyC, aR, bC, w = _grid_block_data(problem, R, C, self.shrink)
        T0 = flush_subnormal(aR[:, None] * bC[None, :])
        step = partial(_grid_pga_step, CxR=CxR, CyC=CyC, aR=aR, bC=bC, w=w,
                       logw=torch.log(w), loss=problem.loss,
                       use_kernel=self.use_kernel, epsilon=self.epsilon,
                       inner_iters=self.inner_iters,
                       inner_tol=self.inner_tol, reg=self.reg,
                       stable=self.stable)
        err_fn = partial(_dense_marginal_err, a=aR, b=bC)

        def obj_fn(t):
            return torch.sum(t * grid_cost(CxR, CyC, t, problem.loss,
                                           self.use_kernel))

        T, errors, n_iters, converged, status, trace = pga_loop(
            step, err_fn, T0, self.outer_iters, self.tol, obj_fn=obj_fn,
            **_health_kw(self))
        value = torch.sum(T * grid_cost(CxR, CyC, T, problem.loss,
                                        self.use_kernel))
        return GWOutput(value=value, coupling=GridCoupling(R, C, T),
                        errors=errors, converged=converged, n_iters=n_iters,
                        status=status, trace=trace)
