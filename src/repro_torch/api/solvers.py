"""Solver configurations + runners (counterpart of repro.api.solvers, spar part).

Each solver is a frozen dataclass registered in a name registry
(``get_solver`` / ``available_solvers``); ``run(problem, generator,
support)`` dispatches on the problem's structure. The outer loop goes
through :func:`repro_torch.api.driver.pga_loop`.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import torch

from repro_torch.api.driver import pga_loop
from repro_torch.api.output import GWOutput, SparseCoupling
from repro_torch.core import sampling
from repro_torch.core.sinkhorn import (
    sparse_sinkhorn,
    sparse_sinkhorn_logdomain,
)
from repro_torch.core.utils import flush_subnormal, log_floor
from repro_torch.kernels.spar_cost.ops import make_spar_cost_fn

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


def _coo_marginal_err(T, rows, cols, a, b):
    mu = torch.zeros_like(a).index_add_(0, rows, T)
    nu = torch.zeros_like(b).index_add_(0, cols, T)
    return torch.sum(torch.abs(mu - a)) + torch.sum(torch.abs(nu - b))


def _spar_pga_step(T, scale, cost_fn, a, b, rows, cols, w, logw, m: int,
                   n: int, epsilon, inner_iters: int, inner_tol: float,
                   reg: str, stable: bool, alpha=1.0, lin=0.0):
    """One proximal/entropic PGA outer step on the COO support.

    The iteration cost is C = α·(L @ T̃) + (1-α)·lin; in the stable path
    the cost function writes logK = -C/ε + log w (+ log T̃) directly.
    ``scale`` is the loop's ε-rescue escalation (1.0 until a rescue).
    """
    epsilon = epsilon * scale
    if stable:
        off = logw - ((1.0 - alpha) / epsilon) * lin
        if reg == "prox":
            off = off + log_floor(T)
        logK = cost_fn((-alpha / epsilon) * T, off)
        return sparse_sinkhorn_logdomain(a, b, rows, cols, logK, m, n,
                                         inner_iters, tol=inner_tol)
    C = cost_fn(alpha * T, (1.0 - alpha) * lin)
    Cs = C - torch.min(C)          # constant shift — Sinkhorn-invariant
    K = flush_subnormal(flush_subnormal(torch.exp(-Cs / epsilon)) * w)
    if reg == "prox":
        K = flush_subnormal(K * T)
    return sparse_sinkhorn(a, b, rows, cols, K, m, n, inner_iters,
                           tol=inner_tol)


def _health_kw(solver):
    """Loop keywords wiring a config's rescue/fault knobs into pga_loop."""
    return dict(scaled_step=True, max_rescues=solver.max_rescues,
                rescue_factor=solver.rescue_factor, fault=solver.fault,
                trace=solver.trace)


@register_solver("spar_gw")
@dataclass(frozen=True)
class SparGWSolver:
    """Importance-sparsified GW — the paper's contribution (Alg. 2 / 4).

    ``s`` is the sampled support size (the paper uses s = 16n);
    ``cost_impl`` selects the O(s²) cost-assembly backend
    (kernels/spar_cost). ``max_rescues`` / ``rescue_factor`` bound the
    ε-rescue restarts on detected divergence. ``fault`` and ``trace`` are
    kept for parity with the reference and must stay at their defaults
    until fault injection and traces are ported.
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
            raise NotImplementedError(
                "unbalanced spar_gw is not ported yet (ROADMAP queue 1, "
                "item 7)")
        return self._run_balanced(problem, generator, support)

    def _run_balanced(self, problem, generator, support) -> GWOutput:
        Cx, a = problem.geom_x.cost_matrix, problem.geom_x.weights
        Cy, b = problem.geom_y.cost_matrix, problem.geom_y.weights
        m, n = a.shape[0], b.shape[0]
        probs = sampling.balanced_probs(a, b, self.shrink)
        if support is None:
            rows, cols = sampling.sample_pairs(generator, probs, self.s)
        else:
            rows, cols = (torch.as_tensor(x, dtype=torch.int64,
                                          device=a.device) for x in support)
            if tuple(rows.shape) != (self.s,) or tuple(cols.shape) != (self.s,):
                raise ValueError(
                    f"support must be two ({self.s},) index arrays, got "
                    f"{tuple(rows.shape)} and {tuple(cols.shape)}")
            lo_r, hi_r, lo_c, hi_c = torch.stack(
                [*torch.aminmax(rows), *torch.aminmax(cols)]).tolist()
            if lo_r < 0 or hi_r >= m or lo_c < 0 or hi_c >= n:
                raise ValueError(
                    f"support indices out of range: rows in [{lo_r}, "
                    f"{hi_r}] for m={m}, cols in [{lo_c}, {hi_c}] for n={n}")
        p = probs.pair_prob(rows, cols)                     # (s,)
        w = 1.0 / (self.s * p)                              # importance adj.
        T0 = flush_subnormal(a[rows] * b[cols])             # step 4 init on S
        cost_fn = make_spar_cost_fn(Cx, Cy, rows, cols, problem.loss,
                                    impl=self.cost_impl, chunk=self.cost_chunk)
        fused = problem.is_fused
        alpha = float(problem.fused_penalty) if fused else 1.0
        lin = problem.linear_cost_at(rows, cols) if fused else 0.0
        step = partial(_spar_pga_step, cost_fn=cost_fn, a=a, b=b, rows=rows,
                       cols=cols, w=w, logw=torch.log(w), m=m, n=n,
                       epsilon=self.epsilon, inner_iters=self.inner_iters,
                       inner_tol=self.inner_tol, reg=self.reg,
                       stable=self.stable, alpha=alpha, lin=lin)
        err_fn = partial(_coo_marginal_err, rows=rows, cols=cols, a=a, b=b)
        T, errors, n_iters, converged, status, trace = pga_loop(
            step, err_fn, T0, self.outer_iters, self.tol, **_health_kw(self))
        # Step 8: plug-in objective on the sparse support, O(s²).
        quad = torch.sum(T * cost_fn(T))
        if fused:
            value = alpha * quad + (1.0 - alpha) * torch.sum(lin * T)
        else:
            value = quad
        return GWOutput(value=value, coupling=SparseCoupling(rows, cols, T),
                        errors=errors, converged=converged, n_iters=n_iters,
                        status=status, trace=trace)
