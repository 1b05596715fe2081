"""SPAR-GW / SPAR-FGW — legacy entry points (deprecation shims).

Counterpart of ``repro.core.spar_gw``. The solvers live in
``repro_torch.api.solvers.SparGWSolver``; ``repro_torch.solve`` is the
front door. These functions keep the reference's positional signatures
and bare-tuple returns, and return what the matching ``repro_torch.solve``
call returns, bit for bit, on the same generator state.

Where the reference takes a JAX ``key`` these take a ``torch.Generator``.
``support=(rows, cols)`` fixes the sampled support instead (the parity
tests pass the reference's draws), and ``device`` is where the solve
runs: the CUDA card unless ``"cpu"`` is given.
"""
from __future__ import annotations

import warnings


def _warn_deprecated(name: str):
    warnings.warn(
        f"repro_torch.core.{name} is a deprecation shim; build a "
        f"QuadraticProblem and call repro_torch.solve(...) instead",
        DeprecationWarning, stacklevel=3)


def _problem(a, b, Cx, Cy, **kw):
    from repro_torch.api import Geometry, QuadraticProblem
    return QuadraticProblem(Geometry(Cx, a, validate=False),
                            Geometry(Cy, b, validate=False),
                            validate=False, **kw)


def _coo(out):
    c = out.coupling
    return out.value, (c.rows, c.cols, c.vals)


def spar_cost(Cx, Cy, rows, cols, tvals, loss: str, chunk: int = 1024):
    """Plain COO cost assembly (kept as the public torch oracle)."""
    from repro_torch.kernels.spar_cost.ref import spar_cost_ref
    return spar_cost_ref(Cx, Cy, rows, cols, tvals, loss, chunk)


def spar_gw(generator, a, b, Cx, Cy, s: int, loss: str = "l2",
            reg: str = "prox", epsilon: float = 1e-2, outer_iters: int = 20,
            inner_iters: int = 50, shrink: float = 0.0,
            cost_chunk: int = 1024, stable: bool = True,
            cost_impl: str = "auto", support=None, device=None):
    """Algorithm 2 (shim). Returns (gw_estimate, (rows, cols, vals))."""
    from repro_torch.api import SparGWSolver, solve
    _warn_deprecated("spar_gw")
    solver = SparGWSolver(s=s, reg=reg, epsilon=epsilon,
                          outer_iters=outer_iters, inner_iters=inner_iters,
                          shrink=shrink, cost_chunk=cost_chunk,
                          stable=stable, cost_impl=cost_impl)
    return _coo(solve(_problem(a, b, Cx, Cy, loss=loss), solver,
                      generator=generator, support=support, device=device,
                      validate=False))


def spar_fgw(generator, a, b, Cx, Cy, M, s: int, alpha: float = 0.6,
             loss: str = "l2", reg: str = "prox", epsilon: float = 1e-2,
             outer_iters: int = 20, inner_iters: int = 50,
             shrink: float = 0.0, cost_chunk: int = 1024,
             stable: bool = True, cost_impl: str = "auto", support=None,
             device=None):
    """SPAR-FGW — Algorithm 4 (shim). Fused GW with feature matrix M.

    Returns (fgw_estimate, (rows, cols, coupling_values)).
    """
    from repro_torch.api import SparGWSolver, solve
    _warn_deprecated("spar_fgw")
    solver = SparGWSolver(s=s, reg=reg, epsilon=epsilon,
                          outer_iters=outer_iters, inner_iters=inner_iters,
                          shrink=shrink, cost_chunk=cost_chunk,
                          stable=stable, cost_impl=cost_impl)
    problem = _problem(a, b, Cx, Cy, loss=loss, fused_penalty=alpha, M=M)
    return _coo(solve(problem, solver, generator=generator, support=support,
                      device=device, validate=False))
