"""UGW helpers (counterpart of ``repro.core.spar_ugw``).

Unbalanced GW relaxes the marginal constraints through quadratic KL
divergences (Séjourné et al., 2021). The solver is the unbalanced branch
of ``SparGWSolver`` / ``DenseGWSolver`` (api/solvers.py); ``spar_ugw``
and ``ugw_dense`` are the legacy entry points, deprecation shims over
``repro_torch.solve`` as in ``core/spar_gw.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core.gw import dense_cost
from repro_torch.core.spar_gw import _coo, _problem, _warn_deprecated
from repro_torch.core.utils import flush_subnormal, quadratic_kl
from repro_torch.kernels.spar_cost.ref import spar_cost_ref


def _marginal_penalty(T_rows_sum, T_cols_sum, a, b, lam):
    """E(T) = λ Σ_i log(μ_i/a_i) μ_i + λ Σ_j log(ν_j/b_j) ν_j (scalar).

    A marginal entry below the smallest normal counts as 0 (``μ > 0`` is
    False for it under XLA's flush).
    """
    eps = 1e-30

    def term(mu, w):
        mu, w = flush_subnormal(mu), flush_subnormal(w)
        return torch.sum(torch.where(
            mu > 0, torch.log(torch.clamp_min(mu, eps) / w) * mu,
            torch.zeros_like(mu)))

    return lam * (term(T_rows_sum, a) + term(T_cols_sum, b))


def ugw_value(a, b, Cx, Cy, rows, cols, T, lam, loss: str, cost_chunk=1024,
              cost_fn=None):
    """UGW objective on a sparse coupling (Alg. 3 step 11)."""
    m, n = a.shape[0], b.shape[0]
    mu = torch.zeros(m, dtype=T.dtype, device=T.device).index_add_(0, rows, T)
    nu = torch.zeros(n, dtype=T.dtype, device=T.device).index_add_(0, cols, T)
    if cost_fn is None:
        def cost_fn(t):
            return spar_cost_ref(Cx, Cy, rows, cols, t, loss, cost_chunk)
    quad = torch.sum(T * cost_fn(T))
    return quad + lam * quadratic_kl(mu, a) + lam * quadratic_kl(nu, b)


def naive_ugw_value(a, b, Cx, Cy, loss: str = "l2", lam: float = 1.0):
    """Naive transport plan T = a bᵀ baseline (paper Fig. 3)."""
    T = flush_subnormal(a[:, None] * b[None, :])
    quad = torch.sum(T * dense_cost(Cx, Cy, T, loss))
    return (quad + lam * quadratic_kl(T.sum(1), a)
            + lam * quadratic_kl(T.sum(0), b))


def spar_ugw(generator, a, b, Cx, Cy, s: int, loss: str = "l2",
             lam: float = 1.0, epsilon: float = 1e-2, outer_iters: int = 20,
             inner_iters: int = 50, shrink: float = 0.0,
             cost_chunk: int = 1024, cost_impl: str = "auto", support=None,
             device=None):
    """Algorithm 3 (shim). Returns (ugw_estimate, (rows, cols, vals))."""
    from repro_torch.api import SparGWSolver, solve
    _warn_deprecated("spar_ugw")
    solver = SparGWSolver(s=s, epsilon=epsilon, outer_iters=outer_iters,
                          inner_iters=inner_iters, shrink=shrink,
                          cost_chunk=cost_chunk, cost_impl=cost_impl)
    return _coo(solve(_problem(a, b, Cx, Cy, loss=loss, lam=lam), solver,
                      generator=generator, support=support, device=device,
                      validate=False))


def ugw_dense(a, b, Cx, Cy, loss: str = "l2", lam: float = 1.0,
              epsilon: float = 1e-2, outer_iters: int = 20,
              inner_iters: int = 50, device=None):
    """Dense PGA-UGW baseline (shim; the paper's benchmark for Fig. 3).
    Returns (ugw_value, T)."""
    from repro_torch.api import DenseGWSolver, solve
    _warn_deprecated("ugw_dense")
    solver = DenseGWSolver(epsilon=epsilon, outer_iters=outer_iters,
                           inner_iters=inner_iters)
    out = solve(_problem(a, b, Cx, Cy, loss=loss, lam=lam), solver,
                device=device, validate=False)
    return out.value, out.coupling
