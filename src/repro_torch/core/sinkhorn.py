"""Sinkhorn scaling, dense and sparse (COO): the paper's Step 7.

Counterpart of ``repro.core.sinkhorn``: the dense plain and log-domain
loops (the grid path's s_r x s_c block, the dense solver) and the sparse
ones, O(H s), each balanced and unbalanced (Alg. 3 step 9, exponent
ρ = λ/(λ+ε)). Sparse segment sums are ``index_add_``; segment maxima are ``scatter_reduce("amax",
include_self=False)`` into an output initialised to -inf, so an empty
segment keeps -inf exactly as ``jax.ops.segment_max`` gives it and takes
the ``_NEG_INF`` branch. Indices are int64 (``scatter_reduce`` needs it).

``tol=0`` runs the fixed iteration budget with no host synchronisation;
``tol>0`` stops once the sup-norm change of the potentials is <= tol,
which reads that change on the host after every iteration.

Subnormals are flushed where the reference's XLA flush changes a result
(see ``core/utils.py``): the marginals' logs, the plain-domain inputs and
the products inside its matvecs, and the returned coupling values.

``differentiable`` is kept in the dense signatures for parity: torch's
plain loop is already differentiable, so it only keeps the reference's
refusal of ``tol > 0`` with it.
"""
from __future__ import annotations

import torch

from repro_torch.core.utils import flush_subnormal, log_floor, safe_div

_NEG_INF = -1e30   # proxy for -inf that stays NaN-free under arithmetic


def _finite(x):
    return torch.where(torch.isfinite(x) & (x > _NEG_INF / 2), x,
                       torch.zeros_like(x))


def _scaling_loop(body, init, iters: int, tol: float):
    """Run ``carry <- body(carry)`` for a fixed budget or to tolerance.

    ``body`` maps a tuple of potential vectors (1-D, one dtype) to the
    updated tuple. The update that brings the change to <= tol is kept, as
    in the reference.
    """
    carry = init
    if not tol or tol <= 0.0:
        for _ in range(iters):
            carry = body(carry)
        return carry
    for _ in range(iters):
        new = body(carry)
        # the potentials are vectors: one max over their concatenation
        delta = torch.max(torch.abs(torch.cat(new) - torch.cat(carry)))
        carry = new
        if bool(delta <= tol):
            break
    return carry


def _check_differentiable(differentiable: bool, tol: float):
    if differentiable and tol and tol > 0.0:
        raise ValueError(
            "tol-based early stopping is not supported with "
            "differentiable=True (reverse-mode AD needs the fixed-length "
            "scan); pass tol=0")


def dense_matvec(K, x):
    """y_i = Σ_j K_ij x_j with every product flushed, as XLA sums them."""
    return flush_subnormal(K * x[None, :]).sum(dim=1)


def sinkhorn(a, b, K, iters: int, differentiable: bool = False,
             tol: float = 0.0):
    """Plain Sinkhorn scaling (Alg. 1 step 5): u = a ⊘ (K v), v = b ⊘ (Kᵀ u).

    Returns the dense coupling diag(u) K diag(v); rows/cols whose
    denominator is 0 get scaling 0 (dead).
    """
    _check_differentiable(differentiable, tol)
    a, b, K = flush_subnormal(a), flush_subnormal(b), flush_subnormal(K)
    m, n = K.shape
    u0 = torch.ones(m, dtype=K.dtype, device=K.device)
    v0 = torch.ones(n, dtype=K.dtype, device=K.device)
    Kt = K.t()

    def body(carry):
        u, v = carry
        u = safe_div(a, dense_matvec(K, v))
        v = safe_div(b, dense_matvec(Kt, u))
        return (u, v)

    u, v = _scaling_loop(body, (u0, v0), iters, tol)
    return flush_subnormal(flush_subnormal(u[:, None] * K) * v[None, :])


def sinkhorn_log(a, b, logK, iters: int, differentiable: bool = False,
                 tol: float = 0.0):
    """Log-domain Sinkhorn on a dense log-kernel. Returns the coupling T."""
    _check_differentiable(differentiable, tol)
    m, n = logK.shape
    la = log_floor(a)
    lb = log_floor(b)
    f0 = torch.zeros(m, dtype=logK.dtype, device=logK.device)
    g0 = torch.zeros(n, dtype=logK.dtype, device=logK.device)

    def body(carry):
        f, g = carry
        f = _finite(la - torch.logsumexp(logK + g[None, :], dim=1))
        g = _finite(lb - torch.logsumexp(logK + f[:, None], dim=0))
        return (f, g)

    f, g = _scaling_loop(body, (f0, g0), iters, tol)
    return flush_subnormal(torch.exp(logK + f[:, None] + g[None, :]))


def sinkhorn_unbalanced(a, b, K, lam, eps, iters: int, tol: float = 0.0):
    """Plain unbalanced Sinkhorn (Alg. 3 step 9): exponent λ/(λ+ε)."""
    a, b, K = flush_subnormal(a), flush_subnormal(b), flush_subnormal(K)
    m, n = K.shape
    rho = lam / (lam + eps)
    u0 = torch.ones(m, dtype=K.dtype, device=K.device)
    v0 = torch.ones(n, dtype=K.dtype, device=K.device)
    Kt = K.t()

    def body(carry):
        u, v = carry
        u = flush_subnormal(safe_div(a, dense_matvec(K, v)) ** rho)
        v = flush_subnormal(safe_div(b, dense_matvec(Kt, u)) ** rho)
        return (u, v)

    u, v = _scaling_loop(body, (u0, v0), iters, tol)
    return flush_subnormal(flush_subnormal(u[:, None] * K) * v[None, :])


def sinkhorn_unbalanced_log(a, b, logK, lam, eps, iters: int,
                            tol: float = 0.0):
    """Log-domain unbalanced Sinkhorn: f = ρ (log a - lse(logK + g))."""
    m, n = logK.shape
    rho = lam / (lam + eps)
    la = log_floor(a)
    lb = log_floor(b)
    f0 = torch.zeros(m, dtype=logK.dtype, device=logK.device)
    g0 = torch.zeros(n, dtype=logK.dtype, device=logK.device)

    def body(carry):
        f, g = carry
        f = _finite(rho * (la - torch.logsumexp(logK + g[None, :], dim=1)))
        g = _finite(rho * (lb - torch.logsumexp(logK + f[:, None], dim=0)))
        return (f, g)

    f, g = _scaling_loop(body, (f0, g0), iters, tol)
    return flush_subnormal(torch.exp(logK + f[:, None] + g[None, :]))


def coo_matvec(rows, cols, vals, x, out_dim: int):
    """y_i = Σ_{l: rows_l = i} vals_l * x[cols_l] — sparse K @ x."""
    prod = flush_subnormal(vals * x[cols])
    return torch.zeros(out_dim, dtype=prod.dtype,
                       device=prod.device).index_add_(0, rows, prod)


def segment_logsumexp(vals, segs, num: int):
    """Per-segment logsumexp; empty segments -> _NEG_INF. NaN-free."""
    maxs = torch.full((num,), float("-inf"), dtype=vals.dtype,
                      device=vals.device).scatter_reduce(
        0, segs, vals, "amax", include_self=False)
    maxs_safe = torch.where(maxs > _NEG_INF / 2, maxs, torch.zeros_like(maxs))
    sums = torch.zeros(num, dtype=vals.dtype, device=vals.device).index_add_(
        0, segs, torch.exp(vals - maxs_safe[segs]))
    out = log_floor(sums) + maxs_safe
    return torch.where(sums > 0, out, torch.full_like(out, _NEG_INF))


def sparse_sinkhorn(a, b, rows, cols, vals, m: int, n: int, iters: int,
                    tol: float = 0.0):
    """Plain-domain sparse Sinkhorn on a COO kernel (paper-faithful).

    Returns the COO values of the coupling T̃ (same sparsity pattern).
    Rows/cols without support get scaling 0 (dead).
    """
    # XLA reads subnormal inputs as 0: a subnormal kernel value times a
    # huge scaling would otherwise come out normal
    a, b, vals = flush_subnormal(a), flush_subnormal(b), flush_subnormal(vals)
    u0 = torch.ones(m, dtype=vals.dtype, device=vals.device)
    v0 = torch.ones(n, dtype=vals.dtype, device=vals.device)

    def body(carry):
        u, v = carry
        u = safe_div(a, coo_matvec(rows, cols, vals, v, m))
        v = safe_div(b, coo_matvec(cols, rows, vals, u, n))
        return (u, v)

    u, v = _scaling_loop(body, (u0, v0), iters, tol)
    return flush_subnormal(flush_subnormal(u[rows] * vals) * v[cols])


def sparse_sinkhorn_logdomain(a, b, rows, cols, logvals, m: int, n: int,
                              iters: int, tol: float = 0.0):
    """Log-domain sparse Sinkhorn (production default; small-ε safe)."""
    la = log_floor(a)
    lb = log_floor(b)
    f0 = torch.zeros(m, dtype=logvals.dtype, device=logvals.device)
    g0 = torch.zeros(n, dtype=logvals.dtype, device=logvals.device)

    def body(carry):
        f, g = carry
        f = _finite(la - segment_logsumexp(logvals + g[cols], rows, m))
        g = _finite(lb - segment_logsumexp(logvals + f[rows], cols, n))
        return (f, g)

    f, g = _scaling_loop(body, (f0, g0), iters, tol)
    return flush_subnormal(torch.exp(logvals + f[rows] + g[cols]))


def sparse_sinkhorn_unbalanced(a, b, rows, cols, vals, lam, eps, m: int,
                               n: int, iters: int, tol: float = 0.0):
    """Plain-domain unbalanced sparse Sinkhorn (Alg. 3 step 9)."""
    a, b, vals = flush_subnormal(a), flush_subnormal(b), flush_subnormal(vals)
    rho = lam / (lam + eps)
    u0 = torch.ones(m, dtype=vals.dtype, device=vals.device)
    v0 = torch.ones(n, dtype=vals.dtype, device=vals.device)

    def body(carry):
        u, v = carry
        u = flush_subnormal(
            safe_div(a, coo_matvec(rows, cols, vals, v, m)) ** rho)
        v = flush_subnormal(
            safe_div(b, coo_matvec(cols, rows, vals, u, n)) ** rho)
        return (u, v)

    u, v = _scaling_loop(body, (u0, v0), iters, tol)
    return flush_subnormal(flush_subnormal(u[rows] * vals) * v[cols])


def sparse_sinkhorn_unbalanced_log(a, b, rows, cols, logvals, lam, eps,
                                   m: int, n: int, iters: int,
                                   tol: float = 0.0):
    """Log-domain unbalanced sparse Sinkhorn."""
    rho = lam / (lam + eps)
    la = log_floor(a)
    lb = log_floor(b)
    f0 = torch.zeros(m, dtype=logvals.dtype, device=logvals.device)
    g0 = torch.zeros(n, dtype=logvals.dtype, device=logvals.device)

    def body(carry):
        f, g = carry
        f = _finite(rho * (la - segment_logsumexp(logvals + g[cols], rows, m)))
        g = _finite(rho * (lb - segment_logsumexp(logvals + f[rows], cols, n)))
        return (f, g)

    f, g = _scaling_loop(body, (f0, g0), iters, tol)
    return flush_subnormal(torch.exp(logvals + f[rows] + g[cols]))
