"""Sparse (COO) Sinkhorn scaling: the paper's Step 7 with sparse matvecs, O(H s).

Counterpart of the sparse half of ``repro.core.sinkhorn``. Segment sums
are ``index_add_``; segment maxima are ``scatter_reduce("amax",
include_self=False)`` into an output initialised to -inf, so an empty
segment keeps -inf exactly as ``jax.ops.segment_max`` gives it and takes
the ``_NEG_INF`` branch. Indices are int64 (``scatter_reduce`` needs it).

``tol=0`` runs the fixed iteration budget with no host synchronisation;
``tol>0`` stops once the sup-norm change of the potentials is <= tol,
which reads that change on the host after every iteration.

Subnormals are flushed where the reference's XLA flush changes a result
(see ``core/utils.py``): the marginals' logs, the plain-domain inputs and
the products inside its matvecs, and the returned coupling values.
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

    ``body`` maps a tuple of potential vectors to the updated tuple. The
    update that brings the change to <= tol is kept, as in the reference.
    """
    carry = init
    if not tol or tol <= 0.0:
        for _ in range(iters):
            carry = body(carry)
        return carry
    for _ in range(iters):
        new = body(carry)
        delta = torch.stack([torch.max(torch.abs(n - o))
                             for n, o in zip(new, carry)]).max()
        carry = new
        if bool(delta <= tol):
            break
    return carry


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
