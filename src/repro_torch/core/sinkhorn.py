"""Sinkhorn scaling, dense and sparse (COO): the paper's Step 7.

Counterpart of ``repro.core.sinkhorn``: the dense plain and log-domain
loops (the grid path's s_r x s_c block, the dense solver, and batched for
the multiscale refinement's blocks) and the sparse
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

The ``*_lanes`` / ``*_batched`` variants run B independent solves (the
lanes of a server flush) in one batch: dense ones over (B, m, n) stacks,
sparse ones over one segment space of B·m rows and B·n columns (each
lane's indices offset by its lane), so a lane's segment sums hold only
its own entries. With ``tol > 0`` each lane stops on its own, as the
reference's ``vmap``-ed ``while_loop`` freezes a lane that met its
tolerance.

``differentiable`` is kept in the dense signatures for parity: torch's
plain loop is already differentiable, so it only keeps the reference's
refusal of ``tol > 0`` with it.

On CUDA tensors the balanced log-domain sparse loops
(:func:`sparse_sinkhorn_logdomain` and its lanes) run each half-step as
one launch of K7 (``kernels/sparse_sinkhorn``) in a
``solver.sinkhorn_kernel`` span; on CPU tensors they run the plain body
below, which is K7's plain version. The other loops are plain on both.
"""
from __future__ import annotations

import torch

from repro_torch.core.utils import NEG_INF as _NEG_INF
from repro_torch.core.utils import flush_subnormal, log_floor, safe_div
from repro_torch.kernels.sparse_sinkhorn.ops import logdomain_body
from repro_torch.obs.span import span


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


def _scaling_loop_lanes(body, init, iters: int, tol: float):
    """:func:`_scaling_loop` over lanes: ``init`` is a tuple of (B, ·)
    potentials. With ``tol > 0`` a lane's change is the sup-norm over its
    own potentials; a lane that met ``tol`` keeps the update that did so
    and changes no more. The lanes still active are read on the host after
    every iteration."""
    carry = init
    if not tol or tol <= 0.0:
        for _ in range(iters):
            carry = body(carry)
        return carry
    active = torch.ones(carry[0].shape[0], dtype=torch.bool,
                        device=carry[0].device)
    for _ in range(iters):
        new = body(carry)
        delta = torch.amax(torch.abs(torch.cat(new, 1) - torch.cat(carry, 1)),
                           dim=1)
        carry = tuple(torch.where(active[:, None], x, y)
                      for x, y in zip(new, carry))
        active = active & ~(delta <= tol)
        if not bool(active.any()):
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


def sinkhorn_log_batched(a, b, logK, iters: int, tol: float = 0.0):
    """B independent log-domain Sinkhorn solves in one batch: the
    reference's ``jax.vmap`` of :func:`sinkhorn_log`.

    a (B, m), b (B, n), logK (B, m, n); returns the (B, m, n) couplings.
    With ``tol > 0`` each block stops on its own, as the vmapped
    ``while_loop`` freezes a lane once it meets its tolerance: a block's
    change is the sup-norm over its own potentials, and a block that met
    it keeps the update that did so and changes no more. The blocks still
    active are read on the host after every iteration.
    """
    Bn, m, n = logK.shape
    la = log_floor(a)
    lb = log_floor(b)
    f0 = torch.zeros((Bn, m), dtype=logK.dtype, device=logK.device)
    g0 = torch.zeros((Bn, n), dtype=logK.dtype, device=logK.device)

    def body(carry):
        f, g = carry
        f = _finite(la - torch.logsumexp(logK + g[:, None, :], dim=2))
        g = _finite(lb - torch.logsumexp(logK + f[:, :, None], dim=1))
        return (f, g)

    f, g = _scaling_loop_lanes(body, (f0, g0), iters, tol)
    return flush_subnormal(torch.exp(logK + f[:, :, None] + g[:, None, :]))


def sinkhorn_batched(a, b, K, iters: int, tol: float = 0.0):
    """B plain Sinkhorn solves in one batch (lanes of :func:`sinkhorn`):
    a (B, m), b (B, n), K (B, m, n); returns the (B, m, n) couplings."""
    a, b, K = flush_subnormal(a), flush_subnormal(b), flush_subnormal(K)
    Bn, m, n = K.shape
    Kt = K.transpose(1, 2)
    u0 = torch.ones((Bn, m), dtype=K.dtype, device=K.device)
    v0 = torch.ones((Bn, n), dtype=K.dtype, device=K.device)

    def body(carry):
        u, v = carry
        u = safe_div(a, flush_subnormal(K * v[:, None, :]).sum(dim=2))
        v = safe_div(b, flush_subnormal(Kt * u[:, None, :]).sum(dim=2))
        return (u, v)

    u, v = _scaling_loop_lanes(body, (u0, v0), iters, tol)
    return flush_subnormal(flush_subnormal(u[:, :, None] * K)
                           * v[:, None, :])


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

    if logvals.is_cuda:
        with span("solver.sinkhorn_kernel"):
            f, g = _scaling_loop(
                logdomain_body(la, lb, rows, cols, logvals, m, n), (f0, g0),
                iters, tol)
    else:
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


def _lane_flat(idx, size: int):
    """(B, s) per-lane indices into [0, size) as (B·s,) indices into one
    segment space of B·size, lane b offset by b·size."""
    lane = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return (idx + size * lane).reshape(-1)


def sparse_sinkhorn_lanes(a, b, rows, cols, vals, iters: int,
                          tol: float = 0.0):
    """B plain-domain sparse Sinkhorn solves (lanes of
    :func:`sparse_sinkhorn`): a (B, m), b (B, n), rows, cols, vals (B, s);
    returns the (B, s) coupling values."""
    a, b, vals = flush_subnormal(a), flush_subnormal(b), flush_subnormal(vals)
    (Bn, m), n, s = a.shape, b.shape[1], rows.shape[1]
    r, c, kv = _lane_flat(rows, m), _lane_flat(cols, n), vals.reshape(-1)
    u0 = torch.ones((Bn, m), dtype=vals.dtype, device=vals.device)
    v0 = torch.ones((Bn, n), dtype=vals.dtype, device=vals.device)

    def body(carry):
        u, v = carry
        u = safe_div(a, coo_matvec(r, c, kv, v.reshape(-1), Bn * m)
                     .view(Bn, m))
        v = safe_div(b, coo_matvec(c, r, kv, u.reshape(-1), Bn * n)
                     .view(Bn, n))
        return (u, v)

    u, v = _scaling_loop_lanes(body, (u0, v0), iters, tol)
    return flush_subnormal(flush_subnormal(u.reshape(-1)[r] * kv)
                           * v.reshape(-1)[c]).view(Bn, s)


def sparse_sinkhorn_logdomain_lanes(a, b, rows, cols, logvals, iters: int,
                                    tol: float = 0.0):
    """B log-domain sparse Sinkhorn solves (lanes of
    :func:`sparse_sinkhorn_logdomain`): a (B, m), b (B, n), rows, cols,
    logvals (B, s); returns the (B, s) coupling values."""
    (Bn, m), n, s = a.shape, b.shape[1], rows.shape[1]
    r, c, lv = _lane_flat(rows, m), _lane_flat(cols, n), logvals.reshape(-1)
    la = log_floor(a)
    lb = log_floor(b)
    f0 = torch.zeros((Bn, m), dtype=logvals.dtype, device=logvals.device)
    g0 = torch.zeros((Bn, n), dtype=logvals.dtype, device=logvals.device)

    def body(carry):
        f, g = carry
        f = _finite(la - segment_logsumexp(lv + g.reshape(-1)[c], r, Bn * m)
                    .view(Bn, m))
        g = _finite(lb - segment_logsumexp(lv + f.reshape(-1)[r], c, Bn * n)
                    .view(Bn, n))
        return (f, g)

    if lv.is_cuda:
        with span("solver.sinkhorn_kernel"):
            flat = logdomain_body(la.reshape(-1), lb.reshape(-1), r, c, lv,
                                  Bn * m, Bn * n)

            def lanes(carry):
                f, g = flat((carry[0].reshape(-1), carry[1].reshape(-1)))
                return (f.view(Bn, m), g.view(Bn, n))

            f, g = _scaling_loop_lanes(lanes, (f0, g0), iters, tol)
    else:
        f, g = _scaling_loop_lanes(body, (f0, g0), iters, tol)
    return flush_subnormal(torch.exp(lv + f.reshape(-1)[r]
                                     + g.reshape(-1)[c])).view(Bn, s)
