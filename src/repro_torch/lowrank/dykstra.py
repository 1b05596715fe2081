"""LR-Dykstra — projection of low-rank factors onto the coupling polytope.

One mirror-descent step of the low-rank GW solver produces three positive
kernels ``(K1, K2, k3)``; this module projects them onto

    C(a, b, r) = {(Q, R, g): Q 1_r = a, R 1_r = b,
                  Qᵀ1_m = Rᵀ1_n = g, g ≥ α}

in KL geometry by Dykstra's alternating projections (Scetbon, Cuturi &
Peyré, 2021, Alg. 2), O((m + n)·r) an iteration, through the shared
``_scaling_loop`` (fixed budget, or to tolerance with one host
synchronisation an iteration). The α floor on g keeps all r components
live.
"""
from __future__ import annotations

import torch

from repro_torch.core.sinkhorn import _scaling_loop
from repro_torch.core.utils import flush_subnormal, safe_div


def _or(x, fallback):
    """x where finite, else ``fallback`` — extreme kernels (e^{±1/ε} at
    tiny ε) drive 0·inf / inf/inf products non-finite; dropping that
    update is the KL-safe fallback."""
    return torch.where(torch.isfinite(x), x, fallback)


def lr_dykstra(K1, K2, k3, a, b, alpha: float, iters: int, tol: float):
    """Project kernels (K1 (m, r), K2 (n, r), k3 (r,)) onto C(a, b, r).
    Returns the feasible factors ``(Q, R, g)``.

    ``tol=0`` runs the fixed budget; ``tol>0`` stops once the sup-norm
    change of all scalings is <= tol.
    """
    r = k3.shape[0]
    m, n = K1.shape[0], K2.shape[0]
    ones_r = torch.ones(r, dtype=K1.dtype, device=K1.device)
    # (u1, u2) row scalings, (v1, v2) column scalings, g inner marginal,
    # (q1, q2, q3_1, q3_2) Dykstra correction terms
    init = (torch.ones(m, dtype=K1.dtype, device=K1.device),
            torch.ones(n, dtype=K2.dtype, device=K2.device),
            ones_r, ones_r, k3, ones_r, ones_r, ones_r, ones_r)

    def body(carry):
        u1, u2, v1, v2, g, q1, q2, q3_1, q3_2 = carry
        # outer-marginal projections: Q 1_r = a, R 1_r = b
        u1 = safe_div(a, K1 @ v1)
        u2 = safe_div(b, K2 @ v2)
        # g ≥ α projection (with its Dykstra correction)
        gq3 = g * q3_1
        g_mid = torch.clamp_min(_or(gq3, g), alpha)
        q3_1 = _or(safe_div(gq3, g_mid), 1.0)
        # shared inner marginal: Qᵀ1 = Rᵀ1 = g, geometric-mean coupling
        kt1u = K1.t() @ u1
        kt2u = K2.t() @ u2
        prod1 = (v1 * q1) * kt1u
        prod2 = (v2 * q2) * kt2u
        g_raw = flush_subnormal((g_mid * q3_2 * prod1 * prod2) ** (1.0 / 3.0))
        g_new = torch.where(torch.isfinite(g_raw) & (g_raw > 0), g_raw,
                            g_mid)
        v1_new = safe_div(g_new, kt1u)
        v2_new = safe_div(g_new, kt2u)
        q1 = _or(safe_div(v1 * q1, v1_new), 1.0)
        q2 = _or(safe_div(v2 * q2, v2_new), 1.0)
        q3_2 = _or(safe_div(g_mid * q3_2, g_new), 1.0)
        return (u1, u2, v1_new, v2_new, g_new, q1, q2, q3_1, q3_2)

    u1, u2, v1, v2, g, *_ = _scaling_loop(body, init, iters, tol)
    Q = _or(flush_subnormal(u1[:, None] * K1 * v1[None, :]), 0.0)
    R = _or(flush_subnormal(u2[:, None] * K2 * v2[None, :]), 0.0)
    return Q, R, g
