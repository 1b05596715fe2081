"""Low-rank GW gradients and objective — never an m×n intermediate.

With the coupling factored as ``T = Q diag(1/g) Rᵀ`` and the ground-loss
h-matrices as ``Hx ≈ U1 V1ᵀ``, ``Hy ≈ U2 V2ᵀ``, the quadratic part of
the GW objective on the coupling polytope is

    F(Q, R, g) = -⟨Hx T Hy, T⟩ = -tr(Sx D Sy D),
    Sx = Qᵀ Hx Q,  Sy = Rᵀ Hy R,  D = diag(1/g)

(the f1/f2 terms are constant on the polytope and re-enter only in the
reported value). Gradients cost O((m + n)·r·(r + c)).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.lowrank.factorize import CostFactors, GroundFactors


class LRGradients(NamedTuple):
    grad_q: torch.Tensor   # (m, r) = ∂F/∂Q = G R diag(1/g), G = -2 Hx T Hy
    grad_r: torch.Tensor   # (n, r) = ∂F/∂R = Gᵀ Q diag(1/g)
    grad_g: torch.Tensor   # (r,)  = ∂F/∂g = -diag(Qᵀ G R)/g²


def _small_gram(h: CostFactors, X):
    """Sx = Xᵀ (U Vᵀ) X as two skinny products, (r × r)."""
    return (h.u.t() @ X).t() @ (h.v.t() @ X)


def gw_lr_gradients(Q, R, g, hx: CostFactors, hy: CostFactors):
    """Gradients of F(Q, R, g) = -⟨Hx T Hy, T⟩ at T = Q diag(1/g) Rᵀ."""
    inv_g = 1.0 / g
    v1q = hx.v.t() @ Q                     # (c1, r)
    u2r = hy.u.t() @ R                     # (c2, r)
    v2r = hy.v.t() @ R                     # (c2, r)
    u1q = hx.u.t() @ Q                     # (c1, r)
    sx = u1q.t() @ v1q                     # Qᵀ Hx Q   (r, r)
    sy = u2r.t() @ v2r                     # Rᵀ Hy R   (r, r)
    # G R D = -2 Hx Q D (Rᵀ Hy R) D  — assembled right-to-left, all skinny
    grad_q = -2.0 * (hx.u @ ((v1q * inv_g[None, :]) @ sy * inv_g[None, :]))
    # Gᵀ Q D = -2 Hy R D (Qᵀ Hx Q) D
    grad_r = -2.0 * (hy.u @ ((v2r * inv_g[None, :]) @ sx * inv_g[None, :]))
    # ∂F/∂g_k = (2/g_k²) Σ_l Sx[k, l] (1/g_l) Sy[l, k]
    grad_g = 2.0 * torch.einsum("kl,lk->k", sx, sy * inv_g[:, None]) \
        * inv_g ** 2
    return LRGradients(grad_q, grad_r, grad_g)


def gw_lr_value(Q, R, g, fx: GroundFactors, fy: GroundFactors):
    """Plug-in GW objective of the factored coupling, O((m + n)·(r + c)²).

    value = ⟨f1(Cx) μ, μ⟩ + ⟨f2(Cy) ν, ν⟩ - ⟨Hx T Hy, T⟩ with (μ, ν) the
    marginals of T itself (``LowRankCoupling.marginals``).
    """
    mu = Q @ (R.sum(dim=0) / g)
    nu = R @ (Q.sum(dim=0) / g)
    inv_g = 1.0 / g
    sx = _small_gram(fx.h, Q)
    sy = _small_gram(fy.h, R)
    cross = torch.einsum("kl,lk->", sx * inv_g[None, :], sy * inv_g[None, :])
    return (torch.dot(mu, fx.apply_f(mu)) + torch.dot(nu, fy.apply_f(nu))
            - cross)
