"""Dense GW cost assembly (counterpart of ``repro.core.gw``).

``dense_cost`` / ``gw_objective`` are the shared primitives of the dense
solver and of the unbalanced SPAR-GW init: O(n²m + m²n) per call for
decomposable ground losses (Peyré et al., 2016), a row-chunked O(m²n²)
contraction for the others. The legacy Algorithm 1 entry points
(``gw_dense``, ``egw``, ``pga_gw``, ``fgw_dense``) are deprecation shims
over ``repro_torch.solve`` with ``DenseGWSolver``, as in
``core/spar_gw.py``; ``device`` is where they run (the card unless
``"cpu"`` is given).
"""
from __future__ import annotations

import torch

from repro_torch.core import ground_cost as gc
from repro_torch.core.utils import flush_subnormal


def dense_cost(Cx, Cy, T, loss: str, row_chunk: int = 8):
    """C(T)_ij = Σ_{i',j'} L(Cx_ii', Cy_jj') T_i'j'  — tensor-matrix product.

    Decomposable losses use the Peyré decomposition. The others contract
    ``row_chunk`` rows of Cx at a time: one chunk is a (row_chunk, m, n, n)
    tensor (0.5 GiB at m = n = 256 and 8 rows).
    """
    dec = gc.get_decomposition(loss)
    if dec is not None:
        mu = T.sum(dim=1)             # row marginal
        nu = T.sum(dim=0)             # col marginal
        term1 = (dec.f1(Cx) @ mu)[:, None]
        term2 = (dec.f2(Cy) @ nu)[None, :]
        term3 = dec.h1(Cx) @ T @ dec.h2(Cy).t()
        return term1 + term2 - term3
    L = gc.get_loss(loss)
    out = [torch.einsum("abcd,bd->ac",
                        L(Cx_chunk[:, :, None, None], Cy[None, None, :, :]), T)
           for Cx_chunk in torch.split(Cx, row_chunk, dim=0)]
    return torch.cat(out, dim=0)


def dense_cost_lanes(Cx, Cy, T, loss: str, row_chunk: int = 8):
    """:func:`dense_cost` of B lanes: Cx (B, m, m), Cy (B, n, n), T
    (B, m, n) -> (B, m, n).

    Decomposable losses take a batched matmul for the (m, n) term and a
    matvec per lane for the marginal terms: a batched matvec of B >= 2
    runs another kernel than the single matvec of :func:`dense_cost` and
    sums in another order, so with this split a lane's bits are its solo
    bits on the CPU (the batched matmul is lane by lane the single one).
    The other losses take the chunked contraction, lane by lane."""
    dec = gc.get_decomposition(loss)
    if dec is None:
        return torch.stack([dense_cost(cx, cy, t, loss, row_chunk)
                            for cx, cy, t in zip(Cx, Cy, T)])
    mu = T.sum(dim=2)                 # row marginals (B, m)
    nu = T.sum(dim=1)                 # col marginals (B, n)
    term1 = torch.stack([f @ x for f, x in zip(dec.f1(Cx), mu)])
    term2 = torch.stack([f @ x for f, x in zip(dec.f2(Cy), nu)])
    term3 = dec.h1(Cx) @ T @ dec.h2(Cy).transpose(1, 2)
    return term1[:, :, None] + term2[:, None, :] - term3


def gw_objective(Cx, Cy, T, loss: str, row_chunk: int = 8):
    """⟨L(Cx, Cy) ⊗ T, T⟩."""
    return torch.sum(dense_cost(Cx, Cy, T, loss, row_chunk) * T)


def entropic_gw_value(Cx, Cy, T, loss: str, epsilon: float):
    """GW_ε = ⟨C(T), T⟩ + ε·H(T) for the entropic variant; entries below
    the smallest normal count as 0, as under XLA's flush."""
    Tf = flush_subnormal(T)
    ent = torch.sum(torch.where(Tf > 0, Tf * torch.log(
        torch.where(Tf > 0, Tf, torch.ones_like(Tf))), torch.zeros_like(Tf)))
    return gw_objective(Cx, Cy, T, loss) + epsilon * ent


def gw_dense(a, b, Cx, Cy, loss: str = "l2", reg: str = "prox",
             epsilon: float = 1e-2, outer_iters: int = 20,
             inner_iters: int = 50, stable: bool = True, device=None):
    """Algorithm 1 (shim): EGW (reg='ent') or PGA-GW (reg='prox').

    ``stable=True`` runs the Sinkhorn projection in the log domain;
    ``stable=False`` is the plain-domain algorithm as the paper writes it.
    Returns (gw_value, T).
    """
    from repro_torch.api import DenseGWSolver, solve
    from repro_torch.core.spar_gw import _problem, _warn_deprecated
    _warn_deprecated("gw_dense")
    solver = DenseGWSolver(reg=reg, epsilon=epsilon, outer_iters=outer_iters,
                           inner_iters=inner_iters, stable=stable)
    out = solve(_problem(a, b, Cx, Cy, loss=loss), solver, device=device,
                validate=False)
    return out.value, out.coupling


def egw(a, b, Cx, Cy, **kw):
    kw.setdefault("reg", "ent")
    return gw_dense(a, b, Cx, Cy, **kw)


def pga_gw(a, b, Cx, Cy, **kw):
    kw.setdefault("reg", "prox")
    return gw_dense(a, b, Cx, Cy, **kw)


def fgw_dense(a, b, Cx, Cy, M, alpha: float = 0.6, loss: str = "l2",
              reg: str = "prox", epsilon: float = 1e-2, outer_iters: int = 20,
              inner_iters: int = 50, stable: bool = True, device=None):
    """Dense fused GW (shim; appendix A baseline): C_fu = α L⊗T + (1-α) M.
    Returns (fgw_value, T)."""
    from repro_torch.api import DenseGWSolver, solve
    from repro_torch.core.spar_gw import _problem, _warn_deprecated
    _warn_deprecated("fgw_dense")
    solver = DenseGWSolver(reg=reg, epsilon=epsilon, outer_iters=outer_iters,
                           inner_iters=inner_iters, stable=stable)
    problem = _problem(a, b, Cx, Cy, loss=loss, fused_penalty=alpha, M=M)
    out = solve(problem, solver, device=device, validate=False)
    return out.value, out.coupling
