"""Grid-SPAR-GW: factorized importance sparsification on a grid support.

Counterpart of ``repro.core.grid_gw``. The paper's sampling probability
(eq. 5) is a product measure p_ij = (sqrt(a_i)/Z_a)(sqrt(b_j)/Z_b).
Sampling a row set R (s_r i.i.d. draws ∝ sqrt(a)) and a column set C
(s_c i.i.d. draws ∝ sqrt(b)) and taking the support S = R × C yields
s = s_r·s_c pairs, each marginally distributed exactly as p_ij, so the
importance-weighted estimator stays unbiased.

The sparse coupling is then a dense s_r × s_c block: cost assembly is two
matmuls (decomposable L) or a 4-D contraction (arbitrary L — the
``gw_cost`` kernel), and Sinkhorn runs on dense matrices.

Duplicate sampled indices split the marginal mass among themselves
(matching the COO segment-sum semantics). ``grid_spar_gw`` is the legacy
entry point, a deprecation shim over ``repro_torch.solve`` with
``GridGWSolver`` as in ``core/spar_gw.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core import ground_cost as gc
from repro_torch.core.sinkhorn import sinkhorn
from repro_torch.core.utils import flush_subnormal
from repro_torch.kernels.gw_cost.ops import gw_cost
from repro_torch.kernels.gw_cost.ref import gw_cost_ref


def grid_cost(CxR, CyC, T, loss: str, use_kernel: bool = False):
    """C̃[k,m] = Σ_{l,p} L(CxR[k,l], CyC[m,p]) T[l,p] on the grid support.

    Decomposable L → O(s_r² s_c + s_r s_c²) matmuls. Arbitrary L →
    O(s_r² s_c²) contraction: ``use_kernel`` routes it to the ``gw_cost``
    kernel on the tensors' device (its plain version on the CPU), else to
    the plain chunked contraction.
    """
    dec = gc.get_decomposition(loss)
    if dec is not None:
        mu = T.sum(dim=1)
        nu = T.sum(dim=0)
        t1 = (dec.f1(CxR) @ mu)[:, None]
        t2 = (dec.f2(CyC) @ nu)[None, :]
        t3 = dec.h1(CxR) @ T @ dec.h2(CyC).t()
        return t1 + t2 - t3
    if use_kernel:
        return gw_cost(CxR, CyC, T, loss, device=CxR.device)
    return gw_cost_ref(CxR, CyC, T, loss)


def _dedup_marginal(idx, full_weight, n_total: int):
    """Split marginal mass among duplicate draws: a[idx]/count(idx)."""
    counts = torch.zeros(n_total, dtype=torch.float32,
                         device=idx.device).index_add_(
        0, idx, torch.ones(idx.shape[0], dtype=torch.float32,
                           device=idx.device))
    return flush_subnormal(full_weight[idx] / counts[idx])


def grid_spar_gw(generator, a, b, Cx, Cy, s_r: int, s_c: int,
                 loss: str = "l2", reg: str = "prox", epsilon: float = 1e-2,
                 outer_iters: int = 20, inner_iters: int = 50,
                 shrink: float = 0.0, use_kernel: bool = False,
                 stable: bool = True, support=None, device=None):
    """Grid-structured SPAR-GW (shim). Returns (gw_estimate, (R, C,
    T_block)); ``support=(R, C)`` fixes the row and col sets."""
    from repro_torch.api import GridGWSolver, solve
    from repro_torch.core.spar_gw import _problem, _warn_deprecated
    _warn_deprecated("grid_spar_gw")
    solver = GridGWSolver(s_r=s_r, s_c=s_c, reg=reg, epsilon=epsilon,
                          outer_iters=outer_iters, inner_iters=inner_iters,
                          shrink=shrink, use_kernel=use_kernel, stable=stable)
    out = solve(_problem(a, b, Cx, Cy, loss=loss), solver,
                generator=generator, support=support, device=device,
                validate=False)
    c = out.coupling
    return out.value, (c.rows, c.cols, c.block)


def grid_spar_gw_differentiable(a, b, CxR, CyC, aR, bC, w, loss: str,
                                epsilon: float, outer_iters: int,
                                inner_iters: int):
    """Differentiable core of grid SPAR-GW (entropic, unrolled) for an
    alignment loss: takes the pre-gathered sub-blocks, so autograd flows
    into CxR / CyC (and aR, bC, w). A fixed ``outer_iters`` x
    ``inner_iters`` budget through the plain cost assembly and the plain
    dense Sinkhorn. Returns ``(value, T)``; ``a`` and ``b`` are unused, as
    in the reference's signature.
    """
    T = flush_subnormal(aR[:, None] * bC[None, :])
    for _ in range(outer_iters):
        Cmat = grid_cost(CxR, CyC, T, loss)
        Cs = Cmat - torch.min(Cmat).detach()   # Sinkhorn-invariant shift
        K = flush_subnormal(flush_subnormal(torch.exp(-Cs / epsilon)) * w)
        T = sinkhorn(aR, bC, K, inner_iters, differentiable=True)
    return torch.sum(T * grid_cost(CxR, CyC, T, loss)), T
