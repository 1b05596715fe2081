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
(matching the COO segment-sum semantics).
"""
from __future__ import annotations

import torch

from repro_torch.core import ground_cost as gc
from repro_torch.core.utils import flush_subnormal
from repro_torch.kernels.gw_cost.ops import gw_cost
from repro_torch.kernels.gw_cost.ref import gw_cost_ref


def grid_cost(CxR, CyC, T, loss: str, use_kernel: bool = False):
    """C̃[k,m] = Σ_{l,p} L(CxR[k,l], CyC[m,p]) T[l,p] on the grid support.

    Decomposable L → O(s_r² s_c + s_r s_c²) matmuls. Arbitrary L →
    O(s_r² s_c²) contraction: ``use_kernel`` routes it to the ``gw_cost``
    kernel (its plain version on CPU tensors), else to the plain chunked
    contraction.
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
        return gw_cost(CxR, CyC, T, loss)
    return gw_cost_ref(CxR, CyC, T, loss)


def _dedup_marginal(idx, full_weight, n_total: int):
    """Split marginal mass among duplicate draws: a[idx]/count(idx)."""
    counts = torch.zeros(n_total, dtype=torch.float32,
                         device=idx.device).index_add_(
        0, idx, torch.ones(idx.shape[0], dtype=torch.float32,
                           device=idx.device))
    return flush_subnormal(full_weight[idx] / counts[idx])
