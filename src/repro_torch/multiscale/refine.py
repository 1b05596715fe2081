"""Block-local expansion of a coarse coupling — multiscale stage 3
(counterpart of ``repro.multiscale.refine``).

For each of the ``max_pairs`` heaviest anchor pairs (c, d) of the coarse
coupling T̃, an entropic Sinkhorn runs between the member distributions
of clusters c and d. The local ground cost is the linearized GW cost
around the block-constant expansion T⁰ of T̃:

    E[i, j] = Σ_{i', j'} L(Cx[i, i'], Cy[j, j']) · T⁰[i', j']

For decomposable losses L = f1 + f2 - h1·h2 this is f1(Cx)·a + f2(Cy)·b
minus a rank-k cross term (h1(Cx)·P_u) T̃ (h2(Cy)·P_v)ᵀ through the
membership matrices; indecomposable losses take the distance-to-anchor
profile cost L(d(x_i, x_c), d(y_j, y_d)). Fused problems add the
(1-α)-weighted linear term on the block.

All blocks share the shape (cap_x, cap_y) (padded slots get weight ~0 and
are zeroed on emission), so the B local solves are one batched log
Sinkhorn (:func:`~repro_torch.core.sinkhorn.sinkhorn_log_batched`) and the
per-block cross terms one ``torch.bmm``.
"""
from __future__ import annotations

import torch

from repro_torch.api.output import QuantizedCoupling
from repro_torch.core import ground_cost as gc
from repro_torch.core.sinkhorn import sinkhorn_log_batched
from repro_torch.core.utils import div_floor, flush_subnormal, scalar
from repro_torch.multiscale.anchors import (
    AnchorAssignment,
    member_table,
    membership,
)

# padded member slots get this weight instead of 0: a normal float32, so
# their log-weight stays finite (≈ -69) under the reference's flush and
# their coupling mass ≈ 1e-30 (an exact 0 would be clamped to full mass)
_PAD_WEIGHT = 1e-30


def top_pairs(Tc, max_pairs: int):
    """The ``max_pairs`` heaviest entries of the coarse coupling, heaviest
    first; equal entries in flat-index order, as ``lax.top_k`` gives them
    (a stable descending sort). Returns (rows, cols, mass)."""
    ky = Tc.shape[1]
    mass, flat = torch.sort(Tc.reshape(-1), descending=True, stable=True)
    mass, flat = mass[:max_pairs], flat[:max_pairs]
    return flat // ky, flat % ky, mass


def _member_side(cost, weights, anchors: AnchorAssignment, cap: int):
    """Padded member data for one side: indices, mask, member weights,
    anchor-distance columns (all (k, cap)-shaped, padded slots at ~0
    weight; an empty cluster's row is NaN, as in the reference)."""
    k = anchors.indices.shape[0]
    table, _ = member_table(anchors.assign, k, cap)
    mask = table >= 0
    safe = torch.where(mask, table, 0)
    w = torch.where(mask, weights[safe], 0.0)
    w = torch.clamp_min(div_floor(w, w.sum(dim=1, keepdim=True)), _PAD_WEIGHT)
    prof = torch.where(mask, cost[safe, anchors.indices[:, None]], 0.0)
    return safe, mask, w, prof


def _linearized_factors(problem, ax, ay, Tc):
    """The rank-k factorization of the linearized GW cost E around the
    block-constant expansion T⁰ (decomposable losses):
    E[i, j] = t1[i] + t2[j] - (Gx @ T̃ @ Gyᵀ)[i, j]."""
    dec = gc.get_decomposition(problem.loss)
    Cx, a = problem.geom_x.cost_matrix, problem.geom_x.weights
    Cy, b = problem.geom_y.cost_matrix, problem.geom_y.weights
    t1 = dec.f1(Cx) @ a                              # (m,)  μ(T⁰) = a exactly
    t2 = dec.f2(Cy) @ b                              # (n,)
    Gx = dec.h1(Cx) @ membership(ax, a)              # (m, k_x)
    Gy = dec.h2(Cy) @ membership(ay, b)              # (n, k_y)
    Mid = Tc @ Gy.t()                                # (k_x, n)
    return t1, t2, Gx, Mid


def block_refine(problem, ax: AnchorAssignment, ay: AnchorAssignment, Tc,
                 *, cap_x: int, cap_y: int, max_pairs: int, epsilon,
                 iters: int, tol: float) -> QuantizedCoupling:
    """Expand the coarse coupling Tc into a ``QuantizedCoupling``."""
    Cx, a = problem.geom_x.cost_matrix, problem.geom_x.weights
    Cy, b = problem.geom_y.cost_matrix, problem.geom_y.weights
    fused = problem.is_fused
    alpha = scalar(problem.fused_penalty) if fused else 1.0

    tx, mask_x, u, dx = _member_side(Cx, a, ax, cap_x)
    ty, mask_y, v, dy = _member_side(Cy, b, ay, cap_y)
    pr, pc, mass = top_pairs(Tc, max_pairs)
    mx, my = tx[pr], ty[pc]                          # (B, cap_x), (B, cap_y)
    if gc.get_decomposition(problem.loss) is not None:
        t1, t2, Gx, Mid = _linearized_factors(problem, ax, ay, Tc)
        E = (t1[mx][:, :, None] + t2[my][:, None, :]
             - torch.bmm(Gx[mx], Mid.t()[my].transpose(1, 2)))
    else:
        E = gc.get_loss(problem.loss)(dx[pr][:, :, None], dy[pc][:, None, :])
    if fused:
        E = alpha * E + (1.0 - alpha) * problem.linear_cost_at(
            mx[:, :, None], my[:, None, :])
    blocks = sinkhorn_log_batched(u[pr], v[pc], -E / epsilon, iters, tol=tol)
    blocks = flush_subnormal(blocks * mass[:, None, None])
    # zero the (≈1e-30-mass) padded slots exactly; padded member index -> 0
    blocks = blocks * mask_x[pr][:, :, None] * mask_y[pc][:, None, :]
    return QuantizedCoupling(pr, pc, mx, my, blocks)
