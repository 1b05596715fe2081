"""GW representation alignment for LM training and serving.

Counterpart of ``repro.core.align``. ``gw_alignment_loss`` is a
differentiable entropic Grid-SPAR-GW distance between the token-relation
geometries of two hidden-state tensors (teacher and student layers, or
two models across incomparable spaces). Dense relation matrices are S x S;
importance sparsification makes the loss O(s_r s_c) instead.

The gradient with respect to the hidden states is autograd through the
plain unrolled loop (``core/grid_gw.grid_spar_gw_differentiable``): for
the l2 loss no kernel is on this path, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.grid_gw import grid_spar_gw_differentiable


def _pairwise_sq_dists(h):
    """(S, D) -> (S, S) squared euclidean relation matrix."""
    sq = torch.sum(h * h, dim=-1)
    G = h @ h.t()
    d = sq[:, None] + sq[None, :] - 2.0 * G
    return torch.clamp_min(d, 0.0)


def _at_least_f32(x):
    return x.float() if x.element_size() < 4 else x


def _draw(generator, S: int, k: int, device):
    return torch.randint(0, S, (k,), generator=generator,
                         device=generator.device).to(device)


def gw_alignment_loss(generator, h_x, h_y, s_r: int = 64, s_c: int = 64,
                      epsilon: float = 0.05, outer_iters: int = 3,
                      inner_iters: int = 10, draws=None):
    """Batched GW distance between hidden geometries; the scalar mean GW.

    h_x: (B, S, D_x), h_y: (B, S, D_y) — different widths are fine (GW
    compares relation matrices, not features). Per example, a row set R
    (s_r tokens) and a col set C (s_c tokens) are drawn uniformly with
    replacement from ``generator``, R then C; ``draws=(R, C)`` with R
    (B, s_r) and C (B, s_c) fixes them instead (the parity tests pass the
    reference's ``split``/``randint`` draws). Runs on the hidden states'
    device.

    Each token is normalized to unit length before its relations are
    formed, as in the reference; only the drawn tokens are normalized
    (the same values: the norm is per token). Relation matrices of a
    16-bit dtype are taken in float32: jnp promotes a bfloat16 one to
    float32 at its first product with the float32 weights, torch refuses
    mixed dtypes there. A float64 input stays float64.
    """
    B, S, _ = h_x.shape
    vals = []
    for i in range(B):
        if draws is None:
            R = _draw(generator, S, s_r, h_x.device)
            C = _draw(generator, S, s_c, h_x.device)
        else:
            R = torch.as_tensor(draws[0][i], dtype=torch.int64,
                                device=h_x.device)
            C = torch.as_tensor(draws[1][i], dtype=torch.int64,
                                device=h_y.device)
        hx, hy = h_x[i][R], h_y[i][C]
        hxn = hx / (torch.linalg.norm(hx, dim=-1, keepdim=True) + 1e-6)
        hyn = hy / (torch.linalg.norm(hy, dim=-1, keepdim=True) + 1e-6)
        CxR = _at_least_f32(_pairwise_sq_dists(hxn))
        CyC = _at_least_f32(_pairwise_sq_dists(hyn))
        f = dict(dtype=CxR.dtype, device=CxR.device)
        aR = torch.full((s_r,), 1.0 / s_r, **f)
        bC = torch.full((s_c,), 1.0 / s_c, **f)
        w = torch.ones((s_r, s_c), **f)      # uniform measure: uniform w
        val, _ = grid_spar_gw_differentiable(
            aR, bC, CxR, CyC, aR, bC, w, "l2", epsilon, outer_iters,
            inner_iters)
        vals.append(val)
    return torch.mean(torch.stack(vals))
