"""Plain PyTorch versions of the COO spar_cost family.

``spar_cost_ref`` is the paper-faithful row-chunked assembly (the plain
version of the gather-fused kernel). ``materialize_loss`` builds the
iteration-invariant loss matrix for the materialized mode, whose matvec is
the plain version of the matvec kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import ground_cost as gc


def spar_cost_ref(Cx, Cy, rows, cols, tvals, loss: str, chunk: int = 1024):
    """C̃(T̃)_k = Σ_l L(Cx[r_k, r_l], Cy[c_k, c_l]) T̃_l for k ∈ [s].  O(s²).

    Row-chunked so the gathered (chunk, s) blocks stay bounded.
    """
    L = gc.get_loss(loss)
    s = rows.shape[0]
    chunk = max(1, min(chunk, s))
    out = []
    for lo in range(0, s, chunk):
        rk, ck = rows[lo:lo + chunk], cols[lo:lo + chunk]
        Gx = Cx[rk][:, rows]               # (chunk, s)
        Gy = Cy[ck][:, cols]
        out.append(L(Gx, Gy) @ tvals)
    if not out:
        return tvals.new_zeros(0)
    return torch.cat(out)


def _loss_magnitude(loss: str, x, y):
    """Σ of the magnitudes of the terms that make up L(x, y) in fp32."""
    if loss == "l1":
        return torch.abs(x) + torch.abs(y)
    if loss == "l2":
        return (torch.abs(x) + torch.abs(y)) ** 2
    lx = torch.log(torch.clamp_min(x, gc._KL_EPS))
    ly = torch.log(torch.clamp_min(y, gc._KL_EPS))
    return torch.abs(x) * (torch.abs(lx) + torch.abs(ly)) + torch.abs(x) \
        + torch.abs(y)


def spar_cost_error_scale(Cx, Cy, rows, cols, t, off, loss: str,
                          chunk: int = 1024):
    """Per-row scale of fp32 rounding in ``L-matvec(t) + off``, (s,).

    Σ_l |terms of L(Cx[r_k, r_l], Cy[c_k, c_l])|·|t_l| + |off_k|. Two
    correct fp32 evaluations that sum in different orders differ by at
    most about (number of sequential additions)·2⁻²⁴ times this scale;
    it is what kernel-vs-plain checks hold their difference against (kl
    cancels, so |L| itself would be too small a scale).
    """
    s = rows.shape[0]
    chunk = max(1, min(chunk, s))
    out = []
    for lo in range(0, s, chunk):
        rk, ck = rows[lo:lo + chunk], cols[lo:lo + chunk]
        out.append(_loss_magnitude(loss, Cx[rk][:, rows], Cy[ck][:, cols])
                   @ torch.abs(t))
    return torch.cat(out) + torch.abs(off)


def materialize_loss(Cx, Cy, rows, cols, loss: str, chunk: int = None,
                     out=None):
    """Lmat[k, l] = L(Cx[r_k, r_l], Cy[c_k, c_l]) — (s, s) float32.

    Default is one vectorized gather with a ~3·s² transient (Gx, Gy,
    result); pass ``chunk`` to bound the transient to O(chunk·s). ``out``
    (an (s, s) float32 tensor, e.g. one lane of a lane stack) receives the
    matrix instead of a new one.
    """
    L = gc.get_loss(loss)
    if chunk is None:
        Lmat = L(Cx[rows][:, rows], Cy[cols][:, cols]).float()
        return Lmat if out is None else out.copy_(Lmat)
    s = rows.shape[0]
    Lmat = (torch.empty((s, s), dtype=torch.float32, device=Cx.device)
            if out is None else out)
    for lo in range(0, s, chunk):
        rk, ck = rows[lo:lo + chunk], cols[lo:lo + chunk]
        Lmat[lo:lo + chunk] = L(Cx[rk][:, rows], Cy[ck][:, cols])
    return Lmat
