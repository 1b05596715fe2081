"""Plain PyTorch version of the Mamba2 SSD intra-chunk block (K6's plain
version): the reference's oracle ``ssd_intra_ref``, batched over G.

Its forward is the reference's, value for value. Its gradient is the
reference's where that is finite: the reference takes exp of cs_s - cs_t
above the diagonal too and masks the product afterwards, so where that
exponent overflows (a chunk whose decays sum past ~88, as at zamba2-7b's
widths on random weights) its gradient is NaN; here the exponent is
masked first.
"""
from __future__ import annotations

import torch


def ssd_intra_ref(xdt, cs, Bm, Cm):
    """xdt: (G, k, H, P) inputs pre-multiplied by dt; cs: (G, k, H)
    within-chunk cumulative dA; Bm/Cm: (G, k, N). Returns y: (G, k, H, P)
    with y[s] = Σ_{t≤s} (C_s·B_t) exp(cs_s - cs_t) xdt[t]."""
    k = xdt.shape[1]
    tri = torch.ones((k, k), dtype=torch.bool, device=xdt.device).tril()
    # the exponent is masked before exp (the kernel never forms it above
    # the diagonal): there cs_s - cs_t > 0 may pass float32's exp range,
    # and exp's backward would send 0·inf = NaN through the masked entries
    diff = cs[:, :, None, :] - cs[:, None, :, :]
    decay = torch.exp(torch.where(tri[:, :, None], diff, 0.0))  # (G,k,k,H)
    Gm = Cm @ Bm.transpose(1, 2)                                  # (G,k,k)
    M = torch.where(tri[:, :, None], Gm[..., None] * decay, 0.0)
    return torch.einsum("gsth,gthp->gshp", M, xdt)


def ssd_intra_error_scale(xdt, cs, Bm, Cm):
    """Per-output scale of fp32 rounding in the intra-chunk block,
    (G, k, H, P): the output with every product taken in absolute value,
    Σ_{t≤s} (|C_s|·|B_t|) exp(cs_s - cs_t) |xdt[t]|. It bounds the Gram
    sum's terms and the sum over t, so two correct fp32 evaluations differ
    by about (N + k)·2⁻²⁴ of it."""
    return ssd_intra_ref(xdt.float().abs(), cs.float(), Bm.float().abs(),
                         Cm.float().abs())
