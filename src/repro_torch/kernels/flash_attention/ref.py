"""Plain PyTorch version of causal GQA attention (K5's plain version).

The counterpart of the reference's oracle ``attention_ref``: layout
(B, S, H, hd) for q and (B, S, K, hd) for k and v, H = G·K, q head h
reading kv head h // G, scale 1/√hd, the -1e30 causal mask and the softmax
in float32. The scores and the probabilities follow the inputs' dtype as
the reference's einsums do; the kernel's plain version
(``flash_attention.flash_attention_plain``) calls this in float32.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, causal: bool = True):
    """q: (B, S, H, hd); k, v: (B, S, K, hd), H = G·K -> (B, S, H, hd)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    s = s / math.sqrt(hd)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def attention_error_scale(q, k, v):
    """Per-output scale of fp32 rounding in causal attention, (B, S, H, hd).

    Σ_t p_st·|v_t|: the output's sum taken over absolute values. Two
    correct fp32 evaluations that sum in other orders differ by about
    (terms added in sequence)·2⁻²⁴ of it.
    """
    return attention_ref(q.float(), k.float(), v.float().abs())
