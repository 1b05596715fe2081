"""GQA self-attention (the port of ``repro.models.attention``'s GQA part).

Projections are stored flat ``(d_model, n·head_dim)`` as in the reference.
Train and prefill take ``cache=None`` and return the fresh cache ``(k, v)``.
With ``use_flash`` the causal attention runs through the flash attention
kernel (K5), where the reference runs its blockwise XLA scan
(``blockwise_gqa``, whose TPU analogue K5 is); otherwise through the masked
scores path ``_gqa_scores_combine``. MLA, cross-attention and the decode
cache branch are not ported yet (ROADMAP item 17).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.layers import apply_rope
from repro_torch.models.module import Builder

NEG_INF = -1e30


def gqa_params(b: Builder, cfg: ArchConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": b.param((d, cfg.n_heads * hd)),
        "wk": b.param((d, cfg.n_kv_heads * hd)),
        "wv": b.param((d, cfg.n_kv_heads * hd)),
        "wo": b.param((cfg.n_heads * hd, d)),
    }


def _gqa_scores_combine(q, k, v, mask):
    """q: (B,S,K,G,hd), k/v: (B,T,K,hd), mask: (S,T) bool."""
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float()
    scores = scores / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v)


def gqa_attention(p, cfg: ArchConfig, x, positions, cache=None,
                  use_flash: bool = False, use_kernel: bool = True):
    """Causal self-attention for train and prefill. Returns
    (out, (k, v)).

    ``use_kernel=False`` sends the ``use_flash`` branch to K5's plain
    version (float32 inside, output in q's dtype) instead of the kernel;
    it exists to hold the kernel against its plain version on the card.
    """
    if cache is not None:
        raise NotImplementedError("the decode cache branch is not ported "
                                  "yet (ROADMAP item 17)")
    B, S, _ = x.shape
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    H = cfg.n_heads
    G = H // K
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, K, hd)
    v = (x @ p["wv"]).reshape(B, S, K, hd)
    q = apply_rope(q, positions, cfg.rope_theta)       # head h = kv·G + g
    k = apply_rope(k, positions, cfg.rope_theta)

    if use_flash and S > 1:
        if use_kernel:
            out = flash_attention(q, k, v, device=x.device)
        else:
            out = attention_ref(q.float(), k.float(), v.float()).to(q.dtype)
    else:
        mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
        out = _gqa_scores_combine(q.reshape(B, S, K, G, hd), k, v, mask)
    out = out.reshape(B, S, H * hd)
    return out @ p["wo"], (k, v)
