"""GQA self-attention (the port of ``repro.models.attention``'s GQA part).

Projections are stored flat ``(d_model, n·head_dim)`` as in the reference.
Train and prefill take ``cache=None`` and return the fresh cache ``(k, v)``.
With ``use_flash`` the causal attention runs through the flash attention
kernel (K5), where the reference runs its blockwise XLA scan
(``blockwise_gqa``, whose TPU analogue K5 is); otherwise through the masked
scores path ``_gqa_scores_combine``. Decode takes a cache ``(k, v)`` of
shape (B, T, K, hd) and a write offset, and always runs the scores path
(K5 is for S > 1, as the reference's ``use_flash`` is). MLA and
cross-attention are not ported yet (ROADMAP item 17b).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.layers import apply_rope
from repro_torch.models.module import Builder

NEG_INF = -1e30


class TensorSpec(NamedTuple):
    """Shape and dtype of one cache tensor (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def gqa_params(b: Builder, cfg: ArchConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": b.param((d, cfg.n_heads * hd)),
        "wk": b.param((d, cfg.n_kv_heads * hd)),
        "wv": b.param((d, cfg.n_kv_heads * hd)),
        "wo": b.param((cfg.n_heads * hd, d)),
    }


def _gqa_scores_combine(q, k, v, mask):
    """q: (B,S,K,G,hd), k/v: (B,T,K,hd), mask: (S,T) or (B,S,T) bool."""
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float()
    scores = scores / math.sqrt(q.shape[-1])
    if mask.dim() == 3:
        mask = mask[:, None, None]
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v)


def gqa_attention(p, cfg: ArchConfig, x, positions, cache=None,
                  cache_index=None, use_flash: bool = False,
                  use_kernel: bool = True):
    """Causal self-attention. Returns (out, cache).

    Train and prefill: ``cache=None``; the fresh ``(k, v)`` comes back.
    ``use_kernel=False`` sends the ``use_flash`` branch to K5's plain
    version (float32 inside, output in q's dtype) instead of the kernel;
    it exists to hold the kernel against its plain version on the card.

    Decode: ``cache=(k, v)`` of shape (B, T, K, hd) and ``cache_index``
    the absolute position of x's first token. The new k and v are written
    into the cache tensors in place at ``cache_index`` (the reference
    returns updated copies; in place spares a copy of every cache a
    step), keys at positions past the query's are masked, and the same
    tensors come back as the new cache.
    """
    B, S, _ = x.shape
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    H = cfg.n_heads
    G = H // K
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, K, hd)
    v = (x @ p["wv"]).reshape(B, S, K, hd)
    q = apply_rope(q, positions, cfg.rope_theta)       # head h = kv·G + g
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None:
        ck, cv = cache
        ck[:, cache_index:cache_index + S] = k.to(ck.dtype)
        cv[:, cache_index:cache_index + S] = v.to(cv.dtype)
        T = ck.shape[1]
        valid = torch.arange(T, device=x.device)[None, :] \
            <= positions[:, -1:]                       # absolute positions
        dt = torch.promote_types(q.dtype, ck.dtype)    # as jnp promotes
        out = _gqa_scores_combine(q.reshape(B, S, K, G, hd).to(dt),
                                  ck.to(dt), cv.to(dt),
                                  valid[:, None, :].expand(B, S, T))
        return out.reshape(B, S, H * hd) @ p["wo"], (ck, cv)

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


def gqa_cache_spec(cfg: ArchConfig, batch: int, seq: int, dtype):
    shape = (batch, seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return (TensorSpec(shape, dtype), TensorSpec(shape, dtype))
