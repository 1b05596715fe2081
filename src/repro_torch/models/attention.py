"""Attention variants: GQA self-attention, MLA (latent) and
cross-attention (the port of ``repro.models.attention``).

Projections are stored flat ``(d_model, n·head_dim)`` as in the reference.
Train and prefill take ``cache=None`` and return the fresh cache ``(k, v)``.
With ``use_flash`` the causal attention runs through the flash attention
kernel (K5), where the reference runs its blockwise XLA scan
(``blockwise_gqa``, whose TPU analogue K5 is; ``use_kernel=False`` runs
it here, in float32, as K5's plain version); otherwise through the masked
scores path ``_gqa_scores_combine``. Decode takes a cache ``(k, v)`` of
shape (B, T, K, hd) and a write offset, and always runs the scores path
(K5 is for S > 1, as the reference's ``use_flash`` is).

MLA (MiniCPM3 / DeepSeek-V2 style) keeps the compressed latent
``(c_kv, k_rope)`` as its cache and expands keys and values from it; its
``use_flash`` branch is the reference's blockwise online softmax
(``blockwise_mla``) in torch ops, as the reference computes it outside
any Pallas kernel. Cross-attention attends, unmasked, from the text to
the image embeddings, gated by ``tanh(gate)``; it keeps no cache.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.dispatch import gqa_on_local_shards
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope
from repro_torch.models.module import Builder
from repro_torch.models.sharding_ctx import merge_last, split_last

NEG_INF = -1e30

# Blockwise-attention KV chunk size (the reference's ``_FLASH_CHUNK``): the
# default of ``blockwise_gqa`` and ``blockwise_mla``; a hill-climbing lever.
_FLASH_CHUNK = {"size": 512}


def set_flash_chunk(size: int):
    _FLASH_CHUNK["size"] = size


class TensorSpec(NamedTuple):
    """Shape and dtype of one cache tensor (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def gqa_params(b: Builder, cfg: ArchConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": b.param((d, cfg.n_heads * hd), ("embed", "heads")),
        "wk": b.param((d, cfg.n_kv_heads * hd), ("embed", "kv")),
        "wv": b.param((d, cfg.n_kv_heads * hd), ("embed", "kv")),
        "wo": b.param((cfg.n_heads * hd, d), ("heads", "embed")),
    }


def blockwise_gqa(q, k, v, chunk: int = 0):
    """Causal online-softmax attention over KV chunks of ``chunk`` keys
    (``set_flash_chunk``'s size unless given; halved until it divides S):
    the (S, S) scores never exist at full length. The reference's
    function, and K5's plain version on the ``use_flash`` path.

    q: (B,S,K,G,hd), k/v: (B,S,K,hd) -> (B,S,K,G,hd) in v's dtype.
    """
    B, S, K, G, hd = q.shape
    chunk = min(chunk or _FLASH_CHUNK["size"], S)
    while S % chunk != 0:
        chunk //= 2
    scale = 1.0 / math.sqrt(hd)
    q_pos = torch.arange(S, device=q.device)
    m = torch.full((B, K, G, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, K, G, hd), dtype=v.dtype, device=q.device)
    for t0 in range(0, S, chunk):
        s = torch.einsum("bskgd,btkd->bkgst", q,
                         k[:, t0:t0 + chunk]).float() * scale
        mask = (t0 + torch.arange(chunk, device=q.device))[None, :] \
            <= q_pos[:, None]                                # (S, chunk)
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        pr = torch.exp(s - m_new[..., None])
        l = l * corr + pr.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bskgd", pr.to(v.dtype),
                          v[:, t0:t0 + chunk])
        acc = acc * corr.permute(0, 3, 1, 2)[..., None].to(acc.dtype) + pv
        m = m_new
    return acc / l.permute(0, 3, 1, 2).clamp(min=1e-30)[..., None].to(
        acc.dtype)


def _blockwise_plain(q, k, v):
    """K5's plain version: q (B,S,H,hd), k/v (B,S,K,hd) -> (B,S,H,hd) in
    q's dtype, through :func:`blockwise_gqa` in float32."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    out = blockwise_gqa(q.float().reshape(B, S, K, H // K, hd), k.float(),
                        v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


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
    version, :func:`blockwise_gqa` in float32 (output in q's dtype),
    instead of the kernel; it holds the kernel against its plain version
    on the card, and the dry run takes it on fake tensors.

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
    q = split_last(x @ p["wq"], H, hd)
    k = split_last(x @ p["wk"], K, hd)
    v = split_last(x @ p["wv"], K, hd)
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
        out = _gqa_scores_combine(split_last(merge_last(q), K, G, hd).to(dt),
                                  ck.to(dt), cv.to(dt),
                                  valid[:, None, :].expand(B, S, T))
        return merge_last(out, out.ndim - 2) @ p["wo"], (ck, cv)

    if use_flash and S > 1:
        if use_kernel:
            out = flash_attention(q, k, v, device=x.device)
        else:
            out = gqa_on_local_shards(_blockwise_plain, q, k, v)
    else:
        mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
        out = _gqa_scores_combine(split_last(merge_last(q), K, G, hd), k, v,
                                  mask)
    out = merge_last(out, out.ndim - 2)
    return out @ p["wo"], (k, v)


def gqa_cache_spec(cfg: ArchConfig, batch: int, seq: int, dtype):
    shape = (batch, seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return (TensorSpec(shape, dtype), TensorSpec(shape, dtype))


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention
# ---------------------------------------------------------------------------

def mla_params(b: Builder, cfg: ArchConfig):
    d = cfg.d_model
    H = cfg.n_heads
    qr, kr = cfg.mla_q_rank, cfg.mla_kv_rank
    nd, rd, vd = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    return {
        "wq_a": b.param((d, qr), ("embed", "lora")),
        "q_norm": b.param((qr,), ("lora",), init="ones"),
        "wq_b": b.param((qr, H * (nd + rd)), ("lora", "heads")),
        "wkv_a": b.param((d, kr + rd), ("embed", "lora")),
        "kv_norm": b.param((kr,), ("lora",), init="ones"),
        "wkv_b": b.param((kr, H * (nd + vd)), ("lora", "heads")),
        "wo": b.param((H * vd, d), ("heads", "embed")),
    }


def _latent_norm(a, scale):
    """The latents' RMS norm: eps 1e-6, the factor cast to a's dtype
    before it multiplies (unlike ``layers.rmsnorm``)."""
    inv = torch.rsqrt((a.float() ** 2).mean(dim=-1, keepdim=True) + 1e-6)
    return a * inv.to(a.dtype) * scale


def _mla_qkv(p, cfg: ArchConfig, x, positions):
    B, S, _ = x.shape
    H = cfg.n_heads
    nd, rd = cfg.mla_nope_dim, cfg.mla_rope_dim
    kr = cfg.mla_kv_rank
    qa = _latent_norm(x @ p["wq_a"], p["q_norm"])
    q = split_last(qa @ p["wq_b"], H, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = x @ p["wkv_a"]
    c_kv = _latent_norm(ckv[..., :kr], p["kv_norm"])
    k_rope = apply_rope(ckv[..., kr:], positions, cfg.rope_theta)  # shared
    return q_nope, q_rope, c_kv, k_rope


def _mla_scale(cfg: ArchConfig) -> float:
    """1/√(nope + rope): the q·k width, not the config's head_dim."""
    return 1.0 / math.sqrt(cfg.mla_nope_dim + cfg.mla_rope_dim)


def _mla_attend(p, cfg: ArchConfig, q_nope, q_rope, c_kv, k_rope, mask):
    """Latent attention over all of c_kv: keys and values expanded from
    the latent. mask: (S, T) or (B, S, T) bool."""
    B, T, _ = c_kv.shape
    H = cfg.n_heads
    nd, vd = cfg.mla_nope_dim, cfg.mla_v_dim
    kv = split_last(c_kv @ p["wkv_b"], H, nd + vd)
    k_nope, v = kv[..., :nd], kv[..., nd:]
    s1 = torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
    s2 = torch.einsum("bshd,btd->bhst", q_rope, k_rope)
    scores = ((s1 + s2) * _mla_scale(cfg)).float()
    if mask.dim() == 3:
        mask = mask[:, None]
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs, v)
    return merge_last(out) @ p["wo"]


def blockwise_mla(p, cfg: ArchConfig, q_nope, q_rope, c_kv, k_rope,
                  chunk: int = 0):
    """Causal online-softmax MLA over KV chunks of ``chunk`` positions
    (``set_flash_chunk``'s size unless given; halved until it divides S):
    keys and values are expanded from the latent one chunk at a time, so
    neither the (S, S) scores nor the expanded KV exist at full length."""
    B, S, H, nd = q_nope.shape
    vd = cfg.mla_v_dim
    chunk = min(chunk or _FLASH_CHUNK["size"], S)
    while S % chunk != 0:
        chunk //= 2
    scale = _mla_scale(cfg)
    q_pos = torch.arange(S, device=c_kv.device)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32,
                   device=c_kv.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=c_kv.device)
    acc = torch.zeros((B, S, H, vd), dtype=c_kv.dtype, device=c_kv.device)
    for t0 in range(0, S, chunk):
        kv = split_last(c_kv[:, t0:t0 + chunk] @ p["wkv_b"], H,
                        nd + vd)
        k_nope, v = kv[..., :nd], kv[..., nd:]
        s = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
             + torch.einsum("bshd,btd->bhst", q_rope,
                            k_rope[:, t0:t0 + chunk])).float() * scale
        mask = (t0 + torch.arange(chunk, device=c_kv.device))[None, :] \
            <= q_pos[:, None]
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))             # (B,H,S)
        corr = torch.exp(m - m_new)
        pr = torch.exp(s - m_new[..., None])
        l = l * corr + pr.sum(dim=-1)
        pv = torch.einsum("bhst,bthd->bshd", pr.to(v.dtype), v)
        acc = acc * corr.transpose(1, 2)[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / l.transpose(1, 2).clamp(min=1e-30)[..., None].to(acc.dtype)
    return merge_last(out) @ p["wo"]


def mla_attention(p, cfg: ArchConfig, x, positions, cache=None,
                  cache_index=None, use_flash: bool = False):
    """Returns (out, cache). The cache is the compressed latent
    ``(c_kv (B, T, kv_rank), k_rope (B, T, rope_dim))``: fresh for train
    and prefill; in decode written in place at ``cache_index``, as the
    GQA cache is, with keys past the query's position masked."""
    B, S, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    if cache is None:
        if use_flash and S > 1:
            out = blockwise_mla(p, cfg, q_nope, q_rope, c_kv, k_rope)
        else:
            mask = torch.ones((S, S), dtype=torch.bool,
                              device=x.device).tril()
            out = _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, mask)
        return out, (c_kv, k_rope)
    cc, cr = cache
    cc[:, cache_index:cache_index + S] = c_kv.to(cc.dtype)
    cr[:, cache_index:cache_index + S] = k_rope.to(cr.dtype)
    T = cc.shape[1]
    valid = torch.arange(T, device=x.device)[None, :] <= positions[:, -1:]
    dt = torch.promote_types(q_nope.dtype, cc.dtype)  # as jnp promotes
    out = _mla_attend({**p, "wkv_b": p["wkv_b"].to(dt), "wo": p["wo"].to(dt)},
                      cfg, q_nope.to(dt), q_rope.to(dt), cc.to(dt),
                      cr.to(dt), valid[:, None, :].expand(B, S, T))
    return out, (cc, cr)


def mla_cache_spec(cfg: ArchConfig, batch: int, seq: int, dtype):
    return (TensorSpec((batch, seq, cfg.mla_kv_rank), dtype),
            TensorSpec((batch, seq, cfg.mla_rope_dim), dtype))


# ---------------------------------------------------------------------------
# Cross-attention (VLM image layers)
# ---------------------------------------------------------------------------

def xattn_params(b: Builder, cfg: ArchConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": b.param((d, cfg.n_heads * hd), ("embed", "heads")),
        "wk": b.param((d, cfg.n_kv_heads * hd), ("embed", "kv")),
        "wv": b.param((d, cfg.n_kv_heads * hd), ("embed", "kv")),
        "wo": b.param((cfg.n_heads * hd, d), ("heads", "embed")),
        "gate": b.param((1,), (None,), init="zeros"),
    }


def cross_attention(p, cfg: ArchConfig, x, kv_src):
    """x: (B, S, D) text; kv_src: (B, N_img, D) image embeddings (the stub
    frontend). Unmasked GQA, gated by tanh(gate) (zero at init, llama-3.2
    style). Float32 embeddings against bfloat16 activations compute the
    keys, values and output in float32, as jnp promotes."""
    if kv_src is None:
        raise ValueError("cross-attention needs the image embeddings (img)")
    B, S, _ = x.shape
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    H = cfg.n_heads
    G = H // K
    kv_src = kv_src.to(x.device)
    dt = torch.promote_types(x.dtype, kv_src.dtype)
    q = split_last(x @ p["wq"], K, G, hd).to(dt)
    k = split_last(kv_src.to(dt) @ p["wk"].to(dt), K, hd)
    v = split_last(kv_src.to(dt) @ p["wv"].to(dt), K, hd)
    mask = torch.ones((S, k.shape[1]), dtype=torch.bool, device=x.device)
    out = merge_last(_gqa_scores_combine(q, k, v, mask), 3)
    return torch.tanh(p["gate"]) * (out @ p["wo"].to(dt))
