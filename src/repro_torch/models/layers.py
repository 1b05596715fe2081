"""Shared layers: RMSNorm, RoPE, SwiGLU MLP, embeddings, cross entropy.

The counterpart of ``repro.models.layers``. Where the reference mixes a
bfloat16 activation with a float32 factor, jnp promotes to float32; torch
does the same for elementwise ops, so the casts below sit where the
reference's ``astype`` calls are.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.module import Builder


def rmsnorm_params(b: Builder, d: int):
    return {"scale": b.param((d,), init="ones")}


def rmsnorm(p, x, eps: float = 1e-5):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd) or (..., S, hd); positions: (..., S)."""
    inv = rope_frequencies(x.shape[-1], theta, x.device)     # (hd/2,)
    ang = positions[..., None].float() * inv                 # (..., S, hd/2)
    if x.ndim == ang.ndim + 1:                               # head axis present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_params(b: Builder, d: int, f: int):
    return {
        "w_gate": b.param((d, f)),
        "w_up": b.param((d, f)),
        "w_down": b.param((f, d)),
    }


def mlp(p, x):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def embed_params(b: Builder, vocab: int, d: int):
    return {"table": b.param((vocab, d), scale=0.02)}


def embed(p, tokens):
    return p["table"][tokens]


def cross_entropy(logits, labels):
    """Mean CE over tokens, in float32. labels: integer ids."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()
