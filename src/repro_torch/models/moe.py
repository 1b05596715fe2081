"""Mixture-of-Experts MLP with top-k routing: the port of
``repro.models.moe``, both dispatch formulations.

``gshard`` (the default): tokens in groups of ``Sg = min(4096, T)``
(halved until Sg divides T), a capacity per group, slots filled choice by
choice (every token's first choice before any second one), within a
choice in token order; a token whose slot index reaches the capacity is
dropped. The reference builds the (G, E, cap, D) expert buffer with a
one-hot einsum; here each token is put into its slot by index (a dropped
one into a spare slot that is cut off, so that no boolean mask makes the
host wait for the device), and each token gathers its slots' outputs
back. A slot holds one token, so the values are the same, without the
einsum's G·Sg·E·cap·D products (~107 GFLOP a layer at llama4-scout's
width). The Switch aux loss counts the *kept* assignments.

``sort``: the assignments sorted by expert (a stable sort) into an
(E, cap, D) buffer with one global capacity; its aux loss counts *all*
assignments, as the reference's does.

Both return the Switch load-balancing loss; ``no_drop=True`` sizes the
buffers so that nothing drops (decode). Routing ties go to the lower
expert index, as ``lax.top_k`` breaks them (``torch.topk`` does not
promise it). ``sharding_ctx.constrain`` is the identity on one card and
is left out; the reference's ``bf16_dispatch`` lever waits for its only
caller (``launch/hillclimb.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import mlp, mlp_params
from repro_torch.models.module import Builder

_GROUP_SIZE = 4096


def moe_params(b: Builder, cfg: ArchConfig):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": b.param((d, E)),
        "w_gate": b.param((E, d, f)),
        "w_up": b.param((E, d, f)),
        "w_down": b.param((E, f, d)),
    }
    if cfg.shared_expert:
        p["shared"] = mlp_params(b, d, f)
    return p


def moe_mlp(p, cfg: ArchConfig, x, no_drop: bool = False,
            impl: str = "gshard"):
    """x: (B, S, D) -> (out (B, S, D), aux loss, a float32 scalar)."""
    if impl == "gshard":
        return moe_mlp_gshard(p, cfg, x, no_drop=no_drop)
    if impl == "sort":
        return moe_mlp_sort(p, cfg, x, no_drop=no_drop)
    raise ValueError(f"unknown MoE impl {impl!r}")


def _route(p, x, k: int):
    """Router logits in float32, their softmax, and the top-k (values,
    expert ids) with ties to the lower id (a stable descending sort)."""
    logits = (x @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    vals, sel = torch.sort(logits, dim=-1, descending=True, stable=True)
    return probs, vals[..., :k], sel[..., :k]


def _experts(p, buf):
    """The SwiGLU experts on their slots: buf (..., E, cap, D)."""
    h = torch.einsum("...ecd,edf->...ecf", buf, p["w_gate"])
    h = F.silu(h) * torch.einsum("...ecd,edf->...ecf", buf, p["w_up"])
    return torch.einsum("...ecf,efd->...ecd", h, p["w_down"])


def moe_mlp_gshard(p, cfg: ArchConfig, x, no_drop: bool = False):
    """GShard dispatch with per-group capacity. x: (B,S,D) -> (out, aux)."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.experts_per_token
    Sg = min(_GROUP_SIZE, T)
    while T % Sg != 0:
        Sg //= 2
    G = T // Sg
    cap = Sg * k if no_drop else max(1, int(Sg * k / E * cfg.capacity_factor))
    xg = x.reshape(G, Sg, D)

    probs, gate_vals, sel = _route(p, xg, k)                 # (G,Sg,k)
    weights = torch.softmax(gate_vals, dim=-1)

    # slot of each (token, choice): the assignments to its expert before it,
    # every earlier choice's included (dropped ones too), as counts_used
    counts_used = torch.zeros((G, E), dtype=torch.int64, device=x.device)
    pos, keep = [], []
    for j in range(k):
        oh = F.one_hot(sel[..., j], E)                       # (G,Sg,E)
        before = torch.cumsum(oh, dim=1) - oh + counts_used[:, None, :]
        pos_j = torch.gather(before, 2, sel[..., j:j + 1])[..., 0]
        pos.append(pos_j)
        keep.append(pos_j < cap)
        counts_used = counts_used + oh.sum(dim=1)
    pos, keep = torch.stack(pos, -1), torch.stack(keep, -1)  # (G,Sg,k)

    # Switch aux loss: the kept assignments' share per expert
    kept = torch.zeros((E,), dtype=torch.float32, device=x.device)
    kept = kept.index_add_(0, sel.reshape(-1), keep.reshape(-1).float())
    frac = kept / (G * Sg)
    aux = E * torch.sum(frac / k * probs.mean(dim=(0, 1)))

    # token -> slot by index, a dropped one to the spare slot ``cap``, cut
    # off after (no mask, so no host sync); the empty slots stay 0, as the
    # einsum leaves them
    gi = torch.arange(G, device=x.device)[:, None, None].expand(G, Sg, k)
    slot = torch.where(keep, pos, cap)
    buf = x.new_zeros((G, E, cap + 1, D)).index_put(
        (gi, sel, slot), xg[:, :, None, :].expand(G, Sg, k, D))
    y = _experts(p, buf[:, :, :cap])                         # (G,E,cap,D)

    # each token sums its kept slots' outputs at its gate weights (in the
    # activation dtype, accumulated in float32 as the einsum does)
    w = (weights * keep).to(x.dtype).float()
    got = y[gi, sel, pos.clamp(max=cap - 1)]                 # (G,Sg,k,D)
    out = (got.float() * w[..., None]).sum(dim=2).to(x.dtype)
    out = out.reshape(B, S, D)
    if cfg.shared_expert:
        out = out + mlp(p["shared"], x)
    return out, aux


def moe_mlp_sort(p, cfg: ArchConfig, x, no_drop: bool = False):
    """Sort dispatch with one global capacity. x: (B,S,D) -> (out, aux)."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.experts_per_token
    cap = T * k if no_drop else max(1, int(T * k / E * cfg.capacity_factor))
    xf = x.reshape(T, D)

    probs, gate_vals, sel = _route(p, xf, k)                 # (T,k)
    weights = torch.softmax(gate_vals, dim=-1).to(x.dtype)

    # Switch aux loss over all assignments, dropped ones included
    ex = sel.reshape(-1)                                     # (T·k,)
    counts = torch.bincount(ex, minlength=E).float()
    aux = E * torch.sum((counts / (T * k)) * probs.mean(dim=0))

    # assignments sorted by expert; rank within the expert is the slot
    wt = weights.reshape(-1)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    order = torch.argsort(ex, stable=True)
    ex_s, tok_s, wt_s = ex[order], tok[order], wt[order]
    pos = torch.arange(T * k, device=x.device) - torch.searchsorted(
        ex_s, ex_s, side="left")
    keep = pos < cap
    slot = torch.where(keep, pos, cap)                       # overflow: cap
    buf = x.new_zeros((E, cap + 1, D)).index_put((ex_s, slot), xf[tok_s])
    y = _experts(p, buf[:, :cap])                            # (E,cap,D)

    gathered = y[ex_s, pos.clamp(max=cap - 1)]               # (T·k, D)
    contrib = gathered * (wt_s * keep.to(x.dtype))[:, None]
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device).index_add(
        0, tok_s, contrib)
    if cfg.shared_expert:
        out = out + mlp(p["shared"], xf)
    return out.reshape(B, S, D), aux
