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
promise it). ``set_moe_options(bf16_dispatch=True)`` rounds the combine
weights to bfloat16, the reference's hill-climbing lever. On a mesh
(DTensor activations) gshard runs :func:`_gshard_mesh`, with the
reference's ``sharding_ctx.constrain`` sites.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distrib.sharding import is_dtensor
from repro_torch.models import sharding_ctx
from repro_torch.models.layers import mlp, mlp_params
from repro_torch.models.module import Builder
from repro_torch.models.sharding_ctx import constrain

_GROUP_SIZE = 4096

# Hillclimb lever: the combine weights in bfloat16 instead of float32 (the
# reference's combine tensor, its largest MoE transient); the gate weights
# stay float32 until they are rounded.
_MOE_OPTS = {"bf16_dispatch": False}


def set_moe_options(**kw):
    _MOE_OPTS.update(kw)


def moe_params(b: Builder, cfg: ArchConfig):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": b.param((d, E), ("embed", None)),
        "w_gate": b.param((E, d, f), ("expert", "embed", "mlp")),
        "w_up": b.param((E, d, f), ("expert", "embed", "mlp")),
        "w_down": b.param((E, f, d), ("expert", "mlp", "embed")),
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


def _slots(sel, E: int, cap: int):
    """Slot of each (token, choice) and whether it is kept: the
    assignments to its expert before it, every earlier choice's included
    (dropped ones too), as ``counts_used``. sel: (G,Sg,k) expert ids."""
    G, _, k = sel.shape
    counts_used = torch.zeros((G, E), dtype=torch.int64, device=sel.device)
    pos, keep = [], []
    for j in range(k):
        oh = F.one_hot(sel[..., j], E)                       # (G,Sg,E)
        before = torch.cumsum(oh, dim=1) - oh + counts_used[:, None, :]
        pos_j = torch.gather(before, 2, sel[..., j:j + 1])[..., 0]
        pos.append(pos_j)
        keep.append(pos_j < cap)
        counts_used = counts_used + oh.sum(dim=1)
    return torch.stack(pos, -1), torch.stack(keep, -1)     # (G,Sg,k)


def _kept_counts(sel, keep, E: int):
    """Kept assignments per expert, (E,) float32."""
    kept = torch.zeros((E,), dtype=torch.float32, device=sel.device)
    return kept.index_add_(0, sel.reshape(-1), keep.reshape(-1).float())


def _dispatch(xg, sel, pos, keep, E: int, cap: int):
    """The (G, E, cap, D) expert buffer. Each token goes to its slot by
    index, a dropped one to the spare slot ``cap``, cut off after (no
    mask, so no host sync); the empty slots stay 0, as the reference's
    einsum leaves them."""
    G, Sg, D = xg.shape
    k = sel.shape[-1]
    gi = torch.arange(G, device=xg.device)[:, None, None].expand(G, Sg, k)
    slot = torch.where(keep, pos, cap)
    buf = xg.new_zeros((G, E, cap + 1, D)).index_put(
        (gi, sel, slot), xg[:, :, None, :].expand(G, Sg, k, D))
    return buf[:, :, :cap]


def _combine(y, sel, pos, keep, weights, dtype):
    """Each token sums its kept slots' outputs at its gate weights, in the
    activation dtype ``dtype`` accumulated in float32 as the einsum does;
    with ``bf16_dispatch`` the weights are rounded to bfloat16 first (the
    reference's combine tensor). y: (G, E, cap, D) -> (G, Sg, D)."""
    G, Sg, k = sel.shape
    cap = y.shape[2]
    comb = torch.bfloat16 if _MOE_OPTS["bf16_dispatch"] else torch.float32
    w = (weights * keep).to(comb).to(dtype).float()
    gi = torch.arange(G, device=y.device)[:, None, None].expand(G, Sg, k)
    got = y[gi, sel, pos.clamp(max=cap - 1)]                 # (G,Sg,k,D)
    return (got.float() * w[..., None]).sum(dim=2).to(dtype)


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
    if is_dtensor(x):
        return _gshard_mesh(p, cfg, x, G, Sg, cap)
    xg = x.reshape(G, Sg, D)

    probs, gate_vals, sel = _route(p, xg, k)                 # (G,Sg,k)
    weights = torch.softmax(gate_vals, dim=-1)
    pos, keep = _slots(sel, E, cap)

    # Switch aux loss: the kept assignments' share per expert
    frac = _kept_counts(sel, keep, E) / (G * Sg)
    aux = E * torch.sum(frac / k * probs.mean(dim=(0, 1)))

    y = _experts(p, _dispatch(xg, sel, pos, keep, E, cap))  # (G,E,cap,D)
    out = _combine(y, sel, pos, keep, weights, x.dtype).reshape(B, S, D)
    if cfg.shared_expert:
        out = out + mlp(p["shared"], x)
    return out, aux


def _gshard_mesh(p, cfg: ArchConfig, x, G: int, Sg: int, cap: int):
    """:func:`moe_mlp_gshard` on a mesh (x a DTensor). The groups split
    over the data axes (where they divide) and the experts over 'model'
    at the reference's ``constrain`` sites; the routing, the slot
    assignment, the scatter into the expert buffer and the gather back
    run on each rank's own groups (index ops have no DTensor rule), and
    the experts' matmuls run as DTensor ops on the buffer split over
    experts, the reference's expert-parallel all-to-all."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    mesh = x.device_mesh
    dp = set(sharding_ctx._ACT_SHARD["dp"])
    rows = [Shard(0) if name in dp and B % mesh.size(i) == 0
            and G % mesh.size(i) == 0 else Replicate()
            for i, name in enumerate(mesh.mesh_dim_names)]
    x_rows = x.redistribute(mesh, rows)
    xg_l = x_rows.to_local().reshape(-1, Sg, D)              # own groups
    xg = constrain(DTensor.from_local(xg_l, mesh, rows, run_check=False),
                   "dp", None, None)

    probs, gate_vals, sel = _route(p, xg, k)                 # (G,Sg,k)
    weights = torch.softmax(gate_vals, dim=-1)
    sel_l = sel.redistribute(mesh, rows).to_local()
    pos_l, keep_l = _slots(sel_l, E, cap)

    partial = [Partial() if isinstance(r, Shard) else Replicate()
               for r in rows]
    kept = DTensor.from_local(_kept_counts(sel_l, keep_l, E), mesh, partial,
                              run_check=False)
    frac = kept / (G * Sg)
    aux = E * torch.sum(frac / k * probs.mean(dim=(0, 1)))

    xg_l = xg.redistribute(mesh, rows).to_local()
    buf = DTensor.from_local(_dispatch(xg_l, sel_l, pos_l, keep_l, E, cap),
                             mesh, rows, run_check=False)
    buf = constrain(buf, "dp", "model", None, None)          # EP all-to-all
    y = constrain(_experts(p, buf), "dp", "model", None, None)
    out_l = _combine(y.redistribute(mesh, rows).to_local(), sel_l, pos_l,
                     keep_l, weights.redistribute(mesh, rows).to_local(),
                     x.dtype)
    # the reference's constrain(out, "dp", None, None): out is in rows
    out = DTensor.from_local(out_l.reshape(-1, S, D), mesh, rows,
                             run_check=False)
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
