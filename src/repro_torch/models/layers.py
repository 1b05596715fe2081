"""Shared layers: RMSNorm, RoPE, SwiGLU MLP, embeddings, cross entropy.

The counterpart of ``repro.models.layers``. Where the reference mixes a
bfloat16 activation with a float32 factor, jnp promotes to float32; torch
does the same for elementwise ops, so the casts below sit where the
reference's ``astype`` calls are.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distrib.sharding import is_dtensor
from repro_torch.models.module import Builder


def rmsnorm_params(b: Builder, d: int):
    return {"scale": b.param((d,), ("embed",), init="ones")}


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
        "w_gate": b.param((d, f), ("embed", "mlp")),
        "w_up": b.param((d, f), ("embed", "mlp")),
        "w_down": b.param((f, d), ("mlp", "embed")),
    }


def mlp(p, x):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def embed_params(b: Builder, vocab: int, d: int):
    return {"table": b.param((vocab, d), ("vocab", "embed"), scale=0.02)}


def embed(p, tokens):
    table = p["table"]
    if is_dtensor(table):
        return _embed_on_mesh(table, tokens)
    return table[tokens]


def _embed_on_mesh(table, tokens):
    """The lookup on a mesh: the table gathered whole on every rank (the
    reference's sharded step fails on this very gather, ROADMAP §3; the
    DTensor rules for a vocabulary-split gather are not relied on), each
    rank's own tokens looked up, the rows placed as the tokens are (split
    over batch or replicated). Where the tokens are split, the table's
    gradient from each rank is a partial sum over the ranks."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = table.device_mesh
    if is_dtensor(tokens):
        placements, tokens = tokens.placements, tokens.to_local()
    else:
        placements = (Replicate(),) * mesh.ndim
    full = table.redistribute(mesh, (Replicate(),) * mesh.ndim).to_local(
        grad_placements=[Partial() if pl.is_shard() else Replicate()
                         for pl in placements])
    return DTensor.from_local(full[tokens], mesh, placements,
                              run_check=False)


def unembed(p_head, x):
    return x @ p_head


def cross_entropy(logits, labels):
    """Mean CE over tokens, in float32. labels: integer ids.

    Logits that are a DTensor (the mesh path) stay split over the
    vocabulary: :class:`_VocabParallelCE` runs on each rank's slice with
    two all-reduces of (B, S) values, where ``logsumexp`` and the gold
    gather would gather the logits whole (DTensor has no vocabulary-
    parallel rule for them, and its pointwise rules gather the slices in
    the backward)."""
    logits = logits.float()
    if is_dtensor(logits):
        return _vocab_parallel_ce(logits, labels).mean()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


class _VocabParallelCE(torch.autograd.Function):
    """Per-token ``logsumexp - gold`` of float32 logits split over the
    vocabulary across ``group``: ``local`` (..., V_l) this rank's slice,
    ``hit`` the mask of the gold entry within it. The max and the sums
    are all-reduced over the group (``group=None``: one slice, no
    reduction)."""

    @staticmethod
    def forward(ctx, local, hit, group):
        import torch.distributed as dist

        m = local.amax(dim=-1)
        if group is not None:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(local - m[..., None])
        sums = torch.stack([e.sum(dim=-1),
                            torch.where(hit, local, 0.0).sum(dim=-1)])
        if group is not None:
            dist.all_reduce(sums, group=group)
        ctx.save_for_backward(e, sums[0], hit)
        return m + torch.log(sums[0]) - sums[1]

    @staticmethod
    def backward(ctx, g):
        e, s, hit = ctx.saved_tensors
        return g[..., None] * (e / s[..., None] - hit.float()), None, None


def _vocab_parallel_ce(logits, labels):
    """The per-token CE of a DTensor of logits on each rank's slice of
    the vocabulary (split over at most one mesh dim: a split over more is
    kept on the first), as a DTensor laid out as the logits' other
    dims."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, last = logits.device_mesh, logits.ndim - 1
    split = [i for i, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim == last]
    pl = [Replicate() if p.is_partial() or i in split[1:] else p
          for i, p in enumerate(logits.placements)]
    logits = logits.redistribute(mesh, pl)
    out_pl = [Replicate() if split and i == split[0] else p
              for i, p in enumerate(pl)]
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    lab = labels.redistribute(mesh, out_pl).to_local().long()
    local = logits.to_local()
    off, group = 0, None
    if split:
        i = split[0]
        chunk = -(-logits.shape[-1] // mesh.size(i))       # as Shard cuts
        off = min(mesh.get_local_rank(i) * chunk, logits.shape[-1])
        group = mesh.get_group(i)
        if dist.get_world_size(group) == 1:
            group = None
    vocab = off + torch.arange(local.shape[-1], device=local.device)
    ce = _VocabParallelCE.apply(local, vocab == lab[..., None], group)
    return DTensor.from_local(ce, mesh, out_pl, run_check=False)

