"""Call-time device resolution, block sizing and memory budgets.

The PyTorch counterpart of ``repro.kernels.dispatch``. Two rules carry
over:

1. **Nothing is decided at import.** :func:`resolve_device` picks the
   device when an entry point is called: the caller's ``device`` if given,
   else the CUDA card. With no card and no explicit device it raises; it
   never falls back to the CPU silently.
2. **One knob surface.** Block sizes resolve as explicit argument >
   ``REPRO_BLOCK_<FAMILY>`` env var > registry default, and the memory
   budget comes from one place.

The reference's ``vmem_budget`` has no counterpart: no kernel here reads
an on-chip budget (K4 picks its route from the card's own numbers,
``kernels/sinkhorn/sinkhorn.sinkhorn_route``). Its padding helpers and
autotune cache are not ported: no kernel here pads (K1-K6 mask their
ragged edges) and no caller tunes a block size.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on, resolved now (not at import).

    ``device`` wins when given (``"cpu"`` runs the plain PyTorch versions
    of the kernels). Otherwise the port runs on the CUDA card and raises
    if there is none.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return torch.device("cuda")


def refuse_grad(kernel: str, *inputs) -> None:
    """Raise if autograd would have to differentiate through ``kernel``.

    The reference's Pallas kernels have no reverse-mode rule (``jax.grad``
    through them raises, in interpret mode too), and neither have their
    CUDA counterparts here: with grad enabled and any tensor among
    ``inputs`` requiring grad, this raises a ``RuntimeError`` that names
    the kernel instead of returning an output with no gradient. It looks
    at the inputs, not the device, so the plain version on the CPU
    refuses as the kernel does.
    """
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in inputs):
        raise RuntimeError(
            f"{kernel} has no backward: the reference's Pallas kernel "
            f"refuses reverse mode, and so does its port. Differentiate "
            f"through another impl (spar_gw: cost_impl='materialized' or "
            f"'jnp'; grid_gw: use_kernel=False), or call it under "
            f"torch.no_grad()")


def _env_bytes(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if not raw:
        return default
    return int(float(raw))


def materialize_budget() -> int:
    """Device-memory budget for materializing the (s, s) spar_cost loss matrix.

    16 GiB, a fifth of an 80 GB H100. It admits the main path's support
    (n = 2048, s = 16n = 32768: a 4 GiB matrix, built in one gather with a
    12 GiB transient) and leaves most of the card to the caller. Above it
    ``"auto"`` takes the gather-fused kernel, which needs no (s, s) storage.
    """
    return _env_bytes("REPRO_SPAR_MATERIALIZE_BUDGET", 16 * 2**30)


@dataclass
class KernelFamily:
    name: str
    default_block: int
    description: str = ""


_REGISTRY: dict[str, KernelFamily] = {}


def register(name: str, default_block: int,
             description: str = "") -> KernelFamily:
    """Register (or re-register, idempotently) a kernel family."""
    fam = KernelFamily(name, default_block, description)
    _REGISTRY[name] = fam
    return fam


def block_size(family: str, override: Optional[int] = None,
               cap: Optional[int] = None) -> int:
    """Resolve the block size for a kernel family.

    Priority: ``override`` arg > ``REPRO_BLOCK_<FAMILY>`` env > registry
    default (128 for an unregistered family). ``cap`` clamps from above
    while keeping the result >= 1.
    """
    bs = override
    if bs is None:
        env = os.environ.get(f"REPRO_BLOCK_{family.upper()}")
        if env:
            bs = int(env)
    if bs is None:
        fam = _REGISTRY.get(family)
        bs = fam.default_block if fam is not None else 128
    if cap is not None:
        bs = min(bs, cap)
    return max(int(bs), 1)


def on_local_shards(fn, args, roles, out_roles):
    """``fn(*args)`` on each rank's shards where ``args`` are DTensors
    (the mesh path): ``fn(*args)`` itself otherwise.

    A kernel takes plain tensors, and the SSD is independent per batch
    row and per head (attention too, :func:`gqa_on_local_shards`); so a
    kernel entry point runs on the local shards of its inputs, never on a
    gathered full tensor.
    ``roles[i]`` names the role of each dim of ``args[i]`` (e.g.
    ``("batch", None, "heads", None)``), ``out_roles`` those of the
    output's. On each mesh dim the first argument's split is kept where it
    falls on a role that every argument having it divides evenly;
    elsewhere the inputs are redistributed to replicated (a ``Partial``
    input is reduced). The output is a DTensor with the kept splits.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    anchor = next(a for a in args if isinstance(a, DTensor))
    mesh = anchor.device_mesh
    args = [a if isinstance(a, DTensor) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False) for a in args]
    kept = []                          # per mesh dim: a role or None
    for i, pl in enumerate(args[0].placements):
        role = roles[0][pl.dim] if isinstance(pl, Shard) else None
        if role is not None and all(
                a.shape[r.index(role)] % mesh.size(i) == 0
                for a, r in zip(args, roles) if role in r) and \
                role not in kept:
            kept.append(role)
        else:
            kept.append(None)

    def placements(r):
        return [Shard(r.index(k)) if k is not None and k in r
                else Replicate() for k in kept]

    local = [a.redistribute(mesh, placements(r)).to_local()
             for a, r in zip(args, roles)]
    out = fn(*local)
    return DTensor.from_local(out, mesh, placements(out_roles),
                              run_check=False)


def gqa_on_local_shards(fn, q, k, v):
    """``fn(q, k, v)`` for causal GQA attention, q (B, S, H, hd) and k, v
    (B, S, K, hd), on each rank's shards where they are DTensors;
    ``fn(q, k, v)`` itself otherwise. ``fn`` reads the group size from
    its inputs' shapes (q head h reads kv head h // (H / K)).

    As :func:`on_local_shards` with the roles (batch, -, heads, -), except
    that q keeps a head split that its own H divides even where the kv
    heads do not split as far (llama3-8b's 8 kv heads on 16 'model'
    ranks). Then k and v are gathered over that mesh dim and each rank
    takes the kv heads its own q heads read: one head read by all of them
    (G a multiple of the rank's q heads), else one kv head per q head. So
    ``fn`` runs on the rank's q heads only, never on all H. The gradient
    of the gathered k and v is each rank's part of the sum, a ``Partial``
    reduced over the mesh dim on the way back.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not any(isinstance(a, DTensor) for a in (q, k, v)):
        return fn(q, k, v)
    mesh = next(a for a in (q, k, v) if isinstance(a, DTensor)).device_mesh
    q, k, v = (a if isinstance(a, DTensor) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for a in (q, k, v))
    B, _, H, _ = q.shape
    K = k.shape[2]
    G = H // K
    roles = ("batch", None, "heads", None)
    kept = []                          # per mesh dim: a role or None
    for i, pl in enumerate(q.placements):
        role = roles[pl.dim] if isinstance(pl, Shard) else None
        size = {"batch": B, "heads": H}.get(role, 1)
        kept.append(role if role is not None and role not in kept
                    and size % mesh.size(i) == 0 else None)
    q_pl = [Shard(roles.index(r)) if r else Replicate() for r in kept]
    i_h = kept.index("heads") if "heads" in kept else None
    if i_h is None or K % mesh.size(i_h) == 0:
        kv_pl = grad_pl = q_pl
    else:
        kv_pl = [Replicate() if i == i_h else p for i, p in enumerate(q_pl)]
        grad_pl = [Partial() if i == i_h else p for i, p in enumerate(q_pl)]
    ql = q.redistribute(mesh, q_pl).to_local()
    kl, vl = (a.redistribute(mesh, kv_pl).to_local(grad_placements=grad_pl)
              for a in (k, v))
    if kv_pl is not q_pl:
        Hl = H // mesh.size(i_h)
        h0 = mesh.get_local_rank(i_h) * Hl
        if G % Hl == 0:
            kl, vl = (a[:, :, h0 // G:h0 // G + 1] for a in (kl, vl))
        else:
            idx = torch.arange(h0, h0 + Hl, device=kl.device) // G
            kl, vl = (a.index_select(2, idx) for a in (kl, vl))
    return DTensor.from_local(fn(ql, kl, vl), mesh, q_pl, run_check=False)
