"""Activation-sharding context shared by model components, the port of
``repro.models.sharding_ctx``.

Set by ``launch/train`` and ``launch/dryrun`` under a mesh; each constraint
is the identity unless sharding is enabled and its input is a DTensor
(parameters placed on a mesh make the activations DTensors). Then it
``redistribute``\\ s the input to the guarded placements, the counterpart
of the reference's ``with_sharding_constraint``. The guards are the
reference's: an entry is dropped when it does not divide its dim.
"""
from __future__ import annotations

import torch

_ACT_SHARD = {"enabled": False, "dp": ("data",), "dp_size": 1,
              "model_size": 1, "sp": False}


def set_activation_sharding(enabled: bool, dp=("data",), dp_size: int = 1,
                            model_size: int = 1, sp: bool = False):
    """``sp=True`` additionally shards the sequence dim of the residual
    stream over 'model' (sequence parallelism): per-layer activation saves
    under remat shrink by the TP degree, at an all-gather at layer entry
    (the Korthikanti et al. pattern). A hill-climbing lever."""
    _ACT_SHARD.update(enabled=enabled, dp=tuple(dp), dp_size=dp_size,
                      model_size=model_size, sp=sp)


def enabled() -> bool:
    return _ACT_SHARD["enabled"]


def guarded_spec(shape, *spec_entries):
    """The reference's spec for ``shape``: entries ``"dp"`` (the data
    axes), ``"model"`` or None, each dropped where it does not divide its
    dim (or the dim is 1)."""
    from repro_torch.distrib.sharding import Spec

    out = []
    for dim, e in zip(shape, spec_entries):
        if e == "dp":
            ok = dim % _ACT_SHARD["dp_size"] == 0 and dim > 1
            out.append(_ACT_SHARD["dp"] if ok else None)
        elif e == "model":
            out.append("model" if dim % _ACT_SHARD["model_size"] == 0
                       and dim > 1 else None)
        else:
            out.append(None)
    return Spec(*out)


def constrain(x, *spec_entries):
    """``x`` redistributed to the guarded spec of ``spec_entries`` when
    sharding is on and ``x`` is a DTensor; else ``x`` itself."""
    if not _ACT_SHARD["enabled"]:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = guarded_spec(x.shape, *spec_entries)
    placements = spec.placements(x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def constrain_acts(x):
    if _ACT_SHARD["sp"] and x.ndim >= 3:
        return constrain(x, "dp", "model", *([None] * (x.ndim - 2)))
    return constrain(x, "dp", *([None] * (x.ndim - 1)))


def constrain_logits(x):
    return constrain(x, "dp", *([None] * (x.ndim - 2)), "model")


def reduce_grad(x):
    """``x`` itself; where sharding is on and ``x`` is a DTensor, its
    gradient is brought back to x's own layout on the way back. A
    projection whose weight is split over 'model' by output columns gives
    its input a ``Partial`` gradient; left so, it reaches the previous
    block's last projection, where DTensor (which weighs bytes, not
    FLOPs) replicates that projection's weight and runs the product whole
    on every rank of 'model'. The reduction here is Megatron's ``f``: the
    identity forward, an all-reduce backward. No counterpart in the
    reference: XLA places that reduction itself."""
    if not _ACT_SHARD["enabled"]:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or any(p.is_partial()
                                         for p in x.placements):
        return x
    return _ReduceGrad.apply(x)


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g
        return g.redistribute(ctx.mesh, ctx.placements)


def _replicate_where(x, bad):
    """``x`` with the mesh dims where ``bad(placement, mesh size)`` holds
    redistributed to ``Replicate()``."""
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    pl = [Replicate() if bad(p, mesh.size(i)) else p
          for i, p in enumerate(x.placements)]
    if pl == list(x.placements):
        return x
    return x.redistribute(mesh, pl)


def split_last(x, *sizes):
    """``x.reshape(*x.shape[:-1], *sizes)``. On a DTensor whose last dim is
    split over a mesh dim that does not divide ``sizes[0]`` (a head count
    that the flat projection's width hides: 3 heads of 16 over 2 ranks),
    that mesh dim is replicated first, as XLA reshards such a reshape."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        last = x.ndim - 1
        x = _replicate_where(
            x, lambda p, n: p.is_shard(last) and sizes[0] % n != 0)
    return x.reshape(*x.shape[:-1], *sizes)


def local_elementwise(fn, x):
    """An elementwise ``fn`` (one with no DTensor rule, e.g. the backward
    of ``logsigmoid``) applied to each rank's shard of a DTensor, a
    ``Partial`` one reduced first; ``fn(x)`` on a plain tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return fn(x)
    x = _replicate_where(x, lambda p, n: p.is_partial())
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False)


class _MergeLast(torch.autograd.Function):
    """Reshape merging the last ``n`` dims, whose backward splits the
    gradient with :func:`split_last`: the gradient of a projection that is
    split over a mesh dim may not split evenly into heads."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.sizes = tuple(x.shape[-n:])
        return x.reshape(*x.shape[:-n], -1)

    @staticmethod
    def backward(ctx, g):
        return split_last(g, *ctx.sizes), None


def merge_last(x, n: int = 2):
    """``x`` with its last ``n`` dims merged into one (heads back into the
    flat projection width); a plain reshape off the mesh."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _MergeLast.apply(x, n)
    return x.reshape(*x.shape[:-n], -1)
