"""Logical-axis → mesh-axis sharding rules (DP / FSDP / TP / SP / EP), the
port of ``repro.distrib.sharding``.

Every parameter carries a tuple of logical axis names (``models/module.py``
in ``axes`` mode); this module maps them to specs for a concrete mesh. A
spec is the reference's ``PartitionSpec`` as a tuple (:class:`Spec`): one
entry per tensor dim, ``None`` (replicated), a mesh axis name, or a tuple
of names (the dim split over several axes, major to minor), trailing
``None``\\ s dropped. :class:`NamedSharding` pairs it with a mesh and turns
it into DTensor placements: ``Shard(d)`` on each mesh dim that splits
tensor dim d, ``Replicate()`` on the others. :func:`shard` places a tree
of tensors by a tree of shardings (the reference's ``device_put``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims,
or, where no process group is needed (the rules alone), an
:class:`AbstractMesh` of axis names and sizes (the reference's
``jax.sharding.AbstractMesh``).

Rules are a plain dict so hill-climbing can override them. Divisibility
guard: a mesh axis is only assigned when it divides the dimension, else
the dim falls back to replication, so one rule table serves all ten
architectures (9-head GQA, 73448-vocab, batch-1 long-context cells).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

# FSDP over 'data' (params gathered per use), TP over 'model', EP over
# 'model' for experts.
DEFAULT_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": ("data",),
    "mlp": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "lora": (None,),
}


class AbstractMesh(NamedTuple):
    """Axis names and sizes with no process group behind them."""
    shape_tuple: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor placed on a mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return tuple(mesh.axis_names)
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    shape = mesh.shape_tuple if isinstance(mesh, AbstractMesh) \
        else tuple(mesh.shape)
    return dict(zip(axis_names(mesh), shape))


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Spec(tuple):
    """The reference's ``PartitionSpec``: a tuple of per-dim entries,
    normalized as it normalizes them (a one-name tuple is the name)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"

    def placements(self, mesh):
        """DTensor placements on ``mesh``, one per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard

        names = axis_names(mesh)
        out = [Replicate() for _ in names]
        for dim, entry in enumerate(self):
            axes = _axes_of(entry)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry} is not in the mesh's "
                                 f"axis order {names}")
            for i in idx:
                out[i] = Shard(dim)
        return tuple(out)


class NamedSharding(NamedTuple):
    """A mesh and a :class:`Spec` (the reference's ``NamedSharding``)."""
    mesh: object
    spec: Spec

    @property
    def placements(self):
        return self.spec.placements(self.mesh)


def spec_for(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
             mesh, rules: Optional[Dict] = None) -> Spec:
    rules = rules or DEFAULT_RULES
    sizes = axis_sizes(mesh)
    used = set()
    out = []
    for dim, name in zip(shape, axes):
        assigned = None
        if name is not None:
            for mesh_axis in rules.get(name, (None,)):
                if mesh_axis is None or mesh_axis in used:
                    continue
                if mesh_axis not in sizes:
                    continue
                if dim % sizes[mesh_axis] == 0:
                    assigned = mesh_axis
                    used.add(mesh_axis)
                    break
        out.append(assigned)
    while out and out[-1] is None:
        out.pop()
    return Spec(*out)


def is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(e, (str, type(None))) for e in x)


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (dicts, lists, tuples and
    NamedTuples walked; ``is_leaf`` stops the walk early)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, x, *(r[i] for r in rest), is_leaf=is_leaf)
                 for i, x in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(tree, *rest)


def param_shardings(axes_tree, shape_tree, mesh, rules=None):
    """A tree of :class:`NamedSharding` matching the params tree."""
    return tree_map(
        lambda axes, shp: NamedSharding(
            mesh, spec_for(tuple(axes), tuple(shp.shape), mesh, rules)),
        axes_tree, shape_tree, is_leaf=is_axes)


def data_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry the batch dim (pure DP across pods)."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def _dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= sizes[a]
    return n


def batch_sharding(mesh, ndim: int, batch_size: int,
                   seq_axis: Optional[str] = None,
                   seq_len: int = 0) -> NamedSharding:
    """Batch sharded over the data axes (divisibility-guarded); optional
    sequence sharding (SP) on dim 1."""
    dp = data_axes(mesh)
    first = dp if batch_size % _dp_size(mesh) == 0 else None
    rest = [None] * (ndim - 1)
    if seq_axis and ndim > 1 and \
            seq_len % axis_sizes(mesh)[seq_axis] == 0:
        rest[0] = seq_axis
    return NamedSharding(mesh, Spec(first, *rest))


def cache_sharding(mesh, shape, batch_size: int) -> NamedSharding:
    """KV caches: batch over data axes, seq (dim 1) over 'model'.

    Falls back per dim when sizes don't divide (e.g. batch=1 long-context:
    everything hangs off the seq dim instead)."""
    dp = data_axes(mesh)
    dp_size = _dp_size(mesh)
    model = axis_sizes(mesh)["model"]
    spec = [None] * len(shape)
    if len(shape) >= 2:
        if batch_size % dp_size == 0:
            spec[0] = dp
            if shape[1] % model == 0:
                spec[1] = "model"
        else:
            if shape[1] % (dp_size * model) == 0:
                spec[1] = tuple(dp) + ("model",)
            elif shape[1] % model == 0:
                spec[1] = "model"
    return NamedSharding(mesh, Spec(*spec))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, Spec())


def place(x: torch.Tensor, sharding: NamedSharding):
    """One tensor as a DTensor laid out by ``sharding``. Every rank holds
    the same global tensor and keeps its own shard of it, so placing
    takes no communication (a DTensor is redistributed instead)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(x, DTensor):
        return x.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(x, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def shard(tree, shardings):
    """``tree`` placed leaf by leaf by the matching tree of
    :class:`NamedSharding` (the reference's ``jax.device_put``)."""
    return tree_map(place, tree, shardings)
