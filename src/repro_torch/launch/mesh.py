"""Mesh construction, the port of ``repro.launch.mesh``.

Functions, not module constants: a mesh is built over the default process
group, which the caller initializes first (``torch.distributed`` with its
address, rank and world size; the dry run's ``fake`` group at 256 or 512
ranks). Each raises if the group's size does not match the mesh's.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.kernels import dispatch


def _mesh(shape, axes, device):
    from torch.distributed.device_mesh import init_device_mesh

    device_type = dispatch.resolve_device(device).type
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the default process group has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: (data=16, model=16) = 256 ranks; multi-pod: (pod=2,
    data=16, model=16) = 512 ranks. On the card's device type unless
    ``device`` says otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(shape=(2, 2), axes=("data", "model"), device=None):
    """A small mesh for multi-process tests (gloo ranks on the CPU with
    ``device="cpu"``)."""
    return _mesh(shape, axes, device)
