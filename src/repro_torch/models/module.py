"""Parameter declarations read in three modes (the reference's ``Builder``).

Module code declares each parameter once, with its shape, its logical
sharding axes and its init rule; a ``Builder`` reads the declarations in
one of three modes:

  · ``init``  — tensors drawn from a ``torch.Generator`` on a device: a
    fan-in scaled normal by default (scale 1/√shape[0]), ``zeros`` and
    ``ones``, and an explicit ``scale`` where a module gives one (the
    embedding's 0.02). The values differ from JAX's threefry draws; tests
    carry the reference's weights across instead (``models.interop``);
  · ``shape`` — tensors on the ``meta`` device: shapes and dtypes with no
    allocation (the dry run's abstract parameters);
  · ``axes``  — the logical axes tuples, which ``distrib.sharding`` maps to
    mesh placements.

The three trees have one structure by construction. The reference's
``vmapped`` (stacked superblocks under ``lax.scan``) has no counterpart:
the port keeps ``blocks`` as a list with one dict per superblock, so a
superblock leaf's axes carry no leading ``None``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import dispatch

MODES = ("init", "shape", "axes")


class Builder:
    """Reads parameter declarations in ``mode``; ``init`` draws every
    parameter on ``device`` from one generator, in declaration order."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32, mode: str = "init"):
        if mode not in MODES:
            raise ValueError(f"unknown Builder mode {mode!r}")
        if mode == "init" and generator is None:
            raise ValueError("init mode draws from a generator")
        self.mode = mode
        self.generator = generator
        self.device = torch.device(device if mode == "init" else "meta")
        self.dtype = dtype

    def param(self, shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
              init: str = "normal", scale: Optional[float] = None,
              dtype=None):
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in rank")
        if init not in ("normal", "zeros", "ones"):
            raise ValueError(f"unknown init {init!r}")
        dtype = dtype or self.dtype
        if self.mode == "axes":
            return tuple(axes)
        if self.mode == "shape":
            return torch.empty(shape, dtype=dtype, device="meta")
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if scale is None:
            fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
            scale = 1.0 / math.sqrt(fan_in)
        w = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)


def make(init_fn, cfg, mode: str, generator: Optional[torch.Generator] = None,
         dtype=torch.float32, device=None):
    """``init_fn(b, cfg)`` read by a ``Builder`` in ``mode``; ``init``
    draws from ``generator`` on ``device`` (the card unless given)."""
    if mode == "init":
        device = dispatch.resolve_device(device)
    b = Builder(generator, device, dtype, mode)
    return init_fn(b, cfg)
