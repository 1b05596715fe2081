"""Parameter building in init mode, from a ``torch.Generator``.

The counterpart of the reference's ``Builder`` in its ``init`` mode, with
its rules: a fan-in scaled normal by default (scale 1/√shape[0]), ``zeros``
and ``ones``, and an explicit ``scale`` where a module gives one (the
embedding's 0.02). The values differ from JAX's threefry draws; tests carry
the reference's weights across instead (``models.interop``). The ``shape``
and ``axes`` modes serve the reference's dry run and sharding, which are
not ported.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


class Builder:
    """Draws every parameter on ``device`` from one generator, in order."""

    def __init__(self, generator: torch.Generator, device,
                 dtype=torch.float32):
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype

    def param(self, shape: Tuple[int, ...], init: str = "normal",
              scale: Optional[float] = None, dtype=None):
        dtype = dtype or self.dtype
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if init != "normal":
            raise ValueError(f"unknown init {init!r}")
        if scale is None:
            fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
            scale = 1.0 / math.sqrt(fan_in)
        w = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)
