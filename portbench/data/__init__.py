"""Input generators of the benchmark's traffic, frozen here: one module a
problem family, named by a configuration's ``problem.family``.

A family module defines ``READS`` (the configuration keys it reads, as
``group.key``) and ``make_pool(config, n, size, seed, device) -> Pool``.
"""
from dataclasses import dataclass
from typing import List

import torch


@dataclass
class Pool:
    """Clouds made in set-up: their cost matrices on the device, and the two
    marginals of a pair (a for a request's first cloud, b for its
    second)."""
    costs: List[torch.Tensor]
    a: torch.Tensor
    b: torch.Tensor
