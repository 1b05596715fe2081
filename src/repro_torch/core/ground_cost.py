"""Ground cost functions L(x, y) on tensors (counterpart of repro.core.ground_cost).

A cost is *decomposable* (Peyré et al., 2016) when
``L(x, y) = f1(x) + f2(y) - h1(x) h2(y)``, which enables the two-matmul
grid path. ``l1`` is the paper's canonical indecomposable cost; ``kl``
clamps both arguments at ``_KL_EPS`` before the logs, as the reference
does.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

_KL_EPS = 1e-10


def l1(x, y):
    return torch.abs(x - y)


def l2(x, y):
    return (x - y) ** 2


def kl(x, y):
    xs = torch.clamp_min(x, _KL_EPS)
    ys = torch.clamp_min(y, _KL_EPS)
    return x * (torch.log(xs) - torch.log(ys)) - x + y


class Decomposition(NamedTuple):
    f1: Callable
    f2: Callable
    h1: Callable
    h2: Callable


LOSSES = {"l1": l1, "l2": l2, "kl": kl}

DECOMPOSITIONS: dict[str, Optional[Decomposition]] = {
    "l1": None,
    # (x-y)^2 = x^2 + y^2 - x * 2y
    "l2": Decomposition(
        f1=lambda x: x**2, f2=lambda y: y**2, h1=lambda x: x,
        h2=lambda y: 2.0 * y),
    # x log(x/y) - x + y = (x log x - x) + y - x log y
    "kl": Decomposition(
        f1=lambda x: x * torch.log(torch.clamp_min(x, _KL_EPS)) - x,
        f2=lambda y: y,
        h1=lambda x: x,
        h2=lambda y: torch.log(torch.clamp_min(y, _KL_EPS))),
}


def get_loss(name: str) -> Callable:
    return LOSSES[name]


def get_decomposition(name: str) -> Optional[Decomposition]:
    return DECOMPOSITIONS.get(name)
