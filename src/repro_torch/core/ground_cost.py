"""Ground cost functions L(x, y) on tensors (counterpart of repro.core.ground_cost).

``l1`` is the paper's canonical indecomposable cost; ``kl`` clamps both
arguments at ``_KL_EPS`` before the logs, as the reference does.
"""
from __future__ import annotations

from typing import Callable

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


LOSSES = {"l1": l1, "l2": l2, "kl": kl}


def get_loss(name: str) -> Callable:
    return LOSSES[name]
