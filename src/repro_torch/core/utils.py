"""Small shared utilities for the GW core, and the reference's subnormal flush.

XLA (on the CPU and on the TPU) flushes float32 subnormals to zero, on
input and on output of every operation; PyTorch keeps them, on the CPU and
on the card. Where that changes a result (a log, a division, a ``> 0``
test) the port flushes explicitly, so both frameworks take the same
branch:

* ``log(max(x, 1e-38))`` in the reference is ``-inf`` for every x below
  the smallest normal (the 1e-38 floor is itself subnormal and flushes);
* ``x > 0`` is False for a subnormal x;
* a product that lands below the smallest normal is 0.
"""
from __future__ import annotations

import torch

FLT_MIN = torch.finfo(torch.float32).tiny     # smallest normal float32


def flush_subnormal(x):
    """x with every entry of magnitude below the smallest normal set to 0.

    NaN passes through (its comparison is False), as it does under XLA.
    """
    return torch.where(torch.abs(x) < FLT_MIN, torch.zeros_like(x), x)


def log_floor(x):
    """The reference's ``log(max(x, 1e-38))`` as XLA evaluates it.

    ``-inf`` for x below the smallest normal (zero and subnormals alike),
    ``log(x)`` above it, NaN for NaN.
    """
    return torch.log(torch.clamp_min(flush_subnormal(x), 0.0))


def safe_div(num, den):
    """num / den with 0 where den == 0 (dead Sinkhorn rows/cols).

    Inputs and output are flushed, so a subnormal denominator counts as 0
    exactly as in the reference.
    """
    num, den = flush_subnormal(num), flush_subnormal(den)
    pos = den > 0
    q = torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)),
                    torch.zeros_like(num))
    return flush_subnormal(q)
