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
    return torch.where(torch.abs(x) < FLT_MIN, 0.0, x)


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
    # den > 0 once den is flushed; where it is not, the quotient is dropped
    pos = den >= FLT_MIN
    return flush_subnormal(torch.where(pos, flush_subnormal(num) / den, 0.0))


def generalized_kl(p, q):
    """KL(p || q) = Σ p log(p/q) - m(p) + m(q) for nonnegative vectors."""
    p, q = flush_subnormal(p), flush_subnormal(q)
    eps = 1e-30
    p_ = torch.clamp_min(p, eps)
    q_ = torch.clamp_min(q, eps)
    return (torch.sum(p * (torch.log(p_) - torch.log(q_))) - torch.sum(p)
            + torch.sum(q))


def quadratic_kl(p, q):
    """KL^⊗(p || q) = KL(p ⊗ p || q ⊗ q) (Séjourné et al., 2021)."""
    p, q = flush_subnormal(p), flush_subnormal(q)
    mp, mq = torch.sum(p), torch.sum(q)
    eps = 1e-30
    cross = torch.sum(p * (torch.log(torch.clamp_min(p, eps))
                           - torch.log(torch.clamp_min(q, eps))))
    return 2.0 * mp * cross - mp ** 2 + mq ** 2
