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


def scalar(x) -> float:
    """A problem scalar (``fused_penalty``, ``lam``) as a Python float: a
    tensor's value, read without autograd (it may require grad)."""
    return float(x.detach()) if isinstance(x, torch.Tensor) else float(x)


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
    exactly as in the reference. As there, the dropped entries divide by 1
    instead of 0, so their gradient is 0 and not NaN (autograd multiplies
    the zero cotangent of the dropped branch by 1/den).
    """
    # den > 0 once den is flushed; where it is not, the quotient is dropped
    pos = den >= FLT_MIN
    return flush_subnormal(torch.where(
        pos, flush_subnormal(num) / torch.where(pos, den, 1.0), 0.0))


def div_floor(num, den):
    """The reference's ``num / max(den, 1e-38)`` as XLA evaluates it.

    The floor is itself subnormal and flushes, so a ``den`` below the
    smallest normal divides by 0: NaN for 0/0, ±inf otherwise.
    """
    den = torch.where(den < FLT_MIN, 0.0, den)
    return flush_subnormal(flush_subnormal(num) / den)


def chunked_rows(fn, n_rows: int, chunk: int):
    """Apply ``fn(start_index, chunk_size)`` over row chunks, concat results.

    The last chunk is ragged (``n_rows - start`` rows); ``fn`` handles it.
    """
    chunk = min(chunk, n_rows)
    return torch.cat([fn(lo, min(chunk, n_rows - lo))
                      for lo in range(0, n_rows, chunk)], dim=0)


def total_mass(x):
    return torch.sum(x)


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
