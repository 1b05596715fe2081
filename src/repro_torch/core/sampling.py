"""Importance-sampling probabilities and the COO sampler (paper §3.1, eq. 5).

The balanced probability p_ij ∝ sqrt(a_i b_j) is a product measure,
p_ij = (sqrt(a_i)/Z_a)(sqrt(b_j)/Z_b), so rows and cols are drawn
independently per pair: exact i.i.d. draws from p with O(m + n) setup.

``shrink`` interpolates toward the uniform distribution, which enforces
regularity condition (H.4): p_ij >= c3/n².

torch's generator gives other numbers than JAX's threefry from the same
seed; parity tests inject the reference's support instead.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class FactorizedProbs(NamedTuple):
    pa: torch.Tensor   # (m,) row factor, sums to 1
    pb: torch.Tensor   # (n,) col factor, sums to 1

    def pair_prob(self, rows, cols):
        return self.pa[rows] * self.pb[cols]


def balanced_probs(a, b, shrink: float = 0.0) -> FactorizedProbs:
    """Eq. (5): p_ij = sqrt(a_i b_j) / Σ sqrt(a_i b_j), factorized."""
    pa = torch.sqrt(a)
    pa = pa / pa.sum()
    pb = torch.sqrt(b)
    pb = pb / pb.sum()
    if shrink > 0.0:
        pa = (1 - shrink) * pa + shrink / a.shape[0]
        pb = (1 - shrink) * pb + shrink / b.shape[0]
    return FactorizedProbs(pa, pb)


def sample_pairs(generator: torch.Generator, probs: FactorizedProbs, s: int):
    """s i.i.d. pairs from the product measure (paper Alg. 2 step 3).

    Draws on the generator's device and returns int64 indices on the
    device of ``probs``.
    """
    dev = generator.device
    rows = torch.multinomial(probs.pa.to(dev), s, replacement=True,
                             generator=generator)
    cols = torch.multinomial(probs.pb.to(dev), s, replacement=True,
                             generator=generator)
    return rows.to(probs.pa.device), cols.to(probs.pb.device)
