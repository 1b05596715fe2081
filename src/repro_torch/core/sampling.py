"""Importance-sampling probabilities and samplers (paper §3.1, eq. 5 / 9).

The balanced probability p_ij ∝ sqrt(a_i b_j) is a product measure,
p_ij = (sqrt(a_i)/Z_a)(sqrt(b_j)/Z_b). It is used twice:

* COO path — rows and cols are drawn independently per pair: exact
  i.i.d. draws from p with O(m + n) setup;
* grid path — a row set and a col set are drawn once and the support is
  their cross product (see core/grid_gw.py).

``shrink`` interpolates toward the uniform distribution, which enforces
regularity condition (H.4): p_ij >= c3/n².

The unbalanced probability (eq. 9) is a dense m x n matrix; pairs are
drawn from it by inverse-CDF sampling on its flattened float64 cumsum.

torch's generator gives other numbers than JAX's threefry from the same
seed; parity tests inject the reference's support instead.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.utils import flush_subnormal, log_floor


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


def _draw(generator: torch.Generator, p, k: int):
    """k i.i.d. int64 indices drawn from ``p`` on the generator's device,
    returned on the device of ``p``."""
    return torch.multinomial(p.to(generator.device), k, replacement=True,
                             generator=generator).to(p.device)


def sample_pairs(generator: torch.Generator, probs: FactorizedProbs, s: int):
    """s i.i.d. pairs from the product measure (paper Alg. 2 step 3).

    Draws rows then cols on the generator's device and returns int64
    indices on the device of ``probs``.
    """
    return _draw(generator, probs.pa, s), _draw(generator, probs.pb, s)


def sample_grid(generator: torch.Generator, probs: FactorizedProbs, s_r: int,
                s_c: int):
    """Row set R (s_r i.i.d.) and col set C (s_c i.i.d.) for the grid path.

    Draws rows then cols on the generator, as :func:`sample_pairs` does.
    """
    return _draw(generator, probs.pa, s_r), _draw(generator, probs.pb, s_c)


def unbalanced_probs(a, b, logK, lam: float, eps: float, shrink: float = 0.0):
    """Eq. (9): p_ij ∝ (a_i b_j)^{λ/(2λ+ε)} K_ij^{ε/(2λ+ε)}  (dense m×n).

    Takes log K (the kernel at T⁰ underflows float32 for small ε); the
    normalization is computed with max-subtraction. A product a_i b_j
    below the smallest normal has log -inf, as under XLA's flush.
    """
    e1 = lam / (2 * lam + eps)
    e2 = eps / (2 * lam + eps)
    logab = log_floor(a[:, None] * b[None, :])
    logP = e1 * logab + e2 * logK
    logP = logP - torch.max(logP)
    P = flush_subnormal(torch.exp(logP))
    P = flush_subnormal(P / P.sum())
    if shrink > 0.0:
        P = (1 - shrink) * P + shrink / (P.shape[0] * P.shape[1])
    return P


def sample_pairs_2d(generator: torch.Generator, P, s: int):
    """s i.i.d. index pairs ``(rows, cols)`` from a dense 2-D probability
    matrix, int64 on the device of ``P``.

    Inverse-CDF draws: s uniforms from the generator (on its device) are
    located in the float64 cumsum of the flattened P. A zero cell spans an
    empty interval and is never drawn. ``torch.multinomial`` would cap
    m·n at 2²⁴ categories; this has no such cap.
    """
    m, n = P.shape
    cdf = torch.cumsum(P.reshape(-1).to(torch.float64), 0)
    u = torch.rand(s, generator=generator, dtype=torch.float64,
                   device=generator.device).to(P.device) * cdf[-1]
    flat = torch.searchsorted(cdf, u, right=True).clamp_max(m * n - 1)
    return flat // n, flat % n


def poisson_mask(generator: torch.Generator, probs_flat, s: int):
    """Poisson subsampling (appendix B): keep element ij w.p. min(1, s p_ij).

    Returns ``(mask, p_star)``; E[nnz] ≤ s. Used in tests to check the
    expectation-equivalence with the fixed-size i.i.d. scheme.
    """
    p_star = torch.clamp_max(s * probs_flat, 1.0)
    u = torch.rand(probs_flat.shape, generator=generator,
                   device=generator.device).to(probs_flat.device)
    return u < p_star, p_star
