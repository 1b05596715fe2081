"""The least work of an unbalanced SPAR-GW solve (Alg. 3, l2 loss), in
float32 operations, by the cheapest exact route known, as
``roofline.py`` counts the balanced one (an exp or a log counted as one
operation; the peaks are ``roofline``'s). m = n points a cloud, s pairs:

* the init, once (steps 2-5). T⁰ = a bᵀ / sqrt(m(a) m(b)) is rank one, so
  the cross term of its l2 cost is Cx T⁰ Cyᵀ = (Cx a)(Cy b)ᵀ / sqrt(m(a)
  m(b)): two matrix-vector products, 2 n² each, and the marginal terms
  Cx² μ⁰ and Cy² ν⁰ another two, 3 n² each with the squares: 10 n², where
  a dense product spends 2 n³. Eq. (9)'s log p is then α_i + β_j + γ u_i
  v_j, 3 a cell; the maximum, the exp of the difference, the sum, the
  normalisation and the running sum of the inverse-CDF draw 6 more: 9 n².
  Each of the s draws is a binary search of ⌈log₂ n²⌉ comparisons;
* ``outer_iters`` + 1 l2 cost evaluations, ``roofline.cost_eval_ops``
  each (the steps' and the value's);
* ``outer_iters · inner_iters`` unbalanced Sinkhorn iterations: the
  balanced half steps' 8 s (``roofline.SINKHORN_OPS_PER_PAIR``) and, at
  each of the 2 n segments, the difference from log a (or log b) and the
  product by ρ: 8 s + 4 n;
* each outer step's marginals and penalties: the mass m(T) and the row
  and column sums (3 s), the log-kernel's offset log T + log w + the
  penalty's constant (3 s), the new iterate exp(log K + f_r + g_c) (3 s)
  and step 10's rescaling, its sum and product (2 s): 11 s; the penalty
  E(T), a quotient, a log, a product and a sum at each of the 2 n
  marginal entries: 8 n;
* the value (step 11), past its cost evaluation: the marginals and
  Σ T L(T), 4 s, and the two quadratic KLs, 5 a marginal entry: 10 n.

These are counts of what the algorithm needs, not of what a program
spends: the port computes the init's cross term as a dense product.
"""
from __future__ import annotations

import math

from portbench import roofline

STEP_OPS_PER_PAIR = 11
STEP_OPS_PER_POINT = 8


def init_ops(s: int, n: int) -> float:
    """Operations of the init: the rank-one cost, eq. (9) and the draw."""
    return (10.0 + 9.0) * n * n + s * math.ceil(math.log2(n * n))


def sinkhorn_iter_ops(s: int, n: int) -> float:
    """Operations of one unbalanced log-domain Sinkhorn iteration."""
    return roofline.SINKHORN_OPS_PER_PAIR * float(s) + 4.0 * n


def step_ops(s: int, n: int) -> float:
    """Operations of an outer step besides its cost and Sinkhorn loop."""
    return STEP_OPS_PER_PAIR * float(s) + STEP_OPS_PER_POINT * float(n)


def solve_ops(s: int, n: int, outer_iters: int, inner_iters: int) -> float:
    """Operations of one whole unbalanced solve."""
    return (init_ops(s, n)
            + (outer_iters + 1) * roofline.cost_eval_ops(s, n)
            + outer_iters * inner_iters * sinkhorn_iter_ops(s, n)
            + outer_iters * step_ops(s, n)
            + 4.0 * s + 10.0 * n)
