"""Solver fallback ladder — what ``solve(..., on_failure="fallback")`` walks
(counterpart of ``repro.health.fallback``).

When a solve comes back unhealthy (DIVERGED/STALLED status or non-finite
value) after its own ε-rescue budget, the front door retries the problem
on the next solver down the ladder

    lowrank_gw -> quantized_gw -> spar_gw -> dense_gw

ordered most-scalable-first and gated by the eligibility rules of
``select_solver`` (lowrank needs balanced, non-fused, decomposable
problems) plus feasibility caps on the quadratic and cubic rungs. Each
attempt draws from a generator derived from the caller's seed and the
attempt number (``api.solve.attempt_generator``), so a recovered solve is
bitwise reproducible from run to run.
"""
from __future__ import annotations

from typing import Sequence

# most scalable first; grid_gw is excluded (a sparsification variant, not
# a robustness rung — the same failure surface as spar_gw)
LADDER = ("lowrank_gw", "quantized_gw", "spar_gw", "dense_gw")

# feasibility caps on max(m, n) for the quadratic/cubic rungs: 4× the
# auto-selection thresholds
FALLBACK_SPAR_MAX = 8192
FALLBACK_DENSE_MAX = 1024


def fallback_chain(problem, exclude: Sequence[str] = (),
                   generator_available: bool = True):
    """Ordered list of solver configs eligible to retry ``problem``.

    exclude             — registry names already tried
    generator_available — False drops the solvers that draw (the ladder
                          then reduces to dense_gw); the reference's
                          ``key_available``
    """
    # late imports: api.solve imports this module
    from repro_torch.api.solve import _lowrank_eligible
    from repro_torch.api.solvers import get_solver

    size = max(problem.shape)
    fused_unbalanced = problem.is_fused and problem.is_unbalanced
    chain = []
    for name in LADDER:
        if name in exclude:
            continue
        if name == "lowrank_gw" and not _lowrank_eligible(problem):
            continue
        if name == "spar_gw" and (size > FALLBACK_SPAR_MAX
                                  or fused_unbalanced):
            continue
        if name == "dense_gw" and (size > FALLBACK_DENSE_MAX
                                   or fused_unbalanced):
            continue
        cls = get_solver(name)
        if not generator_available and getattr(cls, "requires_key", False):
            continue
        chain.append(cls.default_config(size))
    return chain
