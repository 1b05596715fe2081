"""Structured solver output — ``GWOutput`` and the COO coupling."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.health.status import SolveStatus


class SparseCoupling(NamedTuple):
    """COO coupling on a sampled support of size s.

    Duplicate (row, col) pairs are legitimate parallel entries of the
    importance-sampling estimator; ``todense`` merges them by summation.
    """
    rows: Any   # (s,) int64
    cols: Any   # (s,) int64
    vals: Any   # (s,) float32

    def todense(self, m: int, n: int):
        Z = torch.zeros((m, n), dtype=self.vals.dtype, device=self.vals.device)
        return Z.index_put_((self.rows, self.cols), self.vals, accumulate=True)


@dataclass(frozen=True)
class GWOutput:
    """Result of one GW solve.

    value     — 0-d tensor: the objective estimate
    coupling  — a ``SparseCoupling``
    errors    — (outer_iters,) marginal ℓ1 error after each outer
                iteration; NaN beyond ``n_iters`` and at rescued iterations
    converged — True iff the outer loop met its tolerance (False at tol=0)
    n_iters   — outer iterations taken, rescue attempts included
    status    — :class:`~repro_torch.health.status.SolveStatus`
    trace     — always None until convergence traces are ported
    """
    value: Any
    coupling: Any
    errors: Any
    converged: bool
    n_iters: int
    status: Optional[SolveStatus] = None
    trace: Optional[Any] = None
