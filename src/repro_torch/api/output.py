"""Structured solver output — ``GWOutput`` and the coupling containers."""
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


class GridCoupling(NamedTuple):
    """Factorized (grid) coupling: block[k, l] sits at (rows[k], cols[l]).

    ``todense`` merges duplicate rows or cols by summation.
    """
    rows: Any    # (s_r,) int64
    cols: Any    # (s_c,) int64
    block: Any   # (s_r, s_c) float32

    def todense(self, m: int, n: int):
        Z = torch.zeros((m, n), dtype=self.block.dtype,
                        device=self.block.device)
        return Z.index_put_((self.rows[:, None], self.cols[None, :]),
                            self.block, accumulate=True)


class LowRankCoupling(NamedTuple):
    """Factored coupling T = Q diag(1/g) Rᵀ (Scetbon et al., 2021/22).

    Storage is O((m + n)·r): ``q`` (m, r) with row sums ≈ a, ``r`` (n, r)
    with row sums ≈ b, both column sums ≈ ``g``. The coupling is dense but
    never materialized by the solver; ``todense`` is for small problems.
    """
    q: Any   # (m, r) float32 — left factor, Q 1_r ≈ a
    r: Any   # (n, r) float32 — right factor, R 1_r ≈ b
    g: Any   # (r,) float32 — shared inner marginal

    @property
    def rank(self) -> int:
        return self.g.shape[-1]

    def apply(self, x, axis: int = 0):
        """``T @ x`` (axis=0) or ``Tᵀ @ x`` (axis=1) in O((m + n)·r);
        ``x`` is a vector or an (·, k) stack of vectors."""
        left, right = (self.q, self.r) if axis == 0 else (self.r, self.q)
        y = right.t() @ x                                  # (r,) or (r, k)
        y = y / (self.g[:, None] if y.ndim > 1 else self.g)
        return left @ y

    def marginals(self, m: int = None, n: int = None):
        """(mu, nu) of T itself, T 1 = Q diag(1/g) (Rᵀ 1), in O((m + n)·r)
        (not the factors' row sums, which differ by what the inner
        projection left of its violation)."""
        mu = self.q @ (self.r.sum(dim=0) / self.g)
        nu = self.r @ (self.q.sum(dim=0) / self.g)
        return mu, nu

    def todense(self, m: int = None, n: int = None):
        """The (m, n) coupling (small problems only; the shape follows
        from the factors, the arguments match the other containers)."""
        return (self.q / self.g[None, :]) @ self.r.t()


@dataclass(frozen=True)
class GWOutput:
    """Result of one GW solve.

    value     — 0-d tensor: the objective estimate
    coupling  — a ``SparseCoupling``, a ``GridCoupling``, a dense (m, n)
                tensor (``dense_gw``) or a ``LowRankCoupling``
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
