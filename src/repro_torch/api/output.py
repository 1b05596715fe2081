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


class QuantizedCoupling(NamedTuple):
    """Hierarchical coupling from the multiscale pipeline.

    One refined member×member block per supported anchor pair of the
    coarse coupling. Padded member slots carry point index 0 with block
    value exactly 0.0, so ``tocoo()`` is COO-compatible with the
    SparseCoupling consumers (the padding merges to +0 by summation).
    """
    pair_rows: Any   # (B,) int64 — anchor id on the X side of each block
    pair_cols: Any   # (B,) int64 — anchor id on the Y side of each block
    members_x: Any   # (B, cap_x) int64 — fine point indices (0 where padded)
    members_y: Any   # (B, cap_y) int64
    blocks: Any      # (B, cap_x, cap_y) float32 — 0.0 on padded slots

    def tocoo(self):
        """Flatten to COO (rows, cols, vals) of length B·cap_x·cap_y."""
        Bn, cx, cy = self.blocks.shape
        rows = self.members_x[:, :, None].expand(Bn, cx, cy)
        cols = self.members_y[:, None, :].expand(Bn, cx, cy)
        return rows.reshape(-1), cols.reshape(-1), self.blocks.reshape(-1)

    def todense(self, m: int, n: int):
        rows, cols, vals = self.tocoo()
        return SparseCoupling(rows, cols, vals).todense(m, n)

    def marginals(self, m: int, n: int):
        """(mu, nu) of the refined coupling — O(B·cap²), never densifies."""
        z = self.blocks
        mu = torch.zeros(m, dtype=z.dtype, device=z.device).index_add_(
            0, self.members_x.reshape(-1), z.sum(dim=2).reshape(-1))
        nu = torch.zeros(n, dtype=z.dtype, device=z.device).index_add_(
            0, self.members_y.reshape(-1), z.sum(dim=1).reshape(-1))
        return mu, nu


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
                tensor (``dense_gw``), a ``QuantizedCoupling`` or a
                ``LowRankCoupling``
    errors    — (outer_iters,) marginal ℓ1 error after each outer
                iteration; NaN beyond ``n_iters`` and at rescued iterations
    converged — True iff the outer loop met its tolerance (False at tol=0)
    n_iters   — outer iterations taken, rescue attempts included
    status    — :class:`~repro_torch.health.status.SolveStatus`
    trace     — a :class:`~repro_torch.obs.trace.ConvergenceTrace` when the
                solver ran with ``trace=True`` (the coarse solve's for
                ``quantized_gw``), else None
    """
    value: Any
    coupling: Any
    errors: Any
    converged: bool
    n_iters: int
    status: Optional[SolveStatus] = None
    trace: Optional[Any] = None

    def coupling_dense(self, m: int, n: int):
        """The coupling as a dense (m, n) tensor, whatever its storage."""
        if hasattr(self.coupling, "todense"):
            return self.coupling.todense(m, n)
        return self.coupling
