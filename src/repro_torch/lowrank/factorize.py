"""Low-rank cost factorization — the C ≈ U Vᵀ contract.

Every per-iteration quantity of the low-rank GW solver touches the n×n
cost matrices only through matvecs, so a geometry only has to provide a
pair of skinny factors. Two producers:

* **exact** — a point cloud's squared euclidean distance matrix factors
  at rank d+2 with no error: ``D²_ij = ||x_i||² + ||x_j||² - 2 x_i·x_j``
  is ``[z | 1 | -2X] [1 | z | X]ᵀ`` with ``z = ||x_i||²``;
* **sketch** — an arbitrary cost matrix gets a randomized rank-c range
  sketch (Halko et al.): ``U = qr(C Ω)``, ``V = Cᵀ U``, one O(n²·c) pass.

The sketch's Gaussian Ω is an argument here (the reference draws it from
a PRNG key): the solver draws it from a torch generator, parity tests
pass the reference's. ``torch.linalg.qr`` may give U other column signs
than ``jnp.linalg.qr``; U enters only as U Vᵀ = U Uᵀ C and as products
that pair each column of U with the same column of V, which the signs
cancel out of.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import ground_cost as gc


class CostFactors(NamedTuple):
    """Skinny factors ``U (n×c), V (n×c)`` of a matrix ≈ U Vᵀ."""
    u: Any
    v: Any

    @property
    def rank(self) -> int:
        return self.u.shape[1]

    def apply(self, x):
        """(U Vᵀ) @ x in O(n·c) — vector or (n, k) stack."""
        return self.u @ (self.v.t() @ x)

    def todense(self):
        return self.u @ self.v.t()

    def scale(self, s: float) -> "CostFactors":
        return CostFactors(self.u, s * self.v)


def sq_euclidean_factors(points) -> CostFactors:
    """Exact rank-(d+2) factors of the squared euclidean distance matrix."""
    z = torch.sum(points * points, dim=1, keepdim=True)     # (n, 1)
    one = torch.ones_like(z)
    U = torch.cat([z, one, -2.0 * points], dim=1)           # (n, d+2)
    V = torch.cat([one, z, points], dim=1)                  # (n, d+2)
    return CostFactors(U, V)


def khatri_rao_square(f: CostFactors) -> CostFactors:
    """Factors of the elementwise square of a factored matrix:
    (U Vᵀ)∘(U Vᵀ) = KR(U, U) KR(V, V)ᵀ at rank c², exact."""
    n, c = f.u.shape

    def kr(A):
        return (A[:, :, None] * A[:, None, :]).reshape(n, c * c)

    return CostFactors(kr(f.u), kr(f.v))


def sketch_factors(C, omega, power_iters: int = 1) -> CostFactors:
    """Randomized range sketch C ≈ U (Uᵀ C) with U = qr((C Cᵀ)^p C Ω).

    ``omega`` is the (n, c) standard-normal test matrix; c is the rank.
    """
    Y = C @ omega
    for _ in range(power_iters):
        Y, _ = torch.linalg.qr(Y)
        Y = C @ (C.t() @ Y)
    U, _ = torch.linalg.qr(Y)                               # (n, c)
    return CostFactors(U, C.t() @ U)


class GroundFactors(NamedTuple):
    """One geometry's low-rank view of a decomposable ground loss.

    h        — factors of h(C), the matrix the gradient applies each step
    apply_f  — x ↦ f(C) @ x for the objective's rank-one terms (factored
               on the exact path, a dense matvec on the sketch path)
    exact    — True on the point-cloud rank-(d+2) path
    """
    h: CostFactors
    apply_f: Callable
    exact: bool


def takes_exact_path(geom, loss: str) -> bool:
    """Whether :func:`factor_ground` factors ``geom`` exactly (and so
    needs no sketch matrix): a point cloud with no explicit cost, l2."""
    return geom.is_point_cloud and geom.cost is None and loss == "l2"


def factor_ground(geom, loss: str, side: str, omega=None) -> GroundFactors:
    """Factor one side's h-matrix (h1(Cx) or h2(Cy)) + f-term applier.

    Point clouds with the l2 loss take the exact path (h1 = id, h2 = 2·id,
    f = square kept factored through the Khatri-Rao square). Everything
    else materializes ``geom.cost_matrix`` once and sketches h(C) with the
    (n, c) test matrix ``omega``.
    """
    dec = gc.get_decomposition(loss)
    if dec is None:
        raise NotImplementedError(
            f"lowrank_gw needs a decomposable ground loss "
            f"L = f1 + f2 - h1·h2; {loss!r} has no decomposition "
            f"(known decomposable: l2, kl)")
    h_fn = dec.h1 if side == "x" else dec.h2
    f_fn = dec.f1 if side == "x" else dec.f2

    if takes_exact_path(geom, loss):
        base = sq_euclidean_factors(geom.points)
        h = base if side == "x" else base.scale(2.0)        # h2 = 2y
        fsq = khatri_rao_square(base)                       # f = y², exact
        return GroundFactors(h=h, apply_f=fsq.apply, exact=True)

    C = geom.cost_matrix
    F = f_fn(C)
    return GroundFactors(h=sketch_factors(h_fn(C), omega),
                         apply_f=lambda x: F @ x, exact=False)
