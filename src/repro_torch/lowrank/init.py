"""Initialization of the low-rank factors (Q, R, g).

* ``random`` — full-rank positive factors with exact outer marginals
  (:func:`random_init`); it breaks the column symmetry but carries no
  information;
* ``anchors`` — compress each side to r anchors (coordinate-space FPS
  for point clouds, never an m×n or n×n object; cost FPS and one medoid
  refinement round for precomputed costs), solve the r×r anchor-level
  dense GW, and lift its coupling P to factors

      Q₀[i, c] = a_i·1[cx(i) = c]              (column mass wx_c)
      R₀[j, c] = b_j·P[c, cy(j)] / wy_{cy(j)}
      g₀       = wx

  which is the quantized expansion of P in factored form, feasible by
  construction. A ``blend`` fraction of the uniform rank-one coupling
  keeps every entry positive (zeros are absorbing under the
  multiplicative mirror-descent kernel).

The random inputs of both (each side's FPS start, ``random_init``'s two
uniform matrices) are arguments here; :class:`LowRankDraws` carries them,
together with the sketch matrices of :func:`~repro_torch.lowrank.
factorize.sketch_factors`, from a torch generator or from the reference.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.utils import flush_subnormal
from repro_torch.multiscale.anchors import (
    farthest_point_sampling,
    fps_points,
    medoid_refinement,
)

__all__ = ["LowRankDraws", "random_init", "anchor_init"]


class LowRankDraws(NamedTuple):
    """The random inputs of one low-rank solve; a field left None is drawn
    from the solve's generator. A parity hook: the tests pass the JAX
    reference's draws (``repro_torch.api.interop.to_lowrank_draws``).

    start_x, start_y — FPS start index of each side (``init="anchors"``)
    omega_x, omega_y — (n, c) standard-normal sketch matrix of each side
                       (only on the sketch path: not a point cloud with l2)
    zq, zr           — (m, r) and (n, r) uniforms in [0.5, 1.5)
                       (``init="random"``)
    """
    start_x: Optional[Any] = None
    start_y: Optional[Any] = None
    omega_x: Optional[Any] = None
    omega_y: Optional[Any] = None
    zq: Optional[Any] = None
    zr: Optional[Any] = None


def random_init(a, b, zq, zr):
    """Random full-rank positive init with exact outer marginals, from the
    uniform matrices ``zq`` (m, r) and ``zr`` (n, r).

    A rank-one init (Q = a gᵀ) is a fixed point of the mirror-descent
    kernels, so the init must break the column symmetry; Dykstra restores
    the inner-marginal constraints on the first step.
    """
    rank = zq.shape[1]
    g = torch.full((rank,), 1.0 / rank, dtype=a.dtype, device=a.device)
    Q = a[:, None] * zq / zq.sum(dim=1, keepdim=True)
    R = b[:, None] * zr / zr.sum(dim=1, keepdim=True)
    return Q, R, g


def _side_anchors(start, geom, k: int):
    """(anchor cost (k, k), assign (n,), cluster mass (k,)) for one side."""
    w = geom.weights
    if geom.points is not None:
        idx, assign = fps_points(start, geom.points, k)
        pa = geom.points[idx]
        sq = torch.sum(pa * pa, dim=-1)
        C = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (pa @ pa.t()),
                            0.0)
    else:
        D = geom.cost_matrix
        idx = farthest_point_sampling(start, D, k)
        idx, assign = medoid_refinement(D, w, idx, 1)
        C = D[idx][:, idx]
    mass = torch.zeros(k, dtype=w.dtype, device=w.device).index_add_(
        0, assign, w)
    return C, assign, mass


def anchor_init(starts, problem, rank: int, *, blend: float = 0.2,
                gw_outer: int = 50, gw_inner: int = 100):
    """FPS/anchor-seeded (Q, R, g) — see the module docstring.

    starts — the FPS start index of each side, ``(start_x, start_y)``
    blend  — uniform-coupling mixing fraction τ ∈ (0, 1)
    """
    # local import: api.solvers imports this package's solver
    from repro_torch.api.geometry import Geometry
    from repro_torch.api.problem import QuadraticProblem
    from repro_torch.api.solvers import DenseGWSolver

    a = problem.geom_x.weights
    b = problem.geom_y.weights
    Cax, assign_x, wx = _side_anchors(starts[0], problem.geom_x, rank)
    Cay, assign_y, wy = _side_anchors(starts[1], problem.geom_y, rank)

    # tiny r×r anchor-level GW — prox PGA, ε scaled to the anchor costs
    eps = 0.05 * (torch.mean(Cax) + torch.mean(Cay) + 1e-12)
    tiny = DenseGWSolver(epsilon=eps, outer_iters=gw_outer,
                         inner_iters=gw_inner, tol=1e-9)
    anchor_problem = QuadraticProblem(
        Geometry(Cax, wx, validate=False), Geometry(Cay, wy, validate=False),
        loss=problem.loss, validate=False)
    P = tiny.run(anchor_problem).coupling                       # (r, r)

    # lift: quantized expansion of P in factored form, blended with the
    # uniform coupling. max(wy, 1e-38) as XLA evaluates it: the floor
    # flushes to 0, so a massless cluster divides by zero (NaN), as there
    u = 1.0 / rank
    Q_s = a[:, None] * torch.nn.functional.one_hot(assign_x, rank).to(a.dtype)
    denom = flush_subnormal(wy)
    R_s = flush_subnormal(b)[:, None] * (P[:, assign_y].t()
                                         / denom[assign_y][:, None])
    Q = (1.0 - blend) * Q_s + blend * (a[:, None] * u)
    R = (1.0 - blend) * R_s + blend * (b[:, None] * u)
    g = (1.0 - blend) * wx + blend * u
    return flush_subnormal(Q), flush_subnormal(R), flush_subnormal(g)
