"""Free-support GW barycenters by gradient descent on the support
(counterpart of ``repro.diff.barycenter``).

A barycenter of K measured spaces (Y_1, w_1), …, (Y_K, w_K) is a point
cloud X minimizing

    B(X) = Σ_k ω_k · GW(X, Y_k)

over the support coordinates X ∈ ℝ^{n×d} (uniform weights on X). With
the Danskin envelope on the solver driver, ∇B is K envelope gradients
(one cost contraction per space, no unrolling), so the whole thing is
AdamW (optim/adamw.py, ``weight_decay=0``: shrinking coordinates toward
the origin is meaningless for a support) on the value and its gradient.

GW is invariant to isometries of X, so the minimizer is a *shape*, not a
pose. The objective trajectory is recorded per step and returned in
:class:`BarycenterResult`.

Randomness. A ``torch.Generator`` replaces the reference's key: it draws
the initial support, and input k's solver draws come from a generator of
its own, seeded from the caller's seed and k
(:func:`repro_torch.api.solve.attempt_generator` with attempt k + 1) and
made anew at every step, so a sampled support stays frozen across steps
and the loss surface is deterministic, as the reference's ``fold_in``
sub-keys keep it. ``x0`` and ``supports`` inject an initial support and
per-input sampled supports instead (the parity tests pass the
reference's).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Union

import torch

from repro_torch.api.geometry import Geometry
from repro_torch.api.problem import QuadraticProblem
from repro_torch.api.solve import attempt_generator
from repro_torch.diff.losses import _as_geometry, _uniform, quadratic_loss
from repro_torch.kernels import dispatch
from repro_torch.optim import adamw

__all__ = ["gw_barycenter", "BarycenterResult"]


class BarycenterResult(NamedTuple):
    points: Any        # (n_points, dim) learned support
    objectives: Any    # (steps + 1,) B(X) before each step + final
    grad_norms: Any    # (steps,) global grad norm per step


def _init_support(generator, geoms: Sequence[Geometry], n_points: int,
                  dim: Optional[int], device):
    """Random init scaled to the inputs: N(0, I)·scale draws, the scale
    matched to the first point cloud's RMS radius (or the RMS pairwise
    cost for precomputed geometries), so the first solves start at a
    comparable cost magnitude."""
    pts = next((g.points for g in geoms if g.points is not None), None)
    if dim is None:
        if pts is None:
            raise ValueError(
                "gw_barycenter needs dim= when no input geometry carries "
                "points (precomputed-cost inputs don't fix an embedding "
                "dimension)")
        dim = pts.shape[1]
    with torch.no_grad():
        if pts is not None:
            scale = torch.sqrt(torch.mean(torch.sum(
                (pts - pts.mean(dim=0)) ** 2, dim=-1)) / dim)
        else:
            scale = torch.sqrt(torch.mean(geoms[0].cost_matrix)
                               / (2.0 * dim))
        z = torch.randn((n_points, dim), generator=generator,
                        device=generator.device)
        return scale.to(device) * z.to(device)


def gw_barycenter(geometries: Sequence[Union[Geometry, Any]],
                  n_points: int,
                  generator: Optional[torch.Generator] = None, *,
                  dim: Optional[int] = None,
                  weights: Optional[Sequence[float]] = None,
                  loss: str = "l2",
                  solver: Union[str, object, None] = None,
                  steps: int = 100, lr: float = 0.05,
                  b1: float = 0.9, b2: float = 0.99,
                  max_grad_norm: float = 1e6,
                  x0: Optional[Any] = None,
                  supports: Optional[Sequence[Any]] = None,
                  device=None) -> BarycenterResult:
    """Descend ``Σ_k ω_k GW(X, Y_k)`` over a free support X.

    geometries — input spaces: Geometry instances or (n_k, d_k) point
                 clouds (dimensions may differ across inputs)
    n_points   — barycenter support size
    generator  — draws the initial support (unless ``x0``) and, through
                 one derived generator per input, each input's solver
                 draws (module docstring); needed unless ``x0`` is given
                 and no solver draws anything
    solver     — forwarded to :func:`repro_torch.diff.losses.
                 quadratic_loss` (None auto-selects per input)
    x0         — explicit (n_points, dim) init
    supports   — per-input ``(rows, cols)`` sampled supports for
                 ``spar_gw`` / ``grid_gw`` solves, fixed for every step
    device     — where the solves run (the card unless given)

    Returns :class:`BarycenterResult`; ``objectives`` has the pre-step
    objective at index 0 and the final value last.
    """
    dev = dispatch.resolve_device(device)
    geoms = [_as_geometry(g) for g in geometries]
    if weights is None:
        omega = torch.full((len(geoms),), 1.0 / len(geoms), device=dev)
    else:
        omega = torch.as_tensor(weights, dtype=torch.float32, device=dev)
        omega = omega / torch.sum(omega)
    if x0 is not None:
        X = torch.as_tensor(x0, dtype=torch.float32).to(dev).clone()
    else:
        if generator is None:
            raise ValueError("gw_barycenter draws its initial support: pass "
                             "generator=torch.Generator(...) or x0=")
        X = _init_support(generator, geoms, n_points, dim, dev)
    a = _uniform(n_points, X)

    def objective(X_):
        geom_x = Geometry.from_points(X_, a, validate=False)
        total = 0.0
        for k, geom_k in enumerate(geoms):
            problem = QuadraticProblem(geom_x, geom_k, loss=loss,
                                       validate=False)
            gen_k = (None if generator is None
                     else attempt_generator(generator, k + 1))
            total = total + omega[k] * quadratic_loss(
                problem, solver, gen_k, device=dev,
                support=None if supports is None else supports[k])
        return total

    opt_state = adamw.init(X)
    objectives, grad_norms = [], []
    for _ in range(steps):
        X_ = X.detach().requires_grad_(True)
        value = objective(X_)
        grads, = torch.autograd.grad(value, X_)
        X, opt_state, gnorm = adamw.update(
            grads, opt_state, X, lr, b1=b1, b2=b2, weight_decay=0.0,
            max_grad_norm=max_grad_norm)
        objectives.append(value.detach())    # objective at the pre-update X
        grad_norms.append(gnorm)
    with torch.no_grad():
        final = objective(X)
    return BarycenterResult(points=X,
                            objectives=torch.stack(objectives + [final]),
                            grad_norms=torch.stack(grad_norms))
