"""``gw_loss`` / ``fgw_loss``: GW solves as trainable losses (counterpart
of ``repro.diff.losses``).

Thin wrappers over :func:`repro_torch.solve`: the heavy lifting is the
Danskin envelope on the loop driver (diff/fixed_point.py), which makes
``solve(...).value`` differentiable with respect to every float tensor of
the problem that requires grad: cost matrices, point clouds, fused
features / ``M``, ``fused_penalty``, ``lam``. These wrappers build the
problem from arrays, pick a solver, and (opt-in) recover **marginal**
gradients for balanced problems, where the coupling-polytope constraint
makes the plain envelope return zero. They run on the card unless
``device="cpu"``; the gradient flows back to wherever the inputs live.

What is differentiable, per family, as in the reference (and where the
reference's Pallas kernels refuse, so do the port's):

============  =========================================================
solver        differentiable w.r.t.
============  =========================================================
dense_gw      Cx, Cy (or points), M / features, ``fused_penalty``;
              ``lam`` and marginals for unbalanced problems (the KL
              penalty terms are live paths through the envelope);
              balanced marginals via ``marginal_grads=True``, a
              dual-certificate approximation (see :func:`quadratic_loss`)
spar_gw       gathered Cx, Cy, features, ``fused_penalty``, ``lam``;
              not the marginals (the sampled support is a discrete
              draw from (a, b)). ``cost_impl`` "auto" / "materialized"
              (the matvec kernel K1, whose backward is plain torch) and
              "jnp" differentiate; "pallas" (the gather-fused kernel K2)
              raises, as the reference's kernel does
grid_gw       the gathered blocks CxR, CyC; ``use_kernel=True`` with an
              indecomposable loss (the gw_cost kernel K3) raises
lowrank_gw    point clouds through the exact rank-(d+2) factors (and
              precomputed costs through the sketch), never forming an
              m×n object in either pass
============  =========================================================

Gradient quality is gated on *convergence*: Danskin's theorem holds at a
stationary point of the objective over the polytope, so an unconverged
solve yields a biased gradient. ``reg="ent"`` fixed points are
stationary for the entropic objective, so gradients of the reported
plug-in value carry an O(ε) bias there; prefer the default
``reg="prox"`` when training.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch

from repro_torch.api.geometry import Geometry
from repro_torch.api.problem import QuadraticProblem
from repro_torch.core.gw import dense_cost
from repro_torch.core.utils import safe_div
from repro_torch.kernels import dispatch

__all__ = ["gw_loss", "fgw_loss", "quadratic_loss"]


def _uniform(k: int, like=None) -> torch.Tensor:
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.full((k,), 1.0 / k, dtype=torch.float32, device=device)


def _as_geometry(arr_or_geom, weights=None, features=None) -> Geometry:
    """Points array → point-cloud Geometry; Geometry passes through."""
    if isinstance(arr_or_geom, Geometry):
        return arr_or_geom
    pts = torch.as_tensor(arr_or_geom)
    if pts.ndim != 2:
        raise ValueError(
            f"expected an (n, d) point cloud or a Geometry, got shape "
            f"{tuple(pts.shape)}")
    w = _uniform(pts.shape[0], pts) if weights is None else weights
    return Geometry.from_points(pts, w, features=features, validate=False)


def quadratic_loss(problem: QuadraticProblem,
                   solver: Union[str, object, None] = None,
                   generator: Optional[torch.Generator] = None, *,
                   marginal_grads: bool = False, support=None, draws=None,
                   device=None):
    """Differentiable scalar GW value of a prebuilt problem.

    ``solver`` follows :func:`repro_torch.solve`: a config instance, a
    registry name, or None for auto-selection. ``generator``, ``support``
    and ``draws`` go to ``solve`` as they are; ``device`` is where the
    solve runs (the card unless given).

    marginal_grads — attach *balanced* marginal gradients by adding a
    primal-zero dual correction (the value is unchanged; gradients
    w.r.t. the weight vectors become dual potentials of the linearized
    problem, recovered by a coupling-weighted least squares on
    ∇F(T*) ≈ f ⊕ g). Dense prox solves only; for unbalanced problems
    marginal gradients flow through the KL penalty terms already (and
    exactly), and this flag must stay False.

    **Caveat (balanced only).** The recovery is exact when the converged
    coupling is strictly interior (or its support is connected and
    stable under the perturbation). Prox fixed points of near-isometric
    problems are permutation-like: a zero-sum reweighting then moves the
    support itself and no local recovery reproduces finite differences.
    Treat the result as a descent certificate direction, or use an
    unbalanced formulation (``lam``), whose marginal gradients are
    exact. Gradients are meaningful for zero-sum perturbations only.
    """
    from repro_torch.api.solve import select_solver, solve
    from repro_torch.api.solvers import DenseGWSolver, get_solver

    if solver is None:
        solver = select_solver(problem)
    elif isinstance(solver, str):
        solver = get_solver(solver).default_config(max(problem.shape))
    if marginal_grads:
        if problem.is_unbalanced:
            raise ValueError(
                "marginal_grads=True is for balanced problems; unbalanced "
                "marginal gradients already flow through the KL penalties")
        if not isinstance(solver, DenseGWSolver) or solver.reg != "prox":
            raise ValueError(
                "marginal_grads=True needs a dense prox solve (the dual "
                "recovery reads the full coupling at a true stationary "
                f"point); got {type(solver).__name__}"
                f"(reg={getattr(solver, 'reg', None)!r})")
    dev = dispatch.resolve_device(device)
    problem = problem.to(dev)
    out = solve(problem, solver, generator=generator, support=support,
                draws=draws, device=dev, validate=False)
    value = out.value
    if marginal_grads:
        value = value + _marginal_dual_correction(problem, out.coupling)
    return value


def _marginal_dual_correction(problem: QuadraticProblem, T,
                              sweeps: int = 100):
    """Primal-zero term whose gradient w.r.t. (a, b) is the dual pair.

    At an exact prox fixed point the objective gradient ``A = ∇F(T*)``
    satisfies ``A_ij = f_i + g_j`` on the settled support of T*, so the
    potentials are recovered by coupling-weighted least squares

        min_{f, g}  Σ_ij T*_ij (A_ij − f_i − g_j)²

    through ``sweeps`` sweeps of its alternating normal equations (two
    weighted row/column averages each). The envelope theorem then gives
    dV/da = f, dV/db = g along zero-sum directions, and the correction
    ⟨f, a − a.detach()⟩ + ⟨g, b − b.detach()⟩ is exactly zero in value
    while injecting those gradients. The averages divide by the marginals
    of T* floored at 1e-30, as in the reference (a normal float, so the
    floor is what XLA gives too); ``safe_div`` flushes the quotients as
    XLA does.
    """
    a, b = problem.geom_x.weights, problem.geom_y.weights
    with torch.no_grad():
        A = 2.0 * dense_cost(problem.geom_x.cost_matrix,
                             problem.geom_y.cost_matrix, T, problem.loss)
        if problem.is_fused:
            alpha = problem.fused_penalty
            A = alpha * A + (1.0 - alpha) * problem.linear_cost_dense()
        T = T.detach()
        mu = torch.clamp_min(T.sum(dim=1), 1e-30)
        nu = torch.clamp_min(T.sum(dim=0), 1e-30)
        TA = T * A
        f, g = torch.zeros_like(mu), torch.zeros_like(nu)
        for _ in range(sweeps):
            f = safe_div(TA.sum(dim=1) - T @ g, mu)
            g = safe_div(TA.sum(dim=0) - T.t() @ f, nu)
        # gauge fix: split the shared constant evenly (irrelevant for
        # zero-sum tangents, keeps the pair symmetric for inspection)
        s = 0.5 * (f @ (a / torch.sum(a)) - g @ (b / torch.sum(b)))
    return (torch.sum((f - s) * (a - a.detach()))
            + torch.sum((g + s) * (b - b.detach())))


def gw_loss(x, y, a=None, b=None, *, loss: str = "l2",
            solver: Union[str, object, None] = None,
            generator: Optional[torch.Generator] = None,
            marginal_grads: bool = False, support=None, draws=None,
            device=None):
    """GW distance between two spaces as a differentiable loss.

    x, y — (m, d) / (n, d') point clouds (gradients flow into the
    coordinates) or :class:`Geometry` instances (gradients flow into
    whatever float tensors they carry that require grad, e.g. a
    precomputed cost matrix)
    a, b — optional marginals (uniform when omitted)

    Example: embed a graph so that its metric matches a target shape::

        z = model(node_feats)                            # (n, d) embed
        loss = gw_loss(z, target_points, solver="dense_gw")
        loss.backward()
    """
    problem = QuadraticProblem(_as_geometry(x, a), _as_geometry(y, b),
                               loss=loss, validate=False)
    return quadratic_loss(problem, solver, generator,
                          marginal_grads=marginal_grads, support=support,
                          draws=draws, device=device)


def fgw_loss(x, y, fx=None, fy=None, M=None, *, fused_penalty: Any = 0.5,
             a=None, b=None, loss: str = "l2",
             solver: Union[str, object, None] = None,
             generator: Optional[torch.Generator] = None,
             marginal_grads: bool = False, support=None, draws=None,
             device=None):
    """Fused GW loss ``α·⟨L⊗T, T⟩ + (1−α)·⟨M, T⟩``, differentiable in the
    structures (x, y), the features (fx, fy) or an explicit ``M``, and α
    itself (``fused_penalty`` may be a tensor that requires grad).

    Give either node features ``fx``/``fy`` (M becomes their pairwise
    squared distance) or an explicit ``M``.
    """
    if (fx is None) != (fy is None):
        raise ValueError("fgw_loss needs features on both sides or neither")
    if fx is None and M is None:
        raise ValueError(
            "fgw_loss needs a linear term: pass fx/fy features or M")
    problem = QuadraticProblem(_as_geometry(x, a, features=fx),
                               _as_geometry(y, b, features=fy),
                               loss=loss, fused_penalty=fused_penalty,
                               M=M, validate=False)
    return quadratic_loss(problem, solver, generator,
                          marginal_grads=marginal_grads, support=support,
                          draws=draws, device=device)
