"""Geometry/problem compression onto anchors — multiscale stage 2
(counterpart of ``repro.multiscale.compress``).

Builds the anchor-level ``QuadraticProblem``: each cost matrix compressed
to k×k, marginal mass aggregated per cluster, the fused linear term
collapsed per anchor pair. Two metric compressions:

* ``"mean"`` (default) — C̃[c, c'] = E_{i∈c, i'∈c'}[C[i, i']], the
  conditional average under the member distributions (two matmuls through
  the membership matrix);
* ``"anchor"`` — the anchor row/column submatrix C[idx][:, idx].

An explicit M aggregates to its conditional average; feature-derived
fused terms aggregate the features to cluster means instead, so the
(m, n) linear cost is never materialized.
"""
from __future__ import annotations

import torch

from repro_torch.api.geometry import Geometry
from repro_torch.api.problem import QuadraticProblem
from repro_torch.core import ground_cost as gc
from repro_torch.core.utils import div_floor
from repro_torch.multiscale.anchors import AnchorAssignment, membership

# an empty cluster aggregates to weight exactly 0, which the coarse
# Sinkhorn's log would turn into -inf and its _finite clamp into 0 (full
# kernel mass on the empty anchor); the floor is a normal float32, so it
# survives XLA's flush in the reference and means the same here
_EMPTY_ANCHOR_WEIGHT = 1e-30


def compress_geometry(geom: Geometry, anchors: AnchorAssignment,
                      metric: str = "mean") -> Geometry:
    """The k-point quantized space: compressed cost + aggregated weights
    (+ the weighted feature mean of each cluster, NaN for a massless one,
    as in the reference)."""
    if metric == "mean":
        P = membership(anchors, geom.weights)
        cost = P.t() @ geom.cost_matrix @ P
    elif metric == "anchor":
        idx = anchors.indices
        cost = geom.cost_matrix[idx][:, idx]
    else:
        raise ValueError(f"unknown compress metric {metric!r} "
                         f"(known: mean, anchor)")
    feats = None
    if geom.features is not None:
        k = anchors.indices.shape[0]
        f = geom.features
        wsum = torch.zeros((k, f.shape[1]), dtype=f.dtype,
                           device=f.device).index_add_(
            0, anchors.assign, geom.weights[:, None] * f)
        feats = div_floor(wsum, anchors.weights[:, None])
    weights = torch.clamp_min(anchors.weights, _EMPTY_ANCHOR_WEIGHT)
    return Geometry(cost, weights, feats, validate=False)


def compress_linear_cost(M, ax: AnchorAssignment, ay: AnchorAssignment,
                         a, b):
    """M̃[c, d] = E_{i∈c, j∈d}[M_ij] under the member distributions."""
    return membership(ax, a).t() @ M @ membership(ay, b)


def compress_problem(problem: QuadraticProblem, ax: AnchorAssignment,
                     ay: AnchorAssignment,
                     metric: str = "mean") -> QuadraticProblem:
    """The anchor-level problem: same loss/variant structure, k_x × k_y."""
    gx = compress_geometry(problem.geom_x, ax, metric)
    gy = compress_geometry(problem.geom_y, ay, metric)
    Mk = None
    if problem.M is not None:
        Mk = compress_linear_cost(problem.M, ax, ay, problem.geom_x.weights,
                                  problem.geom_y.weights)
    return QuadraticProblem(gx, gy, loss=problem.loss,
                            fused_penalty=problem.fused_penalty, M=Mk,
                            lam=problem.lam, validate=False)


def coarse_value_correction(problem: QuadraticProblem,
                            coarse_problem: QuadraticProblem):
    """Debias of the coarse GW value: within-cluster cost-variance terms.

    Swaps the compressed f-terms of the coarse objective for the exact
    fine ones (the reference's docstring derives it):

        Δ = ⟨f1(Cx) a, a⟩ - ⟨f1(C̃x) ã, ã⟩ + ⟨f2(Cy) b, b⟩ - ⟨f2(C̃y) b̃, b̃⟩.

    Two O(m²) matvecs per side. None for indecomposable losses.
    """
    dec = gc.get_decomposition(problem.loss)
    if dec is None:
        return None
    a, b = problem.geom_x.weights, problem.geom_y.weights
    ca, cb = coarse_problem.geom_x.weights, coarse_problem.geom_y.weights
    fine = (torch.dot(a, dec.f1(problem.geom_x.cost_matrix) @ a)
            + torch.dot(b, dec.f2(problem.geom_y.cost_matrix) @ b))
    coarse = (torch.dot(ca, dec.f1(coarse_problem.geom_x.cost_matrix) @ ca)
              + torch.dot(cb, dec.f2(coarse_problem.geom_y.cost_matrix) @ cb))
    return fine - coarse
