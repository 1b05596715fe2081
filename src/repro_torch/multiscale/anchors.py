"""Anchor selection for the multiscale (quantized) GW pipeline — stage 1
(counterpart of ``repro.multiscale.anchors``).

Compress each metric-measure space to k ≪ n anchors, working on the
pairwise cost matrix alone (graphs as well as point clouds):

* **farthest-point sampling** — the first anchor is drawn from the
  marginal, each next one maximizes the minimum cost to the anchors
  chosen so far (ties go to the first index, as ``argmax`` gives them in
  both frameworks);
* **weighted medoid refinement** — assign every point to its nearest
  anchor, then move each anchor to the member minimizing the
  marginal-weighted sum of costs to its cluster.

The reference draws inside, from a PRNG key. Here the draw is an
argument: the FPS start (:func:`draw_start`) or, for ``method="random"``,
the k anchors themselves (:func:`draw_anchors`), from a torch generator;
parity tests pass the reference's draws instead.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.sampling import _draw
from repro_torch.core.utils import div_floor, flush_subnormal


class AnchorAssignment(NamedTuple):
    """Anchors for one geometry: k representatives + a hard partition.

    indices — (k,) int64 anchor point indices into the parent geometry
    assign  — (n,) int64 cluster id in [0, k) for every point
    weights — (k,) aggregated marginal mass per anchor (Σ of member weights)
    """
    indices: Any
    assign: Any
    weights: Any


def draw_start(generator: torch.Generator, weights):
    """One index drawn ∝ ``weights`` (entries below the smallest normal
    count as 0, as the reference's ``categorical(log(max(w, 1e-38)))``
    reads them under XLA's flush); a 0-d int64 tensor."""
    return _draw(generator, flush_subnormal(weights), 1)[0]


def draw_anchors(generator: torch.Generator, weights, k: int,
                 method: str = "fps"):
    """The random input of :func:`select_anchors`: the FPS start (0-d) for
    ``"fps"``, k indices drawn without replacement ∝ ``weights`` for
    ``"random"``; int64 on the device of ``weights``."""
    if method == "fps":
        return draw_start(generator, weights)
    if method == "random":
        return torch.multinomial(weights.to(generator.device), k,
                                 replacement=False,
                                 generator=generator).to(weights.device)
    raise ValueError(f"unknown anchor method {method!r} (known: fps, random)")


def farthest_point_sampling(start, D, k: int):
    """k anchor indices (int64): ``start``, then greedy max-min cost."""
    idx = torch.zeros(k, dtype=torch.int64, device=D.device)
    idx[0] = start
    mind = D[start].clone()
    mind[start] = float("-inf")        # chosen points are never re-picked
    for i in range(1, k):
        nxt = torch.argmax(mind)
        idx[i] = nxt
        mind = torch.minimum(mind, D[nxt])
        mind[nxt] = float("-inf")
    return idx


def fps_points(start, points, k: int):
    """Coordinate-space farthest-point sampling — O(n·k·d), no cost matrix.

    Same contract as :func:`farthest_point_sampling` on the squared
    euclidean distances. Returns (indices (k,), assign (n,)): the anchors
    and every point's nearest anchor, both int64.
    """
    n = points.shape[0]

    def d2(j):
        return torch.sum((points - points[j]) ** 2, dim=-1)

    idx = torch.zeros(k, dtype=torch.int64, device=points.device)
    idx[0] = start
    mind = d2(start)
    mind[start] = float("-inf")
    assign = torch.zeros(n, dtype=torch.int64, device=points.device)
    for i in range(1, k):
        nxt = torch.argmax(mind)
        dn = d2(nxt)
        assign = torch.where(dn < mind, i, assign)   # -inf slots keep owner
        mind = torch.minimum(mind, dn)
        mind[nxt] = float("-inf")
        idx[i] = nxt
    # chosen anchors' own slots were frozen at -inf; pin them to themselves
    assign[idx] = torch.arange(k, device=points.device)
    return idx, assign


def medoid_refinement(D, weights, indices, iters: int):
    """Weighted Lloyd/k-medoids rounds on the cost matrix.

    Each round: assign points to the nearest current anchor, then for each
    cluster pick the member j minimizing Σ_{i∈cluster} w_i D[j, i]. Empty
    clusters keep their anchor. Returns (indices, assign), int64.
    """
    k = indices.shape[0]
    idx = indices
    for _ in range(iters):
        assign = torch.argmin(D[:, idx], dim=1)
        member = torch.nn.functional.one_hot(assign, k).to(D.dtype)
        scores = D @ (weights[:, None] * member)                  # (n, k)
        scores = torch.where(member > 0, scores,
                             torch.full_like(scores, float("inf")))
        new = torch.argmin(scores, dim=0)
        empty = torch.sum(member, dim=0) == 0
        idx = torch.where(empty, idx, new)
    assign = torch.argmin(D[:, idx], dim=1)
    return idx, assign


def select_anchors(draw, D, weights, k: int, method: str = "fps",
                   refine_iters: int = 2) -> AnchorAssignment:
    """Pick k anchors of the space (D, weights) and partition the points.

    method — "fps" (``draw`` is the start index) or "random" (``draw``
             holds the k anchors; a baseline); see :func:`draw_anchors`
    """
    if method == "fps":
        idx = farthest_point_sampling(draw, D, k)
    elif method == "random":
        idx = torch.as_tensor(draw, dtype=torch.int64, device=D.device)
        if tuple(idx.shape) != (k,):
            raise ValueError(f"random anchors must be {k} indices, got "
                             f"shape {tuple(idx.shape)}")
    else:
        raise ValueError(f"unknown anchor method {method!r} "
                         f"(known: fps, random)")
    idx, assign = medoid_refinement(D, weights, idx, refine_iters)
    wk = torch.zeros(k, dtype=weights.dtype, device=weights.device)
    return AnchorAssignment(idx, assign, wk.index_add_(0, assign, weights))


def membership(anchors: AnchorAssignment, weights):
    """Conditional membership matrix P (n, k): P[i, c] = w_i/w̃_c · 1[i ∈ c].

    Columns are the member distributions of each cluster (each sums to 1).
    A massless cluster divides by zero (NaN rows), as the reference's
    ``w / max(w̃, 1e-38)`` does under XLA's flush.
    """
    k = anchors.indices.shape[0]
    cond = div_floor(weights, anchors.weights[anchors.assign])
    onehot = torch.nn.functional.one_hot(anchors.assign, k).to(weights.dtype)
    return flush_subnormal(onehot * cond[:, None])


def member_table(assign, k: int, cap: int):
    """Padded member lists: table[c, slot] = point index, -1 where padded.

    Every point gets the slot equal to its rank (by point index) within
    its cluster; points ranked ≥ cap are dropped from the table (their
    mass shows up as marginal violation). Returns (table (k, cap) int64,
    dropped_mask (n,) bool).
    """
    n = assign.shape[0]
    dev = assign.device
    order = torch.argsort(assign, stable=True)          # groups clusters
    counts = torch.bincount(assign, minlength=k)
    starts = torch.cumsum(counts, 0) - counts
    ar = torch.arange(n, device=dev)
    rank = torch.empty_like(assign)
    rank[order] = ar - starts[assign[order]]
    keep = rank < cap
    table = torch.full((k, cap), -1, dtype=torch.int64, device=dev)
    table[assign[keep], rank[keep]] = ar[keep]
    return table, ~keep
