"""Anchor selection (counterpart of the part of ``repro.multiscale.anchors``
that the low-rank solver's anchor init uses).

* **farthest-point sampling** — the first anchor is drawn from the
  marginal, each next one maximizes the minimum cost to the anchors
  chosen so far (ties go to the first index, as ``argmax`` gives them in
  both frameworks);
* **weighted medoid refinement** — assign every point to its nearest
  anchor, then move each anchor to the member minimizing the
  marginal-weighted sum of costs to its cluster.

The reference draws the start inside, from a PRNG key. Here the start is
an argument: :func:`draw_start` draws it from a torch generator, and
parity tests pass the reference's draw instead.
"""
from __future__ import annotations

import torch

from repro_torch.core.sampling import _draw
from repro_torch.core.utils import flush_subnormal


def draw_start(generator: torch.Generator, weights):
    """One index drawn ∝ ``weights`` (entries below the smallest normal
    count as 0, as the reference's ``categorical(log(max(w, 1e-38)))``
    reads them under XLA's flush); a 0-d int64 tensor."""
    return _draw(generator, flush_subnormal(weights), 1)[0]


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
