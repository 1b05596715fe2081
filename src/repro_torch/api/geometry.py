"""``Geometry`` — one side of a (fused) GW problem.

A Geometry owns the space: a pairwise ground cost (explicit ``(n, n)``
matrix, or implied by an ``(n, d)`` point cloud as the squared euclidean
distance matrix), the marginal weights, and optional node features.
Arrays are stored as float32 tensors, on the device they were given on
(numpy arrays land on the CPU); :meth:`to` moves them.
"""
from __future__ import annotations

import hashlib
from dataclasses import InitVar, dataclass, fields
from typing import Any, Optional

import numpy as np
import torch


def _as_f32(x):
    return None if x is None else torch.as_tensor(x, dtype=torch.float32)


def _shape(x):
    return None if x is None else tuple(x.shape)


@dataclass(frozen=True)
class Geometry:
    """Cost matrix (or point cloud) + marginal (+ optional features).

    cost     — (n, n) pairwise ground cost; may be None when ``points``
               is given (the implied cost is then the squared euclidean
               distance matrix of the points)
    weights  — (n,) marginal weights (must sum to 1 in balanced problems;
               checked at the QuadraticProblem boundary)
    features — optional (n, d) node features
    points   — optional (n, d) point cloud
    validate — init-only flag; ``False`` skips all checks
    """
    cost: Optional[Any]
    weights: Any
    features: Optional[Any] = None
    points: Optional[Any] = None
    validate: InitVar[bool] = True

    def __post_init__(self, validate: bool = True):
        for f in fields(self):
            object.__setattr__(self, f.name, _as_f32(getattr(self, f.name)))
        if validate:
            self.check()

    def check(self):
        """Shape checks and the non-negativity of the weights."""
        cs, ws = _shape(self.cost), _shape(self.weights)
        if self.cost is None:
            ps = _shape(self.points)
            if ps is None or len(ps) != 2:
                raise ValueError(
                    "Geometry needs an (n, n) cost matrix or an (n, d) "
                    f"points array; got cost=None, points shape {ps}")
            n = ps[0]
        else:
            if len(cs) != 2 or cs[0] != cs[1]:
                raise ValueError(
                    f"Geometry.cost must be a square (n, n) matrix, got "
                    f"shape {cs}")
            n = cs[0]
            if self.points is not None:
                ps = _shape(self.points)
                if len(ps) != 2 or ps[0] != n:
                    raise ValueError(
                        f"Geometry.points must have shape ({n}, d) to match "
                        f"cost, got shape {ps}")
        if ws is None or len(ws) != 1 or ws[0] != n:
            raise ValueError(
                f"Geometry.weights must have shape ({n},) to match the "
                f"geometry size, got shape {ws}")
        if self.features is not None:
            fs = _shape(self.features)
            if len(fs) != 2 or fs[0] != n:
                raise ValueError(
                    f"Geometry.features must have shape ({n}, d) to match "
                    f"cost, got shape {fs}")
        if n and float(self.weights.min()) < 0.0:
            raise ValueError("Geometry.weights must be non-negative")
        return self

    @classmethod
    def from_points(cls, points, weights, features=None, validate=True):
        """A point-cloud geometry: cost = squared euclidean distances."""
        return cls(None, weights, features=features, points=points,
                   validate=validate)

    def to(self, device) -> "Geometry":
        """The same geometry with every array on ``device``."""
        moved = {f.name: (None if getattr(self, f.name) is None
                          else getattr(self, f.name).to(device))
                 for f in fields(self)}
        return Geometry(**moved, validate=False)

    @property
    def n(self) -> int:
        if self.cost is not None:
            return self.cost.shape[0]
        return self.points.shape[0]

    @property
    def is_point_cloud(self) -> bool:
        return self.points is not None

    @property
    def cost_matrix(self):
        """The dense (n, n) cost — explicit, or assembled from the points."""
        if self.cost is not None:
            return self.cost
        x = self.points
        sq = torch.sum(x * x, dim=-1)
        D = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
        return torch.clamp_min(D, 0.0)

    def content_hash(self) -> str:
        """Stable content digest of the geometry — the serving cache key.

        The same sha256 hex digest as the reference's
        ``repro.Geometry.content_hash`` for the same arrays: each defining
        array is fed as its tag (``cost``, ``pts``, ``w``, ``feat``), its
        numpy dtype name and shape, then its C-contiguous bytes (``none``
        for an absent one). A point-cloud geometry is hashed through its
        points and never materializes its n x n cost.

        Memoized on the instance. Raises on a tensor that requires grad:
        a cache key is never taken of a value the caller differentiates
        (the reference refuses tracers for the same reason).
        """
        cached = getattr(self, "_content_hash", None)
        if cached is not None:
            return cached
        arrays = (self.cost, self.weights, self.features, self.points)
        if any(x is not None and x.requires_grad for x in arrays):
            raise ValueError(
                "Geometry.content_hash needs arrays that do not require "
                "grad; it is a host-side cache key, not a differentiable "
                "function")
        h = hashlib.sha256()

        def feed(tag: bytes, x):
            if x is None:
                h.update(tag + b":none;")
                return
            a = np.ascontiguousarray(x.detach().cpu().numpy())
            h.update(tag + b":" + str(a.dtype).encode()
                     + b":" + repr(a.shape).encode() + b";")
            h.update(a.tobytes())

        if self.cost is not None:
            feed(b"cost", self.cost)
        feed(b"pts", self.points)
        feed(b"w", self.weights)
        feed(b"feat", self.features)
        digest = h.hexdigest()
        object.__setattr__(self, "_content_hash", digest)
        return digest
