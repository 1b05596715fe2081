"""Geometry artifact cache — compute per-geometry work once (counterpart
of ``repro.serve.cache``).

Most per-solve setup depends on **one geometry only**: padding and
device placement of the cost/points/weights, the exact rank-(d+2)
point-cloud cost factors the low-rank family consumes, and the
multiscale anchor selection. In a catalog-matching workload the
reference side recurs across requests, so these artifacts amortize to
~zero.

``GeometryCache`` is a size-bounded LRU keyed on
``(Geometry.content_hash(), artifact tag)`` with hit/miss/eviction
counters (mirrored as ``repro_cache_*`` in the obs registry). The
server's batched hot path consumes the ``padded`` artifact on every
submit; ``lowrank_factors`` and ``anchors`` are built by :meth:`warm` for
catalog references. Artifacts are built on the cache's ``device`` (the
server's), or where the geometry lives when it has none.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Tuple

import torch

from repro_torch.api.geometry import Geometry
from repro_torch.obs.registry import registry
from repro_torch.serve.batching import pad_geometry


class GeometryCache:
    """LRU of per-geometry artifacts keyed on content hash + tag.

    max_entries — capacity in artifacts (not bytes); least recently used
                  artifacts are evicted first. Counters: ``hits`` /
                  ``misses`` / ``evictions``.
    device      — where artifacts are built (None: the geometry's device)
    """

    def __init__(self, max_entries: int = 128, device=None):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self.device = None if device is None else torch.device(device)
        self._store: "OrderedDict[Tuple[str, Any], Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._store)

    def get_or_build(self, geom: Geometry, tag: Any,
                     build: Callable[[Geometry], Any]) -> Any:
        """The cached artifact ``tag`` of ``geom``, building (and
        inserting) it on miss."""
        key = (geom.content_hash(), tag)
        if key in self._store:
            self.hits += 1
            registry().counter("repro_cache_hits_total",
                               "GeometryCache artifact hits").inc()
            self._store.move_to_end(key)
            return self._store[key]
        self.misses += 1
        registry().counter("repro_cache_misses_total",
                           "GeometryCache artifact misses").inc()
        artifact = build(geom)
        self._store[key] = artifact
        while len(self._store) > self.max_entries:
            self._store.popitem(last=False)
            self.evictions += 1
            registry().counter("repro_cache_evictions_total",
                               "GeometryCache LRU evictions").inc()
        return artifact

    def _placed(self, geom: Geometry) -> Geometry:
        return geom if self.device is None else geom.to(self.device)

    # -- built-in artifact kinds -------------------------------------------

    def padded(self, geom: Geometry, nb: int) -> Geometry:
        """``geom`` padded to bucket size ``nb`` on the cache's device —
        the batched hot path's per-request artifact (skips re-padding,
        re-hashing and the host-to-device copy for recurring
        geometries)."""
        return self.get_or_build(
            geom, ("padded", nb),
            lambda g: pad_geometry(self._placed(g), nb))

    def lowrank_factors(self, geom: Geometry):
        """Exact rank-(d+2) squared-euclidean cost factors of a
        point-cloud geometry (lowrank/factorize.py)."""
        if not geom.is_point_cloud:
            raise ValueError(
                "lowrank_factors is a point-cloud artifact; this geometry "
                "only carries an explicit cost matrix")
        from repro_torch.lowrank.factorize import sq_euclidean_factors
        return self.get_or_build(
            geom, ("lr_factors",),
            lambda g: sq_euclidean_factors(self._placed(g).points))

    def anchors(self, geom: Geometry, k: int, method: str = "fps"):
        """Multiscale anchor selection for ``geom`` (multiscale/anchors).
        Keyed per (k, method); the draw comes from a generator seeded with
        the first 8 hex digits of the content hash (as the reference seeds
        its key), so the artifact is a pure function of the geometry on a
        given device."""
        from repro_torch.multiscale.anchors import (
            draw_anchors,
            select_anchors,
        )
        seed = int(geom.content_hash()[:8], 16)

        def build(g):
            g = self._placed(g)
            gen = torch.Generator(device=g.weights.device).manual_seed(seed)
            return select_anchors(draw_anchors(gen, g.weights, k, method),
                                  g.cost_matrix, g.weights, k, method=method)
        return self.get_or_build(geom, ("anchors", k, method), build)

    def warm(self, geom: Geometry, buckets=(), k: int = 0) -> None:
        """Precompute a catalog reference's artifacts: padded copies for
        each bucket in ``buckets``, low-rank factors when the geometry is
        a point cloud, anchors when ``k > 0``."""
        for nb in buckets:
            self.padded(geom, nb)
        if geom.is_point_cloud:
            self.lowrank_factors(geom)
        if k > 0:
            self.anchors(geom, k)

    def reset_counters(self) -> None:
        """Zero the hit/miss/eviction counters, keeping cached artifacts —
        lets benchmarks measure a steady-state pass on a warm cache."""
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "entries": len(self._store),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hits / total if total else 0.0,
        }
