"""The arithmetic of the end-to-end metrics and of a run's spread."""
from __future__ import annotations

import math
import statistics
from typing import Optional, Sequence


def rate(done_s: Sequence[float], start_s: float, end_s: float
         ) -> Optional[float]:
    """Requests completed per second: those done by ``end_s``, over the
    time from ``start_s`` to the last of them. None if none completed."""
    done = [t for t in done_s if t <= end_s]
    if not done or max(done) <= start_s:
        return None
    return len(done) / (max(done) - start_s)


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least q % of the values at or below it."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med)
