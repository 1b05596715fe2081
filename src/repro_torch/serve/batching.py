"""Size-bucketed request batching: padding and lane stacks (counterpart of
``repro.serve.batching``).

Serving traffic arrives with arbitrary geometry sizes. Every request is
rounded up to a small set of **size buckets**, and requests that share a
bucket and a configuration run together as the lanes of one batched
solve (``serve/lanes.py``), so steady-state traffic runs a handful of
shapes however diverse the requests are.

Padding discipline: padded slots get weight ``PAD_WEIGHT = 1e-30``, a
*normal* float32 (a subnormal or zero weight re-enters the kernels
through ``log``/clamp paths as full-mass garbage; the port flushes
subnormals as the reference's XLA does, ``core/utils.py``). Padded
cost/point/feature slots are zero. A padded slot then carries ~1e-30 of
coupling mass, under float32 resolution next to the live entries.

Batch-lane padding is a separate axis: a flush with fewer requests than
its lane count is topped up with **filler lanes** replicating lane 0 with
its fault hook disarmed. The lane count is a power of two, as in the
reference, so a flush has one of a handful of widths and its counters
(``n_lanes``, ``filler_lane_frac``) read as the reference's do (but for
a lone request: see ``MIN_LANES``).

No pytrees. The reference groups requests by the pytree structure and
leaf shapes of ``(padded problem, solver, key)``. The port has no
counterpart of ``repro.api.pytree``: lanes do not go through
``torch.func.vmap``, whose data-dependent stop the host-driven loop
cannot run, and ``serve/lanes.py`` batches them by hand.
:func:`batch_signature` spells out the same split instead: a field that
is a pytree leaf in the reference (a geometry's arrays, ``fused_penalty``,
``M``, ``lam``, a solver's ``epsilon``, a fault's ``at_iter``) is keyed by
shape, dtype and presence, every other field by value, the generator by
its presence. Two solvers that differ only in ``epsilon`` or in their
fault's ``at_iter`` therefore share a bucket, as in the reference, and
the lanes carry those per lane.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.api.geometry import Geometry
from repro_torch.api.problem import QuadraticProblem
from repro_torch.health.faults import FaultSpec

# pad weight: the smallest *normal* float32 scale that survives the
# subnormal flush (same constant as multiscale's _PAD_WEIGHT / lowrank's
# _TINY)
PAD_WEIGHT = 1e-30

# default geometry-size buckets: dense-ish coverage where small-problem
# traffic lives, power-of-two spacing above
DEFAULT_BUCKETS = (16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)

# The reference never dispatches a width-1 stack: XLA lowers a batch-1
# dot_general differently from every width >= 2, so its width-1 lanes had
# other bits. The port measured the same on the CPU for torch's batched
# matvec (a bmm of one batch runs gemv, of B >= 2 the batched kernel, each
# summing in its own order), and its lanes take no batched matvec: the
# dense cost's marginal terms and K1's plain version run one matvec a lane.
# So on the CPU a lane's bits are its solo solve's at every width, width 1
# included (tests/test_torch_serve.py holds this), and the port has no
# floor: a lone request runs as one lane.
MIN_LANES = 1

# the reference's pytree leaves of each solver config (every other field
# is static metadata); solvers it registers itself have epsilon and fault
_SOLVER_LEAVES = {"lowrank_gw": ("epsilon", "gamma", "fault"),
                  "quantized_gw": ("epsilon", "base", "fault")}
_DEFAULT_SOLVER_LEAVES = ("epsilon", "fault")


def bucket_for(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest configured bucket ≥ n; beyond the largest, the next power
    of two (shape diversity is already negligible up there)."""
    if n <= 0:
        raise ValueError(f"geometry size must be positive, got {n}")
    for b in sorted(buckets):
        if n <= b:
            return b
    b = 1
    while b < n:
        b <<= 1
    return b


def next_pow2(n: int) -> int:
    """Lane-count rounding: a flush of n requests runs on the next power
    of two lanes, at least :data:`MIN_LANES`."""
    b = MIN_LANES
    while b < max(1, n):
        b <<= 1
    return b


def _pad_rows(x, rows: int):
    return F.pad(x, (0, 0, 0, rows - x.shape[0]))


def pad_geometry(geom: Geometry, nb: int) -> Geometry:
    """Pad one geometry to bucket size ``nb`` (weights at PAD_WEIGHT,
    cost/points/features zero-padded). No-op when already at size."""
    n = geom.n
    if n > nb:
        raise ValueError(f"geometry of size {n} does not fit bucket {nb}")
    if n == nb:
        return geom
    pad = nb - n
    weights = F.pad(geom.weights, (0, pad), value=PAD_WEIGHT)
    cost = None if geom.cost is None else F.pad(geom.cost, (0, pad, 0, pad))
    points = None if geom.points is None else _pad_rows(geom.points, nb)
    features = (None if geom.features is None
                else _pad_rows(geom.features, nb))
    return Geometry(cost, weights, features=features, points=points,
                    validate=False)


def pad_problem(problem: QuadraticProblem, mb: int, nb: int,
                geom_x=None, geom_y=None) -> QuadraticProblem:
    """Pad a problem to bucket shape (mb, nb). Callers holding cached
    padded geometries pass them via ``geom_x``/``geom_y`` (the serving
    hot path); otherwise both sides are padded here."""
    gx = pad_geometry(problem.geom_x, mb) if geom_x is None else geom_x
    gy = pad_geometry(problem.geom_y, nb) if geom_y is None else geom_y
    M = problem.M
    if M is not None:
        M = F.pad(M, (0, nb - M.shape[1], 0, mb - M.shape[0]))
    return QuadraticProblem(gx, gy, loss=problem.loss,
                            fused_penalty=problem.fused_penalty, M=M,
                            lam=problem.lam, validate=False)


def _leaf(x):
    """(shape, dtype) of a value the reference holds as a pytree leaf;
    Python scalars take the dtypes JAX gives them (float32, int32)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype).replace("torch.", ""))
    if isinstance(x, bool):
        return ((), "bool")
    if isinstance(x, int):
        return ((), "int32")
    if isinstance(x, float):
        return ((), "float32")
    raise TypeError(f"cannot key a batch on a {type(x).__name__} leaf")


def _signature(x):
    if x is None:
        return None
    if isinstance(x, FaultSpec):
        return ("FaultSpec", x.kind, x.site, x.persistent,
                _leaf(x.at_iter))
    if isinstance(x, Geometry):
        return ("Geometry", _leaf(x.cost), _leaf(x.weights),
                _leaf(x.features), _leaf(x.points))
    if isinstance(x, QuadraticProblem):
        return ("QuadraticProblem", x.loss, _signature(x.geom_x),
                _signature(x.geom_y), _leaf(x.fused_penalty), _leaf(x.M),
                _leaf(x.lam))
    if dataclasses.is_dataclass(x):                     # a solver config
        leaves = _SOLVER_LEAVES.get(getattr(type(x), "name", None),
                                    _DEFAULT_SOLVER_LEAVES)
        meta = tuple((f.name, getattr(x, f.name))
                     for f in dataclasses.fields(x) if f.name not in leaves)
        return (type(x), meta,
                tuple(_signature(getattr(x, f)) for f in leaves))
    return _leaf(x)


def batch_signature(item) -> Any:
    """Hashable identity of one padded ``(problem, solver, generator)``
    item: two requests share a bucket iff their signatures match, and
    then their lanes can be stacked. See the module docstring for the
    split it makes (the reference's pytree structure and leaf avals)."""
    problem, solver, generator = item
    return (_signature(problem), _signature(solver), generator is not None)


class GeneratorState(NamedTuple):
    """A generator's device and state, recorded when a request arrives:
    its lane's draw and a later fallback both start from it."""
    device: torch.device
    state: torch.Tensor

    @classmethod
    def of(cls, generator: torch.Generator) -> "GeneratorState":
        return cls(generator.device, generator.get_state())

    def restore(self) -> torch.Generator:
        """A new generator at the recorded state."""
        g = torch.Generator(device=self.device)
        g.set_state(self.state)
        return g


class LaneStack(NamedTuple):
    """The lanes of one flush: lane b solves ``problems[b]`` with
    ``solvers[b]``, drawing from ``generators[b]`` (None for a solver that
    draws nothing)."""
    problems: tuple
    solvers: tuple
    generators: tuple


def stack_items(items: Sequence[Any]) -> LaneStack:
    """The lane stack of same-signature ``(problem, solver,
    GeneratorState or None)`` items, each lane with a generator of its own
    restored from its recorded state (so a filler lane replicating lane 0
    draws what lane 0 draws, from a generator of its own)."""
    problems, solvers, states = zip(*items)
    return LaneStack(problems, solvers,
                     tuple(None if st is None else st.restore()
                           for st in states))


def disarm_fault(solver):
    """A copy of ``solver`` with any fault hook disarmed (at_iter=-1) —
    filler lanes replicate a real lane's config but must never fire its
    chaos hook."""
    fault: Optional[FaultSpec] = getattr(solver, "fault", None)
    if fault is None:
        return solver
    return dataclasses.replace(solver,
                               fault=dataclasses.replace(fault, at_iter=-1))
