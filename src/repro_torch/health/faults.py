"""Fault injection — a chaos harness for the numerical-health machinery
(counterpart of ``repro.health.faults``).

Detection and recovery paths that only fire on real divergence are
untestable on healthy problems, so every solver config carries an
optional ``fault`` field (a :class:`FaultSpec`) that the shared loop
applies at configured iterations:

    solver = DenseGWSolver(fault=FaultSpec(at_iter=3, kind="nan"))
    out = repro_torch.solve(problem, solver)   # diverges at iteration 3

For the multiscale solver, ``QuantizedGWSolver.fault`` targets the polish
loop; to poison the coarse solve, set the fault on the nested ``base``
config instead. The port's loop runs on the host with no lanes, so
``at_iter`` is a Python int.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.utils import flush_subnormal

_KINDS = ("nan", "inf", "overflow", "zero")
_SITES = ("iterate", "cost")

# finite but huge: squares/products overflow fp32 downstream, so the
# fault is not caught at the injection step — it exercises the detection
# of divergence that develops over the following iterations
_OVERFLOW_SCALE = 1e30


@dataclass(frozen=True)
class FaultSpec:
    """Inject a numerical fault into the outer loop at chosen iterations.

    at_iter    — iteration index to fire at (0-based; negative = never)
    kind       — "nan" / "inf": poison every entry of the iterate;
                 "overflow": scale by 1e30 (finite now, overflows later);
                 "zero": wipe the iterate (mass-collapse path)
    site       — "iterate": applied to the step's output (a poisoned
                 update); "cost": applied to the step's input, so the
                 fault flows through the cost evaluation / inner Sinkhorn
    persistent — fire at every iteration >= at_iter instead of once (a
                 once-off fault is rescuable by restarting; a persistent
                 one exhausts rescue and must end DIVERGED)
    """
    at_iter: int = -1
    kind: str = "nan"
    site: str = "iterate"
    persistent: bool = False

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got "
                             f"{self.kind!r}")
        if self.site not in _SITES:
            raise ValueError(f"site must be one of {_SITES}, got "
                             f"{self.site!r}")

    def fires(self, i: int) -> bool:
        at = int(self.at_iter)
        hit = i >= at if self.persistent else i == at
        return hit and at >= 0

    def apply(self, T, i: int):
        """``T`` (a tensor or a tuple of tensors) poisoned entirely when
        the fault fires at iteration ``i``, else ``T`` itself."""
        if not self.fires(i):
            return T
        if isinstance(T, tuple):
            return tuple(self._poison(x) for x in T)
        return self._poison(T)

    def _poison(self, x):
        if self.kind == "nan":
            return torch.full_like(x, float("nan"))
        if self.kind == "inf":
            return torch.full_like(x, float("inf"))
        if self.kind == "zero":
            return torch.zeros_like(x)
        return flush_subnormal(x) * _OVERFLOW_SCALE
