"""Numerical health of the port's outer loop: status lattice and ε-rescue."""
from repro_torch.health.loop import (
    DEFAULT_MASS_CEIL,
    DEFAULT_MASS_FLOOR,
    DEFAULT_STALL_ERR,
    LoopResult,
    health_loop,
)
from repro_torch.health.status import (
    CONVERGED,
    DIVERGED,
    MAXITER,
    STALLED,
    STATUS_NAMES,
    SolveStatus,
)

__all__ = [
    "CONVERGED",
    "MAXITER",
    "STALLED",
    "DIVERGED",
    "STATUS_NAMES",
    "SolveStatus",
    "LoopResult",
    "health_loop",
    "DEFAULT_MASS_CEIL",
    "DEFAULT_MASS_FLOOR",
    "DEFAULT_STALL_ERR",
]
