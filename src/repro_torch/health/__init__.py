"""Numerical health & recovery of the port (counterpart of repro.health).

Detection (finite-guards + stall classification in the shared loop),
ε-rescue restarts, the solver fallback ladder behind ``solve(...,
on_failure="fallback")``, and the fault-injection harness that makes all
of it testable.
"""
from repro_torch.health.fallback import LADDER, fallback_chain
from repro_torch.health.faults import FaultSpec
from repro_torch.health.loop import (
    DEFAULT_MASS_CEIL,
    DEFAULT_MASS_FLOOR,
    DEFAULT_STALL_ERR,
    LoopResult,
    health_loop,
    tree_finite,
)
from repro_torch.health.status import (
    CONVERGED,
    DIVERGED,
    MAXITER,
    STALLED,
    STATUS_NAMES,
    SolveDivergedError,
    SolveStatus,
)

__all__ = [
    "CONVERGED",
    "MAXITER",
    "STALLED",
    "DIVERGED",
    "STATUS_NAMES",
    "SolveStatus",
    "SolveDivergedError",
    "FaultSpec",
    "LoopResult",
    "health_loop",
    "tree_finite",
    "DEFAULT_MASS_CEIL",
    "DEFAULT_MASS_FLOOR",
    "DEFAULT_STALL_ERR",
    "fallback_chain",
    "LADDER",
]
