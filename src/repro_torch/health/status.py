"""Solve-status lattice — the machine-readable health verdict of a solve.

Four codes, ordered by severity (higher = worse), so a join is ``max``:

    CONVERGED (0) — outer tolerance met, marginal error healthy
    MAXITER   (1) — iteration budget exhausted before the tolerance
    STALLED   (2) — tolerance met but the marginal violation stayed large:
                    a non-coupling fixed point
    DIVERGED  (3) — a non-finite or mass-collapsed iterate appeared and
                    rescue was exhausted; the returned state is the last
                    healthy iterate, never the poisoned one

The port's loop is driven from the host, so a status holds plain Python
numbers.
"""
from __future__ import annotations

import math
from typing import NamedTuple

CONVERGED = 0
MAXITER = 1
STALLED = 2
DIVERGED = 3

STATUS_NAMES = ("CONVERGED", "MAXITER", "STALLED", "DIVERGED")


class SolveStatus(NamedTuple):
    """Per-solve numerical-health verdict.

    code      — lattice code (see module constants)
    fail_iter — iteration index of the first unhealthy step, whether or
                not it was later rescued; -1 if the solve never went
                unhealthy
    last_err  — last finite recorded diagnostic (marginal ℓ1 violation);
                NaN if no iteration completed healthily
    n_rescues — ε-rescue restarts consumed (0 = none needed)
    """
    code: int
    fail_iter: int
    last_err: float
    n_rescues: int

    @property
    def is_converged(self):
        return self.code == CONVERGED

    @property
    def is_stalled(self):
        return self.code == STALLED

    @property
    def is_diverged(self):
        return self.code == DIVERGED

    @property
    def is_healthy(self):
        """CONVERGED or MAXITER — the solve produced a usable iterate."""
        return self.code <= MAXITER

    @classmethod
    def healthy(cls, code):
        """An all-clear status with the given code (no failure recorded)."""
        return cls(code=int(code), fail_iter=-1, last_err=math.nan,
                   n_rescues=0)

    def join(self, other: "SolveStatus") -> "SolveStatus":
        """Lattice join of two stage statuses: the worse code wins and
        carries its failure provenance."""
        src = other if other.code > self.code else self
        return SolveStatus(max(self.code, other.code), src.fail_iter,
                           src.last_err, self.n_rescues + other.n_rescues)

    def describe(self) -> str:
        return STATUS_NAMES[self.code]


class SolveDivergedError(RuntimeError):
    """Raised by ``solve(..., on_failure="raise")`` when the solve failed
    (DIVERGED/STALLED status or non-finite value); the failed output
    rides on ``.output``."""

    def __init__(self, message: str, output=None):
        super().__init__(message)
        self.output = output
