"""``repro_torch.solve`` — the front door of the port.

    out = repro_torch.solve(problem, SparGWSolver(s=16 * n),
                            generator=torch.Generator("cuda").manual_seed(0))

With ``solver=None`` a solver is auto-selected from the problem's
structure (:func:`select_solver`, same thresholds as the reference). The
solve runs on the CUDA card unless ``device`` says otherwise.
"""
from __future__ import annotations

from typing import Union

from repro_torch.api.problem import QuadraticProblem
from repro_torch.api.solvers import get_solver
from repro_torch.kernels import dispatch

# auto-selection size thresholds (max(m, n)); see select_solver
AUTO_DENSE_MAX = 256
AUTO_SPAR_MAX = 2048
_LOWRANK_MIN = 8192
_LOWRANK_LOSSES = ("l2", "kl")

# solvers of the reference that the port does not have yet, with the
# ROADMAP queue-1 item that brings each
_NOT_PORTED = {"dense_gw": 8, "lowrank_gw": 10, "quantized_gw": 11}


def _solver_class(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"solver {name!r} is not ported yet (ROADMAP queue 1, item "
            f"{_NOT_PORTED[name]})")
    return get_solver(name)


def _select_name(problem: QuadraticProblem) -> str:
    size = max(problem.shape)
    if size <= AUTO_DENSE_MAX:
        return "dense_gw"
    if size <= AUTO_SPAR_MAX:
        return "spar_gw"
    factorizable = (problem.geom_x.is_point_cloud
                    and problem.geom_y.is_point_cloud
                    and problem.loss == "l2")
    lowrank_ok = (not problem.is_fused and not problem.is_unbalanced
                  and problem.loss in _LOWRANK_LOSSES)
    if lowrank_ok and (factorizable or size > _LOWRANK_MIN):
        return "lowrank_gw"
    return "quantized_gw"


def select_solver(problem: QuadraticProblem):
    """Pick a solver config from the problem's structure (size/variant).

    max(m, n) <= 256 → ``dense_gw``; <= 2048 → ``spar_gw`` with s = 16n;
    larger → ``lowrank_gw`` or ``quantized_gw`` as in the reference.
    Raises NotImplementedError where that solver is not ported yet.
    """
    return _solver_class(_select_name(problem)).default_config(
        max(problem.shape))


def solve(problem: QuadraticProblem, solver: Union[str, object, None] = None,
          generator=None, support=None, device=None):
    """Solve a QuadraticProblem; returns a ``GWOutput``.

    solver    — a solver config instance, a registry name (that solver's
                ``default_config`` for the problem size), or None to
                auto-select (:func:`select_solver`)
    generator — ``torch.Generator`` for the support draw
    support   — ``(rows, cols)`` index arrays fixing the support instead
                of drawing it (parity tests inject the reference's draw)
    device    — where to run; default the CUDA card (raises without one).
                ``"cpu"`` runs the plain PyTorch versions of the kernels.
    """
    dev = dispatch.resolve_device(device)
    if solver is None:
        solver = select_solver(problem)
    elif isinstance(solver, str):
        solver = _solver_class(solver).default_config(max(problem.shape))
    return solver.run(problem.to(dev), generator=generator, support=support)
