"""``repro_torch.solve`` — the front door of the port.

    out = repro_torch.solve(problem, SparGWSolver(s=16 * n),
                            generator=torch.Generator("cuda").manual_seed(0))

With ``solver=None`` a solver is auto-selected from the problem's
structure (:func:`select_solver`, same thresholds as the reference). The
solve runs on the CUDA card unless ``device`` says otherwise.

Telemetry, as in the reference (``repro_torch.obs``): the spans
``solve``, ``solve.select``, ``solve.validate``, ``solve.dispatch`` and
``solve.fallback``, and the counters ``repro_solves_total`` (by solver
and status), ``repro_rescues_total``, ``repro_solve_failures_total``,
``repro_fallback_attempts_total`` and ``repro_fallback_recoveries_total``.
Two differences, both because the port has no ``jit``: a dispatch is
never marked ``compiled`` (there is no executable cache to grow; every
``solve.dispatch`` record carries ``compiled=False``), and every solve's
outcome is counted and noted for ``obs.report()``, not only under
``on_failure != "none"``: the reference skips that to keep its
dispatch asynchronous, while the port's loop has read the status on the
host already (noting the value adds one host read at the end).
"""
from __future__ import annotations

import math
from typing import Union

import torch

from repro_torch.api.problem import QuadraticProblem
from repro_torch.api.solvers import get_solver
from repro_torch.health.fallback import fallback_chain
from repro_torch.health.status import STALLED, SolveDivergedError
from repro_torch.kernels import dispatch
from repro_torch.obs.registry import registry
from repro_torch.obs.report import note_solve
from repro_torch.obs.span import span

# auto-selection size thresholds (max(m, n)); see select_solver
AUTO_DENSE_MAX = 256
AUTO_SPAR_MAX = 2048
# above this, even the multiscale pipeline's quadratic stages dominate:
# route to the linear-time low-rank solver whenever the problem admits it
_LOWRANK_MIN = 8192
_LOWRANK_LOSSES = ("l2", "kl")

# attempt k of the fallback ladder draws from the caller's seed plus k
# times this odd 64-bit constant (the golden-ratio increment), mod 2^64
_ATTEMPT_STRIDE = 0x9E3779B97F4A7C15


def _lowrank_eligible(problem: QuadraticProblem) -> bool:
    """lowrank_gw handles balanced, non-fused, decomposable-loss problems."""
    return (not problem.is_fused and not problem.is_unbalanced
            and problem.loss in _LOWRANK_LOSSES)


def select_solver(problem: QuadraticProblem):
    """Pick a solver config from the problem's structure (size/variant).

    max(m, n) <= 256 → ``dense_gw``; <= 2048 → ``spar_gw`` with s = 16n;
    larger → ``lowrank_gw`` when the problem admits it and either both
    geometries are l2 point clouds or max(m, n) > 8192, else
    ``quantized_gw`` — as in the reference.
    """
    size = max(problem.shape)
    if size <= AUTO_DENSE_MAX:
        name = "dense_gw"
    elif size <= AUTO_SPAR_MAX:
        name = "spar_gw"
    else:
        factorizable = (problem.geom_x.is_point_cloud
                        and problem.geom_y.is_point_cloud
                        and problem.loss == "l2")
        lowrank = _lowrank_eligible(problem) and (factorizable
                                                  or size > _LOWRANK_MIN)
        name = "lowrank_gw" if lowrank else "quantized_gw"
    return get_solver(name).default_config(size)


def attempt_generator(generator: torch.Generator, attempt: int):
    """The generator of fallback attempt ``attempt``: a new generator on
    the same device, seeded from ``generator.initial_seed()`` and the
    attempt number — not from the state the failed attempt left behind,
    so a recovered solve is bitwise reproducible (the reference's
    ``fold_in(key, attempt)``)."""
    seed = (generator.initial_seed() + attempt * _ATTEMPT_STRIDE) % 2**64
    return torch.Generator(device=generator.device).manual_seed(seed)


def _solve_failed(out) -> bool:
    """Failure predicate: DIVERGED/STALLED status or a non-finite value."""
    if out.status is not None and out.status.code >= STALLED:
        return True
    return not math.isfinite(float(out.value.detach()))


def _name(solver) -> str:
    return getattr(type(solver), "name", type(solver).__name__)


def _dispatch(solver, problem, name: str, **run_kw):
    """One solver run under a ``solve.dispatch`` span (never ``compiled``:
    nothing is compiled in front of a solve)."""
    with span("solve.dispatch", solver=name) as sp:
        out = solver.run(problem, **run_kw)
        sp["compiled"] = False
    return out


def _record_outcome(solver_name: str, out) -> None:
    """Registry counters for a finished solve, and ``obs.note_solve``."""
    try:
        reg = registry()
        status_name = ("UNKNOWN" if out.status is None
                       else out.status.describe())
        reg.counter("repro_solves_total", "completed solves by status",
                    solver=solver_name, status=status_name).inc()
        if out.status is not None:
            reg.counter("repro_rescues_total",
                        "eps-rescue restarts consumed",
                        solver=solver_name).inc(float(out.status.n_rescues))
        note_solve(out, solver=solver_name)
    except Exception:  # noqa: BLE001 — telemetry must never break a solve
        pass


def solve(problem: QuadraticProblem, solver: Union[str, object, None] = None,
          generator=None, support=None, device=None, draws=None,
          on_failure: str = "none", validate: bool = True):
    """Solve a QuadraticProblem; returns a ``GWOutput``.

    solver     — a solver config instance, a registry name (that solver's
                 ``default_config`` for the problem size), or None to
                 auto-select (:func:`select_solver`)
    generator  — ``torch.Generator`` for the support draw (``lowrank_gw``:
                 its init and sketches; ``quantized_gw``: its anchors and
                 its base solver's draws); ``dense_gw`` draws nothing
    support    — ``(rows, cols)`` index arrays fixing the sampled support
                 of ``spar_gw`` / ``grid_gw`` instead of drawing it
    device     — where to run; default the CUDA card (raises without one).
                 ``"cpu"`` runs the plain PyTorch versions of the kernels.
    draws      — ``lowrank_gw``: a ``repro_torch.lowrank.LowRankDraws``;
                 ``quantized_gw``: a ``repro_torch.multiscale.
                 QuantizedDraws``; fixes the solver's random inputs
    on_failure — what to do when the solve comes back unhealthy (DIVERGED
                 or STALLED after the solver's own ε-rescue budget, or a
                 non-finite value):
                 * "none" (default) — return the output as it is
                 * "raise" — raise :class:`~repro_torch.health.status.
                   SolveDivergedError` (the failed output on ``.output``)
                 * "fallback" — walk the solver ladder (lowrank →
                   quantized → spar → dense, eligibility-gated; see
                   health/fallback.py), attempt k drawing from
                   :func:`attempt_generator`; returns the first healthy
                   result, or the original failed output if every rung
                   fails
    validate   — run the problem's checks if they have not run yet (a
                 problem built with ``validate=True`` has run them)

    ``support`` and ``draws`` are parity hooks: the tests inject the JAX
    reference's draws (threefry cannot be reproduced in torch) through
    ``repro_torch.api.interop``. They fix the first attempt only.
    """
    if on_failure not in ("none", "raise", "fallback"):
        raise ValueError(
            f"on_failure must be 'none', 'raise' or 'fallback', got "
            f"{on_failure!r}")
    dev = dispatch.resolve_device(device)
    with span("solve", on_failure=on_failure) as sp_solve:
        if solver is None:
            with span("solve.select"):
                solver = select_solver(problem)
        elif isinstance(solver, str):
            solver = get_solver(solver).default_config(max(problem.shape))
        primary = _name(solver)
        sp_solve["solver"] = primary
        if validate and not getattr(problem, "_validated", False):
            with span("solve.validate"):
                problem.check()
        problem = problem.to(dev)
        kw = {} if draws is None else {"draws": draws}
        out = _dispatch(solver, problem, primary, generator=generator,
                        support=support, **kw)
        _record_outcome(primary, out)
        if on_failure == "none" or not _solve_failed(out):
            return out
        registry().counter("repro_solve_failures_total",
                           "solves unhealthy after eps-rescue",
                           solver=primary).inc()
        if on_failure == "raise":
            raise SolveDivergedError(
                f"{primary} failed: status="
                f"{out.status.describe() if out.status is not None else None}"
                f", value={float(out.value.detach())}", output=out)
        with span("solve.fallback", solver=primary) as sp_fb:
            sp_fb["recovered"] = False
            for attempt, cand in enumerate(
                    fallback_chain(problem, exclude=(primary,),
                                   generator_available=generator is not None),
                    start=1):
                cand_name = _name(cand)
                registry().counter("repro_fallback_attempts_total",
                                   "solver-ladder rungs tried",
                                   solver=cand_name).inc()
                cand_gen = (None if generator is None
                            else attempt_generator(generator, attempt))
                cand_out = _dispatch(cand, problem, cand_name,
                                     generator=cand_gen)
                if not _solve_failed(cand_out):
                    sp_fb["recovered"] = True
                    sp_fb["recovered_by"] = cand_name
                    registry().counter("repro_fallback_recoveries_total",
                                       "failed solves rescued by the ladder",
                                       solver=cand_name).inc()
                    _record_outcome(cand_name, cand_out)
                    return cand_out
        return out
