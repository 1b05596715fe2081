"""``QuantizedGWSolver`` — multiscale: compress → solve → refine → polish
(counterpart of ``repro.multiscale.solver``).

Quantized GW (Chowdhury et al., 2021): compress both spaces to k ≈ √n
anchors (anchors.py), solve the k × k anchor problem with any registered
base solver (``base``; dense_gw by default), expand the coarse coupling
block-locally (refine.py), and optionally polish — a few proximal PGA
steps with the exact O(s²) support cost on the refined support (the
SPAR-GW machinery, so each step is one ``spar_cost`` launch), which lets
mass move across blocks. O(m²·k) compression + the k-level solve +
O(B·cap²) refinement (+ O(s²) a polish step) instead of the O(n³) a step
of a full-resolution solve: the route for n ≥ 10k.

The reference splits one PRNG key three ways (anchors of each side, the
base solve). Here the random inputs are one argument,
:class:`QuantizedDraws`; whatever it leaves unset is drawn from the
caller's ``torch.Generator``, in that order.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import partial
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.api.driver import pga_loop
from repro_torch.api.output import GWOutput
from repro_torch.api.solvers import (
    DenseGWSolver,
    _coo_marginal_err,
    _spar_pga_step,
    get_solver,
    register_solver,
)
from repro_torch.core.gw import gw_objective
from repro_torch.health.loop import tree_finite
from repro_torch.health.status import CONVERGED, DIVERGED, MAXITER, SolveStatus
from repro_torch.kernels.spar_cost.ops import make_spar_cost_fn
from repro_torch.multiscale.anchors import draw_anchors, select_anchors
from repro_torch.multiscale.compress import (
    coarse_value_correction,
    compress_problem,
)
from repro_torch.multiscale.refine import block_refine

# dense refined-value evaluation allowed up to this many coupling entries
_REFINED_VALUE_MAX = 512 * 512
# auto-polish runs while the refined support stays below this size (each
# polish step assembles the exact support cost, O(s²))
_POLISH_MAX_SUPPORT = 32768

# anchor problems are k×k (k ≈ √n), so a heavy inner budget is cheap — and
# necessary: an unconverged inner Sinkhorn stalls the coarse PGA at a
# non-coupling fixed point whose marginal violation the refinement inherits
_DEFAULT_BASE = DenseGWSolver(epsilon=1e-2, outer_iters=50, inner_iters=2000,
                              tol=1e-6, inner_tol=1e-8)


class QuantizedDraws(NamedTuple):
    """The random inputs of one quantized solve; a field left None is
    drawn from the solve's generator. A parity hook: the tests pass the
    JAX reference's draws (``repro_torch.api.interop.to_quantized_draws``).

    anchors_x, anchors_y — each side's anchor draw: the FPS start index
                           (``anchor_method="fps"``) or the k anchors
                           (``"random"``); see ``anchors.draw_anchors``
    base                 — what the nested base solver takes: a
                           ``(rows, cols)`` support for ``spar_gw`` /
                           ``grid_gw``, a ``LowRankDraws`` for
                           ``lowrank_gw``; None for ``dense_gw``
    """
    anchors_x: Optional[Any] = None
    anchors_y: Optional[Any] = None
    base: Optional[Any] = None


def _materialized(problem):
    """Point-cloud geometries densified once up front: the pipeline reads
    ``cost_matrix`` from half a dozen stages, each of which would
    otherwise assemble it again."""
    if problem.geom_x.cost is not None and problem.geom_y.cost is not None:
        return problem
    from repro_torch.api.geometry import Geometry
    from repro_torch.api.problem import QuadraticProblem

    def dense(g):
        return Geometry(g.cost_matrix, g.weights, g.features, validate=False)

    return QuadraticProblem(dense(problem.geom_x), dense(problem.geom_y),
                            loss=problem.loss,
                            fused_penalty=problem.fused_penalty,
                            M=problem.M, lam=problem.lam, validate=False)


def _auto_k(n: int) -> int:
    return min(n, max(16, math.isqrt(n - 1) + 1))        # ⌈√n⌉, floor 16


def _auto_cap(n: int, k: int) -> int:
    return min(n, max(8, -(-3 * n // k)))                # 3× mean cluster size


def _base_kw(draw) -> dict:
    """The keyword through which a base solver takes its draw."""
    # local import: lowrank.init imports this package's anchors
    from repro_torch.lowrank.init import LowRankDraws

    if draw is None:
        return {}
    return {"draws" if isinstance(draw, LowRankDraws) else "support": draw}


@register_solver("quantized_gw")
@dataclass(frozen=True)
class QuantizedGWSolver:
    """Multiscale quantized GW: compress → base solve → refine → polish.

    k_x, k_y      — anchor counts (0 → ⌈√n⌉ with a floor of 16)
    max_members   — member-table cap per cluster (0 → 3× mean cluster size;
                    members past the cap are dropped from refinement and
                    surface as marginal violation)
    max_pairs     — refined anchor pairs (0 → 2(k_x + k_y))
    anchor_method — "fps" (farthest-point + medoid refinement) or "random"
    anchor_iters  — weighted-medoid refinement rounds
    compress_metric — "mean" (conditional-average anchor costs) or
                    "anchor" (submatrix)
    base          — nested solver config for the anchor-level problem; any
                    registered solver instance, or a registry name string
                    (resolved at construction). Sampling bases with s=0 are
                    sized for the coarse problem.
    epsilon       — entropic temperature of the block-local refinement
                    Sinkhorn and the polish steps
    refine_iters, refine_tol — budget/tolerance of each local Sinkhorn
    polish_iters  — exact-support-cost proximal PGA steps after refinement
                    (balanced problems only): -1 → auto (5 steps while the
                    support is ≤ 32768 entries, else none), 0 → off
    polish_inner_iters — inner Sinkhorn budget per polish step
    value_mode    — "coarse" reports the anchor-level objective; "refined"
                    the true objective of the output coupling (via the
                    support cost when polishing, else by densifying — small
                    problems only); "auto" picks refined whenever polish
                    ran or m·n ≤ 512², coarse otherwise (and always for
                    unbalanced problems)
    debias        — apply the within-cluster cost-variance correction to
                    reported coarse values (balanced decomposable problems)
    max_rescues, rescue_factor — ε-rescue budget of the polish loop (the
                    coarse solve has the base solver's own)
    fault         — a ``FaultSpec`` for the polish loop; to poison the
                    coarse solve, set it on the ``base`` config instead
    trace         — forwarded to the base solver, whose loop raises until
                    convergence traces are ported (ROADMAP queue 1, item 14)
    """
    k_x: int = 0
    k_y: int = 0
    max_members: int = 0
    max_pairs: int = 0
    anchor_method: str = "fps"
    anchor_iters: int = 2
    compress_metric: str = "mean"
    base: Any = _DEFAULT_BASE
    epsilon: Any = 5e-2
    refine_iters: int = 200
    refine_tol: float = 1e-8
    polish_iters: int = -1
    polish_inner_iters: int = 500
    value_mode: str = "auto"
    debias: bool = True
    max_rescues: int = 2
    rescue_factor: float = 2.0
    fault: Any = None
    trace: bool = False

    requires_key = True

    def __post_init__(self):
        if isinstance(self.base, str):
            object.__setattr__(self, "base", get_solver(self.base)())
        if self.value_mode not in ("auto", "coarse", "refined"):
            raise ValueError(
                f"value_mode must be auto|coarse|refined, got "
                f"{self.value_mode!r}")

    @classmethod
    def default_config(cls, n: int):
        return cls()

    # -- sizing -------------------------------------------------------------

    def _resolve(self, m: int, n: int):
        kx = min(self.k_x or _auto_k(m), m)
        ky = min(self.k_y or _auto_k(n), n)
        cap_x = min(self.max_members or _auto_cap(m, kx), m)
        cap_y = min(self.max_members or _auto_cap(n, ky), n)
        pairs = min(self.max_pairs or 2 * (kx + ky), kx * ky)
        return kx, ky, cap_x, cap_y, pairs

    def _sized_base(self, kx: int, ky: int):
        """Size sampling bases left unconfigured for the coarse shape."""
        base = self.base
        if getattr(base, "s", None) == 0:
            base = dataclasses.replace(base, s=16 * max(kx, ky))
        if getattr(base, "s_r", None) == 0:
            side = type(base).default_config(max(kx, ky))
            base = dataclasses.replace(base, s_r=side.s_r, s_c=side.s_c)
        if self.trace and getattr(base, "trace", None) is False:
            base = dataclasses.replace(base, trace=True)
        return base

    def _polish_budget(self, support: int, balanced: bool) -> int:
        if not balanced:
            if self.polish_iters > 0:
                raise NotImplementedError(
                    "polish is balanced-only (proximal PGA on the support "
                    "assumes coupling marginals); set polish_iters=0 for "
                    "unbalanced problems")
            return 0
        if self.polish_iters >= 0:
            return self.polish_iters
        return 5 if support <= _POLISH_MAX_SUPPORT else 0

    # -- pipeline -----------------------------------------------------------

    def run(self, problem, generator=None, support=None,
            draws=None) -> GWOutput:
        """Solve ``problem`` on its device.

        ``draws`` (a :class:`QuantizedDraws`) fixes any of the random
        inputs; ``generator`` draws the rest. ``support`` does not apply:
        a base solver's support goes in ``draws.base``.
        """
        if support is not None:
            raise ValueError("QuantizedGWSolver samples no support of its "
                             "own; pass the base solver's as "
                             "draws=QuantizedDraws(base=(rows, cols))")
        d = draws if draws is not None else QuantizedDraws()
        if generator is None and (d.anchors_x is None or d.anchors_y is None):
            raise ValueError(
                "QuantizedGWSolver draws its anchors: pass generator="
                "torch.Generator(...) or draws=QuantizedDraws(...)")
        problem = _materialized(problem)
        m, n = problem.shape
        kx, ky, cap_x, cap_y, pairs = self._resolve(m, n)

        sides = []
        for draw, geom, k in ((d.anchors_x, problem.geom_x, kx),
                              (d.anchors_y, problem.geom_y, ky)):
            if draw is None:
                draw = draw_anchors(generator, geom.weights, k,
                                    self.anchor_method)
            sides.append(select_anchors(
                torch.as_tensor(draw, device=geom.weights.device),
                geom.cost_matrix, geom.weights, k,
                method=self.anchor_method, refine_iters=self.anchor_iters))
        ax, ay = sides

        coarse_problem = compress_problem(problem, ax, ay,
                                          self.compress_metric)
        coarse = self._sized_base(kx, ky).run(
            coarse_problem, generator=generator, **_base_kw(d.base))
        Tc = coarse.coupling_dense(kx, ky)

        coupling = block_refine(problem, ax, ay, Tc, cap_x=cap_x,
                                cap_y=cap_y, max_pairs=pairs,
                                epsilon=self.epsilon,
                                iters=self.refine_iters, tol=self.refine_tol)

        piters = self._polish_budget(pairs * cap_x * cap_y,
                                     not problem.is_unbalanced)
        if piters > 0:
            coupling, value, polish_status = self._polish(problem, coupling,
                                                          piters)
            if self.value_mode == "coarse":
                value = self._coarse_value(problem, coarse_problem, coarse)
        else:
            polish_status = None
            value = self._value(problem, coarse_problem, coarse, coupling,
                                m, n)
        status = self._combined_status(coarse, polish_status, value, coupling)
        return GWOutput(value=value, coupling=coupling, errors=coarse.errors,
                        converged=coarse.converged, n_iters=coarse.n_iters,
                        status=status, trace=coarse.trace)

    def _combined_status(self, coarse, polish_status, value, coupling):
        """Join the stage verdicts: the coarse solve's status is the
        baseline; the polish (a fixed-budget refinement, so its MAXITER
        is by design) only contributes divergence; a final finite-guard
        on the output catches anything the uninstrumented refinement
        stage produced."""
        status = coarse.status
        if status is None:      # third-party base without health plumbing
            status = SolveStatus.healthy(
                CONVERGED if coarse.converged else MAXITER)
        if polish_status is not None:
            status = status.join(polish_status._replace(
                code=DIVERGED if polish_status.is_diverged else CONVERGED))
        ok = bool(tree_finite((value, *coupling)))
        return status.join(SolveStatus.healthy(CONVERGED if ok else DIVERGED))

    # -- polish: exact-support-cost proximal PGA (SPAR-GW machinery) --------

    def _polish(self, problem, coupling, piters: int):
        a = problem.geom_x.weights
        b = problem.geom_y.weights
        m, n = problem.shape
        rows, cols, vals = coupling.tocoo()
        in_support = vals > 0
        cost_fn = make_spar_cost_fn(problem.geom_x.cost_matrix,
                                    problem.geom_y.cost_matrix,
                                    rows, cols, problem.loss)
        fused = problem.is_fused
        alpha = float(problem.fused_penalty) if fused else 1.0
        lin = problem.linear_cost_at(rows, cols) if fused else 0.0
        # padded/underflowed entries enter at 1e-30: the proximal kernel
        # carries log T̃, so they stay ~0 relative to the live support
        T0 = torch.clamp_min(vals, 1e-30)
        step = partial(_spar_pga_step, cost_fn=cost_fn, a=a, b=b, rows=rows,
                       cols=cols, w=torch.ones_like(vals),
                       logw=torch.zeros_like(vals), m=m, n=n,
                       epsilon=self.epsilon,
                       inner_iters=self.polish_inner_iters,
                       inner_tol=self.refine_tol, reg="prox", stable=True,
                       alpha=alpha, lin=lin)
        err_fn = partial(_coo_marginal_err, rows=rows, cols=cols, a=a, b=b)
        T, _, _, _, status, _ = pga_loop(
            step, err_fn, T0, piters, 0.0, scaled_step=True,
            max_rescues=self.max_rescues, rescue_factor=self.rescue_factor,
            fault=self.fault)
        T = torch.where(in_support, T, 0.0)
        quad = torch.sum(T * cost_fn(T))      # exact ⟨L⊗T, T⟩ on the support
        if fused:
            value = alpha * quad + (1.0 - alpha) * torch.sum(lin * T)
        else:
            value = quad
        blocks = T.reshape(coupling.blocks.shape)
        return coupling._replace(blocks=blocks), value, status

    # -- value without polish ----------------------------------------------

    def _coarse_value(self, problem, coarse_problem, coarse):
        """The anchor-level objective, debiased for balanced decomposable
        problems (compress.coarse_value_correction)."""
        if not self.debias or problem.is_unbalanced:
            return coarse.value
        correction = coarse_value_correction(problem, coarse_problem)
        if correction is None:
            return coarse.value
        if problem.is_fused:
            # the f-terms enter the fused objective α-weighted; the
            # explicit-M linear term aggregates exactly
            correction = float(problem.fused_penalty) * correction
        return coarse.value + correction

    def _value(self, problem, coarse_problem, coarse, coupling, m: int,
               n: int):
        refined_ok = not problem.is_unbalanced
        if self.value_mode == "refined" and not refined_ok:
            raise NotImplementedError(
                "value_mode='refined' is balanced-only (the refined "
                "unbalanced objective needs dense marginal-KL terms); use "
                "value_mode='coarse' for unbalanced problems")
        if self.value_mode == "refined" and m * n > _REFINED_VALUE_MAX:
            raise ValueError(
                f"value_mode='refined' without polish densifies the "
                f"({m}, {n}) coupling; only supported up to "
                f"{_REFINED_VALUE_MAX} entries — use value_mode='coarse' "
                f"(the quantized-GW estimate) instead")
        use_refined = self.value_mode == "refined" or (
            self.value_mode == "auto" and refined_ok
            and m * n <= _REFINED_VALUE_MAX)
        if not use_refined:
            return self._coarse_value(problem, coarse_problem, coarse)
        T = coupling.todense(m, n)
        quad = gw_objective(problem.geom_x.cost_matrix,
                            problem.geom_y.cost_matrix, T, problem.loss)
        if problem.is_fused:
            alpha = float(problem.fused_penalty)
            return alpha * quad + (1.0 - alpha) * torch.sum(
                problem.linear_cost_dense() * T)
        return quad
