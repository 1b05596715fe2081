"""``LowRankGWSolver`` — linear-time GW with rank-r couplings.

Scetbon, Peyré & Cuturi's GW-LR: the coupling stays factored as
``T = Q diag(1/g) Rᵀ``, the ground costs enter only through skinny
factors (exact rank d+2 for point clouds, randomized rank-c sketches
otherwise — factorize.py), and each outer step is mirror descent on
(Q, R, g) followed by an LR-Dykstra projection onto the coupling polytope
(dykstra.py), O((m + n)·r·(r + c)) a step. The outer loop is the shared
health loop with the (Q, R, g) triple as its iterate.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import torch

from repro_torch.api.driver import pga_loop
from repro_torch.api.output import GWOutput, LowRankCoupling
from repro_torch.api.solvers import register_solver
from repro_torch.core.utils import flush_subnormal
from repro_torch.lowrank.dykstra import lr_dykstra
from repro_torch.lowrank.factorize import factor_ground, takes_exact_path
from repro_torch.lowrank.gradients import gw_lr_gradients, gw_lr_value
from repro_torch.lowrank.init import LowRankDraws, anchor_init, random_init
from repro_torch.multiscale.anchors import draw_start

# floor for log(max(·, _TINY)) kernels: a normal float32, so log never
# sees 0 and 0·(-inf) never makes a NaN when the entropic exponent is 0
_TINY = 1e-30


def _auto_rank(m: int, n: int) -> int:
    """Constant-by-default coupling rank (the paper's r ∈ [10, 100] regime
    with small-problem clamping) — keeps the per-iteration cost linear."""
    return max(2, min(min(m, n) // 2, 10))


def _auto_cost_rank(m: int, n: int) -> int:
    # exact below 32 points: a tiny matrix needs no sketch error
    return min(min(m, n), 32)


def _resolve_draws(draws, generator, problem, init: str, rank: int,
                   cost_rank: int) -> LowRankDraws:
    """``draws`` with every field this solve needs filled in: the given
    value (on the problem's device), else a draw from ``generator``."""
    given = draws if draws is not None else LowRankDraws()
    gx, gy = problem.geom_x, problem.geom_y
    dev = gx.weights.device
    needs = {
        "start_x": init == "anchors", "start_y": init == "anchors",
        "omega_x": not takes_exact_path(gx, problem.loss),
        "omega_y": not takes_exact_path(gy, problem.loss),
        "zq": init == "random", "zr": init == "random"}
    makers = {
        "start_x": lambda: draw_start(generator, gx.weights),
        "start_y": lambda: draw_start(generator, gy.weights),
        "omega_x": lambda: torch.randn((gx.n, cost_rank), generator=generator,
                                       device=generator.device),
        "omega_y": lambda: torch.randn((gy.n, cost_rank), generator=generator,
                                       device=generator.device),
        "zq": lambda: 0.5 + torch.rand((gx.n, rank), generator=generator,
                                       device=generator.device),
        "zr": lambda: 0.5 + torch.rand((gy.n, rank), generator=generator,
                                       device=generator.device)}
    out = {}
    for name in LowRankDraws._fields:
        value = getattr(given, name)
        if needs[name] and value is None:
            if generator is None:
                raise ValueError(
                    "LowRankGWSolver draws its init and sketches: pass "
                    "generator=torch.Generator(...) or draws=LowRankDraws("
                    f"...) with {name} set")
            value = makers[name]()
        if value is not None:
            dtype = torch.int64 if name.startswith("start") else torch.float32
            value = torch.as_tensor(value, dtype=dtype).to(dev)
        out[name] = value
    return LowRankDraws(**out)


@register_solver("lowrank_gw")
@dataclass(frozen=True)
class LowRankGWSolver:
    """Low-rank GW (Scetbon et al.) — balanced, decomposable losses.

    rank          — coupling rank r (0 → auto: min(n/2, 10))
    cost_rank     — sketch rank c for non-point-cloud geometries
                    (0 → auto: min(n, 32)); unused on the exact path
    epsilon       — entropic smoothing of the mirror step (0 = pure
                    mirror descent, the paper's default)
    gamma         — mirror step size; rescaled each step by the sup-norm
                    of the gradients when ``gamma_rescale``
    g_floor       — lower bound α on the inner marginal g
    init          — "anchors" (FPS anchors + r×r anchor GW, lifted to
                    feasible factors) or "random"
    init_blend    — uniform-coupling fraction mixed into the anchors init
    outer_iters   — mirror-descent step budget
    inner_iters   — Dykstra budget per mirror step
    tol           — outer stop: relative ℓ1 change of (Q, R, g)
    inner_tol     — Dykstra stop: sup-norm change of the scalings
    max_rescues, rescue_factor — rescue budget on detected divergence;
                    the escalation divides γ (step-size halving)
    fault         — a ``FaultSpec`` the loop injects into (Q, R, g)
    trace         — raises until convergence traces are ported (item 14)
    """
    rank: int = 0
    cost_rank: int = 0
    epsilon: Any = 0.0
    gamma: Any = 10.0
    gamma_rescale: bool = True
    g_floor: float = 1e-10
    init: str = "anchors"
    init_blend: float = 0.2
    outer_iters: int = 300
    inner_iters: int = 200
    tol: float = 1e-6
    inner_tol: float = 3e-6
    max_rescues: int = 2
    rescue_factor: float = 2.0
    fault: Any = None
    trace: bool = False

    requires_key = True

    @classmethod
    def default_config(cls, n: int):
        return cls()

    def _resolve(self, m: int, n: int):
        rank = self.rank or _auto_rank(m, n)
        cost_rank = self.cost_rank or _auto_cost_rank(m, n)
        return min(rank, min(m, n)), min(cost_rank, min(m, n))

    def run(self, problem, generator=None, support=None,
            draws=None) -> GWOutput:
        """Solve ``problem`` on its device.

        ``generator`` draws the init and the sketches; ``draws`` (a
        :class:`~repro_torch.lowrank.init.LowRankDraws`) fixes any of them
        instead. ``support`` does not apply and must be None.
        """
        if problem.is_fused or problem.is_unbalanced:
            raise NotImplementedError(
                "LowRankGWSolver supports balanced non-fused problems only; "
                "use SparGWSolver for fused/unbalanced variants")
        if support is not None:
            raise ValueError("LowRankGWSolver samples no support; pass its "
                             "random inputs as draws=LowRankDraws(...)")
        if self.init not in ("anchors", "random"):
            raise ValueError(f"unknown init {self.init!r} "
                             f"(known: anchors, random)")
        a = problem.geom_x.weights
        b = problem.geom_y.weights
        m, n = problem.shape
        rank, cost_rank = self._resolve(m, n)
        d = _resolve_draws(draws, generator, problem, self.init, rank,
                           cost_rank)

        fx = factor_ground(problem.geom_x, problem.loss, "x", d.omega_x)
        fy = factor_ground(problem.geom_y, problem.loss, "y", d.omega_y)
        if self.init == "anchors":
            state0 = anchor_init((d.start_x, d.start_y), problem, rank,
                                 blend=self.init_blend)
        else:
            state0 = random_init(a, b, d.zq, d.zr)

        step = partial(self._md_step, a=a, b=b, hx=fx.h, hy=fy.h)

        def err_fn(state):
            # ℓ1 marginal violation of the coupling T = Q diag(1/g) Rᵀ
            mu, nu = LowRankCoupling(*state).marginals()
            return torch.sum(torch.abs(mu - a)) + torch.sum(torch.abs(nu - b))

        (Q, R, g), errors, n_iters, converged, status, trace = pga_loop(
            step, err_fn, state0, self.outer_iters, self.tol,
            scaled_step=True, max_rescues=self.max_rescues,
            rescue_factor=self.rescue_factor, fault=self.fault,
            trace=self.trace)
        value = gw_lr_value(Q, R, g, fx, fy)
        return GWOutput(value=value, coupling=LowRankCoupling(Q, R, g),
                        errors=errors, converged=converged, n_iters=n_iters,
                        status=status, trace=trace)

    def _md_step(self, state, scale, a, b, hx, hy):
        """One mirror-descent + Dykstra-projection step on (Q, R, g).

        ``scale`` is the loop's rescue escalation: it shrinks the mirror
        step (γ / scale), the mirror-descent analogue of ε-doubling.
        """
        Q, R, g = state
        grads = gw_lr_gradients(Q, R, g, hx, hy)
        # drop the gradient components the constraint set absorbs (a row
        # constant of ∇Q/∇R, a global constant of ∇g) before the sup-norm
        # rescale, so they do not throttle γ
        gq = grads.grad_q - grads.grad_q.mean(dim=1, keepdim=True)
        gr = grads.grad_r - grads.grad_r.mean(dim=1, keepdim=True)
        gg = grads.grad_g - grads.grad_g.mean()
        gamma = self.gamma / scale
        if self.gamma_rescale:
            sup = torch.maximum(torch.max(torch.abs(gq)),
                                torch.maximum(torch.max(torch.abs(gr)),
                                              torch.max(torch.abs(gg))))
            # the floor keeps γ0/sup finite at exact stationarity
            gamma = gamma / torch.clamp_min(sup, _TINY)
        # KL-prox mirror kernel K = prev^(1-γε) ⊙ exp(-γ ∇); the exponent
        # is clamped at 0 (the rescaled γ is unbounded)
        carry = torch.clamp_min(
            torch.as_tensor(1.0 - gamma * self.epsilon, device=Q.device), 0.0)

        def kernel(x, grad):
            return flush_subnormal(torch.exp(
                carry * torch.log(torch.clamp_min(x, _TINY)) - gamma * grad))

        K1, K2, k3 = kernel(Q, gq), kernel(R, gr), kernel(g, gg)
        return lr_dykstra(K1, K2, k3, a, b, self.g_floor,
                          self.inner_iters, self.inner_tol)
