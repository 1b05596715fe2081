"""Plain reference of the unbalanced SPAR-GW solve (Li et al.,
arXiv:2205.13573, Alg. 3), written from the paper in plain PyTorch.

It takes only the benchmark's inputs (the two cost matrices, the two
marginals, the relaxation strength λ, the seed of the request's generator
and the solver's settings from the configuration file) and works out
again, in float64 unless told otherwise:

1. the rank-one start T⁰ = a bᵀ / sqrt(m(a) m(b)) and its log-kernel
   log K⁰ = -(L⊗T⁰ + E(T⁰)) / (ε m(T⁰)) + log T⁰, where
   E(T) = λ Σ_i μ_i log(μ_i / a_i) + λ Σ_j ν_j log(ν_j / b_j) is the
   marginal penalty of T's row and column sums μ, ν. T⁰ is rank one, so
   for the l2 loss Cx T⁰ Cyᵀ = (Cx a)(Cy b)ᵀ / sqrt(m(a) m(b)): the dense
   term costs O(n²);
2. the sampling probability of eq. (9),
   p_ij ∝ (a_i b_j)^{λ/(2λ+ε)} K⁰_ij^{ε/(2λ+ε)};
3. the support: s i.i.d. pairs drawn by inverse CDF, s float64 uniforms
   of a ``torch.Generator`` seeded with the request's seed located in the
   float64 running sum of p's m·n cells. p is computed for the draw in
   float32, the precision the configuration states, in the program's
   order of operations (the dense product included), so that the same
   generator state draws the same pairs;
4. the importance weights w = 1 / (s p) (p in the run's precision) and the
   start T = a_r b_c / sqrt(m(a) m(b)) on the support;
5. each proximal step with ε̄ = ε m(T), λ̄ = λ m(T): log K = -(L(T) +
   E(T)) / ε̄ + log T + log w, H unbalanced log-domain Sinkhorn iterations
   with the exponent ρ = λ̄ / (λ̄ + ε̄), then step 10's rescaling of the new
   iterate to the geometric mean of its mass and the old one's,
   sqrt(m(T) / m(T_new)) T_new;
6. the health rule of the outer loop: a step whose iterate is not finite
   or whose mass leaves (1e-20, 1e20) is dropped and ε doubled, at most
   ``max_rescues`` times, after which the solve has diverged;
7. the value, step 11: Σ_k T_k L(T)_k + λ KL⊗(μ‖a) + λ KL⊗(ν‖b), with
   KL⊗(p‖q) = 2 m(p) Σ p log(p/q) - m(p)² + m(q)².

L(T) on the support is computed by two dense products, exact in float64,
by ``spar_gw.py``'s cost; that module also gives the helpers, settings,
constants and numbers the two references share, and nothing of the
benchmark or the program is imported. An entry below float32's smallest normal is set to 0
(its log -inf), as in the float32 solve the configuration states.

A float32 ulp of p can move an inverse-CDF draw across a cell boundary,
so the redrawn support may differ from the program's in a few pairs: an
answer is judged on the program's own support (:func:`compare` solves
again on it where they differ), and ``support_mismatch`` counts the pairs
that differ. On the H100 at n = 8192 (s = 131 072) the redraw matched the
program's draw exactly in every reading; a ±1-ulp change of every cell of
p moved 8-14 draws, p computed at float64 and rounded 15 085-24 153, and
a draw from eq. (5) 131 046-131 072. A limit of 64 pairs leaves room for
a few ulps and fails an eq. (5) draw by three orders of magnitude.

``precision="tf32"`` is the control (every matrix and matrix-vector
product's inputs rounded to TF32, 10 explicit mantissa bits),
``precision="float32"`` the same solve in float32 with TF32 off, a witness
of float32's own reach. Both TF32 switches of torch are set to False at import.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from . import spar_gw
from .spar_gw import (DIVERGED, MASS_CEIL, MASS_FLOOR, MAXITER, _L2Cost,
                      _finite, _flush, _log0, _segment_lse, to_tf32)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

READS = spar_gw.READS
NUMBERS = spar_gw.NUMBERS + ("mass_rel",)
TINY = 1e-30            # floor of the penalty's, the KL's and step 10's
                        # quotients


class Result(NamedTuple):
    value: float
    rows: torch.Tensor
    cols: torch.Tensor
    T: torch.Tensor          # (s,) in the precision of the run
    status: int
    n_iters: int
    again: Optional[Callable] = None    # the same solve on another support


def program_settings(config: dict, n: int) -> dict:
    """The keyword arguments of the program's solver at cloud size ``n``,
    as :func:`spar_gw.program_settings` gives them; refuses, besides, a
    problem without ``lam``."""
    if float(config["problem"].get("lam", 0.0)) <= 0.0:
        raise NotImplementedError("this reference is the unbalanced solve: "
                                  "problem.lam > 0")
    return spar_gw.program_settings(config, n)


def _penalty(mu, nu, a, b, lam: float):
    """E(T) from T's row and column sums; a sum entry of 0 adds 0."""
    def term(p, q):
        p, q = _flush(p), _flush(q)
        return torch.sum(torch.where(
            p > 0, torch.log(torch.clamp_min(p, TINY) / q) * p,
            torch.zeros_like(p)))
    return lam * (term(mu, a) + term(nu, b))


def _quadratic_kl(p, q):
    p, q = _flush(p), _flush(q)
    mp, mq = torch.sum(p), torch.sum(q)
    cross = torch.sum(p * (torch.log(torch.clamp_min(p, TINY))
                           - torch.log(torch.clamp_min(q, TINY))))
    return 2.0 * mp * cross - mp ** 2 + mq ** 2


def _eq9(logab, logK0, lam: float, eps: float):
    """Eq. (9) from log(a_i b_j) and log K⁰, normalised by its maximum."""
    logP = (lam / (2 * lam + eps)) * logab + (eps / (2 * lam + eps)) * logK0
    P = _flush(torch.exp(logP - torch.max(logP)))
    return _flush(P / P.sum())


def probs_float32(Cx, Cy, a, b, lam: float, eps: float):
    """Eq. (9)'s (m, n) p from float32 inputs, in float32 and in the
    program's order of operations: the dense l2 product (Cx T⁰)(2 Cy)ᵀ and
    the marginal terms by matrix-vector products."""
    scale = torch.sqrt(torch.sum(a) * torch.sum(b))
    Td = _flush(_flush(a[:, None] * b[None, :]) / scale)
    m0 = torch.sum(Td)
    mu, nu = Td.sum(1), Td.sum(0)
    C0 = ((Cx ** 2 @ mu)[:, None] + (Cy ** 2 @ nu)[None, :]
          - Cx @ Td @ (2.0 * Cy).t()) + _penalty(mu, nu, a, b, lam)
    logK0 = -C0 / (eps * m0) + _log0(Td)
    return _eq9(_log0(a[:, None] * b[None, :]), logK0, lam, eps)


def probs(Cx, Cy, a, b, lam: float, eps: float, tf32: bool = False):
    """Eq. (9)'s (m, n) p in the inputs' precision, its dense term by the
    rank-one identity; ``tf32`` rounds each product's inputs."""
    r = to_tf32 if tf32 else (lambda x: x)
    scale = torch.sqrt(torch.sum(a) * torch.sum(b))
    mu, nu = a * (torch.sum(b) / scale), b * (torch.sum(a) / scale)
    xa, yb = r(Cx) @ r(a), r(Cy) @ r(b)
    C0 = ((r(Cx * Cx) @ r(mu))[:, None] + (r(Cy * Cy) @ r(nu))[None, :]
          - (2.0 / scale) * xa[:, None] * yb[None, :]
          + _penalty(mu, nu, a, b, lam))
    logT0 = _log0(a)[:, None] + _log0(b)[None, :] - torch.log(scale)
    logK0 = -C0 / (eps * torch.sum(mu)) + logT0
    return _eq9(_log0(a)[:, None] + _log0(b)[None, :], logK0, lam, eps)


def draw_support(P32, s: int, seed: int):
    """The s pairs a generator seeded with ``seed`` (on the device of
    ``P32``) draws from the float32 (m, n) probability ``P32``: float64
    uniforms located in the running sum of its cells, row-major."""
    m, n = P32.shape
    gen = torch.Generator(device=P32.device).manual_seed(seed)
    cdf = torch.cumsum(P32.reshape(-1).to(torch.float64), 0)
    u = torch.rand(s, generator=gen, dtype=torch.float64,
                   device=P32.device) * cdf[-1]
    flat = torch.searchsorted(cdf, u, right=True).clamp_max(m * n - 1)
    return flat // n, flat % n


def _sinkhorn(la, lb, rows, cols, logK, rho, m: int, n: int, iters: int):
    f = torch.zeros(m, dtype=logK.dtype, device=logK.device)
    g = torch.zeros(n, dtype=logK.dtype, device=logK.device)
    for _ in range(iters):
        f = _finite(rho * (la - _segment_lse(logK + g[cols], rows, m)))
        g = _finite(rho * (lb - _segment_lse(logK + f[rows], cols, n)))
    return _flush(torch.exp(logK + f[rows] + g[cols]))


def _marginals(t, rows, cols, m: int, n: int):
    mu = torch.zeros(m, dtype=t.dtype, device=t.device).index_add_(0, rows, t)
    nu = torch.zeros(n, dtype=t.dtype, device=t.device).index_add_(0, cols, t)
    return mu, nu


def solve(Cx, Cy, a, b, lam: float, seed: int, solver: dict,
          loss: str = "l2", precision: str = "float64",
          support=None) -> Result:
    """The unbalanced SPAR-GW solve of one request.

    Cx, Cy  — float32 cost matrices; a, b — float32 marginals (the
              benchmark's inputs, on the device the reference runs on)
    lam     — λ, the strength of the KL relaxation of the marginals
    seed    — the seed of the request's generator
    solver  — the settings of :func:`program_settings`
    precision — "float64" (the reference), "float32" (a witness) or
              "tf32" (the control)
    support — ``(rows, cols)`` to solve on in place of the redrawn one
    """
    if loss != "l2":
        raise NotImplementedError(f"the reference has the l2 loss only, "
                                  f"not {loss!r}")
    if precision not in ("float64", "float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    s, eps, lam = int(solver["s"]), float(solver["epsilon"]), float(lam)
    if support is None:
        rows, cols = draw_support(probs_float32(Cx, Cy, a, b, lam, eps), s,
                                  seed)
    else:
        rows, cols = (x.to(a.device) for x in support)
    dt = torch.float64 if precision == "float64" else torch.float32
    tf32 = precision == "tf32"
    a_, b_, Cx_, Cy_ = a.to(dt), b.to(dt), Cx.to(dt), Cy.to(dt)
    m, n = a_.shape[0], b_.shape[0]
    scale = torch.sqrt(torch.sum(a_) * torch.sum(b_))
    logw = -torch.log(s * probs(Cx_, Cy_, a_, b_, lam, eps, tf32)[rows,
                                                                   cols])
    la, lb = _log0(a_), _log0(b_)
    cost = _L2Cost(Cx_, Cy_, rows, cols, tf32)
    T = _flush(_flush(a_[rows] * b_[cols]) / scale)
    n_rescues, dead, i = 0, False, 0
    while i < int(solver["outer_iters"]) and not dead:
        mT = torch.sum(T)
        eps_bar = eps * float(solver["rescue_factor"]) ** n_rescues * mT
        lam_bar = lam * mT
        mu, nu = _marginals(T, rows, cols, m, n)
        logK = ((-1.0 / eps_bar) * cost(T)
                - _penalty(mu, nu, a_, b_, lam) / eps_bar + _log0(T) + logw)
        T_new = _sinkhorn(la, lb, rows, cols, logK,
                          lam_bar / (lam_bar + eps_bar), m, n,
                          int(solver["inner_iters"]))
        T_new = _flush(torch.sqrt(mT / torch.clamp_min(torch.sum(T_new),
                                                       TINY)) * T_new)
        mass = float(torch.sum(torch.abs(T_new)))
        if math.isfinite(mass) and MASS_FLOOR < mass < MASS_CEIL:
            T = T_new
        elif n_rescues < int(solver["max_rescues"]):
            n_rescues += 1
        else:
            dead = True
        i += 1
    mu, nu = _marginals(T, rows, cols, m, n)
    value = float(torch.sum(T * cost(T)) + lam * _quadratic_kl(mu, a_)
                  + lam * _quadratic_kl(nu, b_))

    def again(rows_, cols_):
        return solve(Cx, Cy, a, b, lam, seed, solver, loss, precision,
                     support=(rows_, cols_))
    return Result(value, rows, cols, T, DIVERGED if dead else MAXITER, i,
                  again)


def answer(settings: dict, inputs, seed: int,
           precision: str = "float64") -> Result:
    """The reference's answer to a request: ``inputs`` (Cx, a, Cy, b, λ)
    as the program got them, ``settings`` from :func:`program_settings`."""
    Cx, a, Cy, b, lam = inputs
    return solve(Cx, Cy, a, b, lam, seed, settings, precision=precision)


def compare(outcome, ref: Result) -> Dict[str, float]:
    """The numbers of one answer (value, rows, cols, T, status, n_iters,
    fell_back) against the reference's, as :func:`spar_gw.compare` gives
    them, and the total mass's gap: value, coupling and mass against the
    reference solved on the answer's own support, ``support_mismatch``
    against the redrawn one."""
    mismatch = spar_gw.compare(outcome, ref)["support_mismatch"]
    if mismatch and ref.again is not None \
            and outcome.rows.shape == ref.rows.shape:
        ref = ref.again(outcome.rows, outcome.cols)
    out = spar_gw.compare(outcome, ref)
    mass, want = float(torch.sum(outcome.T.double())), float(torch.sum(ref.T))
    out["support_mismatch"] = mismatch
    out["mass_rel"] = (abs(mass - want) / want
                       if outcome.T.shape == ref.T.shape
                       and math.isfinite(mass) else math.inf)
    return out


def aggregate(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """:func:`spar_gw.aggregate`'s numbers and the worst answer's mass
    gap."""
    out = spar_gw.aggregate(readings)
    if out:
        out["mass_rel"] = max(r["mass_rel"] for r in readings)
    return out
