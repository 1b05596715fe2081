"""Plain reference of the balanced SPAR-GW solve (Li et al.,
arXiv:2205.13573, Alg. 2), written from the paper in plain PyTorch.

It takes only the benchmark's inputs (the two cost matrices, the two
marginals, the seed of the request's generator and the solver's settings
from the configuration file) and works out again, in float64 unless told
otherwise:

1. the support: s i.i.d. pairs from p_ij = sqrt(a_i b_j) / Z (eq. 5), rows
   then columns, each by ``torch.multinomial`` with replacement from a
   ``torch.Generator`` seeded with the request's seed. The factors of p are
   computed in float32, the precision the configuration states, so that
   the same generator state draws the same pairs;
2. the importance weights w = 1 / (s p) and the start T0 = a_r b_c;
3. each proximal PGA step in the log domain: log K = -L(T)/ε + log w +
   log T, then H log-domain Sinkhorn iterations on the support;
4. the health rule of the outer loop: a step whose iterate is not finite
   or whose mass leaves (1e-20, 1e20) is dropped and ε doubled, at most
   ``max_rescues`` times, after which the solve has diverged;
5. the value Σ_k T_k L(T)_k (step 8).

The cost L(T)_k = Σ_l (Cx[r_k, r_l] - Cy[c_k, c_l])² T_l is evaluated as
Cx²·u at r_k, plus Cy²·v at c_k, minus twice (Cx D Cyᵀ)[r_k, c_k], where
u, v are T's row and column sums and D the dense m x n sum of T's entries:
two dense products in place of the s² terms, which is exact in float64.

A coupling entry below float32's smallest normal is set to 0 and its log
taken as -inf, as in the float32 solve the configuration states: a dead
entry stays dead. This is part of the algorithm at that precision, not a
rounding; without it a float64 solve revives entries that float32 has
lost for good.

``precision="tf32"`` is the control: the same solve in float32 with every
matrix product's inputs rounded to TF32 (10 explicit mantissa bits, round
to nearest even), the precision a float32 solve with TF32 switched on
would use. ``precision="float32"`` is the same solve in float32 with TF32
off, a second witness of how far float32 rounding alone carries.

As a configuration's ``reference``, this module also gives the settings the
program's solver is built with (:func:`program_settings`), and judges an
answer (:func:`compare`) and a sample of answers (:func:`aggregate`) by the
numbers :data:`NUMBERS`, which the configuration's ``limits`` bound.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, NamedTuple

import torch

SOLVER_KEYS = ("name", "s_per_n", "reg", "epsilon", "outer_iters",
               "inner_iters", "tol", "inner_tol", "shrink", "stable",
               "cost_impl", "max_rescues", "rescue_factor")
READS = tuple(f"solver.{k}" for k in SOLVER_KEYS) + ("problem.loss",
                                                      "dtype")
NUMBERS = ("support_mismatch", "status_mismatch", "value_rel",
           "coupling_rel_median")

FLT_MIN = 1.1754943508222875e-38     # float32's smallest normal
NEG_INF_PROXY = -1e30                # an empty segment's log-sum-exp
MASS_FLOOR = 1e-20
MASS_CEIL = 1e20

# status codes, as the solve reports them
CONVERGED, MAXITER, STALLED, DIVERGED = 0, 1, 2, 3


class Result(NamedTuple):
    value: float
    rows: torch.Tensor
    cols: torch.Tensor
    T: torch.Tensor          # (s,) in the precision of the run
    status: int
    n_iters: int


def program_settings(config: dict, n: int) -> dict:
    """The keyword arguments of the program's solver (``solver.name`` in
    its registry) at cloud size ``n``: every ``solver`` setting of the
    configuration, with ``s = s_per_n · n``. Refuses what this reference
    does not compute: another solver, loss or precision, a tolerance,
    shrinkage, or a solve outside the log domain."""
    sv = dict(config["solver"])
    if sv.pop("name") != "spar_gw" or config["problem"]["loss"] != "l2" \
            or config["dtype"] != "float32":
        raise NotImplementedError("this reference is spar_gw, l2, float32")
    if sv["reg"] != "prox" or sv["tol"] or sv["inner_tol"] or sv["shrink"] \
            or not sv["stable"]:
        raise NotImplementedError("this reference runs the log-domain "
                                  "proximal solve with fixed budgets and no "
                                  "shrinkage")
    return {"s": int(sv.pop("s_per_n")) * n, **sv}


def draw_support(a32, b32, s: int, seed: int):
    """The s support pairs a generator seeded with ``seed`` draws (rows,
    then columns) from the product measure sqrt(a) ⊗ sqrt(b), normalised in
    float32. ``a32``/``b32`` are float32 on the device of the draw."""
    gen = torch.Generator(device=a32.device).manual_seed(seed)
    pa = torch.sqrt(a32)
    pa = pa / pa.sum()
    pb = torch.sqrt(b32)
    pb = pb / pb.sum()
    rows = torch.multinomial(pa, s, replacement=True, generator=gen)
    cols = torch.multinomial(pb, s, replacement=True, generator=gen)
    return rows, cols


def to_tf32(x):
    """float32 ``x`` rounded to TF32 (the low 13 mantissa bits cleared,
    round to nearest even)."""
    i = x.contiguous().view(torch.int32)
    bump = 0x0FFF + ((i >> 13) & 1)
    return ((i + bump) & ~0x1FFF).view(torch.float32)


def _flush(x):
    return torch.where(torch.abs(x) < FLT_MIN, torch.zeros_like(x), x)


def _log0(x):
    """log x, -inf for x below float32's smallest normal."""
    return torch.log(torch.clamp_min(_flush(x), 0.0))


def _finite(x):
    return torch.where(torch.isfinite(x) & (x > NEG_INF_PROXY / 2), x,
                       torch.zeros_like(x))


def _segment_lse(vals, segs, num: int):
    """log Σ exp over each segment; ``NEG_INF_PROXY`` where empty."""
    top = torch.full((num,), -math.inf, dtype=vals.dtype,
                     device=vals.device).scatter_reduce(
        0, segs, vals, "amax", include_self=False)
    top = torch.where(top > NEG_INF_PROXY / 2, top, torch.zeros_like(top))
    sums = torch.zeros(num, dtype=vals.dtype, device=vals.device).index_add_(
        0, segs, torch.exp(vals - top[segs]))
    out = torch.log(sums) + top
    return torch.where(sums > 0, out, torch.full_like(out, NEG_INF_PROXY))


class _L2Cost:
    """L(T) on the support for the l2 ground loss, by dense products."""

    def __init__(self, Cx, Cy, rows, cols, tf32: bool):
        self.rows, self.cols, self.tf32 = rows, cols, tf32
        self.m, self.n = Cx.shape[0], Cy.shape[0]
        r = to_tf32 if tf32 else (lambda x: x)
        self.r = r
        self.Cx, self.CyT = r(Cx), r(Cy.T.contiguous())
        self.Cx2, self.Cy2 = r(Cx * Cx), r(Cy * Cy)

    def __call__(self, t):
        r, rows, cols = self.r, self.rows, self.cols
        u = torch.zeros(self.m, dtype=t.dtype, device=t.device).index_add_(
            0, rows, t)
        v = torch.zeros(self.n, dtype=t.dtype, device=t.device).index_add_(
            0, cols, t)
        D = torch.zeros((self.m, self.n), dtype=t.dtype,
                        device=t.device).index_put_((rows, cols), t,
                                                    accumulate=True)
        cross = r(self.Cx @ r(D)) @ self.CyT
        return ((self.Cx2 @ r(u))[rows] + (self.Cy2 @ r(v))[cols]
                - 2.0 * cross[rows, cols])


def _sinkhorn(la, lb, rows, cols, logK, m: int, n: int, iters: int):
    f = torch.zeros(m, dtype=logK.dtype, device=logK.device)
    g = torch.zeros(n, dtype=logK.dtype, device=logK.device)
    for _ in range(iters):
        f = _finite(la - _segment_lse(logK + g[cols], rows, m))
        g = _finite(lb - _segment_lse(logK + f[rows], cols, n))
    return _flush(torch.exp(logK + f[rows] + g[cols]))


def answer(settings: dict, inputs, seed: int,
           precision: str = "float64") -> Result:
    """The reference's answer to a request: ``inputs`` (Cx, a, Cy, b) as
    the program got them, ``settings`` from :func:`program_settings`."""
    Cx, a, Cy, b = inputs
    return solve(Cx, Cy, a, b, seed, settings, precision=precision)


def _relative(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.sum(torch.abs(x.double() - ref.double()))
                 / torch.sum(torch.abs(ref.double())))


def compare(outcome, ref: Result) -> Dict[str, float]:
    """The numbers of one answer (value, rows, cols, T, status, n_iters,
    fell_back) against the reference's."""
    same = (outcome.rows.shape == ref.rows.shape
            and outcome.cols.shape == ref.cols.shape)
    mismatch = (int(((outcome.rows.to(ref.rows.device) != ref.rows)
                     | (outcome.cols.to(ref.cols.device) != ref.cols)).sum())
                if same else int(ref.rows.numel()))
    return {
        "support_mismatch": mismatch,
        "status_mismatch": int(outcome.status != ref.status
                               or outcome.n_iters != ref.n_iters
                               or outcome.fell_back),
        "value_rel": (abs(outcome.value - ref.value) / abs(ref.value)
                      if math.isfinite(outcome.value) else math.inf),
        "coupling_rel": (_relative(outcome.T.to(ref.T.device), ref.T)
                         if same else math.inf),
    }


def aggregate(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The numbers a sample of answers is judged by: the worst answer's
    support and status mismatches and value gap, and the median answer's
    coupling gap (a few Moon pairs carry every precision's rounding 3–30x
    further through the 20 steps; the median is steady from seed to
    seed)."""
    if not readings:
        return {}
    out = {k: max(r[k] for r in readings)
           for k in ("support_mismatch", "status_mismatch", "value_rel")}
    out["coupling_rel_median"] = statistics.median(
        r["coupling_rel"] for r in readings)
    return out


def solve(Cx, Cy, a, b, seed: int, solver: dict, loss: str = "l2",
          precision: str = "float64") -> Result:
    """The balanced SPAR-GW solve of one request.

    Cx, Cy  — float32 cost matrices; a, b — float32 marginals (the
              benchmark's inputs, on the device the reference runs on)
    seed    — the seed of the request's generator
    solver  — the configuration's settings: ``s``, ``epsilon``,
              ``outer_iters``, ``inner_iters``, ``reg`` ("prox"),
              ``max_rescues``, ``rescue_factor``
    precision — "float64" (the reference), "float32" (a witness) or
              "tf32" (the control)
    """
    if loss != "l2":
        raise NotImplementedError(f"the reference has the l2 loss only, "
                                  f"not {loss!r}")
    if solver["reg"] != "prox" or solver.get("tol", 0.0) or solver.get(
            "inner_tol", 0.0) or solver.get("shrink", 0.0):
        raise NotImplementedError("the reference runs the proximal solve "
                                  "with fixed budgets and no shrinkage")
    s = int(solver["s"])
    rows, cols = draw_support(a, b, s, seed)
    if precision not in ("float64", "float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    dt = torch.float64 if precision == "float64" else torch.float32
    tf32 = precision == "tf32"
    a_, b_ = a.to(dt), b.to(dt)
    m, n = a_.shape[0], b_.shape[0]
    pa = torch.sqrt(a_) / torch.sqrt(a_).sum()
    pb = torch.sqrt(b_) / torch.sqrt(b_).sum()
    logw = -torch.log(s * pa[rows] * pb[cols])
    la, lb = _log0(a_), _log0(b_)
    cost = _L2Cost(Cx.to(dt), Cy.to(dt), rows, cols, tf32)
    eps = float(solver["epsilon"])
    T = _flush(a_[rows] * b_[cols])
    n_rescues, dead, i = 0, False, 0
    while i < int(solver["outer_iters"]) and not dead:
        e = eps * float(solver["rescue_factor"]) ** n_rescues
        logK = (-1.0 / e) * cost(T) + logw + _log0(T)
        T_new = _sinkhorn(la, lb, rows, cols, logK, m, n,
                          int(solver["inner_iters"]))
        mass = float(torch.sum(torch.abs(T_new)))
        if math.isfinite(mass) and MASS_FLOOR < mass < MASS_CEIL:
            T = T_new
        elif n_rescues < int(solver["max_rescues"]):
            n_rescues += 1
        else:
            dead = True
        i += 1
    value = float(torch.sum(T * cost(T)))
    return Result(value, rows, cols, T, DIVERGED if dead else MAXITER, i)
