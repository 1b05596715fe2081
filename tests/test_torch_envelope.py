"""The port's envelope gradient against its own unrolled gradient at
converged fixed points, CPU.

Danskin's theorem makes the two equal where the fixed point is a
stationary point of the objective over the coupling polytope, so each
case first checks that its solve converged (marginal ℓ1 error below
1e-4, last relative movement of the iterate below 1e-5, read from the
convergence trace), then holds the two gradients to the reference's own
bound: a relative gap of 1e-3 in a directional derivative
(tests/test_diff.py's REL_TOL). Measured: 0 for dense, for spar on the
full support and for low rank (at these settled fixed points nothing
flows through the iterations; the dense coupling is a permutation).
tests/test_torch_envelope_spar.py holds spar on a sampled support.
"""
import numpy as np
import torch

import repro_torch
from repro_torch.lowrank.solver import _resolve_draws
from test_torch_solve import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_unrolled import (
    _near_isometric,
    _port_grad,
    _problems,
    _t,
)

REL_TOL = 1e-3


def _rel(u, v):
    return abs(u - v) / max(abs(u), abs(v), 1e-12)


def _envelope_vs_unrolled(pp, Cx, solver, D, **kw):
    C1 = _t(Cx, True)
    out = repro_torch.solve(pp(C1), solver, device="cpu", **kw)
    genv, = torch.autograd.grad(out.value, C1)
    _, gunr = _port_grad(pp, Cx, solver, **kw)
    # converged: the marginals met and the iterate at rest
    assert float(out.errors[out.n_iters - 1]) < 1e-4
    assert float(out.trace.delta[out.n_iters - 1]) < 1e-5
    D = torch.as_tensor(D, dtype=torch.float32)
    return _rel(float((genv * D).sum()), float((gunr * D).sum()))


def test_envelope_matches_unrolled_dense():
    Cx, Cy = _near_isometric(10, 10, 0.1, 0, scale=1.0)
    _, pp = _problems(Cx, Cy)
    D = np.random.default_rng(0).standard_normal((10, 10))
    solver = repro_torch.DenseGWSolver(epsilon=5e-2, outer_iters=20,
                                       inner_iters=50, trace=True)
    assert _envelope_vs_unrolled(pp, Cx, solver, (D + D.T) / 2) <= REL_TOL


def test_envelope_matches_unrolled_spar_on_the_full_support():
    """spar_gw on all n² pairs (s = n², uniform weights, so constant
    importance weights): the dense dynamics through the matvec kernel's
    Function and the sparse Sinkhorn."""
    Cx, Cy = _near_isometric(10, 10, 0.1, 0, scale=1.0)
    _, pp = _problems(Cx, Cy)
    D = np.random.default_rng(0).standard_normal((10, 10))
    full = (torch.arange(10).repeat_interleave(10), torch.arange(10).repeat(10))
    solver = repro_torch.SparGWSolver(s=100, epsilon=5e-2, outer_iters=20,
                                      inner_iters=50, trace=True)
    assert _envelope_vs_unrolled(pp, Cx, solver, (D + D.T) / 2,
                                 support=full) <= REL_TOL


def test_envelope_matches_unrolled_lowrank():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((11, 2)).astype(np.float32)
    y = rng.standard_normal((11, 2)).astype(np.float32)
    a = _t(np.full(11, 1.0 / 11))
    solver = repro_torch.LowRankGWSolver(rank=3, outer_iters=30,
                                         inner_iters=50, tol=0.0,
                                         inner_tol=0.0, trace=True)

    def pp(x_):
        return repro_torch.QuadraticProblem(
            repro_torch.Geometry.from_points(x_, a, validate=False),
            repro_torch.Geometry.from_points(_t(y), a, validate=False),
            validate=False)
    # one set of draws for both runs (the anchor init's FPS starts)
    draws = _resolve_draws(None, torch.Generator().manual_seed(0), pp(_t(x)),
                           "anchors", 3, 11)
    D = np.random.default_rng(2).standard_normal(x.shape)
    assert _envelope_vs_unrolled(pp, x, solver, D, draws=draws) <= REL_TOL
