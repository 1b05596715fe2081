"""The slice as a whole: the port's ``solve`` against ``repro.solve``, CPU.

Each case builds a Moon pair (the paper's §6.1 data) from a numpy seed,
solves it with the JAX reference, and solves it with the port on the
reference's sampled support (``support=``; threefry draws cannot be
reproduced in torch), through ``repro_torch.api.interop``.

Tolerances, and why: both sides run the same fp32 algorithm for 20 outer
x 50 inner iterations and differ only in summation order (XLA's scatter
and matmul vs ``index_add_`` and torch's matmul) and the last ulp of
exp/log. Seen on this data: value rel 6e-7, coupling values abs 5e-8
(entries up to 0.17), marginal errors abs 1e-5 (a difference of sums).
Held to: value rtol 1e-5; vals atol 1e-6 + rtol 1e-4; errors and
last_err atol 5e-5 with NaN in the same places. Iteration counts,
convergence flags and status codes must match exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro_torch.api import interop
from repro_torch.api.solvers import DenseGWSolver, SparGWSolver
from repro_torch.health import FaultSpec
from repro_torch.lowrank.solver import LowRankGWSolver

VALUE_RTOL = 1e-5
VALS_ATOL, VALS_RTOL = 1e-6, 1e-4
ERR_ATOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for a module's tests (the GW parity files
    import this fixture). Their solves are small (n ≤ 150): one thread runs
    them as fast as eight alone, while under the suite's parallel workers
    each process's eight spinning threads contend for the same cores (on
    an 8-core CPU with 6 workers, test_torch_dense.py took 930 s that way
    against 35 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _moon(n, seed=0):
    """Two noisy interleaved half circles with Gaussian marginals floored
    at 1e-9 (benchmarks/datasets.py: moon), Euclidean distance costs."""
    def points(rng):
        n1 = n // 2
        t1, t2 = np.pi * rng.random(n1), np.pi * rng.random(n - n1)
        pts = np.concatenate([np.stack([np.cos(t1), np.sin(t1)], 1),
                              np.stack([1 - np.cos(t2), 0.5 - np.sin(t2)], 1)])
        return pts + 0.05 * rng.standard_normal(pts.shape)

    def weights(mean_frac):
        idx = np.arange(n)
        w = np.exp(-0.5 * ((idx - mean_frac * n) / (n / 20)) ** 2) + 1e-9
        return (w / w.sum()).astype(np.float32)

    def dist(x):
        return np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)).astype(
            np.float32)

    x = points(np.random.default_rng(seed))
    y = points(np.random.default_rng(seed + 1))
    return dist(x), weights(1 / 3), dist(y), weights(1 / 2)


def _run_both(data, loss, M=None, alpha=None, **fields):
    Cx, a, Cy, b = data
    n = max(len(a), len(b))
    js = repro.SparGWSolver(s=16 * n, **fields)
    jp = repro.QuadraticProblem(repro.Geometry(jnp.asarray(Cx), jnp.asarray(a)),
                                repro.Geometry(jnp.asarray(Cy), jnp.asarray(b)),
                                loss=loss, fused_penalty=alpha,
                                M=None if M is None else jnp.asarray(M))
    jo = repro.solve(jp, js, key=jax.random.PRNGKey(0))
    pp = interop.to_problem(Cx, a, Cy, b, loss)
    if M is not None:
        pp = repro_torch.QuadraticProblem(pp.geom_x, pp.geom_y, loss,
                                          fused_penalty=alpha, M=M)
    po = repro_torch.solve(
        pp,
        interop.to_solver({f.name: getattr(js, f.name)
                           for f in dataclasses.fields(js)}),
        support=interop.to_support(jo.coupling.rows, jo.coupling.cols),
        device="cpu")
    return jo, interop.output_to_numpy(po)


def _assert_parity(jo, P):
    np.testing.assert_allclose(P["value"], float(jo.value), rtol=VALUE_RTOL)
    np.testing.assert_array_equal(P["rows"], np.asarray(jo.coupling.rows))
    np.testing.assert_allclose(P["vals"], np.asarray(jo.coupling.vals),
                               rtol=VALS_RTOL, atol=VALS_ATOL)
    np.testing.assert_allclose(P["errors"], np.asarray(jo.errors),
                               rtol=0, atol=ERR_ATOL)      # NaNs must align
    assert P["n_iters"] == int(jo.n_iters)
    assert P["converged"] == bool(jo.converged)
    st = P["status"]
    assert st["code"] == int(jo.status.code)
    assert st["fail_iter"] == int(jo.status.fail_iter)
    assert st["n_rescues"] == int(jo.status.n_rescues)
    np.testing.assert_allclose(st["last_err"], float(jo.status.last_err),
                               rtol=0, atol=ERR_ATOL)


@pytest.fixture(scope="module")
def moon48():
    return _moon(48)


@pytest.mark.parametrize("cost_impl", ["materialized", "pallas"])
@pytest.mark.parametrize("loss", ["l1", "l2", "kl"])
def test_solve_matches_reference(moon48, loss, cost_impl):
    jo, P = _run_both(moon48, loss, cost_impl=cost_impl)
    assert int(jo.status.code) == repro.health.MAXITER
    _assert_parity(jo, P)


@pytest.mark.parametrize("loss,reg,eps,code", [
    ("l2", "ent", 1e-4, 1),      # two rescues, then a healthy run: MAXITER
    ("kl", "prox", 1e-3, 3),     # rescues exhausted: DIVERGED
])
def test_rescue_matches_reference(moon48, loss, reg, eps, code):
    """Plain-domain kernels at small ε underflow: the reference rescues by
    doubling ε from the last healthy iterate; the port must do the same."""
    jo, P = _run_both(moon48, loss, stable=False, reg=reg, epsilon=eps,
                      cost_impl="materialized")
    assert int(jo.status.n_rescues) > 0 and int(jo.status.code) == code
    _assert_parity(jo, P)


@pytest.mark.parametrize("loss", ["l2", "l1"])
def test_fused_solve_matches_reference(moon48, loss):
    """Fused GW (Alg. 4): C = α·(L ⊗ T) + (1-α)·M on the support, with a
    numpy-seeded M and α = 0.7; the objective mixes both terms."""
    M = np.random.default_rng(11).random((48, 48)).astype(np.float32)
    jo, P = _run_both(moon48, loss, M=M, alpha=0.7)
    assert int(jo.status.code) == repro.health.MAXITER
    _assert_parity(jo, P)


def test_tolerance_stops_like_reference(moon48):
    jo, P = _run_both(moon48, "l2", tol=1e-3, inner_tol=1e-4)
    assert bool(jo.converged) and int(jo.n_iters) < 20
    _assert_parity(jo, P)


def test_subnormal_marginal_entry_matches_reference():
    """A marginal entry below the smallest normal float32, sampled thanks to
    ``shrink``: XLA flushes it to 0 (log -inf, potential 0); the port's
    flush reproduces value and coupling within the stated tolerances."""
    Cx, a, Cy, b = _moon(48, seed=3)
    a = a.copy()
    a[0] = np.float32(1e-40)
    jo, P = _run_both((Cx, a, Cy, b), "l2", shrink=0.2)
    assert np.any(np.asarray(jo.coupling.rows) == 0)
    _assert_parity(jo, P)


def test_todense_sums_duplicates_like_reference():
    rows, cols = np.array([0, 1, 0, 2]), np.array([1, 1, 1, 0])
    vals = np.array([0.5, 0.25, 0.125, 1.0], np.float32)
    want = repro.SparseCoupling(jnp.asarray(rows), jnp.asarray(cols),
                                jnp.asarray(vals)).todense(3, 2)
    got = repro_torch.SparseCoupling(torch.from_numpy(rows),
                                     torch.from_numpy(cols),
                                     torch.from_numpy(vals)).todense(3, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,name", [(200, "dense_gw"), (300, "spar_gw"),
                                    (2048, "spar_gw"), (3000, "quantized_gw"),
                                    (3000, "lowrank_gw")])
def test_select_solver_routes_like_reference(n, name):
    """The lowrank_gw case is an l2 point cloud (exactly factorizable);
    the others are cost matrices."""
    a = np.full(n, 1.0 / n, np.float32)
    if name == "lowrank_gw":
        pts = np.random.default_rng(0).standard_normal((n, 3))
        jg = repro.Geometry.from_points(pts.astype(np.float32), a)
        jp = repro.QuadraticProblem(jg, jg)
        p = interop.to_problem(None, a, None, a, points_x=pts, points_y=pts)
    else:
        C = np.zeros((n, n), np.float32)
        jp = repro.QuadraticProblem(repro.Geometry(C, a), repro.Geometry(C, a))
        p = interop.to_problem(C, a, C, a)
    assert type(repro.select_solver(jp)).name == name
    want = {"spar_gw": SparGWSolver(s=16 * n), "dense_gw": DenseGWSolver(),
            "lowrank_gw": LowRankGWSolver(),
            "quantized_gw": repro_torch.QuantizedGWSolver()}
    assert repro_torch.select_solver(p) == want[name]


def test_own_draw_is_reproducible_and_healthy():
    Cx, a, Cy, b = _moon(64)
    p = interop.to_problem(Cx, a, Cy, b, "l2")

    def run():
        return repro_torch.solve(p, "spar_gw", device="cpu",
                                 generator=torch.Generator().manual_seed(1))
    o1, o2 = run(), run()
    assert torch.equal(o1.coupling.vals, o2.coupling.vals)
    assert o1.coupling.rows.shape == (16 * 64,)
    assert np.isfinite(float(o1.value)) and o1.status.is_healthy


def test_unported_paths_raise():
    Cx, a, Cy, b = _moon(48)
    p = interop.to_problem(Cx, a, Cy, b)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="generator"):
        repro_torch.solve(p, SparGWSolver(s=100), device="cpu")
    fused_unbalanced = repro_torch.QuadraticProblem(
        p.geom_x, p.geom_y, lam=1.0, fused_penalty=0.5,
        M=np.ones((48, 48), np.float32))
    with pytest.raises(NotImplementedError,
                       match="fused \\+ unbalanced GW is not implemented"):
        repro_torch.solve(fused_unbalanced, SparGWSolver(s=100), gen,
                          device="cpu")
    # a fault that is not a FaultSpec is a TypeError, as the reference's
    # jit gives for it; a FaultSpec is injected
    with pytest.raises(TypeError, match="FaultSpec"):
        repro_torch.solve(p, SparGWSolver(s=100, fault=object()), gen,
                          device="cpu")
    faulted = repro_torch.solve(p, SparGWSolver(
        s=100, max_rescues=0, fault=FaultSpec(at_iter=1, persistent=True)),
        gen, device="cpu")
    assert faulted.status.describe() == "DIVERGED"
    assert faulted.status.fail_iter == 1
    with pytest.raises(NotImplementedError, match="item 14"):
        repro_torch.solve(p, SparGWSolver(s=100, trace=True), gen,
                          device="cpu")
    dense = repro_torch.solve(p, "dense_gw", device="cpu")   # no generator
    assert dense.status.is_healthy and np.isfinite(float(dense.value))
    assert tuple(dense.coupling.shape) == (48, 48)
    with pytest.raises(ValueError, match="out of range"):
        repro_torch.solve(p, SparGWSolver(s=2), device="cpu",
                          support=([0, 48], [0, 0]))
