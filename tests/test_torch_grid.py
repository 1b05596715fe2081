"""The grid slice: the port's GridGWSolver against ``repro.GridGWSolver``, CPU.

Each solve case builds the paper's Moon pair (§6.1) at n = 48 from a numpy
seed, solves it with the JAX reference (its Pallas gw_cost kernel in
interpret mode where ``use_kernel`` is set), and solves it with the port
on the reference's sampled row and col sets (``support=(R, C)``; threefry
draws cannot be reproduced in torch), through ``repro_torch.api.interop``.
The grid is s_r = 24 by s_c = 20 unless a case says otherwise.

Tolerances, and why: both sides run the same fp32 algorithm for 20 outer
x 50 inner iterations and differ only in summation order (XLA's einsum,
matmul and Pallas tiles vs torch's matmul and matrix-vector products) and
the last ulp of exp/log. Seen on this data: value rel <= 2.4e-6, block
abs <= 1.3e-7 (entries up to 0.2), marginal errors abs <= 1.1e-5. Held to
the same bounds as tests/test_torch_solve.py: value rtol 1e-5; block atol
1e-6 + rtol 1e-4; errors and last_err atol 5e-5 with NaN in the same
places. Iteration counts, convergence flags and status codes must match
exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import grid_gw as j_grid_gw
from repro_torch.api import interop
from repro_torch.api.solvers import GridGWSolver
from repro_torch.core import grid_gw
from test_torch_solve import ERR_ATOL, VALS_ATOL, VALS_RTOL, VALUE_RTOL, _moon
from test_torch_solve import _one_torch_thread  # noqa: F401 (autouse)

S_R, S_C = 24, 20


@pytest.fixture(scope="module")
def moon48():
    return _moon(48)


def _run_both(data, loss, **fields):
    Cx, a, Cy, b = data
    js = repro.GridGWSolver(**{"s_r": S_R, "s_c": S_C, **fields})
    jp = repro.QuadraticProblem(repro.Geometry(jnp.asarray(Cx), jnp.asarray(a)),
                                repro.Geometry(jnp.asarray(Cy), jnp.asarray(b)),
                                loss=loss)
    jo = repro.solve(jp, js, key=jax.random.PRNGKey(0))
    po = repro_torch.solve(
        interop.to_problem(Cx, a, Cy, b, loss),
        interop.to_solver({f.name: getattr(js, f.name)
                           for f in dataclasses.fields(js)}, "grid_gw"),
        support=interop.to_support(jo.coupling.rows, jo.coupling.cols),
        device="cpu")
    return jo, interop.output_to_numpy(po)


def _assert_parity(jo, P):
    np.testing.assert_allclose(P["value"], float(jo.value), rtol=VALUE_RTOL)
    np.testing.assert_array_equal(P["rows"], np.asarray(jo.coupling.rows))
    np.testing.assert_array_equal(P["cols"], np.asarray(jo.coupling.cols))
    np.testing.assert_allclose(P["block"], np.asarray(jo.coupling.block),
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


@pytest.mark.parametrize("loss,fields", [
    ("l1", {"use_kernel": True}),       # the gw_cost kernel (K3)
    ("l1", {"use_kernel": False}),      # the plain chunked contraction
    ("l2", {"use_kernel": True}),       # decomposition: two matmuls
    ("kl", {}),                         # decomposition, kl clamps
    ("l1", {"stable": False, "use_kernel": True}),   # plain-domain Sinkhorn
    ("l2", {"stable": False}),
    ("l2", {"reg": "ent"}),
    ("l1", {"reg": "ent", "use_kernel": True}),
    ("l1", {"shrink": 0.3, "use_kernel": True}),
    ("l1", {"s_r": 23, "s_c": 19, "use_kernel": True}),   # prime sides
], ids=["l1-kernel", "l1-plain", "l2", "kl", "l1-unstable", "l2-unstable",
        "l2-ent", "l1-ent", "l1-shrink", "l1-prime"])
def test_grid_solve_matches_reference(moon48, loss, fields):
    jo, P = _run_both(moon48, loss, **fields)
    assert int(jo.status.code) == repro.health.MAXITER
    _assert_parity(jo, P)


@pytest.mark.parametrize("loss,reg,code", [
    ("l1", "prox", 1),      # one rescue, then a healthy run: MAXITER
    ("kl", "ent", 3),       # rescues exhausted: DIVERGED
])
def test_grid_rescue_matches_reference(moon48, loss, reg, code):
    """Plain-domain kernels at ε = 1e-3 underflow: the reference rescues by
    doubling ε from the last healthy iterate; the port must do the same."""
    jo, P = _run_both(moon48, loss, stable=False, reg=reg, epsilon=1e-3,
                      use_kernel=True)
    assert int(jo.status.n_rescues) > 0 and int(jo.status.code) == code
    _assert_parity(jo, P)


def test_grid_tolerance_stops_like_reference(moon48):
    jo, P = _run_both(moon48, "l1", tol=1e-3, inner_tol=1e-4, use_kernel=True)
    assert bool(jo.converged) and int(jo.n_iters) < 20
    _assert_parity(jo, P)


@pytest.mark.parametrize("loss,use_kernel", [("l1", True), ("l1", False),
                                             ("l2", False), ("kl", False)])
def test_grid_cost_matches_reference(loss, use_kernel):
    """Each route of grid_cost on random blocks (tolerance as in
    tests/test_torch_gw_cost.py: rtol 1e-5 on sums of >= 0 terms; kl's
    decomposition cancels, so atol 1e-5 of the largest entry)."""
    rng = np.random.default_rng(5)
    CxR = (rng.random((13, 13)) + 0.1).astype(np.float32)
    CyC = (rng.random((11, 11)) + 0.1).astype(np.float32)
    T = (rng.random((13, 11)) / 143).astype(np.float32)
    want = np.asarray(j_grid_gw.grid_cost(jnp.asarray(CxR), jnp.asarray(CyC),
                                          jnp.asarray(T), loss, use_kernel))
    got = grid_gw.grid_cost(torch.from_numpy(CxR), torch.from_numpy(CyC),
                            torch.from_numpy(T), loss, use_kernel).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_dedup_marginal_matches_reference():
    idx = np.array([3, 1, 3, 0, 3, 1], np.int64)
    w = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    want = j_grid_gw._dedup_marginal(jnp.asarray(idx), jnp.asarray(w), 4)
    got = grid_gw._dedup_marginal(torch.from_numpy(idx), torch.from_numpy(w),
                                  4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)


def test_grid_todense_sums_duplicates_like_reference():
    rows, cols = np.array([0, 2, 0]), np.array([1, 1])
    block = np.arange(6, dtype=np.float32).reshape(3, 2)
    want = repro.GridCoupling(jnp.asarray(rows), jnp.asarray(cols),
                              jnp.asarray(block)).todense(3, 2)
    got = repro_torch.GridCoupling(torch.from_numpy(rows),
                                   torch.from_numpy(cols),
                                   torch.from_numpy(block)).todense(3, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_grid_own_draw_is_reproducible_and_healthy():
    """``solve(problem, "grid_gw")`` takes the default config (side
    round(√(16n)) = 32 at n = 64) and draws R and C on the generator."""
    Cx, a, Cy, b = _moon(64)
    p = interop.to_problem(Cx, a, Cy, b, "l1")

    def run():
        return repro_torch.solve(p, "grid_gw", device="cpu",
                                 generator=torch.Generator().manual_seed(1))
    o1, o2 = run(), run()
    assert torch.equal(o1.coupling.block, o2.coupling.block)
    assert o1.coupling.rows.shape == (32,) and o1.coupling.block.shape == (
        32, 32)
    assert np.isfinite(float(o1.value)) and o1.status.is_healthy
    assert GridGWSolver.default_config(64) == repro_torch.GridGWSolver(
        s_r=32, s_c=32)


def test_grid_input_checks_like_reference():
    Cx, a, Cy, b = _moon(48)
    p = interop.to_problem(Cx, a, Cy, b)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="s_r > 0"):
        repro_torch.solve(p, GridGWSolver(), gen, device="cpu")
    with pytest.raises(ValueError, match="generator"):
        repro_torch.solve(p, GridGWSolver(s_r=4, s_c=4), device="cpu")
    fused = repro_torch.QuadraticProblem(p.geom_x, p.geom_y, fused_penalty=0.5,
                                         M=np.zeros((48, 48), np.float32))
    with pytest.raises(NotImplementedError, match="balanced non-fused"):
        repro_torch.solve(fused, GridGWSolver(s_r=4, s_c=4), gen,
                          device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        repro_torch.solve(p, GridGWSolver(s_r=2, s_c=3), device="cpu",
                          support=([0, 1], [0, 1]))
    with pytest.raises(ValueError, match="out of range"):
        repro_torch.solve(p, GridGWSolver(s_r=2, s_c=2), device="cpu",
                          support=([0, 1], [0, 48]))
    # trace=True records every iteration (it raised until the traces
    # were ported)
    traced = repro_torch.solve(p, GridGWSolver(s_r=4, s_c=4, trace=True),
                               gen, device="cpu")
    assert repro_torch.obs.n_valid(traced.trace) == traced.n_iters
