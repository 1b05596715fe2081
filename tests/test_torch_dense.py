"""The dense GW solver (Alg. 1) and its cost assembly in the port against
the JAX reference, CPU.

``dense_cost`` / ``gw_objective`` for l1 (the chunked O(m²n²) contraction),
l2 and kl (the Peyré decomposition), then ``DenseGWSolver`` through
``solve`` on the Moon pair at n = 48: balanced, fused and unbalanced, in
the log domain and the plain one, with the proximal and the entropic
regularizer, and a plain-domain case whose kernel underflows so that the
ε-rescue restarts.

Tolerances, and why:
* cost matrices and objectives: rtol 1e-5 plus atol 1e-6 of the largest
  entry — the same fp32 products summed in another order (XLA's einsum
  and dot vs torch's).
* whole solves: the bounds of tests/test_torch_solve.py — value rtol
  1e-5; coupling atol 1e-6 + rtol 1e-4; errors atol 5e-5 with NaN in the
  same places; iteration counts, convergence flags and status exact.
  Both sides run the same fp32 algorithm for 20 outer x 50 inner steps.

Underflow cases: a coupling with entries below float32's smallest normal
(the cost assembly and the proximal log) and marginal entries at 1e-20,
whose products underflow in the rank-one init (the solves).
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import gw as jgw
from repro_torch.api import interop
from repro_torch.core import gw, spar_ugw
from test_torch_solve import ERR_ATOL, VALS_ATOL, VALS_RTOL, VALUE_RTOL, _moon
from test_torch_solve import _one_torch_thread  # noqa: F401 (autouse)

# the module (repro.core re-exports a function of the same name)
jugw = importlib.import_module("repro.core.spar_ugw")

COST_RTOL, COST_ATOL_REL = 1e-5, 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _cost_inputs(underflow):
    rng = np.random.default_rng(0)
    Cx = rng.random((13, 13)).astype(np.float32) + 0.05
    Cy = rng.random((11, 11)).astype(np.float32) + 0.05
    T = rng.random((13, 11)).astype(np.float32)
    T /= T.sum()
    if underflow:
        T[:4] = 1e-40
    return Cx, Cy, T


@pytest.mark.parametrize("underflow", [False, True])
@pytest.mark.parametrize("loss", ["l1", "l2", "kl"])
def test_dense_cost_matches_reference(loss, underflow):
    Cx, Cy, T = _cost_inputs(underflow)
    want = np.asarray(jgw.dense_cost(jnp.asarray(Cx), jnp.asarray(Cy),
                                     jnp.asarray(T), loss, row_chunk=4))
    got = gw.dense_cost(_t(Cx), _t(Cy), _t(T), loss, row_chunk=4).numpy()
    np.testing.assert_allclose(got, want, rtol=COST_RTOL,
                               atol=COST_ATOL_REL * np.abs(want).max())


@pytest.mark.parametrize("loss", ["l1", "l2", "kl"])
def test_gw_objective_and_entropic_value_match_reference(loss):
    Cx, Cy, T = _cost_inputs(False)
    T[0, :3] = 0.0
    args_j = (jnp.asarray(Cx), jnp.asarray(Cy), jnp.asarray(T), loss)
    args_t = (_t(Cx), _t(Cy), _t(T), loss)
    np.testing.assert_allclose(float(gw.gw_objective(*args_t)),
                               float(jgw.gw_objective(*args_j)),
                               rtol=COST_RTOL)
    np.testing.assert_allclose(float(gw.entropic_gw_value(*args_t, 0.05)),
                               float(jgw.entropic_gw_value(*args_j, 0.05)),
                               rtol=COST_RTOL)


@pytest.mark.parametrize("loss", ["l1", "l2"])
def test_ugw_values_match_reference(loss):
    """``naive_ugw_value`` (the T = a bᵀ baseline) and ``ugw_value`` on a
    sparse support with its importance-free plug-in cost."""
    Cx, a, Cy, b = _moon(24, seed=2)
    b = 1.5 * b
    np.testing.assert_allclose(
        float(spar_ugw.naive_ugw_value(_t(a), _t(b), _t(Cx), _t(Cy), loss,
                                       0.7)),
        float(jugw.naive_ugw_value(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(Cx), jnp.asarray(Cy), loss,
                                   0.7)), rtol=COST_RTOL)
    rng = np.random.default_rng(3)
    rows, cols = rng.integers(0, 24, 100), rng.integers(0, 24, 100)
    vals = (rng.random(100) / 80).astype(np.float32)
    want = jugw.ugw_value(jnp.asarray(a), jnp.asarray(b), jnp.asarray(Cx),
                          jnp.asarray(Cy), jnp.asarray(rows),
                          jnp.asarray(cols), jnp.asarray(vals), 0.7, loss)
    got = spar_ugw.ugw_value(_t(a), _t(b), _t(Cx), _t(Cy), _t(rows),
                             _t(cols), _t(vals), 0.7, loss)
    np.testing.assert_allclose(float(got), float(want), rtol=COST_RTOL)


def _run_both(data, loss, lam=None, M=None, alpha=None, **fields):
    Cx, a, Cy, b = data
    js = repro.DenseGWSolver(**fields)
    jp = repro.QuadraticProblem(
        repro.Geometry(jnp.asarray(Cx), jnp.asarray(a)),
        repro.Geometry(jnp.asarray(Cy), jnp.asarray(b)), loss=loss, lam=lam,
        fused_penalty=alpha, M=None if M is None else jnp.asarray(M))
    jo = repro.solve(jp, js)
    po = repro_torch.solve(
        interop.to_problem(Cx, a, Cy, b, loss, lam=lam, M=M,
                           fused_penalty=alpha),
        interop.to_solver({f.name: getattr(js, f.name)
                           for f in dataclasses.fields(js)}, "dense_gw"),
        device="cpu")
    return jo, interop.output_to_numpy(po)


def _assert_parity(jo, P):
    np.testing.assert_allclose(P["value"], float(jo.value), rtol=VALUE_RTOL)
    np.testing.assert_allclose(P["dense"], np.asarray(jo.coupling),
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


@pytest.mark.parametrize("reg", ["prox", "ent"])
@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("loss", ["l1", "l2", "kl"])
def test_dense_solve_matches_reference(moon48, loss, stable, reg):
    jo, P = _run_both(moon48, loss, stable=stable, reg=reg, epsilon=0.05)
    assert int(jo.status.code) <= repro.health.MAXITER      # healthy
    _assert_parity(jo, P)


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("loss", ["l1", "l2"])
def test_dense_fused_solve_matches_reference(moon48, loss, stable):
    M = np.random.default_rng(11).random((48, 48)).astype(np.float32)
    jo, P = _run_both(moon48, loss, M=M, alpha=0.7, stable=stable,
                      epsilon=0.05)
    _assert_parity(jo, P)


@pytest.mark.parametrize("reg", ["prox", "ent"])
@pytest.mark.parametrize("loss", ["l1", "l2", "kl"])
def test_dense_unbalanced_solve_matches_reference(moon48, loss, reg):
    Cx, a, Cy, b = moon48
    jo, P = _run_both((Cx, a, Cy, 1.5 * b), loss, lam=1.0, reg=reg)
    assert int(jo.status.code) == repro.health.MAXITER
    _assert_parity(jo, P)


@pytest.mark.parametrize("reg,eps,code", [
    ("ent", 1e-3, 1),      # two rescues, then a healthy run: MAXITER
    ("prox", 3e-4, 3),     # rescues exhausted: DIVERGED
])
def test_dense_rescue_matches_reference(moon48, reg, eps, code):
    """A plain-domain kernel at small ε underflows: the reference rescues
    by doubling ε from the last healthy iterate; the port must do the
    same."""
    jo, P = _run_both(moon48, "l2", stable=False, reg=reg, epsilon=eps)
    assert int(jo.status.n_rescues) == 2 and int(jo.status.code) == code
    _assert_parity(jo, P)


@pytest.mark.parametrize("lam", [None, 1.0])
def test_dense_underflow_marginals_match_reference(lam):
    """Marginal entries at 1e-20: the init products a_i b_j fall below the
    smallest normal (0 under XLA, log -inf in the proximal term)."""
    Cx, a, Cy, b = _moon(48, seed=3)
    a, b = a.copy(), b.copy()
    a[:3] = 1e-20
    b[-3:] = 1e-20
    a, b = a / a.sum(), b / b.sum()
    jo, P = _run_both((Cx, a, Cy, b), "l2", lam=lam)
    assert np.all(np.asarray(jo.coupling)[:3, -3:] == 0.0)
    _assert_parity(jo, P)


def test_dense_tolerance_stops_like_reference(moon48):
    jo, P = _run_both(moon48, "l2", tol=1e-4, inner_tol=1e-5)
    assert bool(jo.converged) and int(jo.n_iters) < 20
    _assert_parity(jo, P)


def test_dense_point_cloud_geometry_matches_cost_matrix():
    """A point-cloud geometry solves like its squared-distance matrix."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((30, 2)).astype(np.float32)
    Y = rng.standard_normal((30, 3)).astype(np.float32)
    w = np.full(30, 1 / 30, np.float32)
    clouds = interop.to_problem(None, w, None, w, points_x=X, points_y=Y)
    dense = interop.to_problem(clouds.geom_x.cost_matrix.numpy(), w,
                               clouds.geom_y.cost_matrix.numpy(), w)
    v1 = float(repro_torch.solve(clouds, "dense_gw", device="cpu").value)
    v2 = float(repro_torch.solve(dense, "dense_gw", device="cpu").value)
    assert v1 == v2
