"""The low-rank GW solver in the port against the JAX reference, CPU.

The low-rank solve amplifies rounding: the reference's own
``test_lowrank_sketch_path_matches_exact_path`` misses its 2 % bound on
two factorizations of one cost. So parity is held in three layers, each
with the reference's draws injected (each side's FPS start, each side's
sketch matrix Ω where the sketch path runs, ``random_init``'s uniforms;
threefry draws cannot be reproduced in torch) through
``repro_torch.api.interop.to_lowrank_draws``:

1. components — the factors, the gradients and the objective, the
   anchors, both inits, one mirror step, ``lr_dykstra`` — at rtol 1e-5
   plus atol 1e-6 of the largest entry: the same fp32 algorithm, other
   summation orders (XLA's dot vs torch's). The sketch is compared as the
   products U Vᵀ and U Uᵀ, not as U: ``torch.linalg.qr`` may choose other
   column signs than ``jnp.linalg.qr``, and the signs cancel out of both;
   the sketch's products take atol 1e-5 of their largest entry, the
   rounding of a 60-row Householder QR on each side (60·2^-24 = 3.6e-6;
   seen 3.9e-6 with a power iteration);
2. whole solves at a fixed budget (``tol=0``, 20 outer steps): value at
   rtol 1e-5 (seen: rel <= 1.1e-6), iteration counts and status exact,
   marginal errors atol 1e-6; the factors at rtol 1e-4 plus atol 1e-6 of
   their largest entry (seen: 4.1e-5 in a few entries): each mirror step
   exponentiates γ·∇ with |γ·∇| up to γ0 = 10, so a rounding δ of the
   gradient moves a kernel entry by up to 10·δ, step after step;
3. the default config (300 outer steps, ``tol=1e-6``): value rtol 1e-4,
   status and ``n_iters`` equal (seen: value rel <= 9e-6 on these data).

Underflow case: a cluster of points whose weights are subnormal (zero
under XLA's flush) makes an anchor of zero mass; the reference's
``max(wy, 1e-38)`` floor is itself flushed, the lift divides 0 by 0, and
both sides must end DIVERGED the same way.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.lowrank import dykstra as jdykstra
from repro.lowrank import factorize as jfactorize
from repro.lowrank import gradients as jgradients
from repro.lowrank import init as jinit
from repro.multiscale import anchors as janchors
from repro_torch.api import interop
from repro_torch.lowrank import dykstra, factorize, gradients, init
from repro_torch.lowrank.solver import LowRankGWSolver
from repro_torch.multiscale import anchors

RTOL, ATOL_REL = 1e-5, 1e-6
QR_ATOL = 1e-5
FIXED_RTOL = 1e-5
FACTOR_RTOL = 1e-4
DEFAULT_RTOL = 1e-4
FIXED = dict(tol=0.0, outer_iters=20)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL, atol_rel=ATOL_REL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


def _clouds(n=150, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 3)).astype(np.float32)
    Y = (rng.standard_normal((n, 3)) * [1.5, 1.0, 0.5]).astype(np.float32)
    w = np.full(n, 1.0 / n, np.float32)
    return X, Y, w


def _sq_dist(P):
    sq = (P * P).sum(1)
    return np.maximum(sq[:, None] + sq[None] - 2 * P @ P.T, 0).astype(
        np.float32)


def _problems(kind, loss="l2", n=150, seed=0, wx=None, wy=None):
    """The same data as a reference problem and a port problem: ``cloud``
    (point clouds, the exact path for l2) or ``cost`` (their distance
    matrices, the sketch path)."""
    X, Y, w = _clouds(n, seed)
    wx = w if wx is None else wx
    wy = w if wy is None else wy
    j = jnp.asarray
    if kind == "cloud":
        jp = repro.QuadraticProblem(repro.Geometry.from_points(j(X), j(wx)),
                                    repro.Geometry.from_points(j(Y), j(wy)),
                                    loss=loss)
        pp = interop.to_problem(None, wx, None, wy, loss, points_x=X,
                                points_y=Y)
    else:
        Cx, Cy = _sq_dist(X), _sq_dist(Y)
        jp = repro.QuadraticProblem(repro.Geometry(j(Cx), j(wx)),
                                    repro.Geometry(j(Cy), j(wy)), loss=loss)
        pp = interop.to_problem(Cx, wx, Cy, wy, loss)
    return jp, pp


def _ref_draws(key, jp, js):
    """The reference's draws for ``repro.solve(jp, js, key=key)``, in the
    order of its key splits (lowrank/solver.py, init.py, factorize.py)."""
    m, n = jp.shape
    rank, cost_rank = js._resolve(m, n)
    k_init, k_fx, k_fy = jax.random.split(key, 3)
    d = {}
    if js.init == "anchors":
        for side, k, g in zip("xy", jax.random.split(k_init),
                              (jp.geom_x, jp.geom_y)):
            d[f"start_{side}"] = int(jax.random.categorical(
                k, jnp.log(jnp.maximum(g.weights, 1e-38))))
    else:
        kq, kr = jax.random.split(k_init)
        d["zq"] = jax.random.uniform(kq, (m, rank), jnp.float32, 0.5, 1.5)
        d["zr"] = jax.random.uniform(kr, (n, rank), jnp.float32, 0.5, 1.5)
    for side, k, g in zip("xy", (k_fx, k_fy), (jp.geom_x, jp.geom_y)):
        if not (g.is_point_cloud and g.cost is None and jp.loss == "l2"):
            d[f"omega_{side}"] = jax.random.normal(k, (g.n, cost_rank),
                                                   jnp.float32)
    return {k: np.asarray(v) for k, v in d.items()}


def _run_both(kind, loss="l2", seed=0, wx=None, wy=None, **fields):
    jp, pp = _problems(kind, loss, seed=seed, wx=wx, wy=wy)
    js = repro.LowRankGWSolver(**fields)
    key = jax.random.PRNGKey(seed)
    jo = repro.solve(jp, js, key=key)
    po = repro_torch.solve(
        pp, interop.to_solver({f.name: getattr(js, f.name)
                               for f in dataclasses.fields(js)},
                              "lowrank_gw"),
        draws=interop.to_lowrank_draws(**_ref_draws(key, jp, js)),
        device="cpu")
    return jo, interop.output_to_numpy(po)


# -- layer 1: components -----------------------------------------------------

def test_exact_factors_match_reference():
    X, _, _ = _clouds(40)
    jf = jfactorize.sq_euclidean_factors(jnp.asarray(X))
    pf = factorize.sq_euclidean_factors(_t(X))
    _close(pf.u, jf.u)
    _close(pf.v, jf.v)
    _close(pf.todense(), _sq_dist(X), rtol=1e-4)      # exact up to rounding
    jk = jfactorize.khatri_rao_square(jf)
    pk = factorize.khatri_rao_square(pf)
    assert pk.rank == 25
    _close(pk.u, jk.u)
    _close(pk.v, jk.v)


@pytest.mark.parametrize("power_iters", [0, 1])
def test_sketch_factors_match_reference(power_iters):
    X, _, _ = _clouds(60)
    C = np.sqrt(_sq_dist(X))     # full rank (a squared distance has rank 5)
    omega = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (60, 12)))
    jf = jfactorize.sketch_factors(jnp.asarray(C), 12, jax.random.PRNGKey(1),
                                   power_iters)
    pf = factorize.sketch_factors(_t(C), _t(omega), power_iters)
    _close(pf.todense(), jf.todense(), atol_rel=QR_ATOL)
    if power_iters == 0:
        # after a power iteration the span's last directions sit near the
        # spectral gap and U Uᵀ moves with rounding; U Vᵀ does not
        _close(pf.u @ pf.u.T, jf.u @ jf.u.T, atol_rel=QR_ATOL)
    x = np.random.default_rng(2).random(60).astype(np.float32)
    _close(pf.apply(_t(x)), jf.apply(jnp.asarray(x)), atol_rel=QR_ATOL)


@pytest.mark.parametrize("kind,loss", [("cloud", "l2"), ("cost", "l2"),
                                       ("cost", "kl"), ("cloud", "kl")])
def test_factor_ground_matches_reference(kind, loss):
    jp, pp = _problems(kind, loss, n=50)
    x = np.random.default_rng(3).random(50).astype(np.float32)
    for side, jg, pg in (("x", jp.geom_x, pp.geom_x),
                         ("y", jp.geom_y, pp.geom_y)):
        key = jax.random.PRNGKey(4)
        omega = np.asarray(jax.random.normal(key, (50, 20), jnp.float32))
        jf = jfactorize.factor_ground(jg, loss, side, 20, key)
        pf = factorize.factor_ground(pg, loss, side, _t(omega))
        assert pf.exact == jf.exact == (kind == "cloud" and loss == "l2")
        _close(pf.h.todense(), jf.h.todense(), atol_rel=QR_ATOL)
        _close(pf.apply_f(_t(x)), jf.apply_f(jnp.asarray(x)))


def _state(m=40, n=35, r=5, seed=5):
    rng = np.random.default_rng(seed)
    Q = (rng.random((m, r)) / (m * r)).astype(np.float32)
    R = (rng.random((n, r)) / (n * r)).astype(np.float32)
    g = (rng.random(r) + 0.5).astype(np.float32)
    return Q, R, g / g.sum()


def _cloud_factors(m=40, n=35):
    X, Y, _ = _clouds(max(m, n))
    fx = (jfactorize.sq_euclidean_factors(jnp.asarray(X[:m])),
          factorize.sq_euclidean_factors(_t(X[:m])))
    fy = (jfactorize.sq_euclidean_factors(jnp.asarray(Y[:n])).scale(2.0),
          factorize.sq_euclidean_factors(_t(Y[:n])).scale(2.0))
    return fx, fy


def test_gradients_and_value_match_reference():
    Q, R, g = _state()
    (jhx, phx), (jhy, phy) = _cloud_factors()
    jg = jgradients.gw_lr_gradients(jnp.asarray(Q), jnp.asarray(R),
                                    jnp.asarray(g), jhx, jhy)
    pg = gradients.gw_lr_gradients(_t(Q), _t(R), _t(g), phx, phy)
    for got, want in zip(pg, jg):
        _close(got, want)
    jp, pp = _problems("cloud", n=40)
    Q, R, g = _state(40, 40)
    jf = [jfactorize.factor_ground(geom, "l2", side, 0, None)
          for side, geom in (("x", jp.geom_x), ("y", jp.geom_y))]
    pf = [factorize.factor_ground(geom, "l2", side)
          for side, geom in (("x", pp.geom_x), ("y", pp.geom_y))]
    want = float(jgradients.gw_lr_value(jnp.asarray(Q), jnp.asarray(R),
                                        jnp.asarray(g), *jf))
    got = float(gradients.gw_lr_value(_t(Q), _t(R), _t(g), *pf))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("tol", [0.0, 3e-6])
def test_lr_dykstra_matches_reference(tol):
    rng = np.random.default_rng(6)
    K1 = np.exp(rng.standard_normal((40, 5))).astype(np.float32)
    K2 = np.exp(rng.standard_normal((35, 5))).astype(np.float32)
    k3 = np.exp(rng.standard_normal(5)).astype(np.float32)
    a = np.full(40, 1 / 40, np.float32)
    b = rng.random(35).astype(np.float32)
    b /= b.sum()
    jq = jdykstra.lr_dykstra(*map(jnp.asarray, (K1, K2, k3, a, b)), 1e-10,
                             200, tol)
    pq = dykstra.lr_dykstra(*map(_t, (K1, K2, k3, a, b)), 1e-10, 200, tol)
    for got, want in zip(pq, jq):
        _close(got, want)


@pytest.mark.parametrize("epsilon,scale", [(0.0, 1.0), (0.05, 2.0)])
def test_one_mirror_step_matches_reference(epsilon, scale):
    Q, R, g = _state()
    a, b = Q.sum(1), R.sum(1)
    (jhx, phx), (jhy, phy) = _cloud_factors()
    js = repro.LowRankGWSolver(epsilon=epsilon)
    ps = LowRankGWSolver(epsilon=epsilon)
    want = js._md_step((jnp.asarray(Q), jnp.asarray(R), jnp.asarray(g)),
                       scale, jnp.asarray(a), jnp.asarray(b), jhx, jhy)
    got = ps._md_step((_t(Q), _t(R), _t(g)), scale, _t(a), _t(b), phx, phy)
    for x, y in zip(got, want):
        _close(x, y)


def test_anchor_selection_matches_reference():
    X, _, w = _clouds(80)
    D = _sq_dist(X)
    # the reference draws its start inside: the port starts from that draw
    key = jax.random.PRNGKey(7)
    start = int(jax.random.categorical(key, jnp.log(jnp.asarray(w))))
    j_idx = np.asarray(janchors.farthest_point_sampling(
        key, jnp.asarray(D), jnp.asarray(w), 9))
    p_idx = anchors.farthest_point_sampling(start, _t(D), 9).numpy()
    np.testing.assert_array_equal(p_idx, j_idx)
    j_idx2, j_assign = janchors.fps_points(key, jnp.asarray(X),
                                           jnp.asarray(w), 9)
    p_idx2, p_assign = anchors.fps_points(start, _t(X), 9)
    np.testing.assert_array_equal(p_idx2.numpy(), np.asarray(j_idx2))
    np.testing.assert_array_equal(p_assign.numpy(), np.asarray(j_assign))
    j_med, j_massign = janchors.medoid_refinement(
        jnp.asarray(D), jnp.asarray(w), jnp.asarray(j_idx), 2)
    p_med, p_massign = anchors.medoid_refinement(_t(D), _t(w), _t(p_idx), 2)
    np.testing.assert_array_equal(p_med.numpy(), np.asarray(j_med))
    np.testing.assert_array_equal(p_massign.numpy(), np.asarray(j_massign))


def test_fps_ties_go_to_the_first_index():
    """Points on a lattice: many equal max-min distances; argmax takes the
    first in both frameworks."""
    g = np.stack(np.meshgrid(np.arange(6.0), np.arange(6.0)), -1)
    X = g.reshape(-1, 2).astype(np.float32)
    w = np.full(36, 1 / 36, np.float32)
    key = jax.random.PRNGKey(0)
    start = int(jax.random.categorical(key, jnp.log(jnp.asarray(w))))
    j_idx, j_assign = janchors.fps_points(key, jnp.asarray(X),
                                          jnp.asarray(w), 8)
    p_idx, p_assign = anchors.fps_points(start, _t(X), 8)
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(p_assign.numpy(), np.asarray(j_assign))


@pytest.mark.parametrize("kind", ["cloud", "cost"])
def test_inits_match_reference(kind):
    jp, pp = _problems(kind, n=60)
    key = jax.random.PRNGKey(8)
    d = _ref_draws(key, jp, repro.LowRankGWSolver(init="anchors"))
    want = jinit.anchor_init(jax.random.split(key, 3)[0], jp, 6)
    got = init.anchor_init((int(d["start_x"]), int(d["start_y"])), pp, 6)
    for x, y in zip(got, want):
        _close(x, y)
    d = _ref_draws(key, jp, repro.LowRankGWSolver(init="random", rank=6))
    want = jinit.random_init(jax.random.split(key, 3)[0], jp.geom_x.weights,
                             jp.geom_y.weights, 6)
    got = init.random_init(pp.geom_x.weights, pp.geom_y.weights,
                           _t(d["zq"]), _t(d["zr"]))
    for x, y in zip(got, want):
        _close(x, y)


# -- layer 2: whole solves at a fixed budget ---------------------------------

def _assert_fixed_parity(jo, P):
    np.testing.assert_allclose(P["value"], float(jo.value), rtol=FIXED_RTOL)
    c = jo.coupling
    for name, want in (("q", c.q), ("r", c.r), ("g", c.g)):
        _close(P[name], want, rtol=FACTOR_RTOL)
    np.testing.assert_allclose(P["errors"], np.asarray(jo.errors), rtol=0,
                               atol=1e-6)
    assert P["n_iters"] == int(jo.n_iters)
    assert P["converged"] == bool(jo.converged)
    assert P["status"]["code"] == int(jo.status.code)
    assert P["status"]["n_rescues"] == int(jo.status.n_rescues)
    assert P["status"]["fail_iter"] == int(jo.status.fail_iter)


@pytest.mark.parametrize("kind,loss,init_name", [
    ("cloud", "l2", "anchors"), ("cost", "l2", "anchors"),
    ("cloud", "l2", "random"), ("cost", "kl", "anchors")])
def test_fixed_budget_solve_matches_reference(kind, loss, init_name):
    jo, P = _run_both(kind, loss, init=init_name, **FIXED)
    assert int(jo.status.code) == repro.health.MAXITER
    _assert_fixed_parity(jo, P)


def test_fixed_budget_entropic_solve_matches_reference():
    jo, P = _run_both("cloud", epsilon=0.05, rank=6, **FIXED)
    _assert_fixed_parity(jo, P)


def test_zero_mass_anchor_diverges_like_reference():
    """Five far-away points of the second cloud carry subnormal weights:
    FPS picks one of them as an anchor, its cluster has mass 0 under the
    flush, and the lift divides 0 by 0. The NaN init fails every step:
    DIVERGED at step 0 after two rescues, on both sides."""
    n = 150
    wy = np.full(n, 1.0 / (n - 5), np.float32)
    wy[-5:] = 1e-40
    X, Y, w = _clouds(n)
    Y[-5:] += 50.0
    jp = repro.QuadraticProblem(repro.Geometry.from_points(X, w),
                                repro.Geometry.from_points(Y, wy))
    pp = interop.to_problem(None, w, None, wy, points_x=X, points_y=Y)
    js = repro.LowRankGWSolver(**FIXED)
    key = jax.random.PRNGKey(0)
    jo = repro.solve(jp, js, key=key)
    po = interop.output_to_numpy(repro_torch.solve(
        pp, interop.to_solver({f.name: getattr(js, f.name)
                               for f in dataclasses.fields(js)},
                              "lowrank_gw"),
        draws=interop.to_lowrank_draws(**_ref_draws(key, jp, js)),
        device="cpu"))
    assert int(jo.status.code) == repro.health.DIVERGED
    assert po["status"]["code"] == int(jo.status.code)
    assert po["status"]["fail_iter"] == int(jo.status.fail_iter)
    assert po["status"]["n_rescues"] == int(jo.status.n_rescues)
    assert po["n_iters"] == int(jo.n_iters)
    np.testing.assert_array_equal(np.isnan(po["r"]),
                                  np.isnan(np.asarray(jo.coupling.r)))


# -- layer 3: the default config ---------------------------------------------

@pytest.mark.parametrize("kind", ["cloud", "cost"])
def test_default_solve_matches_reference(kind):
    jo, P = _run_both(kind)
    np.testing.assert_allclose(P["value"], float(jo.value), rtol=DEFAULT_RTOL)
    assert P["status"]["code"] == int(jo.status.code)
    assert P["n_iters"] == int(jo.n_iters)


# -- the front door and the container -----------------------------------------

def test_auto_routes_point_clouds_and_draws_itself():
    """An l2 point cloud above 2048 points routes to lowrank_gw; with no
    draws the solver draws from the generator, reproducibly."""
    n = 2100
    X, Y, w = _clouds(n)
    p = interop.to_problem(None, w, None, w, points_x=X, points_y=Y)
    assert isinstance(repro_torch.select_solver(p), LowRankGWSolver)
    solver = LowRankGWSolver(outer_iters=5)

    def run():
        return repro_torch.solve(p, solver, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    o1, o2 = run(), run()
    assert torch.equal(o1.coupling.q, o2.coupling.q)
    assert o1.status.is_healthy and np.isfinite(float(o1.value))
    with pytest.raises(ValueError, match="generator"):
        repro_torch.solve(p, solver, device="cpu")


def test_lowrank_coupling_contract_matches_reference():
    Q, R, g = _state()
    jc = repro.LowRankCoupling(jnp.asarray(Q), jnp.asarray(R), jnp.asarray(g))
    pc = repro_torch.LowRankCoupling(_t(Q), _t(R), _t(g))
    assert pc.rank == jc.rank == 5
    T = pc.todense(40, 35)
    _close(T, jc.todense())
    for got, want in zip(pc.marginals(40, 35), jc.marginals(40, 35)):
        _close(got, want)
    _close(T.sum(1), pc.marginals()[0], rtol=1e-5)
    rng = np.random.default_rng(9)
    for axis, size in ((0, 35), (1, 40)):
        for shape in ((size,), (size, 3)):
            x = rng.standard_normal(shape).astype(np.float32)
            _close(pc.apply(_t(x), axis=axis), jc.apply(jnp.asarray(x),
                                                        axis=axis))
            dense = T if axis == 0 else T.T
            _close(pc.apply(_t(x), axis=axis), dense @ _t(x), rtol=1e-5)


def test_lowrank_rejects_what_the_reference_rejects():
    Cx, w = _sq_dist(_clouds(20)[0]), np.full(20, 0.05, np.float32)
    p = interop.to_problem(Cx, w, Cx, w, lam=1.0)
    with pytest.raises(NotImplementedError, match="balanced non-fused"):
        repro_torch.solve(p, LowRankGWSolver(), device="cpu",
                          generator=torch.Generator())
    p = interop.to_problem(Cx, w, Cx, w, "l1")
    with pytest.raises(NotImplementedError, match="decomposable"):
        repro_torch.solve(p, LowRankGWSolver(), device="cpu",
                          generator=torch.Generator())
