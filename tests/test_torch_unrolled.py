"""The unrolled reference (``repro_torch.diff.unrolled``) and the
unrolled grid core (``core.grid_gw.grid_spar_gw_differentiable``) against
``repro``, CPU. tests/test_torch_envelope.py holds the port's envelope
gradient against this unrolled one.

The reference's float32 unrolled gradient is NaN wherever a prox step's
coupling underflows (``log(max(T, 1e-38))``: XLA flushes the floor to 0,
and 0·inf poisons the backward pass; its own tests run in x64 for that
reason). The port flushes through ``torch.where``, whose backward drops
the dead branch, so its float32 gradient stays finite. Prox cases are
therefore held to the reference in x64 (``jax.enable_x64``) on the same
support; entropic ones (no log T) to the reference in float32.

Tolerances: values rtol 1e-5 (tests/test_torch_solve.py); gradients
rtol 1e-4 of the reference gradient's largest entry (seen: dense 3.1e-6
against x64, entropic dense and spar 1.4e-6 and 1.0e-6 against float32,
low rank 2.1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import sampling as jsampling
from repro.diff.unrolled import unrolled_value as junrolled
from repro_torch.api import interop
from repro_torch.diff import unrolled_value
from test_torch_lowrank import _ref_draws as lowrank_draws
from test_torch_solve import _one_torch_thread  # noqa: F401 (autouse)

GRAD_RTOL = 1e-4
VALUE_RTOL = 1e-5
KEY = jax.random.PRNGKey(5)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float32,
                        requires_grad=grad)


def _close_grad(got, want):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_RTOL * np.abs(want).max())


def _near_isometric(n, m, pert, seed, scale=10.0):
    """tests/test_diff.py's pair with numpy draws: y a rotation of x plus
    noise, truncated to m points; squared distances over ``scale``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2))
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    y = (x @ R.T + pert * rng.standard_normal((n, 2)))[:m]

    def sq(z):
        s = (z * z).sum(1)
        return np.maximum(s[:, None] + s[None] - 2 * z @ z.T, 0) / scale
    return sq(x).astype(np.float32), sq(y).astype(np.float32)


def _problems(Cx, Cy, dtype=jnp.float32):
    a = np.full(len(Cx), 1.0 / len(Cx))
    b = np.full(len(Cy), 1.0 / len(Cy))

    def jp(C):
        return repro.QuadraticProblem(
            repro.Geometry(C, jnp.asarray(a, dtype), validate=False),
            repro.Geometry(jnp.asarray(Cy, dtype), jnp.asarray(b, dtype),
                           validate=False), validate=False)

    def pp(C):
        return repro_torch.QuadraticProblem(
            repro_torch.Geometry(C, _t(a), validate=False),
            repro_torch.Geometry(_t(Cy), _t(b), validate=False),
            validate=False)
    return jp, pp


def _grads(value, inputs):
    return torch.autograd.grad(value, inputs)


def _port_grad(pp, Cx, solver, **kw):
    C = _t(Cx, True)
    value = unrolled_value(pp(C), solver, device="cpu", **kw)
    grad, = torch.autograd.grad(value, C)
    return value.detach(), grad


@pytest.fixture()
def injected_support(monkeypatch):
    """Make the reference's sampler return a given support (its x64 run
    would draw another one: the importance weights move in the low
    bits)."""
    def inject(rows, cols):
        monkeypatch.setattr(jsampling, "sample_pairs",
                            lambda key, probs, s: (jnp.asarray(rows),
                                                   jnp.asarray(cols)))
    return inject


@pytest.mark.parametrize("family", ["dense_gw", "spar_gw"])
@pytest.mark.parametrize("reg", ["prox", "ent"])
def test_unrolled_matches_reference(family, reg, injected_support):
    Cx, Cy = _near_isometric(14, 11, 0.25, 1)
    fields = dict(epsilon=5e-2, outer_iters=10, inner_iters=30, reg=reg)
    if family == "spar_gw":
        fields["s"] = 16 * 14
    J = repro.SparGWSolver if family == "spar_gw" else repro.DenseGWSolver
    js = J(**fields)
    key = KEY if family == "spar_gw" else None
    jp, pp = _problems(Cx, Cy)
    kw = {}
    if family == "spar_gw":
        jo = repro.solve(jp(jnp.asarray(Cx)), js, key=KEY)
        rows, cols = np.asarray(jo.coupling.rows), np.asarray(jo.coupling.cols)
        kw["support"] = interop.to_support(rows, cols)
    v32, g32 = jax.value_and_grad(lambda C: junrolled(jp(C), js, key))(
        jnp.asarray(Cx))
    value, grad = _port_grad(pp, Cx, interop.to_solver(
        fields, "spar_gw" if family == "spar_gw" else "dense_gw"), **kw)
    np.testing.assert_allclose(float(value), float(v32), rtol=VALUE_RTOL)
    if reg == "ent":
        _close_grad(grad, g32)
        return
    assert not np.isfinite(np.asarray(g32)).all()     # the reference's f32
    if family == "spar_gw":
        injected_support(rows, cols)
    with jax.enable_x64(True):
        jp64, _ = _problems(Cx, Cy, jnp.float64)
        g64 = jax.grad(lambda C: junrolled(jp64(C), js, key))(
            jnp.asarray(Cx, jnp.float64))
    _close_grad(grad, g64)


def test_unrolled_lowrank_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((11, 2)).astype(np.float32)
    y = rng.standard_normal((11, 2)).astype(np.float32)
    a = np.full(11, 1.0 / 11, np.float32)
    js = repro.LowRankGWSolver(rank=3, outer_iters=12, inner_iters=30,
                               tol=0.0, inner_tol=0.0)

    def jp(x_):
        return repro.QuadraticProblem(
            repro.Geometry.from_points(x_, jnp.asarray(a), validate=False),
            repro.Geometry.from_points(jnp.asarray(y), jnp.asarray(a),
                                       validate=False), validate=False)
    vj, gj = jax.value_and_grad(lambda x_: junrolled(jp(x_), js, KEY))(
        jnp.asarray(x))
    draws = interop.to_lowrank_draws(**lowrank_draws(KEY, jp(jnp.asarray(x)),
                                                     js))
    xt = _t(x, True)
    p = repro_torch.QuadraticProblem(
        repro_torch.Geometry.from_points(xt, _t(a), validate=False),
        repro_torch.Geometry.from_points(_t(y), _t(a), validate=False),
        validate=False)
    solver = interop.to_solver({f: getattr(js, f)
                                for f in js.__dataclass_fields__},
                               "lowrank_gw")
    value = unrolled_value(p, solver, draws=draws, device="cpu")
    np.testing.assert_allclose(float(value.detach()), float(vj),
                               rtol=VALUE_RTOL)
    _close_grad(*torch.autograd.grad(value, xt), gj)


def test_unrolled_refuses_what_it_cannot_replay():
    Cx, Cy = _near_isometric(8, 8, 0.2, 0)
    _, pp = _problems(Cx, Cy)
    with pytest.raises(ValueError, match="inner_tol"):
        unrolled_value(pp(_t(Cx)), repro_torch.SparGWSolver(s=64,
                                                            inner_tol=1e-5),
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    with pytest.raises(ValueError, match="generator"):
        unrolled_value(pp(_t(Cx)), repro_torch.SparGWSolver(s=64),
                       device="cpu")
    p = repro_torch.QuadraticProblem(pp(_t(Cx)).geom_x, pp(_t(Cx)).geom_y,
                                     lam=1.0, validate=False)
    with pytest.raises(NotImplementedError, match="balanced"):
        unrolled_value(p, repro_torch.DenseGWSolver(), device="cpu")
    with pytest.raises(NotImplementedError, match="GridGWSolver"):
        unrolled_value(pp(_t(Cx)), repro_torch.GridGWSolver(s_r=4, s_c=4),
                       device="cpu")


def test_grid_spar_gw_differentiable_matches_reference():
    from repro.core.grid_gw import (
        grid_spar_gw_differentiable as jgrid_diff,
    )
    from repro_torch.core.grid_gw import grid_spar_gw_differentiable

    rng = np.random.default_rng(4)
    CxR = rng.random((9, 9)).astype(np.float32)
    CyC = rng.random((7, 7)).astype(np.float32)
    aR = rng.random(9).astype(np.float32) + 0.1
    bC = rng.random(7).astype(np.float32) + 0.1
    aR, bC = aR / aR.sum(), bC / bC.sum()
    w = (1.0 + rng.random((9, 7))).astype(np.float32)
    for loss in ("l2", "l1"):
        def jval(CxR_, CyC_):
            return jgrid_diff(None, None, CxR_, CyC_, jnp.asarray(aR),
                              jnp.asarray(bC), jnp.asarray(w), loss, 0.1, 8,
                              30)[0]
        vj, jg = jax.value_and_grad(jval, argnums=(0, 1))(
            jnp.asarray(CxR), jnp.asarray(CyC))
        ins = [_t(CxR, True), _t(CyC, True)]
        vt, T = grid_spar_gw_differentiable(None, None, *ins, _t(aR), _t(bC),
                                            _t(w), loss, 0.1, 8, 30)
        assert T.shape == (9, 7)
        np.testing.assert_allclose(float(vt.detach()), float(vj),
                                   rtol=VALUE_RTOL)
        for got, want in zip(_grads(vt, ins), jg):
            _close_grad(got, want)
