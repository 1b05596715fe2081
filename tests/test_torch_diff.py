"""Differentiation of the port's solves (``repro_torch.diff``) against
``repro.diff``, CPU.

The same seeded numpy inputs go through the reference (``jax.grad`` of
``repro.diff.gw_loss`` / ``fgw_loss`` / ``quadratic_loss``, in float32)
and through the port (``torch.autograd.grad`` of its counterparts, the
reference's sampled support or low-rank draws injected). Both sides
differentiate the post-loop value at the fixed point their loop returns
(the Danskin envelope), so the gradients differ only by the rounding of
the forward solve.

Tolerances, and why: gradients are held to rtol 1e-4 of the reference
gradient's largest entry (seen up to 8.2e-6 on dense l2, 2.4e-6 on spar,
1.0e-6 on low rank); values to rtol 1e-5, as in
tests/test_torch_solve.py. The barycenter's objectives after 5 AdamW
steps get rtol 1e-4 (each step feeds the previous step's gradient back
into the support). K1's ``autograd.Function`` on the CPU runs the same
products as autograd through its plain version, so it is held to equal
bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.diff as jdiff
import repro_torch
from repro_torch import diff
from repro_torch.api import interop
from repro_torch.diff import envelope_loop, locally_constant
from repro_torch.kernels.spar_cost import ops, spar_cost
from repro_torch.optim import adamw
from test_torch_lowrank import _ref_draws as lowrank_draws
from test_torch_solve import _one_torch_thread  # noqa: F401 (autouse)

GRAD_RTOL = 1e-4
VALUE_RTOL = 1e-5
BARY_RTOL = 1e-4
KEY = jax.random.PRNGKey(0)
M_, N_ = 20, 16


def _clouds(m=M_, n=N_, seed=0, d=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float32,
                        requires_grad=grad)


def _close_grad(got, want):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_RTOL * np.abs(want).max())


def _grads(value, inputs):
    return torch.autograd.grad(value, inputs)


# -- the envelope: dense ---------------------------------------------------------

DENSE = dict(outer_iters=30, inner_iters=100)


@pytest.mark.parametrize("loss", ["l2", "l1"])
def test_dense_gradient_matches_reference(loss):
    x, y = _clouds()
    vj, gj = jax.value_and_grad(lambda x_: jdiff.gw_loss(
        x_, jnp.asarray(y), loss=loss,
        solver=repro.DenseGWSolver(**DENSE)))(jnp.asarray(x))
    xt = _t(x, True)
    vt = diff.gw_loss(xt, _t(y), loss=loss,
                      solver=repro_torch.DenseGWSolver(**DENSE), device="cpu")
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=VALUE_RTOL)
    _close_grad(*_grads(vt, xt), gj)


def test_dense_fused_gradient_matches_reference():
    """fgw_loss with features: gradients w.r.t. the structure, both
    feature sets and α; then with an explicit M."""
    x, y = _clouds()
    rng = np.random.default_rng(1)
    fx = rng.standard_normal((M_, 3)).astype(np.float32)
    fy = rng.standard_normal((N_, 3)).astype(np.float32)
    solver = dict(**DENSE)

    def jloss(x_, fx_, fy_, alpha):
        return jdiff.fgw_loss(x_, jnp.asarray(y), fx_, fy_,
                              fused_penalty=alpha,
                              solver=repro.DenseGWSolver(**solver))
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jnp.asarray(fx), jnp.asarray(fy), jnp.float32(0.6))
    ins = [_t(x, True), _t(fx, True), _t(fy, True), _t(0.6, True)]
    vt = diff.fgw_loss(ins[0], _t(y), ins[1], ins[2], fused_penalty=ins[3],
                       solver=repro_torch.DenseGWSolver(**solver),
                       device="cpu")
    for got, want in zip(_grads(vt, ins), jg):
        _close_grad(got, want)

    M = rng.random((M_, N_)).astype(np.float32)
    jgM = jax.grad(lambda M_: jdiff.fgw_loss(
        jnp.asarray(x), jnp.asarray(y), M=M_, fused_penalty=0.3,
        solver=repro.DenseGWSolver(**solver)))(jnp.asarray(M))
    Mt = _t(M, True)
    vt = diff.fgw_loss(_t(x), _t(y), M=Mt, fused_penalty=0.3,
                       solver=repro_torch.DenseGWSolver(**solver),
                       device="cpu")
    _close_grad(*_grads(vt, [Mt]), jgM)


def test_dense_unbalanced_gradient_matches_reference():
    """λ and both marginals are live paths through the KL penalties."""
    x, y = _clouds()
    a = np.full(M_, 1.0 / M_, np.float32)
    b = np.full(N_, 1.5 / N_, np.float32)

    def jval(a_, b_, lam):
        p = repro.QuadraticProblem(
            repro.Geometry.from_points(jnp.asarray(x), a_, validate=False),
            repro.Geometry.from_points(jnp.asarray(y), b_, validate=False),
            lam=lam, validate=False)
        return jdiff.quadratic_loss(p, repro.DenseGWSolver(**DENSE))
    jg = jax.grad(jval, argnums=(0, 1, 2))(jnp.asarray(a), jnp.asarray(b),
                                          jnp.float32(1.0))
    ins = [_t(a, True), _t(b, True), _t(1.0, True)]
    p = repro_torch.QuadraticProblem(
        repro_torch.Geometry.from_points(_t(x), ins[0], validate=False),
        repro_torch.Geometry.from_points(_t(y), ins[1], validate=False),
        lam=ins[2], validate=False)
    vt = diff.quadratic_loss(p, repro_torch.DenseGWSolver(**DENSE),
                             device="cpu")
    for got, want in zip(_grads(vt, ins), jg):
        _close_grad(got, want)


def test_subnormal_couplings_keep_the_gradient_finite_and_equal():
    """The flush rule (ROADMAP §1): the Moon marginals floored at 1e-9 and
    a small ε drive coupling entries below the smallest normal float;
    the port must flush them as XLA does, so its gradient, and the
    balanced marginal gradients through the dual correction (whose row
    sums then hit the 1e-30 floor), stay finite and equal to the
    reference's."""
    from test_torch_solve import _moon

    Cx, a, Cy, b = _moon(40)
    solver = dict(epsilon=3e-3, outer_iters=20, inner_iters=100)
    T = repro_torch.solve(interop.to_problem(Cx, a, Cy, b),
                          repro_torch.DenseGWSolver(**solver),
                          device="cpu").coupling
    tiny = T[(T > 0)].min()
    assert float(tiny) < 1e-30 or bool((T == 0).any())

    def jval(Cx_, a_, b_):
        p = repro.QuadraticProblem(repro.Geometry(Cx_, a_, validate=False),
                                   repro.Geometry(jnp.asarray(Cy), b_,
                                                  validate=False),
                                   validate=False)
        return jdiff.quadratic_loss(p, repro.DenseGWSolver(**solver),
                                    marginal_grads=True)
    jg = jax.grad(jval, argnums=(0, 1, 2))(jnp.asarray(Cx), jnp.asarray(a),
                                          jnp.asarray(b))
    ins = [_t(Cx, True), _t(a, True), _t(b, True)]
    p = repro_torch.QuadraticProblem(
        repro_torch.Geometry(ins[0], ins[1], validate=False),
        repro_torch.Geometry(_t(Cy), ins[2], validate=False), validate=False)
    vt = diff.quadratic_loss(p, repro_torch.DenseGWSolver(**solver),
                             marginal_grads=True, device="cpu")
    for got, want in zip(_grads(vt, ins), jg):
        _close_grad(got, want)


# -- balanced marginal gradients -------------------------------------------------

def test_marginal_grads_match_reference():
    x, y = _clouds()
    a = np.full(M_, 1.0 / M_, np.float32)
    b = np.full(N_, 1.0 / N_, np.float32)
    jg = jax.grad(lambda a_, b_: jdiff.gw_loss(
        jnp.asarray(x), jnp.asarray(y), a_, b_,
        solver=repro.DenseGWSolver(**DENSE), marginal_grads=True),
        argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ins = [_t(a, True), _t(b, True)]
    vt = diff.gw_loss(_t(x), _t(y), ins[0], ins[1],
                      solver=repro_torch.DenseGWSolver(**DENSE),
                      marginal_grads=True, device="cpu")
    v0 = diff.gw_loss(_t(x), _t(y), solver=repro_torch.DenseGWSolver(**DENSE),
                      device="cpu")
    assert float(vt.detach()) == float(v0)        # the correction is zero
    for got, want in zip(_grads(vt, ins), jg):
        _close_grad(got, want)


def test_marginal_grads_errors_match_reference():
    x, y = _clouds()
    b = np.full(N_, 1.5 / N_, np.float32)
    cases = [(dict(b=b), dict(lam=1.0), "balanced problems"),
             ({}, dict(solver="spar"), "dense prox"),
             ({}, dict(reg="ent"), "dense prox")]
    for data, kind, match in cases:
        for lib, pkg, xs in ((jdiff, repro, (jnp.asarray(x), jnp.asarray(y))),
                             (diff, repro_torch, (_t(x), _t(y)))):
            kw = {"device": "cpu"} if lib is diff else {}
            if "b" in data:
                bb = data["b"] if lib is diff else jnp.asarray(data["b"])
                geom = pkg.Geometry.from_points
                a_ = np.full(M_, 1.0 / M_, np.float32)
                p = pkg.QuadraticProblem(
                    geom(xs[0], a_ if lib is diff else jnp.asarray(a_),
                         validate=False),
                    geom(xs[1], bb, validate=False), lam=kind["lam"],
                    validate=False)
                call = (lambda p=p, lib=lib, kw=kw: lib.quadratic_loss(
                    p, "dense_gw", marginal_grads=True, **kw))
            elif kind.get("solver") == "spar":
                draw = ({"generator": torch.Generator().manual_seed(0)}
                        if lib is diff else {"key": KEY})
                call = (lambda xs=xs, lib=lib, pkg=pkg, kw=kw, draw=draw:
                        lib.gw_loss(*xs, solver=pkg.SparGWSolver(s=64),
                                    marginal_grads=True, **draw, **kw))
            else:
                call = (lambda xs=xs, lib=lib, pkg=pkg, kw=kw: lib.gw_loss(
                    *xs, solver=pkg.DenseGWSolver(reg="ent"),
                    marginal_grads=True, **kw))
            with pytest.raises(ValueError, match=match):
                call()


# -- the envelope: spar, low rank ------------------------------------------------

def _spar_problems(x, y, fx=None, fy=None, alpha=None):
    ja = jnp.full((len(x),), 1.0 / len(x))
    jb = jnp.full((len(y),), 1.0 / len(y))
    jp = repro.QuadraticProblem(
        repro.Geometry.from_points(jnp.asarray(x), ja, features=fx,
                                   validate=False),
        repro.Geometry.from_points(jnp.asarray(y), jb, features=fy,
                                   validate=False),
        fused_penalty=alpha, validate=False)
    return jp


@pytest.mark.parametrize("fused", [False, True])
def test_spar_gradient_matches_reference(fused):
    """The reference's support injected; "auto" (the matvec kernel's
    Function, its plain version here) and "jnp" give the same gradient."""
    x, y = _clouds()
    rng = np.random.default_rng(2)
    fx = rng.standard_normal((M_, 3)).astype(np.float32) if fused else None
    fy = rng.standard_normal((N_, 3)).astype(np.float32) if fused else None
    js = repro.SparGWSolver(s=16 * M_)
    jo = repro.solve(_spar_problems(x, y, fx, fy, 0.5 if fused else None),
                     js, key=KEY)
    support = interop.to_support(jo.coupling.rows, jo.coupling.cols)

    def jval(x_, *feats):
        p = _spar_problems(x_, y, *(feats or (None, None)),
                           0.5 if fused else None)
        p = repro.QuadraticProblem(
            repro.Geometry.from_points(x_, p.geom_x.weights,
                                       features=p.geom_x.features,
                                       validate=False),
            p.geom_y, fused_penalty=p.fused_penalty, validate=False)
        return jdiff.quadratic_loss(p, js, KEY)
    jins = [jnp.asarray(x)] + ([jnp.asarray(fx), jnp.asarray(fy)]
                               if fused else [])
    jg = jax.grad(jval, argnums=tuple(range(len(jins))))(*jins)
    for impl in ("auto", "jnp"):
        ins = [_t(v, True) for v in ([x] + ([fx, fy] if fused else []))]
        solver = repro_torch.SparGWSolver(s=16 * M_, cost_impl=impl)
        if fused:
            vt = diff.fgw_loss(ins[0], _t(y), ins[1], ins[2],
                               fused_penalty=0.5, solver=solver,
                               support=support, device="cpu")
        else:
            vt = diff.gw_loss(ins[0], _t(y), solver=solver, support=support,
                              device="cpu")
        for got, want in zip(_grads(vt, ins), jg):
            _close_grad(got, want)


def test_lowrank_gradient_matches_reference():
    x, y = _clouds(24, 24, seed=3)
    a = np.full(24, 1.0 / 24, np.float32)
    js = repro.LowRankGWSolver(rank=3, outer_iters=40, inner_iters=60)

    def jprob(x_):
        return repro.QuadraticProblem(
            repro.Geometry.from_points(x_, jnp.asarray(a), validate=False),
            repro.Geometry.from_points(jnp.asarray(y), jnp.asarray(a),
                                       validate=False), validate=False)
    jg = jax.grad(lambda x_: jdiff.quadratic_loss(jprob(x_), js, KEY))(
        jnp.asarray(x))
    draws = interop.to_lowrank_draws(**lowrank_draws(KEY, jprob(
        jnp.asarray(x)), js))
    xt = _t(x, True)
    vt = diff.gw_loss(xt, _t(y), solver=interop.to_solver(
        {f: getattr(js, f) for f in js.__dataclass_fields__}, "lowrank_gw"),
        draws=draws, device="cpu")
    _close_grad(*_grads(vt, [xt]), jg)


def test_grid_gradient_matches_reference():
    """grid_gw through the plain cost assembly (l1: the 4-D contraction)
    on the reference's row and column sets."""
    x, y = _clouds()
    js = repro.GridGWSolver(s_r=12, s_c=10)
    jp = _spar_problems(x, y)
    jo = repro.solve(repro.QuadraticProblem(jp.geom_x, jp.geom_y, loss="l1",
                                            validate=False), js, key=KEY)
    support = interop.to_support(jo.coupling.rows, jo.coupling.cols)
    jg = jax.grad(lambda x_: jdiff.gw_loss(
        x_, jnp.asarray(y), loss="l1", solver=js, key=KEY))(jnp.asarray(x))
    xt = _t(x, True)
    vt = diff.gw_loss(xt, _t(y), loss="l1",
                      solver=repro_torch.GridGWSolver(s_r=12, s_c=10),
                      support=support, device="cpu")
    _close_grad(*_grads(vt, [xt]), jg)


# -- the loop builds no graph ------------------------------------------------------

def _graph_size(t):
    seen, stack = set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    return len(seen)


@pytest.mark.parametrize("name", ["dense_gw", "spar_gw", "lowrank_gw"])
def test_the_loop_builds_no_graph(name):
    """With grad enabled, a solve's loop leaves nothing in autograd: the
    coupling, errors and trace are plain tensors, and the value's graph is
    the same size for 3 outer steps as for 12."""
    x, y = _clouds()
    sizes = []
    for outer in (3, 12):
        xt = _t(x, True)
        solver = {"dense_gw": repro_torch.DenseGWSolver(outer_iters=outer,
                                                        trace=True),
                  "spar_gw": repro_torch.SparGWSolver(s=8 * M_,
                                                      outer_iters=outer,
                                                      trace=True),
                  "lowrank_gw": repro_torch.LowRankGWSolver(
                      outer_iters=outer, tol=0.0, trace=True)}[name]
        p = repro_torch.QuadraticProblem(
            repro_torch.Geometry.from_points(xt, torch.full((M_,), 1 / M_),
                                             validate=False),
            repro_torch.Geometry.from_points(_t(y), torch.full((N_,), 1 / N_),
                                             validate=False), validate=False)
        out = repro_torch.solve(p, solver, device="cpu",
                                generator=torch.Generator().manual_seed(0))
        leaves = [out.errors, *out.trace]
        leaves += list(out.coupling) if isinstance(out.coupling, tuple) \
            else [out.coupling]
        assert not any(t.requires_grad for t in leaves
                       if isinstance(t, torch.Tensor))
        assert out.value.requires_grad
        sizes.append(_graph_size(out.value))
    assert sizes[0] == sizes[1]


def test_locally_constant_and_envelope_loop_detach():
    w = torch.tensor([2.0, 3.0], requires_grad=True)
    out = locally_constant(lambda v: (v * 2, [v + 1]), w)
    assert not out[0].requires_grad and not out[1][0].requires_grad
    res = envelope_loop(lambda T: 0.5 * T + w, lambda T: (T - 2 * w).abs()
                        .sum(), torch.zeros(2), 5, 0.0, trace=True,
                        obj_fn=lambda T: (T * w).sum())
    assert not res.iterate.requires_grad
    assert not res.trace.objective.requires_grad
    assert torch.isfinite(res.trace.objective[:5]).all()


# -- K1's Function; K2 and K3 refuse ----------------------------------------------

def test_k1_function_matches_autograd_through_the_plain_version():
    g = torch.Generator().manual_seed(0)
    s = 37
    L0 = torch.rand(s, s, generator=g)
    t0 = torch.rand(s, generator=g) - 0.5
    o0 = torch.rand(s, generator=g)
    w = torch.rand(s, generator=g)
    for need in ((True, True, True), (True, False, False),
                 (False, True, False), (False, False, True)):
        ins = [x.clone().requires_grad_(r) for x, r in zip((L0, t0, o0), need)]
        ref = [x.clone().requires_grad_(r) for x, r in zip((L0, t0, o0), need)]
        got = spar_cost.spar_matvec_cuda(*ins)
        want = spar_cost.spar_matvec_plain(*ref)
        assert got.grad_fn is not None and torch.equal(got, want)
        gi = torch.autograd.grad((got * w).sum(), [x for x in ins
                                                   if x.requires_grad])
        gr = torch.autograd.grad((want * w).sum(), [x for x in ref
                                                    if x.requires_grad])
        for a_, b_ in zip(gi, gr):
            assert torch.equal(a_, b_)
    # the one-shot wrapper and the materialized closure go through it too
    Lg = L0.clone().requires_grad_(True)
    assert ops.spar_matvec(Lg, t0).grad_fn is not None
    Cx = torch.rand(9, 9, generator=g).requires_grad_(True)
    Cy = torch.rand(7, 7, generator=g)
    rows = torch.randint(0, 9, (s,), generator=g)
    cols = torch.randint(0, 7, (s,), generator=g)
    fn = ops.make_spar_cost_fn(Cx, Cy, rows, cols, "l2", impl="materialized")
    fj = ops.make_spar_cost_fn(Cx, Cy, rows, cols, "l2", impl="jnp")
    gm, = torch.autograd.grad((fn(t0) * w).sum(), Cx)
    gj, = torch.autograd.grad((fj(t0) * w).sum(), Cx)
    torch.testing.assert_close(gm, gj, rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        assert spar_cost.spar_matvec_cuda(Lg, t0, o0).grad_fn is None


def test_k2_and_k3_refuse_a_gradient():
    """As jax.grad through the reference's Pallas kernels raises (in
    interpret mode too), the gather-fused kernel and gw_cost raise on a
    gradient, on the CPU as on the card; with no grad they run."""
    from repro_torch.core.grid_gw import grid_cost

    x, y = _clouds()
    xt = _t(x, True)
    with pytest.raises(RuntimeError, match="spar_cost_fused"):
        diff.gw_loss(xt, _t(y), solver=repro_torch.SparGWSolver(
            s=8 * M_, cost_impl="pallas"),
            generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="gw_cost"):
        diff.gw_loss(xt, _t(y), loss="l1", solver=repro_torch.GridGWSolver(
            s_r=8, s_c=8, use_kernel=True),
            generator=torch.Generator().manual_seed(0), device="cpu")
    A, B, T = torch.rand(5, 6), torch.rand(4, 7), torch.rand(6, 7)
    with pytest.raises(RuntimeError, match="gw_cost"):
        grid_cost(A.requires_grad_(True), B, T, "l1", use_kernel=True)
    with torch.no_grad():
        assert grid_cost(A, B, T, "l1", use_kernel=True).shape == (5, 4)
    # l2 decomposes into matmuls and never reaches the kernel
    assert grid_cost(A, B, T, "l2", use_kernel=True).grad_fn is not None
    with torch.no_grad():
        out = repro_torch.solve(
            interop.to_problem(None, np.full(M_, 1 / M_, np.float32), None,
                               np.full(N_, 1 / N_, np.float32),
                               points_x=x, points_y=y),
            repro_torch.SparGWSolver(s=8 * M_, cost_impl="pallas"),
            generator=torch.Generator().manual_seed(0), device="cpu")
    assert np.isfinite(float(out.value))


# -- AdamW, the barycenter -----------------------------------------------------------

def test_adamw_matches_reference():
    from repro.optim import adamw as jadamw

    rng = np.random.default_rng(5)
    p = {"w": rng.standard_normal((5, 3)).astype(np.float32),
         "b": [rng.standard_normal(4).astype(np.float32)]}
    jp = jax.tree.map(jnp.asarray, p)
    tp = {"w": _t(p["w"]), "b": [_t(p["b"][0])]}
    js, ts = jadamw.init(jp), adamw.init(tp)
    for step in range(5):
        g = {"w": rng.standard_normal((5, 3)).astype(np.float32),
             "b": [rng.standard_normal(4).astype(np.float32)]}
        g = jax.tree.map(lambda v: v * (4.0 if step == 2 else 0.3), g)
        kw = dict(b1=0.9, b2=0.99, weight_decay=0.01, max_grad_norm=2.0)
        jp, js, jn = jadamw.update(jax.tree.map(jnp.asarray, g), js, jp, 0.05,
                                   **kw)
        tp, ts, tn = adamw.update({"w": _t(g["w"]), "b": [_t(g["b"][0])]},
                                  ts, tp, 0.05, **kw)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tp["b"][0].numpy(), np.asarray(jp["b"][0]),
                                   rtol=1e-6, atol=1e-7)
    assert int(ts.step) == 5
    sched = adamw.cosine_schedule(1.0, 2, 10)
    jsched = jadamw.cosine_schedule(1.0, 2, 10)
    for k in (0, 1, 2, 6, 10, 12):
        np.testing.assert_allclose(float(sched(torch.tensor(k))),
                                   float(jsched(jnp.asarray(k))), rtol=1e-6)


def test_barycenter_matches_reference_from_a_shared_start():
    """5 AdamW steps of a dense barycenter of two clouds from the same x0:
    the same objectives and gradient norms as the reference's."""
    rng = np.random.default_rng(6)
    ys = [rng.standard_normal((14, 2)).astype(np.float32),
          (1.5 * rng.standard_normal((12, 2))).astype(np.float32)]
    x0 = rng.standard_normal((10, 2)).astype(np.float32)
    kw = dict(steps=5, lr=0.05)
    jr = jdiff.gw_barycenter([jnp.asarray(v) for v in ys], 10, KEY,
                             solver=repro.DenseGWSolver(**DENSE),
                             x0=jnp.asarray(x0), **kw)
    pr = diff.gw_barycenter([_t(v) for v in ys], 10,
                            solver=repro_torch.DenseGWSolver(**DENSE),
                            x0=x0, device="cpu", **kw)
    np.testing.assert_allclose(pr.objectives.numpy(),
                               np.asarray(jr.objectives), rtol=BARY_RTOL)
    np.testing.assert_allclose(pr.grad_norms.numpy(),
                               np.asarray(jr.grad_norms), rtol=BARY_RTOL)
    np.testing.assert_allclose(pr.points.numpy(), np.asarray(jr.points),
                               rtol=BARY_RTOL, atol=BARY_RTOL)
    assert isinstance(pr, diff.BarycenterResult)


def test_barycenter_with_sampled_supports_descends():
    """spar_gw inputs: each input's draws come from a generator derived
    from the caller's and k, made anew every step, so its support stays
    fixed and the run repeats to the bit."""
    rng = np.random.default_rng(7)
    ys = [rng.standard_normal((30, 2)).astype(np.float32) for _ in range(2)]

    def run():
        return diff.gw_barycenter(
            ys, 24, torch.Generator().manual_seed(3), steps=4, lr=0.05,
            solver=repro_torch.SparGWSolver(s=8 * 30), device="cpu")
    r1, r2 = run(), run()
    assert torch.equal(r1.objectives, r2.objectives)
    assert torch.equal(r1.points, r2.points)
    assert torch.isfinite(r1.objectives).all()
    assert r1.points.shape == (24, 2)


def test_quadratic_loss_selects_like_solve():
    x, y = _clouds()
    p = repro_torch.QuadraticProblem(
        repro_torch.Geometry.from_points(_t(x), torch.full((M_,), 1 / M_)),
        repro_torch.Geometry.from_points(_t(y), torch.full((N_,), 1 / N_)))
    by_none = diff.quadratic_loss(p, device="cpu")
    by_name = diff.quadratic_loss(p, "dense_gw", device="cpu")
    assert float(by_none) == float(by_name)
    assert float(by_name) == float(repro_torch.solve(p, device="cpu").value)
