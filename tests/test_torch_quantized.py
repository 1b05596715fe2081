"""The multiscale (quantized) solver: the port against ``repro``, CPU.

Every stage and the whole ``solve`` take the same numpy inputs on both
sides. JAX's threefry draws cannot be reproduced in torch, so the port
gets the reference's draws: each side's FPS start (or its k random
anchors) and the base solver's support or low-rank draws, through
``repro_torch.api.interop.to_quantized_draws``.

Tolerances, and why:

* anchor indices, assignments, member tables, top pairs and block member
  lists are discrete and must be equal: both sides take first indices
  on ties (argmin/argmax, a stable argsort, a stable descending sort for
  ``lax.top_k``);
* ``compress_problem`` and ``coarse_value_correction``: rtol 1e-5 — a
  few fp32 matmuls over n ≤ 60 terms, summed in another order;
* ``block_refine`` on the reference's coarse coupling: blocks atol 1e-6
  + rtol 1e-4 — 200 log-Sinkhorn iterations per block carry the ulp
  differences of logsumexp and exp, and each block stops on its own;
* whole solves: value rtol 1e-4 — the coarse PGA's 50 outer x up to
  2000 inner iterations and the polish's 5 x 500 add up the same per-step
  differences; status codes exact; pair rows and columns exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import sampling as jsampling
from repro.multiscale import anchors as janchors
from repro.multiscale import compress as jcompress
from repro.multiscale import refine as jrefine
from repro.multiscale import solver as jsolver
from repro_torch.api import interop
from repro_torch.multiscale import anchors, compress, refine
from repro_torch.multiscale.solver import QuantizedGWSolver
from test_torch_solve import _moon
from test_torch_solve import _one_torch_thread  # noqa: F401 (autouse)

COMPRESS_RTOL = 1e-5
BLOCK_ATOL, BLOCK_RTOL = 1e-6, 1e-4
VALUE_RTOL = 1e-4

# a coarse dense solve that keeps both tolerance stops at a tenth of the
# default's budget (the default base runs in the cases marked below)
FAST_BASE = repro.DenseGWSolver(epsilon=1e-2, outer_iters=20,
                                inner_iters=200, tol=1e-6, inner_tol=1e-8)

# the reference's stages jitted, as repro.solve runs them (eager dispatch
# of their loops compiles every op anew: seconds a call)
jselect_anchors = jax.jit(janchors.select_anchors,
                          static_argnames=("k", "method", "refine_iters"))
jblock_refine = jax.jit(jrefine.block_refine, static_argnames=(
    "cap_x", "cap_y", "max_pairs", "iters", "tol"))


def _adjacency(n=60, seed=11):
    """0/1 graph adjacency costs (tests/test_multiscale.py's case): the
    medoid rounds draw duplicate anchors and leave clusters empty."""
    A = (np.random.default_rng(seed).random((n, n)) < 0.1).astype(np.float32)
    A = np.triu(A, 1)
    A = A + A.T
    deg = A.sum(1) + 1e-6
    a = (deg / deg.sum()).astype(np.float32)
    return A, a, A, a


def _problems(data, loss="l2", lam=None, M=None, alpha=None):
    Cx, a, Cy, b = data
    jp = repro.QuadraticProblem(repro.Geometry(jnp.asarray(Cx), jnp.asarray(a)),
                                repro.Geometry(jnp.asarray(Cy), jnp.asarray(b)),
                                loss=loss, lam=lam, fused_penalty=alpha,
                                M=None if M is None else jnp.asarray(M))
    pp = interop.to_problem(Cx, a, Cy, b, loss, lam=lam, M=M,
                            fused_penalty=alpha)
    return jp, pp


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _anchor_draw(key, g, k, method):
    if method == "fps":
        return int(jax.random.categorical(
            key, jnp.log(jnp.maximum(g.weights, 1e-38))))
    return np.asarray(jax.random.choice(key, g.n, (k,), replace=False,
                                        p=g.weights))


def _ref_draws(key, jp, js):
    """The reference's draws for ``repro.solve(jp, js, key=key)``, in the
    order of its key splits (multiscale/solver.py, anchors.py, and the
    base solver's own)."""
    m, n = jp.shape
    kx, ky = js._resolve(m, n)[:2]
    key_ax, key_ay, key_base = jax.random.split(key, 3)
    d = {"anchors_x": _anchor_draw(key_ax, jp.geom_x, kx, js.anchor_method),
         "anchors_y": _anchor_draw(key_ay, jp.geom_y, ky, js.anchor_method)}
    base = js._sized_base(kx, ky)
    if isinstance(base, (repro.SparGWSolver, repro.LowRankGWSolver)):
        jm = jsolver._materialized(jp)
        ax = jselect_anchors(key_ax, jm.geom_x.cost_matrix,
                             jm.geom_x.weights, k=kx,
                             method=js.anchor_method,
                             refine_iters=js.anchor_iters)
        ay = jselect_anchors(key_ay, jm.geom_y.cost_matrix,
                             jm.geom_y.weights, k=ky,
                             method=js.anchor_method,
                             refine_iters=js.anchor_iters)
        cp = jcompress.compress_problem(jm, ax, ay, js.compress_metric)
        if isinstance(base, repro.SparGWSolver):
            probs = jsampling.balanced_probs(cp.geom_x.weights,
                                             cp.geom_y.weights, base.shrink)
            d["base"] = tuple(np.asarray(x) for x in jsampling.sample_pairs(
                key_base, probs, base.s))
        else:
            d["base"] = _lowrank_draws(key_base, cp, base)
    return d


def _lowrank_draws(key, cp, js):
    """A low-rank base's draws on the (cost-matrix) coarse problem: the
    anchor init's two FPS starts and both sketch matrices."""
    rank, cost_rank = js._resolve(*cp.shape)
    k_init, k_fx, k_fy = jax.random.split(key, 3)
    d = {}
    for side, k, g in zip("xy", jax.random.split(k_init),
                          (cp.geom_x, cp.geom_y)):
        d[f"start_{side}"] = int(jax.random.categorical(
            k, jnp.log(jnp.maximum(g.weights, 1e-38))))
    for side, k, g in zip("xy", (k_fx, k_fy), (cp.geom_x, cp.geom_y)):
        d[f"omega_{side}"] = np.asarray(jax.random.normal(
            k, (g.n, cost_rank), jnp.float32))
    return d


def _fields(js):
    """A reference solver's fields as ``interop.to_solver`` takes them: a
    fault as a dict of its fields, a nested base as ``(name, fields)``."""
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    f = fields.get("fault")
    if f is not None:
        fields["fault"] = {"at_iter": int(f.at_iter), "kind": f.kind,
                           "site": f.site, "persistent": f.persistent}
    if "base" in fields:
        fields["base"] = (type(fields["base"]).name, _fields(fields["base"]))
    return fields


def _port_solver(js):
    """The port's config of a reference solver, nested base and fault
    included."""
    return interop.to_solver(_fields(js), type(js).name)


def _solve_both(jp, pp, js, seed=7):
    key = jax.random.PRNGKey(seed)
    jo = repro.solve(jp, js, key=key)
    po = repro_torch.solve(
        pp, _port_solver(js), device="cpu",
        draws=interop.to_quantized_draws(**_ref_draws(key, jp, js)))
    return jo, po


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, equal_nan=True)


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _assert_solve_parity(jo, po):
    assert isinstance(po.coupling, repro_torch.QuantizedCoupling)
    assert po.status.code == int(jo.status.code), (po.status, jo.status)
    assert po.n_iters == int(jo.n_iters)
    _equal(po.coupling.pair_rows, jo.coupling.pair_rows)
    _equal(po.coupling.pair_cols, jo.coupling.pair_cols)
    _equal(po.coupling.members_x, jo.coupling.members_x)
    _equal(po.coupling.members_y, jo.coupling.members_y)
    _close(float(po.value), float(jo.value), VALUE_RTOL)


# -- stage 1: anchors ----------------------------------------------------------

@pytest.mark.parametrize("method", ["fps", "random"])
@pytest.mark.parametrize("data", ["moon", "adjacency"])
def test_select_anchors_matches_reference(method, data):
    Cx, a, _, _ = _moon(60) if data == "moon" else _adjacency()
    k = 12
    key = jax.random.PRNGKey(3)
    want = jselect_anchors(key, jnp.asarray(Cx), jnp.asarray(a), k=k,
                           method=method)
    draw = _anchor_draw(key, repro.Geometry(jnp.asarray(Cx), jnp.asarray(a)),
                        k, method)
    got = anchors.select_anchors(_t(draw, torch.int64), _t(Cx), _t(a), k,
                                 method=method)
    _equal(got.indices, want.indices)
    _equal(got.assign, want.assign)
    _close(got.weights, want.weights, COMPRESS_RTOL)
    if data == "adjacency":
        # the case the flush rules exist for: some clusters end empty
        assert (np.asarray(want.weights) == 0).any() or method == "random"


def test_select_anchors_rejects_bad_draws():
    Cx, a, _, _ = _moon(20)
    with pytest.raises(ValueError, match="anchor method"):
        anchors.select_anchors(0, _t(Cx), _t(a), 4, method="bogus")
    with pytest.raises(ValueError, match="4 indices"):
        anchors.select_anchors(_t([0, 1], torch.int64), _t(Cx), _t(a), 4,
                               method="random")
    with pytest.raises(ValueError, match="anchor method"):
        anchors.draw_anchors(torch.Generator(), _t(a), 4, "bogus")
    idx = anchors.draw_anchors(torch.Generator().manual_seed(0), _t(a), 4,
                               "random")
    assert idx.shape == (4,) and len(set(idx.tolist())) == 4


def test_membership_and_member_table_match_reference():
    Cx, a, _, _ = _adjacency()
    k = 12
    want = jselect_anchors(jax.random.PRNGKey(0), jnp.asarray(Cx),
                           jnp.asarray(a), k=k)
    got = janchors_to_port(want)
    _close(anchors.membership(got, _t(a)),
           janchors.membership(want, jnp.asarray(a)), COMPRESS_RTOL)
    for cap in (60, 5, 2):          # nothing dropped, some, most
        table, dropped = anchors.member_table(got.assign, k, cap)
        jt, jd = janchors.member_table(want.assign, k, cap)
        _equal(table, jt)
        _equal(dropped, jd)


def janchors_to_port(jan):
    return anchors.AnchorAssignment(_t(jan.indices, torch.int64),
                                    _t(jan.assign, torch.int64),
                                    _t(jan.weights))


def test_empty_cluster_flush_rules_match_reference():
    """The reference's hand-built empty cluster (tests/test_multiscale.py):
    the weight floor of compress, the NaN rows of ``membership`` and of
    ``_member_side`` for a massless cluster, and the NaN feature mean —
    the places where XLA's flush of the 1e-38 floor decides the result."""
    jan = janchors.AnchorAssignment(
        indices=jnp.array([0, 1, 2], jnp.int32),
        assign=jnp.array([0, 0, 1, 1], jnp.int32),
        weights=jnp.array([0.5, 0.5, 0.0]))
    pan = janchors_to_port(jan)
    C = np.arange(16, dtype=np.float32).reshape(4, 4)
    w = np.full(4, 0.25, np.float32)
    jside = jrefine._member_side(jnp.asarray(C), jnp.asarray(w), jan, 3)
    pside = refine._member_side(_t(C), _t(w), pan, 3)
    for got, want in zip(pside, jside):
        _close(got, want, 0.0)
    assert np.isnan(np.asarray(pside[2])[2]).all()
    # a massless cluster with members: membership rows and feature means
    w0 = np.array([0.5, 0.5, 0.0, 0.0], np.float32)
    jan0 = janchors.AnchorAssignment(jnp.array([0, 2], jnp.int32),
                                     jnp.array([0, 0, 1, 1], jnp.int32),
                                     jnp.array([1.0, 0.0]))
    pan0 = janchors_to_port(jan0)
    _close(anchors.membership(pan0, _t(w0)),
           janchors.membership(jan0, jnp.asarray(w0)), 0.0)
    feats = np.ones((4, 2), np.float32)
    jg = jcompress.compress_geometry(
        repro.Geometry(jnp.asarray(C), jnp.asarray(w0),
                       features=jnp.asarray(feats), validate=False), jan0)
    pg = compress.compress_geometry(
        repro_torch.Geometry(C, w0, features=feats, validate=False), pan0)
    _close(pg.features, jg.features, 0.0)
    _close(pg.weights, jg.weights, 0.0)
    assert float(pg.weights.min()) >= 1e-30      # the normal-float floor


# -- stage 2: compression ------------------------------------------------------

@pytest.mark.parametrize("metric", ["mean", "anchor"])
@pytest.mark.parametrize("variant", ["plain", "fused", "features"])
def test_compress_problem_matches_reference(metric, variant):
    data = _moon(60)
    Cx, a, Cy, b = data
    rng = np.random.default_rng(5)
    M = rng.random((60, 60)).astype(np.float32) if variant == "fused" else None
    jp, pp = _problems(data, M=M, alpha=0.6 if M is not None else None)
    if variant == "features":
        fx = rng.standard_normal((60, 3)).astype(np.float32)
        fy = rng.standard_normal((60, 3)).astype(np.float32)
        jp = repro.QuadraticProblem(
            repro.Geometry(jnp.asarray(Cx), jnp.asarray(a), jnp.asarray(fx)),
            repro.Geometry(jnp.asarray(Cy), jnp.asarray(b), jnp.asarray(fy)),
            fused_penalty=0.6)
        pp = repro_torch.QuadraticProblem(
            repro_torch.Geometry(Cx, a, fx), repro_torch.Geometry(Cy, b, fy),
            fused_penalty=0.6)
    jax_ = jselect_anchors(jax.random.PRNGKey(1), jp.geom_x.cost,
                           jp.geom_x.weights, k=10)
    jay = jselect_anchors(jax.random.PRNGKey(2), jp.geom_y.cost,
                          jp.geom_y.weights, k=12)
    want = jcompress.compress_problem(jp, jax_, jay, metric)
    got = compress.compress_problem(pp, janchors_to_port(jax_),
                                    janchors_to_port(jay), metric)
    assert got.shape == (10, 12) and got.loss == want.loss
    for g, w in ((got.geom_x, want.geom_x), (got.geom_y, want.geom_y)):
        _close(g.cost, w.cost, COMPRESS_RTOL, 1e-7)
        _close(g.weights, w.weights, COMPRESS_RTOL)
        if variant == "features":
            _close(g.features, w.features, COMPRESS_RTOL, 1e-7)
    if variant == "fused":
        _close(got.M, want.M, COMPRESS_RTOL)
    corr = compress.coarse_value_correction(pp, got)
    jcorr = jcompress.coarse_value_correction(jp, want)
    # a difference of two O(1) sums: held to rtol 1e-5 of the fine term
    fine = float(jnp.dot(jp.geom_x.weights,
                         jp.geom_x.cost ** 2 @ jp.geom_x.weights))
    _close(float(corr), float(jcorr), 0.0, COMPRESS_RTOL * fine)


def test_coarse_value_correction_is_none_for_l1():
    jp, pp = _problems(_moon(30), loss="l1")
    an = anchors.select_anchors(0, pp.geom_x.cost, pp.geom_x.weights, 8)
    assert compress.coarse_value_correction(
        pp, compress.compress_problem(pp, an, an)) is None


# -- stage 3: block refinement -------------------------------------------------

@pytest.mark.parametrize("case", ["l2", "l1", "fused", "adjacency"])
def test_block_refine_matches_reference(case):
    """The reference's own coarse coupling is injected, so pair selection
    sees the same bits."""
    data = _adjacency() if case == "adjacency" else _moon(60)
    M = (np.random.default_rng(9).random((60, 60)).astype(np.float32)
         if case == "fused" else None)
    jp, pp = _problems(data, loss="l1" if case == "l1" else "l2", M=M,
                       alpha=0.6 if M is not None else None)
    k = 12 if case == "adjacency" else 20
    kw = dict(cap_x=10, cap_y=9, max_pairs=2 * (2 * k), epsilon=5e-2,
              iters=200, tol=1e-8)
    jax_ = jselect_anchors(jax.random.PRNGKey(1), jp.geom_x.cost,
                           jp.geom_x.weights, k=k)
    jay = jselect_anchors(jax.random.PRNGKey(2), jp.geom_y.cost,
                          jp.geom_y.weights, k=k)
    cp = jcompress.compress_problem(jp, jax_, jay)
    Tc = repro.solve(cp, FAST_BASE).coupling
    want = jblock_refine(jp, jax_, jay, Tc, **kw)
    got = refine.block_refine(pp, janchors_to_port(jax_),
                              janchors_to_port(jay), _t(Tc), **kw)
    for name in ("pair_rows", "pair_cols", "members_x", "members_y"):
        _equal(getattr(got, name), getattr(want, name))
    _close(got.blocks, want.blocks, BLOCK_RTOL, BLOCK_ATOL)
    assert np.isfinite(np.asarray(got.blocks)).all()


def test_top_pairs_breaks_ties_like_lax_top_k():
    Tc = np.array([[0.1, 0.3, 0.3], [0.3, 0.0, 0.2]], np.float32)
    for k in (1, 3, 5):
        want = jrefine.top_pairs(jnp.asarray(Tc), k)
        got = refine.top_pairs(_t(Tc), k)
        for g, w in zip(got, want):
            _equal(g, w)


def test_batched_sinkhorn_stops_each_block_on_its_own():
    """Three blocks of one batch against the reference's vmap of the
    tol-stopped sinkhorn_log; the middle one converges first (a flat
    kernel), so a single global stop would change the others."""
    from repro.core.sinkhorn import sinkhorn_log as jsinkhorn_log
    from repro_torch.core.sinkhorn import sinkhorn_log_batched

    rng = np.random.default_rng(0)
    logK = (-rng.random((3, 9, 7)) / 0.05).astype(np.float32)
    logK[1] = -1.0
    a = rng.random((3, 9)).astype(np.float32) + 0.1
    b = rng.random((3, 7)).astype(np.float32) + 0.1
    a /= a.sum(1, keepdims=True)
    b /= b.sum(1, keepdims=True)
    for tol in (1e-8, 1e-3, 0.0):
        want = jax.vmap(lambda x, y, z: jsinkhorn_log(x, y, z, 200, tol=tol))(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(logK))
        got = sinkhorn_log_batched(_t(a), _t(b), _t(logK), 200, tol=tol)
        _close(got, want, BLOCK_RTOL, BLOCK_ATOL)
        solo = [jsinkhorn_log(jnp.asarray(a[i]), jnp.asarray(b[i]),
                              jnp.asarray(logK[i]), 200, tol=tol)
                for i in range(3)]
        _close(got, np.stack(solo), BLOCK_RTOL, BLOCK_ATOL)


# -- the whole solve -----------------------------------------------------------

CASES = {
    # k = n/2, polished (5 steps through K1's plain version on the CPU),
    # the default dense base
    "polished_k_half": (lambda: _moon(48), {}, dict(k_x=24, k_y=24)),
    # every default: k = 16, polished, the default dense base
    "defaults": (lambda: _moon(48, seed=2), {}, {}),
    "spar_base": (lambda: _moon(60), {}, dict(
        k_x=24, k_y=24, polish_iters=0,
        base=repro.SparGWSolver(tol=1e-6, inner_tol=1e-8))),
    "lowrank_base": (lambda: _moon(60), {}, dict(
        k_x=24, k_y=24, polish_iters=0,
        base=repro.LowRankGWSolver(outer_iters=20, tol=0.0))),
    "fused": (lambda: _moon(60), dict(
        M=np.random.default_rng(9).random((60, 60)).astype(np.float32),
        alpha=0.6), dict(k_x=20, k_y=20, base=FAST_BASE)),
    "unbalanced": (lambda: _moon(60), dict(lam=1.0),
                   dict(k_x=20, k_y=20, base=FAST_BASE)),
    "l1": (lambda: _moon(60), dict(loss="l1"),
           dict(k_x=20, k_y=20, base=FAST_BASE)),
    "coarse_debias": (lambda: _moon(60), {}, dict(
        k_x=20, k_y=20, base=FAST_BASE, value_mode="coarse", polish_iters=0)),
    "coarse_raw": (lambda: _moon(60), {}, dict(
        k_x=20, k_y=20, base=FAST_BASE, value_mode="coarse", polish_iters=0,
        debias=False)),
    "refined_dense": (lambda: _moon(60), {}, dict(
        k_x=20, k_y=20, base=FAST_BASE, value_mode="refined",
        polish_iters=0)),
    "auto_unpolished": (lambda: _moon(60), {}, dict(
        k_x=20, k_y=20, base=FAST_BASE, polish_iters=0)),
    "random_anchors": (lambda: _moon(60), {}, dict(
        k_x=20, k_y=20, base=FAST_BASE, anchor_method="random",
        polish_iters=0)),
    "adjacency_empty_clusters": (_adjacency, {}, dict(k_x=12, k_y=12,
                                                      base=FAST_BASE)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_matches_reference(case):
    make, problem_kw, solver_kw = CASES[case]
    jp, pp = _problems(make(), **problem_kw)
    jo, po = _solve_both(jp, pp, repro.QuantizedGWSolver(**solver_kw))
    _assert_solve_parity(jo, po)
    if case == "polished_k_half":
        mu, nu = po.coupling.marginals(48, 48)
        jmu, jnu = jo.coupling.marginals(48, 48)
        _close(mu, jmu, BLOCK_RTOL, BLOCK_ATOL)
        _close(nu, jnu, BLOCK_RTOL, BLOCK_ATOL)
        _close(po.coupling_dense(48, 48), jo.coupling_dense(48, 48),
               BLOCK_RTOL, BLOCK_ATOL)


def test_selected_and_validated_like_reference():
    n = 3000
    a = np.full(n, 1.0 / n, np.float32)
    C = np.zeros((n, n), np.float32)
    p = interop.to_problem(C, a, C, a, "l1")
    assert repro_torch.select_solver(p) == QuantizedGWSolver()
    assert repro_torch.get_solver("quantized_gw") is QuantizedGWSolver
    assert isinstance(QuantizedGWSolver(base="spar_gw").base,
                      repro_torch.SparGWSolver)
    with pytest.raises(ValueError, match="value_mode"):
        QuantizedGWSolver(value_mode="bogus")
    jp, pp = _problems(_moon(40), lam=1.0)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="balanced-only"):
        repro_torch.solve(pp, QuantizedGWSolver(
            k_x=8, k_y=8, value_mode="refined", polish_iters=0), gen,
            device="cpu")
    with pytest.raises(NotImplementedError, match="polish"):
        repro_torch.solve(pp, QuantizedGWSolver(k_x=8, k_y=8,
                                                polish_iters=3), gen,
                          device="cpu")
    with pytest.raises(ValueError, match="generator"):
        repro_torch.solve(pp, QuantizedGWSolver(k_x=8, k_y=8), device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        repro_torch.solve(pp, QuantizedGWSolver(k_x=8, k_y=8, trace=True),
                          gen, device="cpu")


def test_own_draws_are_reproducible():
    """Without draws everything comes from the caller's generator: the
    same seed gives the same bits, another seed other anchors."""
    _, pp = _problems(_moon(48))
    solver = QuantizedGWSolver(k_x=12, k_y=12, polish_iters=0,
                               base=_port_solver(FAST_BASE))

    def run(seed):
        return repro_torch.solve(pp, solver, device="cpu",
                                 generator=torch.Generator().manual_seed(seed))
    o1, o2 = run(0), run(0)
    assert torch.equal(o1.coupling.blocks, o2.coupling.blocks)
    assert float(o1.value) == float(o2.value) and o1.status.is_healthy
