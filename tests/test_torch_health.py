"""Fault injection, ``on_failure`` and the fallback ladder: the port
against ``repro``, CPU.

Every solver runs under the same ``FaultSpec`` on both sides, on the
reference's draws (its sampled support, its low-rank or quantized draws).
Status codes, ``fail_iter`` and ``n_rescues`` must be equal; values are
held to rtol 1e-4 where both are finite. A faulted solve returns an early
iterate (two steps before a fault at iteration 2), where the rounding
differences of the inner Sinkhorn are not yet damped: dense_gw after 2
of its steps differs by 1.2e-5 relative with no fault at all, against
3e-7 after 10 (the rtol 1e-5 of tests/test_torch_solve.py); the quantized
solves take the rtol 1e-4 of tests/test_torch_quantized.py. The fallback
ladder re-draws with its own
generator, so its parity is the recovering rung; the port's own recovery
must repeat to the bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.health import FaultSpec as JFaultSpec
from repro.health import fallback_chain as jfallback_chain
from repro.health import health_loop as jhealth_loop
from repro_torch.api import interop
from repro_torch.api.solve import attempt_generator
from repro_torch.health import (
    FaultSpec,
    SolveDivergedError,
    fallback_chain,
    health_loop,
)
from test_torch_lowrank import _ref_draws as lowrank_draws
from test_torch_quantized import _port_solver
from test_torch_quantized import _ref_draws as quantized_draws
from test_torch_solve import _one_torch_thread  # noqa: F401 (autouse)

N = 24
KEY = jax.random.PRNGKey(0)
VALUE_RTOL = 1e-4


def _data(n=N, seed=0):
    """Two 2-D Gaussian clouds (the second scaled by 1.2), Euclidean
    distance costs, uniform weights: tests/test_health.py's problem with
    numpy draws."""
    rng = np.random.default_rng(seed)

    def dist(x):
        return np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)).astype(
            np.float32)
    a = np.full(n, 1.0 / n, np.float32)
    return (dist(rng.standard_normal((n, 2))), a,
            dist(1.2 * rng.standard_normal((n, 2))), a)


def _problems(n=N, loss="l2", **kw):
    Cx, a, Cy, b = _data(n)
    jp = repro.QuadraticProblem(repro.Geometry(jnp.asarray(Cx), jnp.asarray(a)),
                                repro.Geometry(jnp.asarray(Cy), jnp.asarray(b)),
                                loss=loss, **kw)
    return jp, interop.to_problem(Cx, a, Cy, b, loss, **kw)


def _fast_configs(n=N):
    """tests/test_health.py's small, fast configs of every solver."""
    return {
        "dense_gw": repro.DenseGWSolver(tol=1e-6, inner_tol=1e-8,
                                        outer_iters=10),
        "spar_gw": repro.SparGWSolver(s=8 * n, outer_iters=10,
                                      inner_tol=1e-8),
        "grid_gw": repro.GridGWSolver(s_r=12, s_c=12, outer_iters=10,
                                      inner_tol=1e-8),
        "lowrank_gw": repro.LowRankGWSolver(outer_iters=30),
    }


def _faulted(solver, max_rescues=0, **fault_kw):
    return dataclasses.replace(solver, max_rescues=max_rescues,
                               fault=JFaultSpec(**fault_kw))


def _solve_both(jp, pp, js, key=KEY):
    """The reference's solve and the port's on the reference's draws."""
    jo = repro.solve(jp, js, key=key)
    name = type(js).name
    kw = {}
    if name in ("spar_gw", "grid_gw"):
        kw["support"] = interop.to_support(jo.coupling.rows, jo.coupling.cols)
    elif name == "lowrank_gw":
        kw["draws"] = interop.to_lowrank_draws(**lowrank_draws(key, jp, js))
    elif name == "quantized_gw":
        kw["draws"] = interop.to_quantized_draws(
            **quantized_draws(key, jp, js))
    return jo, repro_torch.solve(pp, _port_solver(js), device="cpu", **kw)


def _assert_status_parity(jo, po):
    js, ps = jo.status, po.status
    assert (ps.code, ps.fail_iter, ps.n_rescues) == (
        int(js.code), int(js.fail_iter), int(js.n_rescues)), (ps, js)
    assert po.n_iters == int(jo.n_iters)
    jv, pv = float(jo.value), float(po.value)
    assert np.isfinite(jv) == np.isfinite(pv)
    if np.isfinite(jv):
        np.testing.assert_allclose(pv, jv, rtol=VALUE_RTOL)


def _equal_bits(o1, o2):
    for x, y in zip(_leaves(o1), _leaves(o2)):
        assert torch.equal(x, y) or (x.is_floating_point() and torch.equal(
            torch.nan_to_num(x, nan=7.0), torch.nan_to_num(y, nan=7.0)))


def _leaves(out):
    c = out.coupling
    parts = list(c) if isinstance(c, tuple) else [c]
    return [out.value, out.errors, *parts]


# -- FaultSpec ----------------------------------------------------------------

def test_fault_spec_validation_matches_reference():
    for kw in ({"kind": "bogus"}, {"site": "bogus"}):
        key = next(iter(kw))
        with pytest.raises(ValueError, match=key):
            JFaultSpec(**kw)
        with pytest.raises(ValueError, match=key):
            FaultSpec(**kw)


@pytest.mark.parametrize("kind", ["nan", "inf", "overflow", "zero"])
@pytest.mark.parametrize("persistent", [False, True])
@pytest.mark.parametrize("at_iter", [-1, 0, 3])
def test_fault_spec_fires_and_applies_like_reference(kind, persistent,
                                                      at_iter):
    jf = JFaultSpec(at_iter=at_iter, kind=kind, persistent=persistent)
    pf = interop.to_fault_spec(at_iter=jf.at_iter, kind=jf.kind,
                               site=jf.site, persistent=jf.persistent)
    x = np.array([0.5, 2.0, 1e-3, 4.0], np.float32)
    for i in range(6):
        assert pf.fires(i) == bool(jf.fires(jnp.int32(i)))
        want = jf.apply((jnp.asarray(x), jnp.asarray(2 * x)), jnp.int32(i))
        got = pf.apply((torch.from_numpy(x), torch.from_numpy(2 * x)), i)
        assert isinstance(got, tuple) and len(got) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(
            pf.apply(torch.from_numpy(x), i).numpy(),
            np.asarray(jf.apply(jnp.asarray(x), jnp.int32(i))))


# -- the fault-carrying loop ---------------------------------------------------

@pytest.mark.parametrize("kind", ["nan", "inf", "overflow", "zero"])
@pytest.mark.parametrize("site", ["iterate", "cost"])
@pytest.mark.parametrize("persistent", [False, True])
def test_health_loop_under_fault_matches_reference(kind, site, persistent):
    """A contraction T <- (T + 1)/2 with one rescue: the once-off faults
    are rescued, the persistent ones end DIVERGED; the overflow fault at
    the cost site is a healthy step that the contraction absorbs."""
    fault = dict(at_iter=2, kind=kind, site=site, persistent=persistent)

    def run(loop, lib, T0, spec):
        return loop(lambda T, scale: 0.5 * T + 0.5 / scale,
                    lambda T: lib.sum(lib.abs(T - 1.0)), T0, 12, 0.0,
                    scaled_step=True, max_rescues=1, fault=spec)

    x = np.array([0.0, 4.0, 2.0], np.float32)
    want = run(jhealth_loop, jnp, jnp.asarray(x), JFaultSpec(**fault))
    got = run(health_loop, torch, torch.from_numpy(x), FaultSpec(**fault))
    js = want.status
    assert (got.status.code, got.status.fail_iter, got.status.n_rescues) == (
        int(js.code), int(js.fail_iter), int(js.n_rescues))
    assert got.n_iters == int(want.n_iters)
    np.testing.assert_allclose(got.iterate.numpy(), np.asarray(want.iterate),
                               rtol=1e-6)
    np.testing.assert_allclose(got.errors.numpy(), np.asarray(want.errors),
                               rtol=1e-6, atol=1e-7, equal_nan=True)


def test_health_loop_rejects_a_fault_that_is_not_a_spec():
    with pytest.raises(TypeError, match="FaultSpec"):
        health_loop(lambda T: T, lambda T: T.sum(), torch.ones(2), 3, 0.0,
                    fault=object())


# -- every solver under a fault ------------------------------------------------

@pytest.mark.parametrize("name", ["dense_gw", "spar_gw", "grid_gw",
                                  "lowrank_gw"])
@pytest.mark.parametrize("kind", ["nan", "inf"])
@pytest.mark.parametrize("site", ["iterate", "cost"])
def test_solver_diverges_at_fault_iteration_like_reference(name, kind, site):
    """tests/test_health.py's matrix: a persistent fault at iteration 2 with
    no rescue ends DIVERGED there, the last healthy iterate returned."""
    jp, pp = _problems()
    js = _faulted(_fast_configs()[name], at_iter=2, kind=kind, site=site,
                  persistent=True)
    jo, po = _solve_both(jp, pp, js)
    _assert_status_parity(jo, po)
    assert po.status.describe() == "DIVERGED" and po.status.fail_iter == 2
    assert bool(torch.isfinite(po.coupling_dense(N, N)).all())
    assert bool(torch.isfinite(po.errors[:2]).all())


@pytest.mark.parametrize("name,kind,site", [
    ("dense_gw", "nan", "iterate"), ("dense_gw", "overflow", "iterate"),
    ("dense_gw", "zero", "iterate"), ("spar_gw", "inf", "iterate"),
    ("spar_gw", "zero", "iterate"), ("spar_gw", "overflow", "cost"),
    ("grid_gw", "nan", "cost"), ("lowrank_gw", "nan", "iterate")])
def test_solver_rescue_matches_reference(name, kind, site):
    """A once-off fault with two rescues: the rescued solve (or, for the
    faults a step absorbs, the unrescued one) against the reference. The
    zero fault at the cost site is held at the step level only (see
    test_zero_input_step_collapses_like_the_reference_step)."""
    jp, pp = _problems()
    js = _faulted(_fast_configs()[name], max_rescues=2, at_iter=3,
                  kind=kind, site=site)
    jo, po = _solve_both(jp, pp, js)
    _assert_status_parity(jo, po)
    assert po.status.is_healthy


def test_zero_input_step_collapses_like_the_reference_step():
    """A zero iterate at the cost site, one dense prox step: log(max(0,
    1e-38)) is -inf once XLA flushes the floor, so the step's coupling
    collapses to 0 on both sides (the isolated jitted step). Inside the
    reference's whole jitted solve XLA leaves that floor unflushed
    (log 1e-38 ≈ -87.5) and the step stays healthy, so a whole solve with
    this fault is not held to the reference (ROADMAP §3)."""
    from repro.core.gw import dense_cost as jdense_cost
    from repro.core.sinkhorn import sinkhorn_log as jsinkhorn_log
    from repro_torch.core.gw import dense_cost
    from repro_torch.core.sinkhorn import sinkhorn_log
    from repro_torch.core.utils import log_floor

    Cx, a, Cy, b = _data()

    @jax.jit
    def jstep(T):
        logK = (-jdense_cost(jnp.asarray(Cx), jnp.asarray(Cy), T, "l2") / 1e-2
                + jnp.log(jnp.maximum(T, 1e-38)))
        return jsinkhorn_log(jnp.asarray(a), jnp.asarray(b), logK, 50,
                             tol=1e-8)

    T = torch.zeros(N, N)
    logK = (-dense_cost(torch.from_numpy(Cx), torch.from_numpy(Cy), T, "l2")
            / 1e-2 + log_floor(T))
    got = sinkhorn_log(torch.from_numpy(a), torch.from_numpy(b), logK, 50,
                       tol=1e-8)
    want = jstep(jnp.zeros((N, N)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.sum()) == 0.0          # mass collapse: a failed step


def test_quantized_inherits_base_divergence_like_reference():
    base = _faulted(repro.DenseGWSolver(tol=1e-6, inner_tol=1e-8), at_iter=2,
                    kind="nan", persistent=True)
    jp, pp = _problems()
    jo, po = _solve_both(jp, pp, repro.QuantizedGWSolver(base=base))
    _assert_status_parity(jo, po)
    assert po.status.describe() == "DIVERGED" and po.status.fail_iter == 2


def test_quantized_polish_divergence_escalates_like_reference():
    js = _faulted(repro.QuantizedGWSolver(polish_iters=3), at_iter=1,
                  kind="nan", persistent=True)
    jp, pp = _problems()
    jo, po = _solve_both(jp, pp, js)
    _assert_status_parity(jo, po)
    assert po.status.describe() == "DIVERGED"


# -- solve(): on_failure -------------------------------------------------------

def test_on_failure_raise_like_reference():
    js = _faulted(repro.DenseGWSolver(outer_iters=5), at_iter=1, kind="nan",
                  persistent=True)
    jp, pp = _problems()
    with pytest.raises(repro.health.SolveDivergedError, match="DIVERGED"):
        repro.solve(jp, js, on_failure="raise")
    with pytest.raises(SolveDivergedError, match="DIVERGED") as exc:
        repro_torch.solve(pp, _port_solver(js), device="cpu",
                          on_failure="raise")
    assert exc.value.output.status.describe() == "DIVERGED"
    healthy = repro_torch.solve(pp, "dense_gw", device="cpu",
                                on_failure="raise")
    assert healthy.status.is_healthy
    with pytest.raises(ValueError, match="on_failure"):
        repro_torch.solve(pp, "dense_gw", device="cpu", on_failure="explode")


@pytest.mark.parametrize("loss,rung", [("l2", "lowrank_gw"),
                                       ("l1", "quantized_gw")])
def test_fallback_recovers_on_the_reference_rung(loss, rung):
    """A persistent NaN on spar_gw: the ladder's first eligible rung
    recovers on both sides (lowrank for l2; l1 is not decomposable, so
    quantized). For the quantized rung (a default low-rank solve takes
    ~20 s here) the port's recovery must equal, bit for bit, a second
    run: a direct solve on that rung with the attempt's generator."""
    js = _faulted(repro.SparGWSolver(s=8 * N, outer_iters=8), at_iter=1,
                  kind="nan", persistent=True)
    jp, pp = _problems(loss=loss)
    jo = repro.solve(jp, js, key=KEY, on_failure="fallback")
    rungs = {repro.LowRankCoupling: "lowrank_gw",
             repro.QuantizedCoupling: "quantized_gw",
             repro_torch.LowRankCoupling: "lowrank_gw",
             repro_torch.QuantizedCoupling: "quantized_gw"}
    assert rungs[type(jo.coupling)] == rung
    assert jo.status.describe() != "DIVERGED"

    o1 = repro_torch.solve(pp, _port_solver(js), device="cpu",
                           generator=torch.Generator().manual_seed(3),
                           on_failure="fallback")
    assert rungs[type(o1.coupling)] == rung and o1.status.is_healthy
    chain = fallback_chain(pp, exclude=("spar_gw",))
    assert type(chain[0]).name == rung
    if rung == "quantized_gw":
        _equal_bits(o1, chain[0].run(pp, generator=attempt_generator(
            torch.Generator().manual_seed(3), 1)))


def test_fallback_without_generator_returns_the_failed_output():
    """No generator: the ladder reduces to dense_gw, which is the failed
    solver itself, so the failed output comes back (as in the
    reference with no key)."""
    js = _faulted(repro.DenseGWSolver(outer_iters=5), at_iter=1, kind="nan",
                  persistent=True)
    jp, pp = _problems()
    jo = repro.solve(jp, js, on_failure="fallback")
    po = repro_torch.solve(pp, _port_solver(js), device="cpu",
                           on_failure="fallback")
    assert po.status.describe() == jo.status.describe() == "DIVERGED"


def test_attempt_generator_ignores_the_failed_attempts_draws():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    torch.rand(100, generator=g2)               # a failed attempt's draws
    for k in (1, 2):
        assert torch.equal(torch.rand(4, generator=attempt_generator(g1, k)),
                           torch.rand(4, generator=attempt_generator(g2, k)))
    assert not torch.equal(torch.rand(4, generator=attempt_generator(g1, 1)),
                           torch.rand(4, generator=attempt_generator(g1, 2)))


# -- the ladder's gates --------------------------------------------------------

def _shape_problems(n, M=None, **kw):
    """Problems whose structure alone matters: 1-D point clouds, so no n×n
    cost matrix is built."""
    x = np.linspace(0.0, 1.0, n, dtype=np.float32)[:, None]
    a = np.full(n, 1.0 / n, np.float32)
    jg = repro.Geometry.from_points(jnp.asarray(x), jnp.asarray(a))
    jp = repro.QuadraticProblem(jg, jg, M=None if M is None else jnp.asarray(M),
                                **kw)
    pp = interop.to_problem(None, a, None, a, points_x=x, points_y=x, M=M,
                            **kw)
    return jp, pp


@pytest.mark.parametrize("n,problem_kw,chain_kw", [
    (N, {}, {}),
    (N, {"lam": 1.0}, {}),
    (N, {"loss": "l1"}, {}),
    (N, {}, {"generator": False}),
    (N, {}, {"exclude": ("spar_gw",)}),
    (N, {"M": np.ones((N, N), np.float32), "fused_penalty": 0.5}, {}),
    (N, {"M": np.ones((N, N), np.float32), "fused_penalty": 0.5,
         "lam": 1.0}, {}),
    (2000, {"loss": "l1"}, {}),
    (9000, {"loss": "l1"}, {}),
])
def test_fallback_chain_gates_like_reference(n, problem_kw, chain_kw):
    """tests/test_health.py's gating cases, the fused ones, and the two
    size caps (dense above 1024, spar above 8192)."""
    jp, pp = _shape_problems(n, **problem_kw)
    available = chain_kw.get("generator", True)
    exclude = chain_kw.get("exclude", ())
    want = [type(s).name for s in jfallback_chain(
        jp, exclude=exclude, key_available=available)]
    chain = fallback_chain(pp, exclude=exclude,
                           generator_available=available)
    assert [type(s).name for s in chain] == want
    for cfg in chain:
        assert cfg == type(cfg).default_config(n)
