"""The legacy core: the port's shims, EMD-GW, SaGroW, the alignment loss
and the dispatch leftovers against ``repro.core`` / ``repro.kernels``, CPU.

Inputs are made from numpy seeds and handed to both packages; where the
reference draws with threefry, its draws are reproduced here with jax and
injected into the port (``support=``, ``draws=``). Tolerances, and why:

* shims: each port shim is bit for bit its ``repro_torch.solve`` call on
  the same generator state (as ``tests/test_api.py`` asserts for the
  reference), and within ``tests/test_torch_solve.py``'s bounds of the
  reference shim (value rtol 1e-5, coupling atol 1e-6 + rtol 1e-4: the
  same fp32 solve in another summation order);
* ``exact_ot`` / ``emd_gw``: the LP is scipy's on both sides, fed the same
  float32 cost, so T atol 1e-9 and the value rtol 1e-6;
* SaGroW: on injected draws each step's gradient and the value within
  rtol 1e-5 (fp32 sums of s' terms in another order);
* the alignment loss: value rtol 1e-5, gradient within 1e-4 of its
  largest entry (``tests/test_torch_diff.py``'s bound against
  ``jax.grad``).

The reference runs are shared through module-scoped fixtures.
"""
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import align as j_align
from repro.core import emd as j_emd
from repro_torch.api import interop
from repro_torch.core import align, emd
from repro_torch.core.gw import dense_cost
from repro_torch.kernels import dispatch
from test_torch_serve import PROX_RTOL, x64_prox_coupling
from test_torch_solve import _one_torch_thread  # noqa: F401 — autouse

# the modules (``repro.core`` and ``repro_torch.core`` export the function
# ``sagrow`` under the module's name)
j_sagrow = importlib.import_module("repro.core.sagrow")
j_sinkhorn = importlib.import_module("repro.core.sinkhorn")
sagrow = importlib.import_module("repro_torch.core.sagrow")

VALUE_RTOL = 1e-5
VALS_ATOL, VALS_RTOL = 1e-6, 1e-4
GRAD_REL = 1e-4

N = 12
KEY = jax.random.PRNGKey(0)
ITERS = dict(outer_iters=4, inner_iters=20)


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x, y = rng.standard_normal((n, 2)), rng.standard_normal((n, 2)) * 1.2
    Cx = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)).astype(np.float32)
    Cy = np.sqrt(((y[:, None] - y[None]) ** 2).sum(-1)).astype(np.float32)
    a = np.full(n, 1 / n, np.float32)
    M = rng.random((n, n)).astype(np.float32)
    return a, a.copy(), Cx, Cy, M


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _gen():
    return torch.Generator().manual_seed(0)


# ---------------------------------------------------------------------------
# the nine shims
# ---------------------------------------------------------------------------

# name -> (reference call, port call taking the reference's support or
# None, the repro_torch.solve call the port shim stands for)
def _shims():
    a, b, Cx, Cy, M = _data()
    ja, jb, jCx, jCy, jM = (jnp.asarray(x) for x in (a, b, Cx, Cy, M))
    pa, pb, pCx, pCy, pM = (_t(x) for x in (a, b, Cx, Cy, M))
    core, jcore = repro_torch.core, repro.core
    s = 2 * N
    cpu = dict(device="cpu")

    def problem(**kw):
        return interop.to_problem(Cx, a, Cy, b, **kw)

    def spar(**kw):
        return repro_torch.SparGWSolver(s=s, **ITERS, **kw)

    def dense(**kw):
        return repro_torch.DenseGWSolver(**ITERS, **kw)

    def solve(prob, solver, generator=None):
        return repro_torch.solve(prob, solver, generator=generator,
                                 device="cpu", validate=False)

    return {
        "spar_gw": (
            lambda: jcore.spar_gw(KEY, ja, jb, jCx, jCy, s=s, **ITERS),
            lambda g, sup: core.spar_gw(g, pa, pb, pCx, pCy, s=s,
                                        support=sup, **ITERS, **cpu),
            lambda g: solve(problem(), spar(), g)),
        "spar_fgw": (
            lambda: jcore.spar_fgw(KEY, ja, jb, jCx, jCy, jM, s=s, **ITERS),
            lambda g, sup: core.spar_fgw(g, pa, pb, pCx, pCy, pM, s=s,
                                         support=sup, **ITERS, **cpu),
            lambda g: solve(problem(M=M, fused_penalty=0.6), spar(), g)),
        "spar_ugw": (
            lambda: jcore.spar_ugw(KEY, ja, jb, jCx, jCy, s=s, lam=1.0,
                                   **ITERS),
            lambda g, sup: core.spar_ugw(g, pa, pb, pCx, pCy, s=s, lam=1.0,
                                         support=sup, **ITERS, **cpu),
            lambda g: solve(problem(lam=1.0), spar(), g)),
        "gw_dense": (
            lambda: jcore.gw_dense(ja, jb, jCx, jCy, **ITERS),
            lambda g, sup: core.gw_dense(pa, pb, pCx, pCy, **ITERS, **cpu),
            lambda g: solve(problem(), dense())),
        "egw": (
            lambda: jcore.egw(ja, jb, jCx, jCy, epsilon=0.1, **ITERS),
            lambda g, sup: core.egw(pa, pb, pCx, pCy, epsilon=0.1, **ITERS,
                                    **cpu),
            lambda g: solve(problem(), dense(reg="ent", epsilon=0.1))),
        "pga_gw": (
            lambda: jcore.pga_gw(ja, jb, jCx, jCy, **ITERS),
            lambda g, sup: core.pga_gw(pa, pb, pCx, pCy, **ITERS, **cpu),
            lambda g: solve(problem(), dense(reg="prox"))),
        "fgw_dense": (
            lambda: jcore.fgw_dense(ja, jb, jCx, jCy, jM, **ITERS),
            lambda g, sup: core.fgw_dense(pa, pb, pCx, pCy, pM, **ITERS,
                                          **cpu),
            lambda g: solve(problem(M=M, fused_penalty=0.6), dense())),
        "ugw_dense": (
            lambda: jcore.ugw_dense(ja, jb, jCx, jCy, lam=1.0, **ITERS),
            lambda g, sup: core.ugw_dense(pa, pb, pCx, pCy, lam=1.0,
                                          **ITERS, **cpu),
            lambda g: solve(problem(lam=1.0), dense())),
        "grid_spar_gw": (
            lambda: jcore.grid_spar_gw(KEY, ja, jb, jCx, jCy, s_r=6, s_c=5,
                                       **ITERS),
            lambda g, sup: core.grid_spar_gw(g, pa, pb, pCx, pCy, s_r=6,
                                             s_c=5, support=sup, **ITERS,
                                             **cpu),
            lambda g: solve(problem(), repro_torch.GridGWSolver(
                s_r=6, s_c=5, **ITERS), g)),
    }


SHIMS = _shims()


@pytest.fixture(scope="module")
def ref_shims():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return {name: ref() for name, (ref, _, _) in SHIMS.items()}


def _parts(out):
    """A shim's result as (value, [coupling arrays])."""
    value, coupling = out
    parts = list(coupling) if isinstance(coupling, tuple) else [coupling]
    return value, parts


@pytest.mark.parametrize("name", sorted(SHIMS))
def test_shim_warns_and_is_its_solve_bitwise(name):
    _, port, direct = SHIMS[name]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = port(_gen(), None)
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, DeprecationWarning)]
    assert any("repro_torch.core." in m and "repro_torch.solve" in m
               for m in msgs), msgs
    out = direct(_gen())
    c = out.coupling
    want = (out.value, c if isinstance(c, torch.Tensor) else tuple(c))
    gv, gparts = _parts(got)
    wv, wparts = _parts(want)
    assert torch.equal(gv, wv)
    assert len(gparts) == len(wparts)
    assert all(torch.equal(x, y) for x, y in zip(gparts, wparts))


# the balanced dense prox shims: their couplings are held to the float64
# solve at PROX_RTOL (see test_torch_serve.py::test_server_matches_reference_server);
# on this problem the two float32 solves part by 1.9e-6 at a 6.0e-4 entry
# after 4 steps; against float64 the port needs rtol 7.2e-4 at atol 1e-6
# and the reference none (tests/torch_prox_readings.py)
PROX_DENSE = ("gw_dense", "pga_gw")


@pytest.mark.parametrize("name", sorted(SHIMS))
def test_shim_matches_reference_shim(name, ref_shims):
    _, port, _ = SHIMS[name]
    rv, rparts = _parts(ref_shims[name])
    support = None
    if len(rparts) == 3:       # (rows, cols, vals) or (R, C, block)
        support = interop.to_support(rparts[0], rparts[1])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        gv, gparts = _parts(port(None, support))
    np.testing.assert_allclose(float(gv), float(rv), rtol=VALUE_RTOL)
    if name in PROX_DENSE:
        a, b, Cx, Cy, _ = _data()
        T64, _ = x64_prox_coupling(Cx, Cy, a, b, **ITERS)
        for side in (gparts[0].numpy(), np.asarray(rparts[0])):
            np.testing.assert_allclose(side, T64, rtol=PROX_RTOL,
                                       atol=VALS_ATOL)
        return
    for g, r in zip(gparts, rparts):
        if g.dtype == torch.int64:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       rtol=VALS_RTOL, atol=VALS_ATOL)


# ---------------------------------------------------------------------------
# exact OT and EMD-GW
# ---------------------------------------------------------------------------

def _emd_cases():
    """(name, a, b, Cx, Cy, loss). ``f32_ties``: four equidistant points
    whose distances differ by ~1e-9, given in float64. Both packages take
    the cost in float32, where those differences vanish and the LP meets
    exact ties; a float64 cost keeps them and picks another plan
    (checked below), so this case holds the port to the float32 cost."""
    a, b, Cx, Cy, _ = _data(10, seed=3)
    rng = np.random.default_rng(37)
    noise = rng.standard_normal((4, 4)) * 1e-9
    noise = noise + noise.T
    np.fill_diagonal(noise, 0)
    tie_x = np.ones((4, 4)) - np.eye(4) + noise
    y = rng.random((4, 2))
    tie_y = np.sqrt(((y[:, None] - y[None]) ** 2).sum(-1))
    w = np.full(4, 0.25)
    return {"l2": (a, b, Cx, Cy, "l2"), "l1": (a, b, Cx, Cy, "l1"),
            "f32_ties": (w, w, tie_x, tie_y, "l2")}


EMD_CASES = _emd_cases()


@pytest.fixture(scope="module")
def ref_emd():
    pytest.importorskip("scipy")
    return {name: j_emd.emd_gw(a, b, Cx, Cy, loss)
            for name, (a, b, Cx, Cy, loss) in EMD_CASES.items()}


def test_exact_ot_matches_reference():
    pytest.importorskip("scipy")
    rng = np.random.default_rng(4)
    a = rng.random(7)
    a /= a.sum()
    b = rng.random(9)
    b /= b.sum()
    M = rng.random((7, 9))
    T = emd.exact_ot(a, b, M)
    np.testing.assert_allclose(T, j_emd.exact_ot(a, b, M), atol=1e-9)
    np.testing.assert_allclose(T.sum(1), a, atol=1e-9)
    np.testing.assert_allclose(T.sum(0), b, atol=1e-9)


@pytest.mark.parametrize("name", sorted(EMD_CASES))
def test_emd_gw_matches_reference(name, ref_emd):
    a, b, Cx, Cy, loss = EMD_CASES[name]
    val, T = emd.emd_gw(a, b, Cx, Cy, loss, device="cpu")
    rval, rT = ref_emd[name]
    assert T.dtype == np.float64
    np.testing.assert_allclose(T, rT, atol=1e-9)
    np.testing.assert_allclose(val, rval, rtol=1e-6)


def test_emd_gw_float32_cost_decides_the_tied_case(ref_emd):
    """The tied case's plan under a float64 cost is another one: a port
    that took the cost in float64 would fail the case above."""
    a, b, Cx, Cy, loss = EMD_CASES["f32_ties"]
    T = np.outer(a, b)
    Cx64, Cy64 = torch.tensor(Cx), torch.tensor(Cy)
    for _ in range(20):
        C = dense_cost(Cx64, Cy64, torch.tensor(T), loss).numpy()
        T_new = emd.exact_ot(a, b, C)
        if np.abs(T_new - T).sum() < 1e-12:
            T = T_new
            break
        T = T_new
    assert np.abs(T - ref_emd["f32_ties"][1]).max() > 0.1


# ---------------------------------------------------------------------------
# SaGroW
# ---------------------------------------------------------------------------

SAGROW_CASES = {"n14_s64": (14, 64), "n18_s20": (18, 20)}
SAGROW_ITERS = dict(epsilon=1e-2, outer_iters=6, inner_iters=30)


@pytest.fixture(scope="module")
def ref_sagrow():
    """Per case: the data, the reference's jitted sagrow, and its steps
    replayed eagerly with the reference's own functions: the iterate each
    gradient sees, the gradient, and the draws ``jax.random.choice`` makes
    from that iterate (``sagrow.py:27-28``)."""
    out = {}
    for name, (n, sp) in SAGROW_CASES.items():
        a, b, Cx, Cy, _ = _data(n, seed=n)
        ja, jb, jCx, jCy = (jnp.asarray(x) for x in (a, b, Cx, Cy))
        value, T_final = j_sagrow.sagrow(KEY, ja, jb, jCx, jCy, sp,
                                         **SAGROW_ITERS)
        keys = jax.random.split(KEY, SAGROW_ITERS["outer_iters"] + 1)
        T = ja[:, None] * jb[None, :]
        steps = []
        for i, k in enumerate(keys):
            probs = (T / jnp.sum(T)).reshape(-1)
            flat = np.asarray(jax.random.choice(k, n * n, (sp,), p=probs))
            M = j_sagrow._sampled_gradient(k, jCx, jCy, T, sp, "l2")
            steps.append((np.asarray(T), np.asarray(M), (flat // n,
                                                         flat % n)))
            if i < SAGROW_ITERS["outer_iters"]:
                K = jnp.exp(-(M - jnp.min(M)) / SAGROW_ITERS["epsilon"]) * T
                T = j_sinkhorn.sinkhorn(ja, jb, K,
                                        SAGROW_ITERS["inner_iters"])
        out[name] = ((a, b, Cx, Cy), float(value), np.asarray(T_final),
                     steps)
    return out


@pytest.mark.parametrize("name", sorted(SAGROW_CASES))
def test_sagrow_gradients_match_reference(name, ref_sagrow):
    (a, b, Cx, Cy), _, _, steps = ref_sagrow[name]
    sp = SAGROW_CASES[name][1]
    for T, M, draws in steps:
        got = sagrow._sampled_gradient(None, _t(Cx), _t(Cy), _t(T), sp,
                                       "l2", draws=draws)
        np.testing.assert_allclose(got.numpy(), M, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", sorted(SAGROW_CASES))
def test_sagrow_matches_reference(name, ref_sagrow):
    (a, b, Cx, Cy), value, T_final, steps = ref_sagrow[name]
    sp = SAGROW_CASES[name][1]
    got, T = sagrow.sagrow(None, a, b, Cx, Cy, sp, draws=[d for *_, d in
                                                           steps],
                           device="cpu", **SAGROW_ITERS)
    np.testing.assert_allclose(float(got), value, rtol=VALUE_RTOL)
    np.testing.assert_allclose(T.numpy(), T_final, rtol=VALS_RTOL,
                               atol=VALS_ATOL)
    # the proximal kernel underflows: the flush rule is exercised
    assert (T_final == 0).any() and (T.numpy() == 0).any()


def test_sagrow_draws_from_its_generator():
    a, b, Cx, Cy, _ = _data(16, seed=1)
    v1, T1 = sagrow.sagrow(_gen(), a, b, Cx, Cy, 32, device="cpu",
                           outer_iters=3, inner_iters=10)
    v2, T2 = sagrow.sagrow(_gen(), a, b, Cx, Cy, 32, device="cpu",
                           outer_iters=3, inner_iters=10)
    assert torch.equal(v1, v2) and torch.equal(T1, T2)
    assert torch.isfinite(v1) and bool(torch.isfinite(T1).all())
    with pytest.raises(ValueError, match="outer_iters"):
        sagrow.sagrow(None, a, b, Cx, Cy, 32, draws=[], device="cpu",
                      outer_iters=3)


# ---------------------------------------------------------------------------
# the GW alignment loss
# ---------------------------------------------------------------------------

# the loss's defaults, and the same with ε = 0.5. At the defaults the
# unrolled loop is ill-conditioned in float32: Sinkhorn on exp(-C/0.05)
# for relations up to ~4 (kernel entries flushed below 1e-38) amplifies
# each rounding by max|C|/ε, and the two float32 gradients part by up to
# 6.7e-4 of the largest entry while the float64 gradient (with float32's
# flush) lies between them: 4.1e-4 from the reference's, 1.2e-4 from the
# port's on one example, 4.6e-5 and 1.1e-4 on the other. So the defaults
# hold both float32 sides to that float64 run at the bound :func:`_unrolled_bound`
# derives, and ε = 0.5 holds the port to jax.grad at 1e-4.
ALIGN_CASES = {"defaults": dict(s_r=8, s_c=6),
               "eps_0.5": dict(s_r=8, s_c=6, epsilon=0.5)}


def _unrolled_bound(case, C_max):
    """Relative bound of a float32 unrolled value or gradient against the
    float64 run: each of the outer x inner scaling passes rounds its
    sums of s_r + s_c terms, and the kernel exp(-C/ε) multiplies the
    cost's rounding by max|C|/ε, once an outer step."""
    outer, inner = case.get("outer_iters", 3), case.get("inner_iters", 10)
    eps = case.get("epsilon", 0.05)
    return outer * (inner + C_max / eps) * (case["s_r"] + case["s_c"]) \
        * 2.0**-24


@pytest.fixture(scope="module")
def align_case():
    """Hidden states, the reference's draws, and per case the reference's
    value and jax.grad in float32."""
    rng = np.random.default_rng(11)
    B, S = 2, 24
    hx = rng.standard_normal((B, S, 16)).astype(np.float32)
    hy = rng.standard_normal((B, S, 12)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    refs = {}
    for name, case in ALIGN_CASES.items():
        def loss(x, y, case=case):
            return j_align.gw_alignment_loss(key, x, y, **case)

        val, (gx, gy) = jax.value_and_grad(loss, argnums=(0, 1))(
            jnp.asarray(hx), jnp.asarray(hy))
        refs[name] = (float(val), (np.asarray(gx), np.asarray(gy)))
    R, C = [], []          # the reference's per-example split / randint
    for k in jax.random.split(key, B):
        kr, kc = jax.random.split(k)
        R.append(np.asarray(jax.random.randint(kr, (8,), 0, S)))
        C.append(np.asarray(jax.random.randint(kc, (6,), 0, S)))
    return hx, hy, (np.stack(R), np.stack(C)), refs


def _port_align(hx, hy, draws, case, dtype=torch.float32):
    x = torch.tensor(hx, dtype=dtype, requires_grad=True)
    y = torch.tensor(hy, dtype=dtype, requires_grad=True)
    val = align.gw_alignment_loss(None, x, y, draws=draws, **case)
    val.backward()
    return float(val), (x.grad.double().numpy(), y.grad.double().numpy())


def test_pairwise_sq_dists_matches_reference():
    h = np.random.default_rng(2).standard_normal((9, 5)).astype(np.float32)
    np.testing.assert_allclose(align._pairwise_sq_dists(_t(h)).numpy(),
                               np.asarray(j_align._pairwise_sq_dists(
                                   jnp.asarray(h))), rtol=1e-5, atol=1e-5)


def test_gw_alignment_loss_matches_jax_grad(align_case):
    hx, hy, draws, refs = align_case
    val, grads = _port_align(hx, hy, draws, ALIGN_CASES["eps_0.5"])
    rval, rgrads = refs["eps_0.5"]
    np.testing.assert_allclose(val, rval, rtol=VALUE_RTOL)
    for got, want in zip(grads, rgrads):
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(got - want).max() <= GRAD_REL * scale


def _ref_align_x64(hx, hy, draws, case):
    """The reference's loss and ``jax.grad`` in float64 on ``draws``: the
    per-example body of ``repro.core.align.gw_alignment_loss`` over the
    reference's own ``_pairwise_sq_dists`` and
    ``grid_spar_gw_differentiable`` (the jitted loss draws its own indices,
    and under x64 ``randint`` draws others)."""
    from repro.core.grid_gw import grid_spar_gw_differentiable as j_diff

    s_r, s_c = case["s_r"], case["s_c"]
    with jax.enable_x64(True):
        def loss(x, y):
            vals = []
            for hx_b, hy_b, R, C in zip(x, y, *draws):
                hxn = hx_b / (jnp.linalg.norm(hx_b, axis=-1,
                                              keepdims=True) + 1e-6)
                hyn = hy_b / (jnp.linalg.norm(hy_b, axis=-1,
                                              keepdims=True) + 1e-6)
                aR, bC = jnp.full((s_r,), 1.0 / s_r), jnp.full((s_c,),
                                                               1.0 / s_c)
                val, _ = j_diff(aR, bC, j_align._pairwise_sq_dists(hxn[R]),
                                j_align._pairwise_sq_dists(hyn[C]), aR, bC,
                                jnp.ones((s_r, s_c)), "l2",
                                case.get("epsilon", 0.05),
                                case.get("outer_iters", 3),
                                case.get("inner_iters", 10))
                vals.append(val)
            return jnp.mean(jnp.stack(vals))

        val, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
            jnp.asarray(hx, jnp.float64), jnp.asarray(hy, jnp.float64))
        return float(val), tuple(np.asarray(g) for g in grads)


def test_gw_alignment_loss_at_defaults_within_float32_reach(align_case):
    """Both float32 sides against two float64 witnesses: the port's own
    run, whose flush helpers flush at float32's smallest normal as XLA
    does in float32, and the reference's run in x64 on the same draws."""
    hx, hy, draws, refs = align_case
    case = ALIGN_CASES["defaults"]
    witnesses = (_port_align(hx, hy, draws, case, torch.float64),
                 _ref_align_x64(hx, hy, draws, case))
    bound = _unrolled_bound(case, C_max=4.0)   # unit tokens: |C| <= 4
    port = _port_align(hx, hy, draws, case)
    for v64, g64 in witnesses:
        for val, grads in (port, refs["defaults"]):
            assert abs(val - v64) <= bound * abs(v64)
            for got, want in zip(grads, g64):
                assert np.abs(got - want).max() <= bound * np.abs(want).max()
    # and directly, each side's bound from the other
    np.testing.assert_allclose(port[0], refs["defaults"][0], rtol=2 * bound)


def test_gw_alignment_loss_draws_from_its_generator(align_case):
    hx, hy, *_ = align_case
    v1 = align.gw_alignment_loss(_gen(), _t(hx), _t(hy))
    v2 = align.gw_alignment_loss(_gen(), _t(hx), _t(hy))
    assert torch.equal(v1, v2) and torch.isfinite(v1)


# ---------------------------------------------------------------------------
# the dispatch leftovers (tests/test_spar_cost_kernel.py:168-195)
# ---------------------------------------------------------------------------

def test_block_size_resolution_order(monkeypatch):
    dispatch.register("_test_family", default_block=64)
    assert dispatch.block_size("_test_family") == 64
    monkeypatch.setenv("REPRO_BLOCK__TEST_FAMILY", "16")
    assert dispatch.block_size("_test_family") == 16
    assert dispatch.block_size("_test_family", override=8) == 8
    assert dispatch.block_size("_test_family", cap=4) == 4


def test_core_exports_the_reference_names():
    import repro.core
    want = {n for n in dir(repro.core) if not n.startswith("_")} - {
        "align", "emd", "grid_gw", "ground_cost", "gw", "sagrow",
        "sampling", "sinkhorn", "spar_gw", "spar_ugw", "utils",
        "sharded_gw"}
    have = set(dir(repro_torch.core))
    assert want <= have, want - have


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b, Cx, Cy, M = _data()
    core = repro_torch.core
    calls = [lambda: core.spar_gw(_gen(), a, b, Cx, Cy, s=2 * N),
             lambda: core.spar_fgw(_gen(), a, b, Cx, Cy, M, s=2 * N),
             lambda: core.spar_ugw(_gen(), a, b, Cx, Cy, s=2 * N),
             lambda: core.gw_dense(a, b, Cx, Cy),
             lambda: core.ugw_dense(a, b, Cx, Cy),
             lambda: core.grid_spar_gw(_gen(), a, b, Cx, Cy, s_r=4, s_c=4),
             lambda: sagrow.sagrow(_gen(), a, b, Cx, Cy, 32),
             lambda: emd.emd_gw(a, b, Cx, Cy)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
