"""Unbalanced SPAR-GW (Alg. 3) in the port against the JAX reference, CPU.

Pieces first: the quadratic and generalized KL, the four unbalanced
Sinkhorn loops (dense and sparse, plain and log domain), eq. (9)'s
sampling probability and the 2-D sampler; then ``SparGWSolver`` on an
unbalanced Moon pair (the second marginal times 1.5, λ = 1) against
``repro.solve`` on the reference's sampled support, for l1, l2 and kl
under both cost impls.

Tolerances, and why:
* KL values: rtol 1e-5 — fp32 sums of 40 terms on each side in another
  order, and the log term cancels against the masses (seen: 1.1e-6).
* Sinkhorn couplings, probabilities: rtol 1e-5, atol 1e-7, as in
  tests/test_torch_sinkhorn.py (same fp32 algorithm, other summation
  order, the last ulp of exp/log/pow carried through the iterations).
* Whole solves: the bounds of tests/test_torch_solve.py (value rtol 1e-5;
  vals atol 1e-6 + rtol 1e-4; errors atol 5e-5; status and iteration
  counts exact). Seen: value rel <= 1.2e-6, vals abs <= 1.7e-7.
* Sampler frequencies: 5 standard errors of each cell's (or row's, or
  col's) frequency, sqrt(p (1 - p) / draws).

Each group has a case where values underflow float32's smallest normal,
which XLA flushes to zero and the port flushes explicitly
(repro_torch/core/utils.py).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import sampling as jsampling
from repro.core import utils as jutils
from repro_torch.api import interop
from repro_torch.core import sampling
from repro_torch.core import sinkhorn as sk
from repro_torch.core import utils
from test_torch_solve import _assert_parity, _moon
from test_torch_solve import _one_torch_thread  # noqa: F401 (autouse)

# the module (repro.core re-exports a function of the same name)
jsk = importlib.import_module("repro.core.sinkhorn")

KL_RTOL = 1e-5
RTOL, ATOL = 1e-5, 1e-7
TINY = np.float32(1e-40)          # subnormal: XLA reads it as 0


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# -- KL divergences -----------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "zeros", "subnormal"])
@pytest.mark.parametrize("name", ["quadratic_kl", "generalized_kl"])
def test_kl_matches_reference(name, case):
    rng = np.random.default_rng(0)
    p = rng.random(40).astype(np.float32)
    q = (rng.random(40) + 0.05).astype(np.float32)
    if case == "zeros":
        p[::5] = 0.0
    elif case == "subnormal":
        p[::4] = TINY
        q[1::4] = TINY
    want = float(getattr(jutils, name)(jnp.asarray(p), jnp.asarray(q)))
    got = float(getattr(utils, name)(_t(p), _t(q)))
    np.testing.assert_allclose(got, want, rtol=KL_RTOL)


# -- the four unbalanced Sinkhorn loops ---------------------------------------

def _marginals(m, n, seed, tiny=False):
    rng = np.random.default_rng(seed)
    a = (rng.random(m) + 0.1).astype(np.float32)
    b = (1.5 * (rng.random(n) + 0.1)).astype(np.float32)
    a, b = a / a.sum(), b / b.sum() * 1.5
    if tiny:
        a[0], b[3] = TINY, TINY
    return a, b


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("tol", [0.0, 1e-6])
@pytest.mark.parametrize("log", [False, True])
def test_dense_unbalanced_sinkhorn_matches_reference(log, tol, tiny):
    m, n, lam, eps = 23, 17, 1.0, 0.05
    a, b = _marginals(m, n, 1, tiny)
    C = np.random.default_rng(2).random((m, n)).astype(np.float32)
    if log:
        logK = -C / eps
        want = jsk.sinkhorn_unbalanced_log(jnp.asarray(a), jnp.asarray(b),
                                           jnp.asarray(logK), lam, eps, 50,
                                           tol=tol)
        got = sk.sinkhorn_unbalanced_log(_t(a), _t(b), _t(logK), lam, eps,
                                         50, tol=tol)
    else:
        K = np.exp(-C / eps).astype(np.float32)
        if tiny:
            K[:, 2] = TINY                   # subnormal kernel column
        want = jsk.sinkhorn_unbalanced(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(K), lam, eps, 50, tol=tol)
        got = sk.sinkhorn_unbalanced(_t(a), _t(b), _t(K), lam, eps, 50,
                                     tol=tol)
    _close(got, want)


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("log", [False, True])
def test_sparse_unbalanced_sinkhorn_matches_reference(log, tiny):
    m, n, s, lam, eps = 31, 29, 300, 0.7, 0.05
    a, b = _marginals(m, n, 3, tiny)
    rng = np.random.default_rng(4)
    rows = rng.integers(0, m - 2, s)         # the last two rows: no support
    cols = rng.integers(0, n, s)
    C = rng.random(s).astype(np.float32)
    args_j = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(rows),
              jnp.asarray(cols))
    args_t = (_t(a), _t(b), _t(rows), _t(cols))
    if log:
        vals = -C / eps
        want = jsk.sparse_sinkhorn_unbalanced_log(
            *args_j, jnp.asarray(vals), lam, eps, m, n, 50)
        got = sk.sparse_sinkhorn_unbalanced_log(*args_t, _t(vals), lam, eps,
                                                m, n, 50)
    else:
        vals = np.exp(-C / eps).astype(np.float32)
        if tiny:
            vals[:20] = TINY
        want = jsk.sparse_sinkhorn_unbalanced(*args_j, jnp.asarray(vals),
                                              lam, eps, m, n, 50)
        got = sk.sparse_sinkhorn_unbalanced(*args_t, _t(vals), lam, eps, m,
                                            n, 50)
    _close(got, want)


# -- eq. (9) and the 2-D sampler ----------------------------------------------

@pytest.mark.parametrize("case", ["plain", "shrink", "extreme_logk",
                                  "underflow"])
def test_unbalanced_probs_match_reference(case):
    n = 10
    a, b = _marginals(n, n, 5)
    logK = -np.random.default_rng(6).random((n, n)).astype(np.float32) / 0.1
    shrink = 0.2 if case == "shrink" else 0.0
    if case == "extreme_logk":       # tests/test_sampling.py's range
        a = b = np.full(n, 1.0 / n, np.float32)
        logK = np.linspace(-500.0, 0.0, n * n, dtype=np.float32).reshape(n, n)
    elif case == "underflow":        # a_i b_j below the smallest normal
        a[:3] = 1e-20
        b[:2] = 1e-20
    want = np.asarray(jsampling.unbalanced_probs(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(logK), 1.0, 1e-2, shrink))
    got = sampling.unbalanced_probs(_t(a), _t(b), _t(logK), 1.0, 1e-2,
                                    shrink).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-5)
    _close(got, want)
    if case == "underflow":
        assert np.all(got[:3, :2] == 0.0) and np.all(want[:3, :2] == 0.0)


def _assert_frequencies(rows, cols, P, draws):
    """Each cell's frequency within 5 standard errors of its probability."""
    freq = np.zeros(P.shape)
    np.add.at(freq, (rows, cols), 1.0 / draws)
    se = np.sqrt(P * (1 - P) / draws)
    assert np.all(np.abs(freq - P) <= 5 * se + 1e-12)


def test_sample_pairs_2d_frequencies():
    P = np.arange(1.0, 36.0).reshape(5, 7)
    P[2, :] = 0.0                            # a zero row is never drawn
    P[:, 4] = 0.0
    P = P / P.sum()
    draws = 200_000
    rows, cols = sampling.sample_pairs_2d(torch.Generator().manual_seed(0),
                                          _t(P.astype(np.float32)), draws)
    assert rows.dtype == torch.int64 and rows.shape == (draws,)
    _assert_frequencies(rows.numpy(), cols.numpy(), P, draws)


def test_sample_pairs_2d_past_multinomial_cap():
    """m·n = 4097² > 2²⁴ categories, where torch.multinomial refuses."""
    m = n = 4097
    assert m * n > 2 ** 24
    P = np.zeros((m, n), np.float32)
    cells = [(0, 0, 0.1), (2048, 17, 0.2), (4096, 0, 0.3), (4096, 4096, 0.4)]
    for i, j, p in cells:
        P[i, j] = p
    draws = 100_000
    rows, cols = sampling.sample_pairs_2d(torch.Generator().manual_seed(1),
                                          _t(P), draws)
    rows, cols = rows.numpy(), cols.numpy()
    drawn = set(zip(rows.tolist(), cols.tolist()))
    assert drawn == {(i, j) for i, j, _ in cells}
    for i, j, p in cells:
        freq = np.mean((rows == i) & (cols == j))
        assert abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / draws)
    # a dense P past the cap: row and col frequencies
    Q = np.random.default_rng(2).random((m, n)).astype(np.float32)
    Q[:, :100] *= 20.0
    Q /= Q.sum(dtype=np.float64)
    rows, cols = sampling.sample_pairs_2d(torch.Generator().manual_seed(3),
                                          _t(Q), draws)
    for idx, marg in ((rows.numpy(), Q.sum(1, dtype=np.float64)),
                      (cols.numpy(), Q.sum(0, dtype=np.float64))):
        # 64 bins of consecutive indices keep every bin's count large
        bins = np.arange(len(marg)) * 64 // len(marg)
        p_bin = np.bincount(bins, weights=marg, minlength=64)
        freq = np.bincount(bins[idx], minlength=64) / draws
        assert np.all(np.abs(freq - p_bin)
                      <= 5 * np.sqrt(p_bin * (1 - p_bin) / draws))


def test_poisson_mask_keeps_min_one_sp():
    p = _t(np.array([0.5, 0.2, 0.01, 0.0], np.float32))
    draws = 20_000
    gen = torch.Generator().manual_seed(4)
    keep = torch.stack([sampling.poisson_mask(gen, p, 3)[0]
                        for _ in range(draws)]).double().mean(0).numpy()
    want = np.minimum(1.0, 3 * p.numpy())
    assert np.all(np.abs(keep - want)
                  <= 5 * np.sqrt(want * (1 - want) / draws) + 1e-12)


# -- whole unbalanced solves --------------------------------------------------

@pytest.fixture(scope="module")
def moon48():
    Cx, a, Cy, b = _moon(48)
    return Cx, a, Cy, (1.5 * b).astype(np.float32)


def _run_both(data, loss, lam=1.0, **fields):
    Cx, a, Cy, b = data
    js = repro.SparGWSolver(s=16 * len(a), **fields)
    jp = repro.QuadraticProblem(repro.Geometry(jnp.asarray(Cx), jnp.asarray(a)),
                                repro.Geometry(jnp.asarray(Cy), jnp.asarray(b)),
                                loss=loss, lam=lam)
    jo = repro.solve(jp, js, key=jax.random.PRNGKey(0))
    po = repro_torch.solve(
        interop.to_problem(Cx, a, Cy, b, loss, lam=lam),
        interop.to_solver({f.name: getattr(js, f.name)
                           for f in dataclasses.fields(js)}),
        support=interop.to_support(jo.coupling.rows, jo.coupling.cols),
        device="cpu")
    return jo, interop.output_to_numpy(po)


@pytest.mark.parametrize("cost_impl", ["materialized", "pallas"])
@pytest.mark.parametrize("loss", ["l1", "l2", "kl"])
def test_unbalanced_solve_matches_reference(moon48, loss, cost_impl):
    jo, P = _run_both(moon48, loss, cost_impl=cost_impl)
    assert int(jo.status.code) == repro.health.MAXITER
    _assert_parity(jo, P)


def test_unbalanced_tolerance_stops_like_reference(moon48):
    jo, P = _run_both(moon48, "l2", lam=0.5, tol=1e-3, inner_tol=1e-4)
    assert bool(jo.converged) and int(jo.n_iters) < 20
    _assert_parity(jo, P)


def test_unbalanced_underflow_matches_reference():
    """Marginal entries at 1e-20: the init products a_i b_j / scale and
    the sampling weights a_i b_j fall below the smallest normal, and
    ``shrink`` makes such pairs drawable."""
    Cx, a, Cy, b = _moon(48, seed=3)
    a, b = a.copy(), (1.5 * b).astype(np.float32)
    a[:4] = 1e-20
    b[-4:] = 1e-20
    jo, P = _run_both((Cx, a, Cy, b), "l2", shrink=0.3)
    rows, cols = np.asarray(jo.coupling.rows), np.asarray(jo.coupling.cols)
    assert np.any((rows < 4) & (cols >= 44))
    _assert_parity(jo, P)


def test_unbalanced_own_draw_is_healthy(moon48):
    Cx, a, Cy, b = moon48
    p = interop.to_problem(Cx, a, Cy, b, lam=1.0)
    out = repro_torch.solve(p, repro_torch.SparGWSolver(s=16 * 48),
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert out.status.is_healthy and np.isfinite(float(out.value))
    assert out.coupling.vals.shape == (16 * 48,)
