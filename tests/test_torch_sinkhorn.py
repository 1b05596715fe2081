"""Parity of the port's sparse and dense Sinkhorn with the JAX reference, CPU.

Tolerance: rtol 1e-5, atol 1e-7 on couplings, potentials and segment
reductions. Both sides run fp32 with the same algorithm; they differ in
the order of the segment sums (XLA scatter vs ``index_add_``) or of the
dense matvecs, and in the last ulp of exp/log, which the scaling
iterations carry along.

The subnormal cases hold the port to the reference where XLA's flush of
float32 subnormals changes a result (see repro_torch/core/utils.py):
a zero or subnormal marginal entry, subnormal kernel values, and a
coupling with subnormal entries entering the proximal log, for the sparse
and the dense loops.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import solvers as jsolvers
from repro.kernels.spar_cost.ops import make_spar_cost_fn as j_cost_fn
from repro_torch.api import solvers
from repro_torch.core import sinkhorn as sk
from repro_torch.core.utils import FLT_MIN
from repro_torch.kernels.spar_cost.ops import make_spar_cost_fn

# the module (repro.core re-exports a function of the same name)
jsk = importlib.import_module("repro.core.sinkhorn")

RTOL, ATOL = 1e-5, 1e-7


def _coo(m, n, s, seed, live_rows=None):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, live_rows or m, s)     # rows >= live_rows: empty
    cols = rng.integers(0, n, s)
    a = rng.random(m).astype(np.float32) + 0.1
    b = rng.random(n).astype(np.float32) + 0.1
    a, b = a / a.sum(), b / b.sum()
    return a, b, rows, cols, rng


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_segment_logsumexp_with_empty_segments():
    rng = np.random.default_rng(0)
    segs = rng.integers(0, 7, 50)                 # segments 7..9 are empty
    vals = (3 * rng.standard_normal(50)).astype(np.float32)
    vals[:5] = -np.inf                            # -inf entries are skipped
    want = jsk.segment_logsumexp(jnp.asarray(vals), jnp.asarray(segs), 10)
    got = sk.segment_logsumexp(torch.from_numpy(vals), torch.from_numpy(segs),
                               10)
    assert np.all(got.numpy()[7:] == -1e30)
    _close(got, want)


def test_coo_matvec_matches_reference():
    a, b, rows, cols, rng = _coo(9, 6, 40, seed=1)
    vals = rng.random(40).astype(np.float32)
    x = rng.random(6).astype(np.float32)
    want = jsk.coo_matvec(jnp.asarray(rows), jnp.asarray(cols),
                          jnp.asarray(vals), jnp.asarray(x), 9)
    got = sk.coo_matvec(torch.from_numpy(rows), torch.from_numpy(cols),
                        torch.from_numpy(vals), torch.from_numpy(x), 9)
    _close(got, want)


def _both(fn_name, a, b, rows, cols, vals, m, n, iters, tol):
    want = getattr(jsk, fn_name)(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(rows), jnp.asarray(cols),
                                 jnp.asarray(vals), m=m, n=n, iters=iters,
                                 tol=tol)
    got = getattr(sk, fn_name)(torch.from_numpy(a), torch.from_numpy(b),
                               torch.from_numpy(rows), torch.from_numpy(cols),
                               torch.from_numpy(vals), m, n, iters, tol)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("tol", [0.0, 1e-4])
def test_logdomain_matches_reference(tol):
    m, n, s = 20, 15, 160
    a, b, rows, cols, rng = _coo(m, n, s, seed=2, live_rows=17)
    logvals = (2 * rng.standard_normal(s)).astype(np.float32)
    want, got = _both("sparse_sinkhorn_logdomain", a, b, rows, cols, logvals,
                      m, n, 50, tol)
    _close(got, want)


@pytest.mark.parametrize("tol", [0.0, 1e-4])
def test_plain_matches_reference(tol):
    m, n, s = 20, 15, 160
    a, b, rows, cols, rng = _coo(m, n, s, seed=3, live_rows=18)
    vals = np.exp(-2 * rng.random(s)).astype(np.float32)
    want, got = _both("sparse_sinkhorn", a, b, rows, cols, vals, m, n, 50,
                      tol)
    _close(got, want)


def test_tol_stops_early_like_reference():
    """A loose tolerance stops long before the budget, at the same point."""
    m, n, s = 12, 10, 90
    a, b, rows, cols, rng = _coo(m, n, s, seed=4)
    logvals = rng.standard_normal(s).astype(np.float32)
    full, _ = _both("sparse_sinkhorn_logdomain", a, b, rows, cols, logvals,
                    m, n, 500, 0.0)
    want, got = _both("sparse_sinkhorn_logdomain", a, b, rows, cols, logvals,
                      m, n, 500, 1e-2)
    assert np.max(np.abs(want - full)) > 1e-6      # it did stop early
    _close(got, want)


def test_subnormal_marginal_entries_follow_reference_flush():
    """a_0 subnormal and a_1 zero, both in the support: XLA's log floor is
    -inf for both, ``_finite`` zeroes their potentials and the rows keep
    full kernel mass. Without the flush the port would give them ~0 mass."""
    m, n, s = 10, 8, 80
    a, b, rows, cols, rng = _coo(m, n, s, seed=5)
    a[0], a[1] = np.float32(1e-40), 0.0
    rows[:4] = [0, 0, 1, 1]
    logvals = rng.standard_normal(s).astype(np.float32)
    want, got = _both("sparse_sinkhorn_logdomain", a, b, rows, cols, logvals,
                      m, n, 30, 0.0)
    assert want[:4].min() > 1e-3                   # the reference's mass
    _close(got, want)


def test_subnormal_kernel_values_follow_reference_flush():
    """Plain domain with kernel values and products below the smallest
    normal: the reference treats them as 0 in every sum, ratio and test."""
    m, n, s = 10, 8, 80
    a, b, rows, cols, rng = _coo(m, n, s, seed=6)
    vals = np.exp(-rng.uniform(0, 100, s)).astype(np.float32)
    rows[rows == 0] = 1
    rows[:3], vals[:3] = 0, [1e-40, 5e-39, 1e-45]  # row 0: only subnormals
    rows[3:6], vals[3:6] = 2, [1e-30, 1e-20, 1e-19]
    want, got = _both("sparse_sinkhorn", a, b, rows, cols, vals, m, n, 20,
                      0.0)
    assert np.all(want[:3] == 0.0)                 # row 0 is dead there
    _close(got, want)


@pytest.mark.parametrize("stable", [True, False])
def test_prox_step_with_subnormal_coupling_entries(stable):
    """One outer PGA step from a T with entries below the smallest normal:
    log(max(T, 1e-38)) is -inf there in the reference, so those entries
    stay dead; the port's flush-aware log reproduces that."""
    m, n, s = 12, 9, 100
    a, b, rows, cols, rng = _coo(m, n, s, seed=7)
    Cx = rng.random((m, m)).astype(np.float32)
    Cy = rng.random((n, n)).astype(np.float32)
    T = (rng.random(s) / s).astype(np.float32)
    T[:5] = [1e-40, 1e-39, 1.1e-38, 0.0, 1e-45]
    w = (1.0 + rng.random(s)).astype(np.float32)
    kw = dict(m=m, n=n, epsilon=0.05, inner_iters=30, inner_tol=0.0,
              reg="prox", stable=stable)
    J = [jnp.asarray(x) for x in (a, b, rows, cols, w)]
    want = jsolvers._spar_pga_step(
        jnp.asarray(T), jnp.float32(1.0),
        j_cost_fn(jnp.asarray(Cx), jnp.asarray(Cy), J[2], J[3], "l2"),
        J[0], J[1], J[2], J[3], J[4], jnp.log(J[4]), **kw)
    P = [torch.from_numpy(x) for x in (a, b, rows, cols, w)]
    got = solvers._spar_pga_step(
        torch.from_numpy(T), 1.0,
        make_spar_cost_fn(torch.from_numpy(Cx), torch.from_numpy(Cy), P[2],
                          P[3], "l2"),
        P[0], P[1], P[2], P[3], P[4], torch.log(P[4]), **kw)
    want = np.asarray(want)
    assert np.all(want[:5] == 0.0)
    assert np.all(got.numpy()[:5] == 0.0)
    assert not np.any((got.numpy() != 0) & (np.abs(got.numpy()) < FLT_MIN))
    _close(got, want)


# ---------------------------------------------------------------------------
# Dense loops (the grid path's s_r x s_c block)
# ---------------------------------------------------------------------------

def _dense(m, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.random(m).astype(np.float32) + 0.1
    b = rng.random(n).astype(np.float32) + 0.1
    return a / a.sum(), b / b.sum(), rng


def _both_dense(fn_name, a, b, K, iters, tol):
    want = getattr(jsk, fn_name)(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(K), iters, tol=tol)
    got = getattr(sk, fn_name)(torch.from_numpy(a), torch.from_numpy(b),
                               torch.from_numpy(K), iters, tol=tol)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("tol", [0.0, 1e-4])
def test_dense_plain_matches_reference(tol):
    a, b, rng = _dense(17, 13, seed=8)
    K = np.exp(-3 * rng.random((17, 13))).astype(np.float32)
    want, got = _both_dense("sinkhorn", a, b, K, 50, tol)
    _close(got, want)


@pytest.mark.parametrize("tol", [0.0, 1e-4])
def test_dense_log_matches_reference(tol):
    a, b, rng = _dense(17, 13, seed=9)
    logK = (3 * rng.standard_normal((17, 13))).astype(np.float32)
    logK[4, :] = -np.inf                          # a row with no support
    want, got = _both_dense("sinkhorn_log", a, b, logK, 50, tol)
    _close(got, want)


def test_dense_tol_stops_early_like_reference():
    a, b, rng = _dense(12, 10, seed=10)
    logK = rng.standard_normal((12, 10)).astype(np.float32)
    full, _ = _both_dense("sinkhorn_log", a, b, logK, 500, 0.0)
    want, got = _both_dense("sinkhorn_log", a, b, logK, 500, 1e-2)
    assert np.max(np.abs(want - full)) > 1e-6      # it did stop early
    _close(got, want)


@pytest.mark.parametrize("fn_name", ["sinkhorn", "sinkhorn_log"])
def test_dense_zero_and_subnormal_marginal_entries(fn_name):
    """a_0 subnormal and a_1 zero: the reference's flush makes both 0, so
    the plain loop gives their rows scaling 0 and the log loop's log floor
    is -inf there (potential clamped to 0: full kernel mass)."""
    a, b, rng = _dense(10, 8, seed=11)
    a[0], a[1] = np.float32(1e-40), 0.0
    K = rng.random((10, 8)).astype(np.float32) + 0.1
    if fn_name == "sinkhorn_log":
        K = np.log(K)
    want, got = _both_dense(fn_name, a, b, K, 30, 0.0)
    if fn_name == "sinkhorn":
        assert np.all(want[:2] == 0.0)
    else:
        assert want[:2].min() > 1e-3
    _close(got, want)


def test_dense_subnormal_kernel_entries_follow_reference_flush():
    """Kernel entries and products below the smallest normal count as 0 in
    every matvec, ratio and test; a row of only subnormals is dead."""
    a, b, rng = _dense(10, 8, seed=12)
    K = np.exp(-rng.uniform(0, 100, (10, 8))).astype(np.float32)
    K[0] = [1e-40, 5e-39, 1e-45, 1e-39, 2e-39, 1e-42, 3e-39, 1e-41]
    K[2, :3] = [1e-30, 1e-20, 1e-19]
    want, got = _both_dense("sinkhorn", a, b, K, 20, 0.0)
    assert np.all(want[0] == 0.0)
    assert not np.any((got != 0) & (np.abs(got) < FLT_MIN))
    _close(got, want)


@pytest.mark.parametrize("fn_name", ["sinkhorn", "sinkhorn_log"])
def test_dense_differentiable_refuses_tol_like_reference(fn_name):
    a, b, _ = _dense(4, 3, seed=13)
    K = np.ones((4, 3), np.float32)
    with pytest.raises(ValueError, match="differentiable"):
        getattr(jsk, fn_name)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(K),
                              5, differentiable=True, tol=1e-3)
    with pytest.raises(ValueError, match="differentiable"):
        getattr(sk, fn_name)(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(K), 5, differentiable=True,
                             tol=1e-3)
    got = getattr(sk, fn_name)(torch.from_numpy(a), torch.from_numpy(b),
                               torch.from_numpy(K), 5, differentiable=True)
    want = getattr(jsk, fn_name)(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(K), 5, differentiable=True)
    _close(got, want)
