"""The sparse log-domain Sinkhorn half-step kernel (K7) on the card,
against its plain version (core/sinkhorn.py's body) on the card.

Marked ``cuda``: every test skips, with the reason, where there is no
CUDA card (a CUDA kernel has no CPU mode). On the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sparse_sinkhorn_cuda.py

Tolerance of the potentials after H half-steps, kernel against plain:
H · (2 (k - 1) 2⁻²⁴ + 2⁻²³ max|plain|), k the longest segment. The two
take the same maximum and the same exp and log of each entry (expf and
logf on both sides) and differ only in the order of each segment's sum:
the plain version's ``index_add_`` adds in the order its atomics land. Two
orders of k terms differ by at most 2 (k - 1) 2⁻²⁴ of the sum, so a
segment's logsumexp by at most that; the potential's own rounding adds an
ulp; and a half-step carries the other potential's difference along
without amplifying it (a logsumexp moves by at most the largest shift of
its terms), so the differences add up at most once per half-step. With
the unbalanced exponent ρ ≤ 1 a half-step rounds twice (the difference,
then ρ times it) and shrinks what it carries by ρ, so the bound takes two
ulps a half-step where it took one.

The lanes of a flush are bitwise their single-lane solves; the gradient
through ``_spar_pga_step`` on the card (K1's and K7's functions) matches
the plain path's on the CPU within 1e-4 of its largest entry, the
tolerance of the port's gradient tests.
"""
import importlib

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import obs
from repro_torch.api import interop
from repro_torch.api.solvers import SparGWSolver
from repro_torch.core.utils import log_floor
from repro_torch.diff import unrolled_value
from repro_torch.kernels.sparse_sinkhorn import ops, sparse_sinkhorn
from test_torch_sparse_sinkhorn_kernel import _plain_body

sk = importlib.import_module("repro_torch.core.sinkhorn")

pytestmark = pytest.mark.cuda
U = 2.0 ** -24
GRAD_ATOL_REL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(B, m, n, s, seed, dev, empty=0):
    """B lanes of a main-path-like log-kernel: a uniformly sampled support
    (the last ``empty`` rows and columns left empty), -C/ε + log w with C
    in [0, 2], ε = 1e-2 and w = mn/s, uniform marginals."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m - empty, (B, s))
    cols = rng.integers(0, n - empty, (B, s))
    logvals = -rng.uniform(0, 2, (B, s)) / 1e-2 + np.log(m * n / s)
    a = np.full((B, m), 1.0 / m)
    b = np.full((B, n), 1.0 / n)

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=dev)
    return (t(a), t(b), t(rows, torch.int64), t(cols, torch.int64),
            t(logvals))


def _potentials(body, m, n, iters, dev):
    carry = (torch.zeros(m, device=dev), torch.zeros(n, device=dev))
    for _ in range(iters):
        carry = body(carry)
    torch.cuda.synchronize()
    return carry


def _bound(iters, rows, cols, plain, ulps=1):
    k = max(torch.bincount(rows).max().item(),
            torch.bincount(cols).max().item())
    top = max(x.abs().max().item() for x in plain)
    return 2 * iters * (2 * (k - 1) * U + 2 * U * top * ulps)


def _rho(dev):
    """ρ = λ/(λ+ε) of the unbalanced cell (λ = 1, ε = 1e-2), a float32
    tensor on the card, as the solver hands it to K7."""
    return torch.tensor(1.0, device=dev) / (1.0 + torch.tensor(1e-2,
                                                               device=dev))


@pytest.mark.parametrize("B,n,s", [(1, 8192, 131072), (8, 2048, 32768)])
def test_potentials_after_50_iterations_match_plain(dev, B, n, s):
    """The lib cell's shape (n = 8192, s = 131 072) and the served cell's
    flush (8 lanes of n = 2048, s = 32 768, as one segment space)."""
    a, b, rows, cols, logvals = _inputs(B, n, n, s, 0, dev)
    r, c = sk._lane_flat(rows, n), sk._lane_flat(cols, n)
    la, lb, lv = log_floor(a).reshape(-1), log_floor(b).reshape(-1), \
        logvals.reshape(-1)
    args = (la, lb, r, c, lv, B * n, B * n)
    got = _potentials(ops.logdomain_body(*args), B * n, B * n, 50, dev)
    want = _potentials(_plain_body(*args), B * n, B * n, 50, dev)
    bound = _bound(50, r, c, want)
    err = max((x - y).abs().max().item() for x, y in zip(got, want))
    print(f"B={B} n={n} s={s}: max |kernel - plain| {err:.3e}, "
          f"bound {bound:.3e}")
    assert err <= bound
    assert all(torch.isfinite(x).all() for x in got)


@pytest.mark.parametrize("B,n,s", [(1, 8192, 131072), (8, 2048, 32768)])
def test_unbalanced_potentials_after_50_iterations_match_plain(dev, B, n, s):
    """The same shapes through the unbalanced bodies, ρ on the card."""
    a, b, rows, cols, logvals = _inputs(B, n, n, s, 6, dev)
    r, c = sk._lane_flat(rows, n), sk._lane_flat(cols, n)
    la, lb, lv = log_floor(a).reshape(-1), log_floor(b).reshape(-1), \
        logvals.reshape(-1)
    args, rho = (la, lb, r, c, lv, B * n, B * n), _rho(dev)
    got = _potentials(ops.logdomain_body(*args, rho=rho), B * n, B * n, 50,
                      dev)
    want = _potentials(_plain_body(*args, rho), B * n, B * n, 50, dev)
    bound = _bound(50, r, c, want, ulps=2)
    err = max((x - y).abs().max().item() for x, y in zip(got, want))
    print(f"rho B={B} n={n} s={s}: max |kernel - plain| {err:.3e}, "
          f"bound {bound:.3e}")
    assert err <= bound
    assert all(torch.isfinite(x).all() for x in got)


@pytest.mark.parametrize("B,n,s", [(1, 8192, 131072), (8, 2048, 32768)])
def test_rho_one_launch_is_bitwise_the_balanced_launch(dev, B, n, s):
    """ρ = 1 multiplies exactly: a launch with it is the balanced launch
    bit for bit (outputs and logsumexps), and so are 50 iterations."""
    a, b, rows, cols, logvals = _inputs(B, n, n, s, 7, dev)
    r, c = sk._lane_flat(rows, n), sk._lane_flat(cols, n)
    la, lb, lv = log_floor(a).reshape(-1), log_floor(b).reshape(-1), \
        logvals.reshape(-1)
    one = torch.ones((), device=dev)
    layout, perm = sparse_sinkhorn.segment_layout(r, c, B * n, B * n)
    pot = torch.randn(B * n, device=dev) * 10
    plain = sparse_sinkhorn._launch(layout, lv[perm], pot, la, True, None)
    with_rho = sparse_sinkhorn._launch(layout, lv[perm], pot, la, True, None,
                                       one)
    assert torch.equal(plain[0], with_rho[0])
    assert torch.equal(plain[1], with_rho[1])
    args = (la, lb, r, c, lv, B * n, B * n)
    got = _potentials(ops.logdomain_body(*args, rho=one), B * n, B * n, 50,
                      dev)
    want = _potentials(ops.logdomain_body(*args), B * n, B * n, 50, dev)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_lanes_are_bitwise_their_single_lane_solves(dev):
    B, n, s = 8, 2048, 32768
    a, b, rows, cols, logvals = _inputs(B, n, n, s, 1, dev)
    lanes = sk.sparse_sinkhorn_logdomain_lanes(a, b, rows, cols, logvals, 50)
    for k in range(B):
        solo = sk.sparse_sinkhorn_logdomain(a[k], b[k], rows[k], cols[k],
                                            logvals[k], n, n, 50)
        assert torch.equal(lanes[k], solo), k
    # and run to run: no atomics
    assert torch.equal(lanes, sk.sparse_sinkhorn_logdomain_lanes(
        a, b, rows, cols, logvals, 50))


def test_edge_branches_match_plain(dev):
    """Empty rows and columns, entries at _NEG_INF and -inf, a segment of
    only such entries and a zero marginal entry take the plain version's
    branches: the same entries are 0 and la + 1e30, the rest agree."""
    _check_edge_branches(dev, None)


def test_edge_branches_with_rho_match_plain(dev):
    """The same branches through the unbalanced bodies: the same entries
    are 0 and ρ (la + 1e30)."""
    _check_edge_branches(dev, _rho(dev))


def _check_edge_branches(dev, rho):
    m, n, s, iters = 300, 260, 4000, 20
    a, b, rows, cols, logvals = _inputs(1, m, n, s, 2, dev, empty=4)
    a, b, rows, cols, logvals = a[0], b[0], rows[0], cols[0], logvals[0]
    logvals[::7] = -1e30
    logvals[3::11] = float("-inf")
    cols[(rows == 5) & (cols == 7)] = 8
    logvals[rows == 5] = float("-inf")           # a row of -inf entries
    logvals[cols == 7] = -1e30                   # a column of _NEG_INF
    a[9] = 0.0                                   # la = -inf
    la, lb = log_floor(a), log_floor(b)
    args = (la, lb, rows, cols, logvals, m, n)
    got = _potentials(ops.logdomain_body(*args, rho=rho), m, n, iters, dev)
    want = _potentials(_plain_body(*args, rho), m, n, iters, dev)
    for x, y in zip(got, want):
        assert torch.equal(x == 0, y == 0)
        assert torch.equal(x > 1e29, y > 1e29)
        assert (y[-4:] > 1e29).all()
    assert got[0][9] == 0 and got[0][5] > 1e29 and got[1][7] > 1e29
    bound = _bound(iters, rows, cols,
                   [torch.where(y > 1e29, 0.0, y) for y in want],
                   ulps=1 if rho is None else 2)
    for x, y in zip(got, want):
        live = y < 1e29
        assert (x[live] - y[live]).abs().max().item() <= bound
        assert torch.equal(x[~live], y[~live])


def test_launches_are_two_an_iteration(dev):
    n, s, iters = 512, 8192, 37
    a, b, rows, cols, logvals = _inputs(3, n, n, s, 3, dev)
    sparse_sinkhorn.reset_launch_counts()
    sk.sparse_sinkhorn_logdomain(a[0], b[0], rows[0], cols[0], logvals[0],
                                 n, n, iters)
    assert sparse_sinkhorn.LAUNCHES["sparse_sinkhorn_half"] == 2 * iters
    sk.sparse_sinkhorn_logdomain_lanes(a, b, rows, cols, logvals, iters)
    assert sparse_sinkhorn.LAUNCHES["sparse_sinkhorn_half"] == 4 * iters
    # with a tolerance: the same two launches an iteration, until it stops
    sparse_sinkhorn.reset_launch_counts()
    sk.sparse_sinkhorn_logdomain(a[0], b[0], rows[0], cols[0], logvals[0],
                                 n, n, 500, tol=1e-3)
    launched = sparse_sinkhorn.LAUNCHES["sparse_sinkhorn_half"]
    assert launched % 2 == 0 and 0 < launched <= 1000


def test_unbalanced_loop_launches_two_an_iteration(dev):
    """The unbalanced loop, λ̄ and ε̄ 0-d tensors on the card as the solver
    gives them: two launches an iteration, with a tolerance until it
    stops, and one ``solver.sinkhorn_kernel`` span a loop."""
    n, s, iters = 512, 8192, 37
    a, b, rows, cols, logvals = _inputs(1, n, n, s, 3, dev)
    args = (a[0], b[0], rows[0], cols[0], logvals[0])
    m_t = torch.tensor(0.9, device=dev)
    lam, eps = 1.0 * m_t, 1e-2 * m_t
    sparse_sinkhorn.reset_launch_counts()
    with obs.span("test.loops") as rec:
        sk.sparse_sinkhorn_unbalanced_log(*args, lam, eps, n, n, iters)
        assert sparse_sinkhorn.LAUNCHES["sparse_sinkhorn_half"] == 2 * iters
        sparse_sinkhorn.reset_launch_counts()
        sk.sparse_sinkhorn_unbalanced_log(*args, lam, eps, n, n, 500,
                                          tol=1e-3)
    launched = sparse_sinkhorn.LAUNCHES["sparse_sinkhorn_half"]
    assert launched % 2 == 0 and 0 < launched <= 1000
    assert rec["sub"]["solver.sinkhorn_kernel"][0] == 2


def _clouds(n, seed):
    rng = np.random.default_rng(seed)
    x, y = rng.random((n, 2)), rng.random((n, 2))
    Cx = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)).astype(np.float32)
    Cy = np.sqrt(((y[:, None] - y[None]) ** 2).sum(-1)).astype(np.float32)
    return Cx, Cy, np.full(n, 1.0 / n, np.float32)


def test_solve_runs_every_sinkhorn_loop_on_the_kernel(dev):
    """A whole spar solve: 20 outer steps of 50 iterations, each loop in a
    ``solver.sinkhorn_kernel`` span under its ``solver.sinkhorn``."""
    n = 300
    Cx, Cy, w = _clouds(n, 4)
    sparse_sinkhorn.reset_launch_counts()
    with obs.span("test.solve") as rec:
        out = repro_torch.solve(interop.to_problem(Cx, w, Cy, w),
                                SparGWSolver(s=16 * n),
                                generator=torch.Generator(dev).manual_seed(0),
                                device=dev)
        torch.cuda.synchronize()
    assert torch.isfinite(out.value) and out.status.n_rescues == 0
    assert not out.status.is_diverged
    assert sparse_sinkhorn.LAUNCHES["sparse_sinkhorn_half"] == 2 * 50 * 20
    assert rec["sub"]["solver.sinkhorn_kernel"][0] == 20
    assert rec["sub"]["solver.sinkhorn"][0] == 20


def test_unbalanced_solve_runs_every_sinkhorn_loop_on_the_kernel(dev):
    """A whole unbalanced spar solve (λ = 1, the second marginal's mass
    1.5): 20 outer steps of 50 iterations, each loop through K7 with ρ in
    a ``solver.sinkhorn_kernel`` span; the value agrees with the plain
    loops' on the CPU on the same support."""
    n = 300
    Cx, Cy, w = _clouds(n, 4)
    problem = interop.to_problem(Cx, w, Cy, 1.5 * w, lam=1.0)
    solver = SparGWSolver(s=16 * n)
    sparse_sinkhorn.reset_launch_counts()
    with obs.span("test.solve") as rec:
        out = repro_torch.solve(problem, solver,
                                generator=torch.Generator(dev).manual_seed(0),
                                device=dev)
        torch.cuda.synchronize()
    assert torch.isfinite(out.value) and out.status.n_rescues == 0
    assert not out.status.is_diverged
    assert sparse_sinkhorn.LAUNCHES["sparse_sinkhorn_half"] == 2 * 50 * 20
    assert rec["sub"]["solver.sinkhorn_kernel"][0] == 20
    assert rec["sub"]["solver.sinkhorn"][0] == 20
    on_cpu = repro_torch.solve(problem, solver, device="cpu", support=(
        out.coupling.rows.cpu(), out.coupling.cols.cpu()))
    assert out.value.item() == pytest.approx(on_cpu.value.item(), rel=1e-4)


def test_unrolled_gradient_through_the_kernel_matches_plain(dev):
    """``unrolled_value``'s gradient with respect to Cx, through
    ``_spar_pga_step`` on the card (K1's ``SparMatvec`` and K7's
    ``HalfStep``), against the same on the CPU (plain versions), on one
    support."""
    n = 150
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, 2))
    y = x @ np.array([[0.8, -0.6], [0.6, 0.8]]) + 0.05 * rng.standard_normal(
        (n, 2))

    def sq(z):
        q = (z * z).sum(1)
        return (np.maximum(q[:, None] + q[None] - 2 * z @ z.T, 0)
                / 10).astype(np.float32)
    Cx, Cy = sq(x), sq(y)
    w = torch.full((n,), 1.0 / n)
    rows = rng.integers(0, n, 8 * n)
    cols = rng.integers(0, n, 8 * n)
    solver = SparGWSolver(s=8 * n, outer_iters=5, inner_iters=30)

    def grad(device):
        C = torch.tensor(Cx, requires_grad=True)
        problem = repro_torch.QuadraticProblem(
            repro_torch.Geometry(C, w, validate=False),
            repro_torch.Geometry(torch.tensor(Cy), w, validate=False),
            validate=False)
        value = unrolled_value(problem, solver, device=device,
                               support=interop.to_support(rows, cols,
                                                          device))
        g, = torch.autograd.grad(value, C)
        return value.item(), g

    sparse_sinkhorn.reset_launch_counts()
    v_card, g_card = grad(dev)
    assert sparse_sinkhorn.LAUNCHES["sparse_sinkhorn_half"] == 2 * 30 * 5
    v_cpu, g_cpu = grad("cpu")
    assert torch.isfinite(g_card).all()
    assert v_card == pytest.approx(v_cpu, rel=1e-4)
    torch.testing.assert_close(
        g_card, g_cpu, rtol=0,
        atol=GRAD_ATOL_REL * g_cpu.abs().max().item())
