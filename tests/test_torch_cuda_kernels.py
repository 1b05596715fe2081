"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips, with the reason, where there is no
CUDA card (a CUDA kernel has no CPU mode). On the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances, kernel against plain version:

* spar_cost (K1, K2): |kernel - plain| <= 1e-4 · scale per row, where
  scale is Σ_l |terms of L|·|t_l| + |off_k|
  (``spar_cost.ref.spar_cost_error_scale``; |Lmat|·|t| + |off| for the
  matvec). A kernel lane adds s/32 terms in sequence and the warp 5 more
  levels, so two correct fp32 sums differ by at most (s/32 + 5)·2⁻²⁴ of
  that scale: 6.1e-5 at s = 32768.
* gw_cost (K3): |kernel - plain| <= 2e-4 · scale per output, scale
  Σ_{l,p} |terms of L|·|T_lp| (``gw_cost.ref.gw_cost_error_scale``). A
  thread adds ceil(L/16)·P terms in sequence and the block 16 more:
  (12·181 + 16)·2⁻²⁴ = 1.3e-4 at the grid path's 181⁴.
* sinkhorn (K4): rtol 1e-4 plus atol 1e-6 of the coupling's largest
  entry. Kernel and plain version flush the same subnormals and differ
  only in the order of each matvec's sum, which the iterations carry
  along but do not amplify.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.api import interop
from repro_torch.api.solvers import GridGWSolver, SparGWSolver
from repro_torch.kernels.gw_cost import gw_cost
from repro_torch.kernels.gw_cost import ref as gw_ref
from repro_torch.kernels.sinkhorn import sinkhorn
from repro_torch.kernels.spar_cost import ref, spar_cost

pytestmark = pytest.mark.cuda
RTOL_SCALE = 1e-4
GW_COST_RTOL_SCALE = 2e-4
SINKHORN_RTOL, SINKHORN_ATOL_REL = 1e-4, 1e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand(shape, seed, dev, lo=0.0):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.random(shape) + lo, dtype=torch.float32,
                        device=dev)


def _support(m, n, s, seed, dev):
    rng = np.random.default_rng(seed)
    rows, cols = rng.integers(0, m, s), rng.integers(0, n, s)
    k = s // 4                         # duplicate pairs: parallel entries
    if k:
        rows[-k:], cols[-k:] = rows[:k], cols[:k]
    return (torch.tensor(rows, dtype=torch.int32, device=dev),
            torch.tensor(cols, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("s,threads", [(1, 256), (31, 256), (3001, 256),
                                       (3001, 64), (4096, 1024)])
def test_matvec_matches_plain(dev, s, threads):
    L = _rand((s, s), 0, dev)
    t = _rand(s, 1, dev) - 0.5
    off = _rand(s, 2, dev, lo=-3.0)
    got = spar_cost.spar_matvec_cuda(L, t, off, threads=threads)
    want = spar_cost.spar_matvec_plain(L, t, off)
    scale = L.abs() @ t.abs() + off.abs()
    assert torch.all((got - want).abs() <= RTOL_SCALE * scale)


@pytest.mark.parametrize("loss", ["l1", "l2", "kl"])
@pytest.mark.parametrize("s", [1, 33, 3001])
def test_fused_matches_plain(dev, loss, s):
    m, n = 777, 555
    Cx, Cy = _rand((m, m), 3, dev, lo=0.05), _rand((n, n), 4, dev, lo=0.05)
    rows, cols = _support(m, n, s, 5, dev)
    t = _rand(s, 6, dev) - 0.5
    off = _rand(s, 7, dev, lo=-3.0)
    got = spar_cost.spar_cost_cuda(Cx, Cy, rows, cols, t, off, loss=loss)
    want = spar_cost.spar_cost_plain(Cx, Cy, rows.long(), cols.long(), t,
                                     off, loss)
    scale = ref.spar_cost_error_scale(Cx, Cy, rows.long(), cols.long(), t,
                                      off, loss)
    assert torch.all((got - want).abs() <= RTOL_SCALE * scale)


def test_launch_counts_and_input_checks(dev):
    s, m = 64, 40
    L = _rand((s, s), 0, dev)
    t, off = _rand(s, 1, dev), _rand(s, 2, dev)
    Cx = _rand((m, m), 3, dev)
    rows, cols = _support(m, m, s, 4, dev)
    spar_cost.reset_launch_counts()
    spar_cost.spar_matvec_cuda(L, t, off)
    spar_cost.spar_cost_cuda(Cx, Cx, rows, cols, t, off)
    spar_cost.spar_cost_cuda(Cx, Cx, rows, cols, t, off, loss="kl")
    torch.cuda.synchronize()
    assert spar_cost.LAUNCHES == {"spar_matvec": 1, "spar_cost_fused": 2}
    with pytest.raises(TypeError):
        spar_cost.spar_matvec_cuda(L.double(), t, off)
    with pytest.raises(ValueError, match="contiguous"):
        spar_cost.spar_matvec_cuda(L.t(), t, off)
    with pytest.raises(ValueError, match="threads"):
        spar_cost.spar_matvec_cuda(L, t, off, threads=48)
    with pytest.raises(IndexError):
        spar_cost.spar_cost_cuda(Cx, Cx, rows + m, cols, t, off)
    assert spar_cost.LAUNCHES == {"spar_matvec": 1, "spar_cost_fused": 2}


@pytest.mark.parametrize("cost_impl", ["materialized", "pallas"])
def test_solve_on_card_matches_cpu(dev, cost_impl):
    """The whole solve on the card against the plain CPU path on the same
    support. index_add_ on the card sums with atomics in no fixed order,
    so the bound is looser than kernel-vs-plain: value rtol 1e-4, coupling
    values atol 1e-6 + rtol 1e-3."""
    n = 300
    rng = np.random.default_rng(0)
    x, y = rng.random((n, 2)), rng.random((n, 2))
    Cx = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)).astype(np.float32)
    Cy = np.sqrt(((y[:, None] - y[None]) ** 2).sum(-1)).astype(np.float32)
    a = np.full(n, 1.0 / n, np.float32)
    solver = SparGWSolver(s=16 * n, cost_impl=cost_impl)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = repro_torch.solve(interop.to_problem(Cx, a, Cy, a), solver,
                            generator=gen, device=dev)
    gpu = interop.output_to_numpy(out)
    cpu = interop.output_to_numpy(repro_torch.solve(
        interop.to_problem(Cx, a, Cy, a), solver, device="cpu",
        support=interop.to_support(gpu["rows"], gpu["cols"])))
    np.testing.assert_allclose(gpu["value"], cpu["value"], rtol=1e-4)
    np.testing.assert_allclose(gpu["vals"], cpu["vals"], rtol=1e-3,
                               atol=1e-6)
    assert gpu["status"]["code"] == cpu["status"]["code"]


@pytest.mark.parametrize("loss", ["l1", "l2", "kl"])
@pytest.mark.parametrize("shape,threads", [
    ((1, 1, 1, 1), 256), ((33, 17, 65, 9), 256), ((181, 181, 181, 181), 256),
    ((100, 70, 50, 130), 128), ((16, 64, 16, 32), 32), ((47, 0, 5, 3), 64)])
def test_gw_cost_matches_plain(dev, loss, shape, threads):
    K, L, M, P = shape
    A, B = _rand((K, L), 8, dev, lo=0.05), _rand((M, P), 9, dev, lo=0.05)
    T = _rand((L, P), 10, dev)
    got = gw_cost.gw_cost_cuda(A, B, T, loss=loss, threads=threads)
    want = gw_cost.gw_cost_plain(A, B, T, loss)
    scale = gw_ref.gw_cost_error_scale(A, B, T, loss)
    assert got.shape == (K, M)
    assert torch.all((got - want).abs() <= GW_COST_RTOL_SCALE * scale)


def _sinkhorn_inputs(m, n, seed, dev, spread=3.0):
    rng = np.random.default_rng(seed)
    a = rng.random(m) + 0.1
    b = rng.random(n) + 0.1
    K = np.exp(-spread * rng.random((m, n)))
    return tuple(torch.tensor(x, dtype=torch.float32, device=dev)
                 for x in (a / a.sum(), b / b.sum(), K))


def _sinkhorn_close(got, want):
    tol = SINKHORN_RTOL * want.abs() + SINKHORN_ATOL_REL * want.abs().max()
    assert torch.all((got - want).abs() <= tol)


@pytest.mark.parametrize("m,n,iters,kernel", [
    (1, 1, 5, "sinkhorn_resident"), (181, 181, 50, "sinkhorn_resident"),
    (37, 1200, 20, "sinkhorn_resident"), (181, 181, 0, "sinkhorn_resident"),
    (613, 487, 30, "sinkhorn_grid"), (2048, 2048, 3, "sinkhorn_grid"),
    (9000, 7, 10, "sinkhorn_grid")])
def test_sinkhorn_matches_plain(dev, m, n, iters, kernel):
    """Both kernels, on either side of the block's shared memory."""
    a, b, K = _sinkhorn_inputs(m, n, m + n, dev)
    assert sinkhorn.fits_shared_memory(m, n, dev) == (
        kernel == "sinkhorn_resident")
    sinkhorn.reset_launch_counts()
    got = sinkhorn.sinkhorn_cuda(a, b, K, iters)
    torch.cuda.synchronize()
    assert sinkhorn.LAUNCHES[kernel] == 1 and sum(
        sinkhorn.LAUNCHES.values()) == 1
    _sinkhorn_close(got, sinkhorn.sinkhorn_plain(a, b, K, iters))


@pytest.mark.parametrize("m,n", [(120, 90), (700, 300)])
def test_sinkhorn_flushes_like_plain(dev, m, n):
    """Subnormal and zero entries in K and a: the kernels flush them where
    the plain version does (dead rows stay exactly 0)."""
    a, b, K = _sinkhorn_inputs(m, n, 3, dev, spread=95.0)
    a[0], a[1] = 1e-40, 0.0
    K[2] = 5e-39
    got = sinkhorn.sinkhorn_cuda(a, b, K, 20)
    want = sinkhorn.sinkhorn_plain(a, b, K, 20)
    assert torch.all(want[:3] == 0) and torch.all(got[:3] == 0)
    assert not torch.any((got != 0) & (got.abs() < torch.finfo().tiny))
    _sinkhorn_close(got, want)


def test_grid_family_launch_counts_and_input_checks(dev):
    A, B, T = _rand((20, 10), 0, dev), _rand((30, 12), 1, dev), _rand(
        (10, 12), 2, dev)
    gw_cost.reset_launch_counts()
    gw_cost.gw_cost_cuda(A, B, T)
    torch.cuda.synchronize()
    assert gw_cost.LAUNCHES == {"gw_cost": 1}
    with pytest.raises(ValueError, match="shape"):
        gw_cost.gw_cost_cuda(A, B, T.t().contiguous())
    with pytest.raises(ValueError, match="threads"):
        gw_cost.gw_cost_cuda(A, B, T, threads=512)
    with pytest.raises(TypeError):
        gw_cost.gw_cost_cuda(A.double(), B, T)
    assert gw_cost.LAUNCHES == {"gw_cost": 1}
    a, b, K = _sinkhorn_inputs(10, 12, 0, dev)
    with pytest.raises(ValueError, match="contiguous"):
        sinkhorn.sinkhorn_cuda(b, a, K.t(), 3)
    with pytest.raises(ValueError, match="shape"):
        sinkhorn.sinkhorn_cuda(b, a, K, 3)


@pytest.mark.parametrize("stable", [True, False])
def test_grid_solve_on_card_matches_cpu(dev, stable):
    """The grid solve with the gw_cost kernel on the card against the plain
    CPU path on the same (R, C): value rtol 1e-4, block atol 1e-6 + rtol
    1e-3 (matmuls and sums in another order on the card)."""
    n = 300
    rng = np.random.default_rng(1)
    x, y = rng.random((n, 2)), rng.random((n, 2))
    Cx = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)).astype(np.float32)
    Cy = np.sqrt(((y[:, None] - y[None]) ** 2).sum(-1)).astype(np.float32)
    a = np.full(n, 1.0 / n, np.float32)
    solver = GridGWSolver(s_r=69, s_c=67, use_kernel=True, stable=stable)
    gw_cost.reset_launch_counts()
    out = repro_torch.solve(interop.to_problem(Cx, a, Cy, a, "l1"), solver,
                            generator=torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    gpu = interop.output_to_numpy(out)
    assert gw_cost.LAUNCHES["gw_cost"] == 21
    cpu = interop.output_to_numpy(repro_torch.solve(
        interop.to_problem(Cx, a, Cy, a, "l1"), solver, device="cpu",
        support=interop.to_support(gpu["rows"], gpu["cols"])))
    np.testing.assert_allclose(gpu["value"], cpu["value"], rtol=1e-4)
    np.testing.assert_allclose(gpu["block"], cpu["block"], rtol=1e-3,
                               atol=1e-6)
    assert gpu["status"]["code"] == cpu["status"]["code"]
    assert gpu["n_iters"] == cpu["n_iters"]
