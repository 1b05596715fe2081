"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips, with the reason, where there is no
CUDA card (a CUDA kernel has no CPU mode). On the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerance: |kernel - plain| <= 1e-4 · scale per row, where scale is
Σ_l |terms of L|·|t_l| + |off_k| (``ref.spar_cost_error_scale``;
|Lmat|·|t| + |off| for the matvec). A kernel lane adds s/32 terms in
sequence and the warp 5 more levels, so two correct fp32 sums differ by
at most (s/32 + 5)·2⁻²⁴ of that scale: 6.1e-5 at s = 32768.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.api import interop
from repro_torch.api.solvers import SparGWSolver
from repro_torch.kernels.spar_cost import ref, spar_cost

pytestmark = pytest.mark.cuda
RTOL_SCALE = 1e-4


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
