"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips, with the reason, where there is no
CUDA card (a CUDA kernel has no CPU mode). On the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances, kernel against plain version:

* spar_cost (K1, K2): |kernel - plain| <= 1e-4 · scale per row, where
  scale is Σ_l |terms of L|·|t_l| + |off_k|
  (``spar_cost.ref.spar_cost_error_scale``; |Lmat|·|t| + |off| for the
  matvec). A kernel lane adds at most s/32 terms in sequence and the warp
  5 more levels (K2's rows path: s/threads terms, 5 levels, then the
  block's warps in order), so two correct fp32 sums differ by at most
  (s/32 + 5)·2⁻²⁴ of that scale: 6.1e-5 at s = 32768, in any order of the
  support.
* gw_cost (K3): |kernel - plain| <= 2e-4 · scale per output, scale
  Σ_{l,p} |terms of L|·|T_lp| (``gw_cost.ref.gw_cost_error_scale``). A
  thread adds ceil(L/S)·ceil(P/warps) terms in sequence (S ranges of l
  over blocks, one range of p per warp), the block ``warps`` more in warp
  order and the split sum S more: (17·23 + 8 + 11)·2⁻²⁴ = 2.4e-5 at the
  grid path's 181⁴ (S = 11 on 132 SMs). The bound of 2e-4 is kept: it
  also covers the plain version's matvec order.
* sinkhorn (K4, all three routes): rtol 1e-4 plus atol 1e-6 of the
  coupling's largest entry. Kernel and plain version flush the same
  subnormals and differ only in the order of each matvec's sum, which the
  iterations carry along but do not amplify.
* flash attention (K5), against the plain version in float32 on the same
  (bf16-valued) inputs: |kernel - plain| <= 2·(S + hd^1.5)·2⁻²⁴ · scale,
  scale = Σ_t p_st·|v_t| (``attention_error_scale``): a score sums hd
  products (its error, up to hd·2⁻²⁴·Σ|q_d k_d|/√hd ≲ hd^1.5·2⁻²⁴ for
  unit inputs, scales p) and an output sums up to S terms, on each side.
  bf16 adds the output's rounding, 2⁻⁸·|plain| (twice the half ulp), and
  the rounding of P to bf16 for the tensor cores' PV product, 2⁻⁸·scale:
  each p_st is off by at most 2⁻⁹ of itself while l sums the unrounded
  p, so the output moves by at most 2⁻⁹·Σ_t p_st·|v_t|, taken twice.
* SSD intra-chunk (K6): |kernel - plain| <= 2·(k + N + 8)·2⁻²⁴ · scale,
  scale = the output over absolute values (``ssd_intra_error_scale``): the
  Gram entry sums N products and the output k terms, on each side. The
  kernel's tensor-core products in 3xTF32 are each within 12·2⁻²⁴ of
  |a||b| and round once per 8 terms and split term (3/8 of a rounding a
  term), which fits the same bound.
* the reduced models on the card against the CPU path: max error 1e-4 of
  the largest logit, as in the CPU parity tests of the whole stack; the
  same for their decode steps.
* the legacy ``spar_gw`` shim: bit for bit its ``repro_torch.solve``
  call, under torch's deterministic algorithms.
"""
import shutil
import subprocess

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.api import interop
from repro_torch.api.solvers import GridGWSolver, SparGWSolver
from repro_torch.configs import get_reduced
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ref import attention_error_scale
from repro_torch.kernels.gw_cost import gw_cost
from repro_torch.kernels.gw_cost import ops as gw_cost_ops
from repro_torch.kernels.gw_cost import ref as gw_ref
from repro_torch.kernels.sinkhorn import ops as sinkhorn_ops
from repro_torch.kernels.sinkhorn import sinkhorn
from repro_torch.kernels.spar_cost import ops, ref, spar_cost
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.ssd.ref import ssd_intra_error_scale
from repro_torch.models import Model

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


@pytest.mark.parametrize("s", [31, 1003])
def test_matvec_function_backward_matches_autograd_through_plain(dev, s):
    """K1's autograd.Function: dLmat = g ⊗ t and doff = g exactly, and dt
    = Lmatᵀ g within the kernel bound, against autograd through the plain
    version; the forward launches the kernel once, the backward none."""
    ins = [_rand((s, s), 3, dev), _rand(s, 4, dev) - 0.5,
           _rand(s, 5, dev, lo=-3.0)]
    w = _rand(s, 6, dev) - 0.5
    got = [x.clone().requires_grad_(True) for x in ins]
    want = [x.clone().requires_grad_(True) for x in ins]
    spar_cost.reset_launch_counts()
    out = spar_cost.spar_matvec_cuda(*got)
    g_k = torch.autograd.grad((out * w).sum(), got)
    assert spar_cost.LAUNCHES["spar_matvec"] == 1
    g_p = torch.autograd.grad(
        (spar_cost.spar_matvec_plain(*want) * w).sum(), want)
    assert torch.equal(g_k[0], g_p[0]) and torch.equal(g_k[2], g_p[2])
    scale = ins[0].abs().t() @ w.abs()
    assert torch.all((g_k[1] - g_p[1]).abs() <= RTOL_SCALE * scale)


def test_fused_and_gw_cost_kernels_refuse_a_gradient(dev):
    A = _rand((40, 30), 7, dev, lo=0.05).requires_grad_(True)
    B, T = _rand((20, 25), 8, dev, lo=0.05), _rand((30, 25), 9, dev)
    with pytest.raises(RuntimeError, match="gw_cost"):
        gw_cost.gw_cost_cuda(A, B, T, loss="l1")
    rows, cols = _support(40, 20, 64, 10, dev)
    Cx = _rand((40, 40), 11, dev).requires_grad_(True)
    with pytest.raises(RuntimeError, match="spar_cost_fused"):
        spar_cost.spar_cost_cuda(Cx, _rand((20, 20), 12, dev), rows, cols,
                                 _rand(64, 13, dev), _rand(64, 14, dev))


@pytest.mark.parametrize("loss", ["l1", "l2", "kl"])
@pytest.mark.parametrize("m,n,s,order", [
    (777, 555, 1, "given"), (777, 555, 33, "given"),
    (777, 555, 3001, "given"), (777, 555, 3001, "sorted"),
    (555, 777, 33, "sorted"), (300, 2048, 32768, "sorted"),
    (2048, 2048, 32768, "given"), (2048, 2048, 32768, "sorted"),
    (30000, 30000, 4096, "given"), (30000, 30000, 4096, "sorted")])
def test_fused_matches_plain(dev, loss, m, n, s, order):
    """Both paths of the kernel (rows in shared memory; at m = n = 30000
    the rows do not fit and are read through L1/L2), m != n, ragged s,
    duplicate pairs, and the support in its given order or sorted by row
    with the outputs scattered back through the permutation."""
    gen = torch.Generator(device=dev).manual_seed(m + n)
    Cx = torch.rand(m, m, generator=gen, device=dev) + 0.05
    Cy = torch.rand(n, n, generator=gen, device=dev) + 0.05
    rows, cols = _support(m, n, s, 5, dev)
    t = _rand(s, 6, dev) - 0.5
    off = _rand(s, 7, dev, lo=-3.0)
    assert (spar_cost.fused_rows_per_block(m, n, s) > 0) == (m + n < 50000)
    spar_cost.reset_launch_counts()
    if order == "given":
        got = spar_cost.spar_cost_cuda(Cx, Cy, rows, cols, t, off, loss=loss)
    else:
        perm, rows_s, cols_s = ops.sort_support(rows, cols)
        assert torch.all(rows_s[1:] >= rows_s[:-1])
        got = spar_cost.launch_fused(Cx, Cy, rows_s, cols_s, t[perm], off,
                                     loss, 256, perm=perm.int())
    torch.cuda.synchronize()
    assert spar_cost.LAUNCHES["spar_cost_fused"] == 1
    want = spar_cost.spar_cost_plain(Cx, Cy, rows.long(), cols.long(), t,
                                     off, loss)
    scale = ref.spar_cost_error_scale(Cx, Cy, rows.long(), cols.long(), t,
                                      off, loss)
    assert torch.all((got - want).abs() <= RTOL_SCALE * scale)


def test_cost_fn_pallas_on_card_matches_plain(dev):
    """The solver's closure: one range check and one sort per support,
    then one launch per call, outputs in the support's own order."""
    m, n, s = 400, 300, 5000
    Cx, Cy = _rand((m, m), 3, dev, lo=0.05), _rand((n, n), 4, dev, lo=0.05)
    rows, cols = _support(m, n, s, 5, dev)
    fn = ops.make_spar_cost_fn(Cx, Cy, rows.long(), cols.long(), "l2",
                               impl="pallas")
    spar_cost.reset_launch_counts()
    for seed in (6, 8):
        t = _rand(s, seed, dev) - 0.5
        off = _rand(s, seed + 1, dev, lo=-3.0)
        got = fn(t, off)
        want = spar_cost.spar_cost_plain(Cx, Cy, rows.long(), cols.long(), t,
                                         off, "l2")
        scale = ref.spar_cost_error_scale(Cx, Cy, rows.long(), cols.long(),
                                          t, off, "l2")
        assert torch.all((got - want).abs() <= RTOL_SCALE * scale)
    assert spar_cost.LAUNCHES["spar_cost_fused"] == 2
    with pytest.raises(IndexError):
        ops.make_spar_cost_fn(Cx, Cy, rows.long() + m, cols.long(), "l2",
                              impl="pallas")


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


def _lanes_matrix(B, s, seed, dev):
    """(B, s, s) uniform matrices on the card in one buffer whose lane
    stride is s² rounded up to 4 floats (every lane 16-byte aligned, as
    ``ops.materialize_lanes`` lays them out)."""
    stride = -(-s * s // 4) * 4
    g = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.rand(B * stride, generator=g, device=dev)
    return buf.as_strided((B, s, s), (stride, s, 1))


@pytest.mark.parametrize("B,s,threads", [(1, 31, 256), (3, 1003, 256),
                                         (5, 2001, 64), (8, 2048, 256)])
def test_matvec_lanes_match_plain_and_single_lane_launches(dev, B, s,
                                                           threads):
    """K1's lane launch: one launch for B lanes, within the kernel bound of
    its plain version, and each lane bitwise what a single-lane launch
    gives on a fresh copy of that lane's inputs."""
    L = _lanes_matrix(B, s, 0, dev)
    t = _rand((B, s), 1, dev) - 0.5
    off = _rand((B, s), 2, dev, lo=-3.0)
    spar_cost.reset_launch_counts()
    got = spar_cost.spar_matvec_cuda(L, t, off, threads=threads)
    torch.cuda.synchronize()
    assert spar_cost.LAUNCHES["spar_matvec"] == 1
    want = spar_cost.spar_matvec_plain(L, t, off)
    scale = torch.stack([L[b].abs() @ t[b].abs() for b in range(B)]) \
        + off.abs()
    assert torch.all((got - want).abs() <= RTOL_SCALE * scale)
    singles = torch.stack([spar_cost.spar_matvec_cuda(
        L[b].clone(), t[b].clone(), off[b].clone(), threads=threads)
        for b in range(B)])
    assert torch.equal(got, singles)


def test_matvec_lanes_input_checks(dev):
    s = 31
    L = _rand((2, s, s), 0, dev)          # lane stride 961: not aligned
    t, off = _rand((2, s), 1, dev), _rand((2, s), 2, dev)
    with pytest.raises(ValueError, match="aligned"):
        spar_cost.spar_matvec_cuda(L, t, off)
    with pytest.raises(ValueError):
        spar_cost.spar_matvec_cuda(_lanes_matrix(2, s, 0, dev), t[:1], off)


def test_matvec_lanes_backward_matches_autograd_through_plain(dev):
    B, s = 3, 256                 # s² a multiple of 4: clones stay aligned
    ins = [_lanes_matrix(B, s, 0, dev), _rand((B, s), 1, dev) - 0.5,
           _rand((B, s), 2, dev, lo=-3.0)]
    w = _rand((B, s), 3, dev) - 0.5
    got = [x.clone().requires_grad_(True) for x in ins]
    want = [x.clone().requires_grad_(True) for x in ins]
    out = spar_cost.spar_matvec_cuda(*got)
    assert "SparMatvec" in type(out.grad_fn).__name__
    g_k = torch.autograd.grad((out * w).sum(), got)
    g_p = torch.autograd.grad(
        (spar_cost.spar_matvec_plain(*want) * w).sum(), want)
    assert torch.equal(g_k[0], g_p[0]) and torch.equal(g_k[2], g_p[2])
    scale = torch.stack([ins[0][b].abs().t() @ w[b].abs()
                         for b in range(B)])
    assert torch.all((g_k[1] - g_p[1]).abs() <= RTOL_SCALE * scale)


def test_spar_lanes_on_card_match_solo_solves(dev):
    """A flush of spar lanes on the card: K1 once a step for all lanes
    (20 steps and the value), each lane within value rtol 1e-4 and
    coupling atol 1e-6 + rtol 1e-3 of its solo solve from the same
    generator state (the same support; index_add_ sums with atomics)."""
    from repro_torch.serve.batching import GeneratorState, stack_items
    from repro_torch.serve.lanes import run_lanes

    n, B = 64, 4
    rng = np.random.default_rng(0)
    a = np.full(n, 1.0 / n, np.float32)
    probs = []
    for _ in range(B):
        x, y = rng.random((n, 2)), rng.random((n, 2))
        Cx = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))
        Cy = np.sqrt(((y[:, None] - y[None]) ** 2).sum(-1))
        probs.append(interop.to_problem(Cx, a, Cy, a, device=dev))
    solver = SparGWSolver(s=16 * n)
    states = [GeneratorState.of(torch.Generator(device=dev).manual_seed(k))
              for k in range(B)]
    spar_cost.reset_launch_counts()
    outs = run_lanes(stack_items([(p, solver, st)
                                  for p, st in zip(probs, states)]))
    torch.cuda.synchronize()
    assert spar_cost.LAUNCHES["spar_matvec"] == solver.outer_iters + 1
    for out, p, st in zip(outs, probs, states):
        solo = solver.run(p, generator=st.restore())
        assert torch.equal(out.coupling.rows, solo.coupling.rows)
        np.testing.assert_allclose(float(out.value), float(solo.value),
                                   rtol=1e-4)
        np.testing.assert_allclose(out.coupling.vals.cpu().numpy(),
                                   solo.coupling.vals.cpu().numpy(),
                                   rtol=1e-3, atol=1e-6)
        assert out.status.code == solo.status.code


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


@pytest.mark.parametrize("loss", ["l1", "kl"])
@pytest.mark.parametrize("shape", [(181, 181, 181, 181), (100, 70, 50, 130)])
def test_gw_cost_split_sum_is_exact_and_repeatable(dev, loss, shape):
    """The (l, p) sum split over S blocks with S not dividing L (ragged
    last range), summed in split order: within the bound of the plain
    version, and the same bits on a second launch."""
    K, L, M, P = shape
    S = gw_cost.splits(K, L, M, dev)
    assert S > 1 and L % S != 0
    A, B = _rand((K, L), 11, dev, lo=0.05), _rand((M, P), 12, dev, lo=0.05)
    T = _rand((L, P), 13, dev)
    gw_cost.reset_launch_counts()
    first = gw_cost.gw_cost_cuda(A, B, T, loss=loss)
    second = gw_cost.gw_cost_cuda(A, B, T, loss=loss)
    torch.cuda.synchronize()
    assert gw_cost.LAUNCHES["gw_cost"] == 2
    assert torch.equal(first, second)
    want = gw_cost.gw_cost_plain(A, B, T, loss)
    scale = gw_ref.gw_cost_error_scale(A, B, T, loss)
    assert torch.all((first - want).abs() <= GW_COST_RTOL_SCALE * scale)


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


# the route each shape takes on the H100 (232 448 B of shared memory a
# block, 132 SMs, clusters of up to 16: test_torch_sinkhorn_kernel.py holds
# the route function to these numbers on the CPU)
@pytest.mark.parametrize("m,n,iters,kernel", [
    (1, 1, 5, "sinkhorn_cluster"), (181, 181, 50, "sinkhorn_cluster"),
    (37, 1200, 20, "sinkhorn_cluster"), (181, 181, 0, "sinkhorn_cluster"),
    (613, 487, 30, "sinkhorn_cluster"), (2048, 2048, 3, "sinkhorn_card"),
    (9000, 7, 10, "sinkhorn_cluster"),
    # each side of each route boundary: 16 -> 8 CTAs a cluster, cluster ->
    # card, card -> stream
    (16, 1660, 7, "sinkhorn_cluster"), (16, 1661, 7, "sinkhorn_cluster"),
    (16, 2904, 7, "sinkhorn_cluster"), (16, 2905, 7, "sinkhorn_card"),
    (724, 724, 7, "sinkhorn_cluster"), (725, 725, 7, "sinkhorn_card"),
    (2636, 2636, 4, "sinkhorn_card"), (2637, 2637, 4, "sinkhorn_stream"),
    # m a multiple of neither 16 nor the card route's 128 CTAs; iters = 0
    # on the card and stream routes
    (2047, 1999, 6, "sinkhorn_card"), (2048, 2048, 0, "sinkhorn_card"),
    (3001, 2999, 0, "sinkhorn_stream")])
def test_sinkhorn_matches_plain(dev, m, n, iters, kernel):
    """Every route, on each side of each of its size boundaries."""
    a, b, K = _sinkhorn_inputs(m, n, m + n, dev)
    assert sinkhorn.route(m, n, dev)[0] == kernel
    sinkhorn.reset_launch_counts()
    got = sinkhorn.sinkhorn_cuda(a, b, K, iters)
    torch.cuda.synchronize()
    assert sinkhorn.LAUNCHES[kernel] == 1 and sum(
        sinkhorn.LAUNCHES.values()) == 1
    _sinkhorn_close(got, sinkhorn.sinkhorn_plain(a, b, K, iters))


def test_sinkhorn_clusters_of_16_on_the_h100(dev):
    """The card allows clusters of 16 CTAs, which the cluster cases above
    take (all but two of 8) and which a cluster launch of 8 runs as well."""
    assert sinkhorn.card_numbers(dev.index or 0)[2] >= 16
    assert sinkhorn.route(181, 181, dev) == ("sinkhorn_cluster", 16)
    a, b, K = _sinkhorn_inputs(181, 181, 4, dev)
    want = sinkhorn.sinkhorn_plain(a, b, K, 30)
    for ctas in (8, 16):
        T = torch.empty_like(K)
        assert sinkhorn._lib().sinkhorn_cluster_launch(
            a.data_ptr(), b.data_ptr(), K.data_ptr(), T.data_ptr(), 181, 181,
            ctas, 30, torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        _sinkhorn_close(T, want)


@pytest.mark.parametrize("m,n,kernel", [
    (181, 181, "sinkhorn_cluster"), (700, 690, "sinkhorn_cluster"),
    (2047, 1999, "sinkhorn_card"), (3001, 2999, "sinkhorn_stream")])
def test_sinkhorn_repeats_bit_for_bit(dev, m, n, kernel):
    """Sums in a fixed order, no atomics: two launches give the same bits."""
    a, b, K = _sinkhorn_inputs(m, n, 5, dev)
    assert sinkhorn.route(m, n, dev)[0] == kernel
    first = sinkhorn.sinkhorn_cuda(a, b, K, 20)
    second = sinkhorn.sinkhorn_cuda(a, b, K, 20)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("m,n,kernel", [
    (120, 90, "sinkhorn_cluster"), (700, 300, "sinkhorn_cluster"),
    (1500, 1400, "sinkhorn_card"), (3001, 2999, "sinkhorn_stream")])
def test_sinkhorn_flushes_like_plain(dev, m, n, kernel):
    """Subnormal and zero entries in K and a: the kernels flush them where
    the plain version does (dead rows stay exactly 0)."""
    a, b, K = _sinkhorn_inputs(m, n, 3, dev, spread=95.0)
    a[0], a[1] = 1e-40, 0.0
    K[2] = 5e-39
    assert sinkhorn.route(m, n, dev)[0] == kernel
    got = sinkhorn.sinkhorn_cuda(a, b, K, 20)
    want = sinkhorn.sinkhorn_plain(a, b, K, 20)
    assert torch.all(want[:3] == 0) and torch.all(got[:3] == 0)
    assert not torch.any((got != 0) & (got.abs() < torch.finfo().tiny))
    _sinkhorn_close(got, want)


def test_sinkhorn_entry_point_runs_on_the_card(dev):
    """``ops.sinkhorn`` and ``ops.gw_cost`` run on the card by default, CPU
    inputs moved there, and launch their kernels."""
    a, b, K = (x.cpu() for x in _sinkhorn_inputs(181, 181, 9, dev))
    sinkhorn.reset_launch_counts()
    T = sinkhorn_ops.sinkhorn(a, b, K, iters=10)
    assert T.is_cuda and sinkhorn.LAUNCHES["sinkhorn_cluster"] == 1
    A, B, Tg = (_rand(s, i, dev).cpu() for i, s in enumerate(
        ((20, 10), (30, 12), (10, 12))))
    gw_cost.reset_launch_counts()
    assert gw_cost_ops.gw_cost(A, B, Tg).is_cuda
    assert gw_cost.LAUNCHES == {"gw_cost": 1}


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


def _normal(shape, seed, dev, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=dev).to(dtype)


@pytest.mark.parametrize("B,S,H,K,hd", [
    (1, 1, 4, 1, 16), (2, 200, 4, 4, 16), (2, 77, 8, 2, 128),
    (1, 1000, 8, 2, 112), (1, 333, 8, 8, 128), (1, 64, 2, 2, 5),
    # llama4-scout's group of 5 (40 / 8, hd 128), musicgen's hd 64 (24 / 24)
    (1, 333, 10, 2, 128), (2, 77, 5, 1, 128), (1, 1000, 40, 8, 128),
    (2, 200, 4, 4, 64), (1, 1000, 24, 24, 64), (1, 65, 24, 24, 64)] + [
    (2, S, 2 * G, 2, hd) for hd in (64, 72, 112, 128)
    for S in (1, 63, 65, 200, 1000) for G in (1, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(dev, B, S, H, K, hd, dtype):
    """Ragged S and last tiles (of 64 and of the bf16 kernel's 128 rows),
    G = 1, 2, 4 and 5, hd from 5 to 128 (72: zero-padded to 80 in the
    bf16 kernel's shared memory)."""
    q = _normal((B * H, S, hd), 0, dev, dtype)
    k = _normal((B * K, S, hd), 1, dev, dtype)
    v = _normal((B * K, S, hd), 2, dev, dtype)
    fa.reset_launch_counts()
    got = fa.flash_attention_cuda(q, k, v, groups=H // K)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 1 and got.dtype == dtype
    q32, k32, v32 = q.float(), k.float(), v.float()
    want = fa.flash_attention_plain(q32, k32, v32, groups=H // K)

    def heads(x, n):                  # (B·n, S, hd) -> (B, S, n, hd)
        return x.reshape(B, n, S, hd).transpose(1, 2)
    scale = attention_error_scale(heads(q32, H), heads(k32, K),
                                  heads(v32, K))
    scale = scale.transpose(1, 2).reshape(B * H, S, hd)
    tol = 2 * (S + hd ** 1.5) * 2.0 ** -24 * scale
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * want.abs() + 2.0 ** -8 * scale
    assert torch.all((got.float() - want).abs() <= tol)


def test_flash_attention_bf16_runs_on_tensor_cores(dev):
    """The bf16 kernel is built from wgmma: HGMMA in the library's SASS."""
    cuda_lib.build(["flash_attention"])
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [tool, "-sass", str(cuda_lib.library_path("flash_attention"))],
        capture_output=True, text=True, check=True, timeout=120).stdout
    assert "HGMMA" in sass


def test_flash_attention_input_checks(dev):
    q = _normal((4, 16, 8), 0, dev)
    fa.reset_launch_counts()
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q.half(), q.half(), q.half(), groups=1)
    with pytest.raises(ValueError, match="head_dim"):
        big = _normal((4, 16, 160), 0, dev)
        fa.flash_attention_cuda(big, big, big, groups=1)
    with pytest.raises(ValueError, match="contiguous"):
        qt = _normal((4, 8, 16), 0, dev).transpose(1, 2)
        fa.flash_attention_cuda(qt, qt, qt, groups=1)
    with pytest.raises(ValueError, match="groups"):
        fa.flash_attention_cuda(q, q[:3], q[:3], groups=2)
    assert fa.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("S,H,K,hd", [(1, 2, 1, 16), (200, 4, 2, 64),
                                      (777, 8, 2, 112)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_grad_matches_plain(dev, S, H, K, hd, dtype):
    """The kernel's autograd.Function: one launch, and dq, dk, dv (its
    plain backward, chunked) against autograd through the plain version
    in float32 on the same inputs: 1e-5 of the largest entry of the three
    in float32, 2⁻⁷ (a bf16 ulp, the output's rounding) in bfloat16. (At
    S = 1 dk is 0: one key takes the whole softmax.)"""
    q, k, v = (_normal((n, S, hd), i, dev, dtype).requires_grad_(True)
               for i, n in enumerate((H, K, K)))
    cot = _normal((H, S, hd), 3, dev)
    fa.reset_launch_counts()
    out = fa.flash_attention_cuda(q, k, v, groups=H // K)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (q, k, v), cot.to(dtype))
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 1
    ref = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(
        fa.flash_attention_plain(*ref, groups=H // K), ref,
        cot.to(dtype).float())
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert (g.float() - w).abs().max() <= rel * scale


def _ssd_inputs(G, k, H, P, N, offset, dev):
    rng = np.random.default_rng(G * k + H)
    size = G * k * H * P
    xdt = _normal((size + offset,), 3, dev)[offset:].view(G, k, H, P)
    cs = -torch.tensor(np.cumsum(rng.random((G, k, H)), axis=1),
                       dtype=torch.float32, device=dev)
    Bm, Cm = _normal((G, k, N), 4, dev), _normal((G, k, N), 5, dev)
    return xdt, cs, Bm, Cm


@pytest.mark.parametrize("G,k,H,P,N,offset", [
    (5, 128, 12, 64, 64, 0), (3, 100, 9, 30, 17, 0), (2, 128, 1, 64, 70, 0),
    (4, 8, 4, 32, 16, 0), (1, 1, 1, 1, 1, 0), (3, 128, 30, 64, 64, 0),
    (2, 64, 15, 12, 8, 1), (4, 128, 112, 64, 64, 0), (2, 128, 17, 64, 64, 0),
    (2, 120, 3, 100, 40, 0), (2, 128, 5, 130, 64, 2)])
def test_ssd_intra_matches_plain(dev, G, k, H, P, N, offset):
    """Ragged G and H (head tiles of 14: H = 17 and 30), zamba2-7b's layer
    widths at G = 4, k < 128 and not a multiple of 8, P not a multiple of
    4 or 8 and P over several units of 64 columns, N over several staged
    chunks of 32, and an xdt that starts 4 or 8 bytes past a 16-byte
    boundary (the 4-byte load route)."""
    xdt, cs, Bm, Cm = _ssd_inputs(G, k, H, P, N, offset, dev)
    ssd.reset_launch_counts()
    got = ssd.ssd_intra_cuda(xdt, cs, Bm, Cm)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES["ssd_intra"] == 1
    want = ssd.ssd_intra_plain(xdt, cs, Bm, Cm)
    scale = ssd_intra_error_scale(xdt, cs, Bm, Cm)
    assert torch.all((got - want).abs()
                     <= 2 * (k + N + 8) * 2.0 ** -24 * scale)


@pytest.mark.parametrize("P,offset,route", [
    (64, 0, "16-byte"), (64, 1, "4-byte"), (62, 0, "4-byte")])
def test_ssd_intra_load_routes_agree_and_repeat(dev, P, offset, route):
    """Both load routes of the kernel (16-byte copies; 4-byte copies for an
    unaligned xdt or P % 4 != 0) match the plain version, and a second
    launch gives the same bits."""
    G, k, H, N = 3, 128, 16, 64
    xdt, cs, Bm, Cm = _ssd_inputs(G, k, H, P, N, offset, dev)
    assert ssd.load_route(xdt) == route
    first = ssd.ssd_intra_cuda(xdt, cs, Bm, Cm)
    second = ssd.ssd_intra_cuda(xdt, cs, Bm, Cm)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    want = ssd.ssd_intra_plain(xdt, cs, Bm, Cm)
    scale = ssd_intra_error_scale(xdt, cs, Bm, Cm)
    assert torch.all((first - want).abs()
                     <= 2 * (k + N + 8) * 2.0 ** -24 * scale)


def test_ssd_intra_runs_on_tensor_cores(dev):
    """The SSD kernel's products are mma.sync TF32: HMMA in its SASS."""
    cuda_lib.build(["ssd_intra"])
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [tool, "-sass", str(cuda_lib.library_path("ssd_intra"))],
        capture_output=True, text=True, check=True, timeout=120).stdout
    assert "HMMA" in sass and "TF32" in sass


def test_ssd_intra_never_forms_the_masked_decay(dev):
    """cs falling by 100 per step: exp(cs_s - cs_t) = exp(100 (t - s))
    overflows in float32 for t > s. The kernel never evaluates it there;
    the output stays finite, and exp(-100) leaves only t == s."""
    G, k, H, P, N = 2, 128, 3, 16, 8
    cs = -100.0 * torch.arange(k, dtype=torch.float32, device=dev)
    cs = cs[None, :, None].expand(G, k, H).contiguous()
    xdt, Bm, Cm = (_normal(s, i, dev) for i, s in
                   enumerate(((G, k, H, P), (G, k, N), (G, k, N))))
    got = ssd.ssd_intra_cuda(xdt, cs, Bm, Cm)
    assert torch.isfinite(got).all()
    Gm = (Cm * Bm).sum(-1)                       # only t == s survives
    torch.testing.assert_close(got, Gm[:, :, None, None] * xdt, rtol=1e-5,
                               atol=1e-5)


def test_ssd_intra_grad_matches_plain(dev):
    """The kernel's autograd.Function at zamba2-7b's layer widths: one
    launch, and the gradient of every input (the plain version's VJP,
    recomputed) against autograd through the plain version: the same
    ops on the same inputs, so within float32 rounding of the largest
    entry."""
    xdt, cs, Bm, Cm = _ssd_inputs(4, 128, 112, 64, 64, 0, dev)
    ins = [x.clone().requires_grad_(True) for x in (xdt, cs, Bm, Cm)]
    cot = _normal(tuple(xdt.shape), 6, dev)
    ssd.reset_launch_counts()
    out = ssd.ssd_intra_cuda(*ins)
    assert type(out.grad_fn).__name__ == "SsdIntraBackward"
    got = torch.autograd.grad(out, ins, cot)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES["ssd_intra"] == 1
    ref = [x.clone().requires_grad_(True) for x in (xdt, cs, Bm, Cm)]
    want = torch.autograd.grad(ssd.ssd_intra_plain(*ref), ref, cot)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-6 * w.abs().max()


@pytest.mark.parametrize("name", ["smollm_135m", "zamba2_7b"])
def test_train_step_on_card_matches_cpu(dev, name):
    """One train step of the reduced model (flash attention, the
    alignment loss on the same draws) on the card through K5 / K6 and
    their Functions against the CPU path: loss, ce and the gradient norm
    within 1e-4, as the CPU parity tests hold the stack."""
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    cfg = get_reduced(name)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = TokenPipeline(cfg, 32, 2).global_batch_at(0)
    rng = np.random.default_rng(1)
    draws = (rng.integers(0, 32, (2, 64)), rng.integers(0, 32, (2, 64)))
    step_fn = steps.make_train_step(model, act_dtype=torch.float32,
                                    use_flash=True, gw_align=True)
    out = {}
    for where in ("cpu", dev):
        p = adamw.tree_map(lambda t: t.to(where), params)
        fa.reset_launch_counts()
        ssd.reset_launch_counts()
        _, state, m = step_fn(p, adamw.init(p), batch, gw_draws=draws)
        out[str(where)] = {k: float(v) for k, v in m.items()}
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] + ssd.LAUNCHES["ssd_intra"] > 0
    for key in ("loss", "ce", "gnorm"):
        assert abs(out["cuda"][key] - out["cpu"][key]) \
            <= 1e-4 * abs(out["cpu"][key])


def test_ssd_intra_input_checks(dev):
    x = _normal((1, 129, 2, 8), 0, dev)
    cs, B = _normal((1, 129, 2), 1, dev), _normal((1, 129, 4), 2, dev)
    ssd.reset_launch_counts()
    with pytest.raises(ValueError, match="chunk"):
        ssd.ssd_intra_cuda(x, cs, B, B)
    with pytest.raises(TypeError):
        ssd.ssd_intra_cuda(x[:, :8].double(), cs[:, :8].contiguous(),
                           B[:, :8].contiguous(), B[:, :8].contiguous())
    assert ssd.LAUNCHES["ssd_intra"] == 0


@pytest.mark.parametrize("name", ["zamba2_7b", "llama3_8b"])
def test_reduced_model_on_card_matches_cpu(dev, name):
    """The reduced models' fp32 forward and prefill on the card, through
    K5 and K6, against the CPU path (plain versions) on the same weights;
    then the bf16 prefill on the card is finite."""
    cfg = get_reduced(name)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)))
    n_sb = cfg.resolved_superblocks
    n_attn = n_sb if cfg.shared_block_every else n_sb * len(cfg.block_pattern)
    n_ssd = sum(k == "mamba2" for k in cfg.block_pattern) * n_sb + len(
        cfg.tail_blocks)
    want, _, _ = model.forward(params, toks, use_flash=True, device="cpu")
    fa.reset_launch_counts()
    ssd.reset_launch_counts()
    got, hidden, _ = model.forward(params, toks, use_flash=True, device=dev)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == n_attn
    assert ssd.LAUNCHES["ssd_intra"] == n_ssd
    assert got.is_cuda and hidden.is_cuda
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert err <= 1e-4
    plain, _, _ = model.forward(params, toks, use_flash=True,
                                use_kernel=False, device=dev)
    assert fa.LAUNCHES["flash_attention"] == n_attn      # no more launches
    assert ssd.LAUNCHES["ssd_intra"] == n_ssd
    assert (plain - got).abs().max() / got.abs().max() <= 1e-4
    logits, cache = model.prefill(params, toks, use_flash=True, device=dev)
    assert torch.isfinite(logits).all() and logits.shape == (
        2, 1, cfg.vocab_size)


@pytest.mark.parametrize("name", ["llama4_scout_17b_a16e",
                                  "phi3_5_moe_42b_a6_6b", "minicpm3_4b",
                                  "llama_3_2_vision_90b", "xlstm_125m",
                                  "musicgen_medium"])
def test_new_arch_on_card_matches_cpu(dev, name):
    """The reduced model's fp32 forward on the card (K5 in every GQA
    self-attention layer) against the CPU path on the same weights within
    1e-4 of the largest logit, its aux loss too; the MoE models at
    capacity factor 100, so that no token's drop depends on rounding."""
    import dataclasses

    cfg = get_reduced(name)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=100.0)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    shape = (2, 64, cfg.n_codebooks) if cfg.n_codebooks > 1 else (2, 64)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, shape))
    img = torch.tensor(rng.standard_normal(
        (2, cfg.n_image_tokens, cfg.d_model)), dtype=torch.float32) \
        if cfg.n_image_tokens else None
    n_attn = 0 if cfg.attn_type == "mla" else cfg.resolved_superblocks * sum(
        k in ("attn", "moe") for k in cfg.block_pattern)
    want, _, want_aux = model.forward(params, toks, img=img, use_flash=True,
                                      device="cpu")
    fa.reset_launch_counts()
    got, _, aux = model.forward(params, toks, img=img, use_flash=True,
                                device=dev)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == n_attn
    assert (got.cpu() - want).abs().max() <= 1e-4 * want.abs().max()
    assert abs(float(aux) - float(want_aux)) <= 1e-4 * abs(float(want_aux))
    logits, _ = model.prefill(params, toks, img=img, use_flash=True,
                              device=dev)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_spar_gw_shim_is_its_solve_bitwise_on_card(dev, impl):
    """The legacy ``spar_gw`` shim on the card is bit for bit
    ``repro_torch.solve`` on the same generator state, with torch's
    deterministic algorithms on (the sparse Sinkhorn's ``index_add_``
    otherwise sums with atomics, in no fixed order); K1 (auto) or K2
    (pallas) launches once a step and once for the value."""
    import warnings

    from repro_torch.core import spar_gw as spar_shim

    Cx, a, Cy, b = (np.asarray(x) for x in _moon_pair(300))
    n = a.shape[0]
    problem = interop.to_problem(Cx, a, Cy, b, device=dev)
    solver = SparGWSolver(s=16 * n, cost_impl=impl)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        spar_cost.reset_launch_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            value, (rows, cols, vals) = spar_shim(
                torch.Generator(dev).manual_seed(0), a, b, Cx, Cy, s=16 * n,
                cost_impl=impl)
        torch.cuda.synchronize()
        launched = dict(spar_cost.LAUNCHES)
        out = repro_torch.solve(problem, solver,
                                generator=torch.Generator(dev).manual_seed(0))
    finally:
        torch.use_deterministic_algorithms(False)
    name = "spar_matvec" if impl == "auto" else "spar_cost_fused"
    assert launched[name] == solver.outer_iters + 1
    assert value.is_cuda and torch.equal(value, out.value)
    c = out.coupling
    assert torch.equal(rows, c.rows) and torch.equal(cols, c.cols)
    assert torch.equal(vals, c.vals)


def _moon_pair(n):
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((n, 2)), rng.standard_normal((n, 2)) * 1.2
    Cx = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)).astype(np.float32)
    Cy = np.sqrt(((y[:, None] - y[None]) ** 2).sum(-1)).astype(np.float32)
    a = np.full(n, 1 / n, np.float32)
    return Cx, a, Cy, a.copy()


@pytest.mark.parametrize("name", ["zamba2_7b", "llama3_8b"])
def test_decode_step_on_card_matches_cpu(dev, name):
    """Teacher-forced fp32 decode steps on the card against the CPU on the
    same weights, within 1e-4 of the largest logit; the caches too."""
    cfg = get_reduced(name)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)))
    caches = {d: model.init_cache(2, 8, dtype=torch.float32, device=d)
              for d in ("cpu", dev)}
    for t in range(8):
        got, _ = model.decode_step(params, toks[:, t:t + 1], caches[dev], t,
                                   act_dtype=torch.float32, device=dev)
        want, _ = model.decode_step(params, toks[:, t:t + 1],
                                    caches["cpu"], t,
                                    act_dtype=torch.float32, device="cpu")
        assert got.is_cuda
        assert (got.cpu() - want).abs().max() <= 1e-4 * want.abs().max()
