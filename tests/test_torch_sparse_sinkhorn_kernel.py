"""The sparse log-domain Sinkhorn half-step (K7) on the CPU: its segment
layout, the body and gradient that drive it, the core loops' CPU route,
and the reader of ``solver.sinkhorn_kernel_share``.

The kernel itself runs only on the card (tests/test_torch_sparse_sinkhorn_cuda.py),
and its wrapper refuses CPU tensors. Here the segment layout is held to a
Python loop; with the launch replaced by the plain half-step over the
layout (core/sinkhorn.py's ``segment_logsumexp`` on the layout's order),
the body that drives the kernel is held to the core's plain body bit for
bit (on the CPU ``index_add_`` sums in input order, and a segment holds
the same entries in the same order in both), and the ``HalfStep``
backward to autograd through the plain body within 1e-4 of the largest
gradient entry (exp(x - lse) against exp(x - max) / sums, and the
rounding-level gradient autograd sends through the max, carried over 12
iterations: 1.2e-5 measured); the core loops on CPU tensors are held to
the plain loops as they were before the kernel, bit for bit.
"""
import importlib
from types import SimpleNamespace

import pytest
import torch

from repro_torch.core.utils import flush_subnormal, log_floor
from repro_torch.kernels.sparse_sinkhorn import ops, sparse_sinkhorn
from repro_torch.kernels.sparse_sinkhorn.sparse_sinkhorn import (
    group_width,
    half_step,
    segment_layout,
)
from repro_torch import obs

sk = importlib.import_module("repro_torch.core.sinkhorn")

GRAD_ATOL_REL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plain_launch(layout, lv, pot, lmarg, want_lse, stream):
    """The kernel's launch as plain torch on the layout: (out, lse)."""
    lse = sk.segment_logsumexp(lv + pot[layout.idx.long()],
                               layout.keys.long(), layout.num)
    return sk._finite(lmarg - lse), lse


@pytest.fixture
def plain_launch(monkeypatch):
    """K7's launch replaced by its plain version, so the body and
    ``HalfStep`` around it run on CPU tensors."""
    monkeypatch.setattr(sparse_sinkhorn, "_launch", _plain_launch)


def _support(m, n, s, seed, empty=3):
    """A support that leaves the last ``empty`` rows and columns empty,
    with duplicate pairs."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, m - empty, (s,), generator=g)
    cols = torch.randint(0, n - empty, (s,), generator=g)
    k = s // 4
    rows[-k:], cols[-k:] = rows[:k], cols[:k]
    return rows, cols


def _problem(m, n, s, seed):
    g = torch.Generator().manual_seed(seed + 1)
    rows, cols = _support(m, n, s, seed)
    logvals = -torch.rand(s, generator=g) * 100.0
    logvals[::11] = -1e30                      # _NEG_INF entries
    logvals[5::13] = float("-inf")             # log_floor(0) entries
    a = torch.rand(m, generator=g) + 0.1
    b = torch.rand(n, generator=g) + 0.1
    return a / a.sum(), b / b.sum(), rows, cols, logvals


def _loop_layout(keys, num):
    """The layout's permutation and offsets by a Python loop."""
    keys = keys.tolist()
    perm = [e for seg in range(num) for e, k in enumerate(keys) if k == seg]
    off = [0]
    for seg in range(num):
        off.append(off[-1] + keys.count(seg))
    return perm, off


@pytest.mark.parametrize("lanes", [1, 3])
def test_segment_layout_matches_a_python_loop(lanes):
    """Stable within a segment, offsets right where segments are empty,
    over lane-offset indices as a flush lays them out."""
    m, n, s = 12, 9, 60
    sup = [_support(m, n, s, seed) for seed in range(lanes)]
    rows = sk._lane_flat(torch.stack([r for r, _ in sup]), m)
    cols = sk._lane_flat(torch.stack([c for _, c in sup]), n)
    for keys, other, num, onum in ((rows, cols, lanes * m, lanes * n),
                                   (cols, rows, lanes * n, lanes * m)):
        layout, perm = segment_layout(keys, other, num, onum)
        want_perm, want_off = _loop_layout(keys, num)
        assert perm.tolist() == want_perm
        assert layout.off.tolist() == want_off
        assert layout.off.dtype == layout.keys.dtype == torch.int32
        assert layout.keys.tolist() == keys[perm].tolist()
        assert layout.idx.tolist() == other[perm].tolist()
        assert (layout.num, layout.other, layout.s) == (num, onum,
                                                        lanes * s)
        # the last rows / columns of every lane are empty
        lens = torch.diff(layout.off).view(lanes, -1)
        assert (lens[:, -3:] == 0).all() and (lens[:, :-3] > 0).any()


def test_segment_layout_of_an_empty_support():
    layout, perm = segment_layout(torch.zeros(0, dtype=torch.int64),
                                  torch.zeros(0, dtype=torch.int64), 4, 5)
    assert layout.off.tolist() == [0] * 5 and perm.numel() == 0
    assert layout.group == 1


@pytest.mark.parametrize("s,num,want", [
    (131072, 8192, 16), (8 * 32768, 8 * 2048, 16), (32768, 2048, 16),
    (17, 2, 16), (100, 100, 1), (0, 5, 1), (5, 0, 1), (10**6, 10, 32),
    (3, 1, 4)])
def test_group_width_follows_the_mean_segment_length(s, num, want):
    assert group_width(s, num) == want


def _plain_body(la, lb, rows, cols, logvals, m, n):
    def body(carry):
        f, g = carry
        f = sk._finite(la - sk.segment_logsumexp(logvals + g[cols], rows, m))
        g = sk._finite(lb - sk.segment_logsumexp(logvals + f[rows], cols, n))
        return (f, g)
    return body


def test_kernel_body_on_cpu_is_the_plain_body_bitwise(plain_launch):
    """The body that drives K7, on CPU tensors (plain half-steps over the
    layouts), against the core's plain body: empty rows and columns,
    entries at _NEG_INF and -inf, 30 iterations."""
    m, n, s = 40, 33, 500
    a, b, rows, cols, logvals = _problem(m, n, s, 3)
    la, lb = log_floor(a), log_floor(b)
    got = want = (torch.zeros(m), torch.zeros(n))
    body = ops.logdomain_body(la, lb, rows, cols, logvals, m, n)
    plain = _plain_body(la, lb, rows, cols, logvals, m, n)
    for _ in range(30):
        got, want = body(got), plain(want)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # an empty row's logsumexp is _NEG_INF, so its f is la + 1e30
    assert (got[0][-3:] > 1e29).all() and (got[1][-3:] > 1e29).all()


def test_kernel_refuses_cpu_tensors():
    """The wrapper has no CPU route: CPU tensors run the core's plain body,
    and the launch refuses them without counting a launch."""
    m, n, s = 10, 8, 40
    a, b, rows, cols, logvals = _problem(m, n, s, 4)
    la, lb = log_floor(a), log_floor(b)
    sparse_sinkhorn.reset_launch_counts()
    body = ops.logdomain_body(la, lb, rows, cols, logvals, m, n)
    with pytest.raises(ValueError, match="CUDA"):
        body((torch.zeros(m), torch.zeros(n)))
    layout, perm = segment_layout(rows, cols, m, n)
    with pytest.raises(ValueError, match="CUDA"):
        half_step(layout, logvals[perm], torch.zeros(n), la)
    assert sparse_sinkhorn.LAUNCHES["sparse_sinkhorn_half"] == 0


def test_kernel_body_refuses_inputs_it_does_not_take():
    m, n, s = 10, 8, 40
    a, b, rows, cols, logvals = _problem(m, n, s, 4)
    la, lb = log_floor(a), log_floor(b)
    with pytest.raises(TypeError):
        ops.logdomain_body(la, lb, rows, cols, logvals.double(), m, n)
    with pytest.raises(ValueError):
        ops.logdomain_body(la[:-1], lb, rows, cols, logvals, m, n)
    with pytest.raises(ValueError):
        ops.logdomain_body(la, lb, rows[:-1], cols, logvals, m, n)


def _old_logdomain(a, b, rows, cols, logvals, m, n, iters, tol):
    """sparse_sinkhorn_logdomain as it was before the kernel route."""
    la, lb = log_floor(a), log_floor(b)
    body = _plain_body(la, lb, rows, cols, logvals, m, n)
    f, g = sk._scaling_loop(body, (torch.zeros(m), torch.zeros(n)), iters,
                            tol)
    return flush_subnormal(torch.exp(logvals + f[rows] + g[cols]))


def _old_logdomain_lanes(a, b, rows, cols, logvals, iters, tol):
    (B, m), n, s = a.shape, b.shape[1], rows.shape[1]
    r, c, lv = sk._lane_flat(rows, m), sk._lane_flat(cols, n), \
        logvals.reshape(-1)
    la, lb = log_floor(a), log_floor(b)

    def body(carry):
        f, g = carry
        f = sk._finite(la - sk.segment_logsumexp(
            lv + g.reshape(-1)[c], r, B * m).view(B, m))
        g = sk._finite(lb - sk.segment_logsumexp(
            lv + f.reshape(-1)[r], c, B * n).view(B, n))
        return (f, g)

    f, g = sk._scaling_loop_lanes(
        body, (torch.zeros(B, m), torch.zeros(B, n)), iters, tol)
    return flush_subnormal(torch.exp(lv + f.reshape(-1)[r]
                                     + g.reshape(-1)[c])).view(B, s)


def _kernel_spans():
    return sum(1 for r in obs.spans()
               if r["name"] == "solver.sinkhorn_kernel")


@pytest.mark.parametrize("tol", [0.0, 1e-4])
def test_cpu_tensors_take_the_plain_body_as_before(tol):
    """On the CPU the core loops are what they were, bit for bit, launch
    nothing and open no kernel span."""
    m, n, s = 30, 26, 300
    sparse_sinkhorn.reset_launch_counts()
    spans_before = _kernel_spans()
    a, b, rows, cols, logvals = _problem(m, n, s, 5)
    got = sk.sparse_sinkhorn_logdomain(a, b, rows, cols, logvals, m, n, 40,
                                       tol=tol)
    assert torch.equal(got, _old_logdomain(a, b, rows, cols, logvals, m, n,
                                           40, tol))
    lanes = [_problem(m, n, s, seed) for seed in (6, 7, 8)]
    A, B, R, C, LV = (torch.stack(x) for x in zip(*lanes))
    got = sk.sparse_sinkhorn_logdomain_lanes(A, B, R, C, LV, 40, tol=tol)
    assert torch.equal(got, _old_logdomain_lanes(A, B, R, C, LV, 40, tol))
    assert sparse_sinkhorn.LAUNCHES["sparse_sinkhorn_half"] == 0
    assert _kernel_spans() == spans_before


def test_half_step_function_backward_matches_autograd_through_plain(
        plain_launch):
    """HalfStep's plain backward (through the body on CPU tensors, whose
    forward is the plain half-step) against autograd through the core's
    plain body: gradients of a coupling's weighted sum with respect to the
    log-kernel and both marginals, after 12 iterations, with empty rows
    and columns and -inf entries on the support."""
    m, n, s = 24, 20, 240
    a, b, rows, cols, logvals = _problem(m, n, s, 9)
    logvals = torch.where(logvals < -1e29, -1e3, logvals)  # finite grads
    logvals[5::13] = float("-inf")
    weight = torch.rand(s, generator=torch.Generator().manual_seed(2))

    def grads(make_body):
        lv = logvals.clone().requires_grad_(True)
        aa = a.clone().requires_grad_(True)
        bb = b.clone().requires_grad_(True)
        la, lb = log_floor(aa), log_floor(bb)
        body = make_body(la, lb, rows, cols, lv, m, n)
        carry = (torch.zeros(m), torch.zeros(n))
        for _ in range(12):
            carry = body(carry)
        f, g = carry
        T = flush_subnormal(torch.exp(lv + f[rows] + g[cols]))
        (T * weight).sum().backward()
        return lv.grad, aa.grad, bb.grad

    got, want = grads(ops.logdomain_body), grads(_plain_body)
    for x, y in zip(got, want):
        assert torch.isfinite(y).all()
        torch.testing.assert_close(
            x, y, rtol=0, atol=GRAD_ATOL_REL * y.abs().max().item())


def test_half_step_takes_the_function_only_with_a_gradient(plain_launch):
    m, n, s = 8, 6, 30
    a, b, rows, cols, logvals = _problem(m, n, s, 10)
    layout, perm = segment_layout(rows, cols, m, n)
    lv = logvals[perm]
    pot = torch.zeros(n, requires_grad=True)
    out = half_step(layout, lv, pot, log_floor(a))
    assert out.grad_fn is not None
    with torch.no_grad():
        assert half_step(layout, lv, pot, log_floor(a)).grad_fn is None
    assert half_step(layout, lv, pot.detach(),
                     log_floor(a)).grad_fn is None


# -- the reader of solver.sinkhorn_kernel_share ----------------------------

def _share_reader():
    from portbench import harness
    return harness.load_reader("solver.sinkhorn_kernel_share")


def _dispatch(name, sub):
    return {"name": name, "start_s": 0.0, "duration_s": 1.0, "sub": sub}


@pytest.mark.parametrize("subs,want", [
    # every Sinkhorn loop of every dispatch on the kernel
    ([{"solver.sinkhorn": [20, 0.1], "solver.sinkhorn_kernel": [20, 0.1]},
      {"solver.sinkhorn": [21, 0.2], "solver.sinkhorn_kernel": [21, 0.2]}],
     1.0),
    # a mix: half of one dispatch's loops, none of another's, a dispatch
    # with no Sinkhorn loop left out
    ([{"solver.sinkhorn": [20, 0.1], "solver.sinkhorn_kernel": [10, 0.1]},
      {"solver.sinkhorn": [20, 0.1]},
      {"solver.cost": [20, 0.1]}],
     0.25),
])
def test_kernel_share_reader_averages_the_dispatches(subs, want):
    spans = [_dispatch(name, sub) for name, sub in
             zip(["solve.dispatch", "serve.dispatch", "solve.dispatch"],
                 subs)]
    spans.append({"name": "serve.submit", "start_s": 0.0, "duration_s": 0.1,
                  "sub": {"solver.sinkhorn_kernel": [9, 1.0]}})
    got = _share_reader().read(SimpleNamespace(spans=spans))
    assert got == pytest.approx(want)


def test_kernel_share_reader_reads_nothing_without_the_span():
    """The parent, whose dispatches hold no kernel span, and a program
    without roll-ups give nothing to read."""
    reader = _share_reader()
    parent = [_dispatch("solve.dispatch", {"solver.sinkhorn": [20, 1.0]})]
    assert reader.read(SimpleNamespace(spans=parent)) is None
    assert reader.read(SimpleNamespace(spans=[])) is None
    old = [{"name": "solve.dispatch", "start_s": 0.0, "duration_s": 1.0}]
    assert reader.read(SimpleNamespace(spans=old)) is None
