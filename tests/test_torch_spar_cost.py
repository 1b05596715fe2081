"""Parity of the port's spar_cost family with the JAX reference, on the CPU.

The same numpy-seeded inputs go through the reference (Pallas kernels in
interpret mode, and its ``ref.py`` oracles) and through the port's plain
versions, which its wrappers run for CPU tensors.

Tolerance: rtol 1e-5, atol 1e-6 on outputs of order 1-10. Both sides
accumulate in fp32 but sum in different orders (Pallas 32-wide tiles vs
torch's matmul), which moves the result by a few ulp of the row sum.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spar_cost import ops as jops
from repro.kernels.spar_cost import ref as jref
from repro_torch.kernels import dispatch
from repro_torch.kernels.spar_cost import ops, ref, spar_cost

RTOL, ATOL = 1e-5, 1e-6


def _inputs(m, n, s, seed, dup=False):
    rng = np.random.default_rng(seed)
    Cx = (rng.random((m, m)) + 0.1).astype(np.float32)   # > 0: kl finite
    Cy = (rng.random((n, n)) + 0.1).astype(np.float32)
    rows = rng.integers(0, m, s).astype(np.int32)
    cols = rng.integers(0, n, s).astype(np.int32)
    if dup:                      # repeat the first pairs: parallel entries
        k = s // 4
        rows[-k:], cols[-k:] = rows[:k], cols[:k]
    t = rng.random(s).astype(np.float32)
    off = rng.standard_normal(s).astype(np.float32)
    return Cx, Cy, rows, cols, t, off


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("loss", ["l1", "l2", "kl"])
@pytest.mark.parametrize("s,dup", [(100, False), (33, True)])
def test_fused_matches_reference_kernel(loss, s, dup):
    Cx, Cy, rows, cols, t, off = _inputs(50, 60, s, seed=s, dup=dup)
    want = jops.spar_cost_fused(jnp.asarray(Cx), jnp.asarray(Cy),
                                jnp.asarray(rows), jnp.asarray(cols),
                                jnp.asarray(t), jnp.asarray(off), loss=loss,
                                block=32, interpret=True)
    got = ops.spar_cost_fused(_t(Cx), _t(Cy), _t(rows), _t(cols), _t(t),
                              _t(off), loss=loss)
    _close(got, want)


@pytest.mark.parametrize("loss", ["l1", "l2", "kl"])
def test_matvec_matches_reference_kernel(loss):
    Cx, Cy, rows, cols, t, off = _inputs(40, 40, 100, seed=7, dup=True)
    Lmat = jref.materialize_loss(jnp.asarray(Cx), jnp.asarray(Cy),
                                 jnp.asarray(rows), jnp.asarray(cols), loss)
    want = jops.spar_matvec(Lmat, jnp.asarray(t), jnp.asarray(off), block=32,
                            interpret=True)
    got = ops.spar_matvec(_t(np.asarray(Lmat)), _t(t), _t(off))
    _close(got, want)


@pytest.mark.parametrize("loss", ["l1", "l2", "kl"])
@pytest.mark.parametrize("chunk", [None, 16])
def test_oracles_match_reference(loss, chunk):
    Cx, Cy, rows, cols, t, _ = _inputs(30, 20, 70, seed=3, dup=True)
    J = [jnp.asarray(x) for x in (Cx, Cy, rows, cols)]
    T = [_t(x).long() if x.dtype == np.int32 else _t(x)
         for x in (Cx, Cy, rows, cols)]
    _close(ref.materialize_loss(*T, loss, chunk),
           jref.materialize_loss(*J, loss, chunk))
    _close(ref.spar_cost_ref(*T, _t(t), loss, chunk or 1024),
           jref.spar_cost_ref(*J, jnp.asarray(t), loss, chunk or 1024))


def test_duplicate_pairs_are_parallel_entries():
    """A pair drawn twice is two COO entries, not one merged entry."""
    Cx, Cy, rows, cols, t, off = _inputs(12, 9, 40, seed=11, dup=True)
    got = ops.spar_cost_fused(_t(Cx), _t(Cy), _t(rows), _t(cols), _t(t),
                              _t(off), loss="l2")
    G = (Cx[rows][:, rows] - Cy[cols][:, cols]) ** 2
    np.testing.assert_allclose(got.numpy(), G @ t + off, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("impl", ["jnp", "pallas", "materialized", "auto"])
@pytest.mark.parametrize("loss", ["l1", "kl"])
def test_cost_fn_impls_match_reference(impl, loss):
    Cx, Cy, rows, cols, t, off = _inputs(25, 35, 77, seed=5)
    jfn = jops.make_spar_cost_fn(jnp.asarray(Cx), jnp.asarray(Cy),
                                 jnp.asarray(rows), jnp.asarray(cols), loss,
                                 impl="jnp")
    fn = ops.make_spar_cost_fn(_t(Cx), _t(Cy), _t(rows).long(),
                               _t(cols).long(), loss, impl=impl, chunk=32)
    _close(fn(_t(t), _t(off)), jfn(jnp.asarray(t), jnp.asarray(off)))
    _close(fn(_t(t)), jfn(jnp.asarray(t)))          # scalar off = 0.0


def test_resolve_impl_follows_budget_and_device(monkeypatch):
    monkeypatch.delenv("REPRO_SPAR_MATERIALIZE_BUDGET", raising=False)
    assert dispatch.materialize_budget() == 16 * 2**30
    assert ops.resolve_impl("auto", 32768, "cuda") == "materialized"
    assert ops.resolve_impl("auto", 32768, "cpu") == "materialized"
    assert ops.resolve_impl("pallas", 10, "cpu") == "pallas"
    monkeypatch.setenv("REPRO_SPAR_MATERIALIZE_BUDGET", "0")
    assert ops.resolve_impl("auto", 10, "cuda") == "pallas"
    assert ops.resolve_impl("auto", 10, "cpu") == "jnp"


def test_block_size_priority(monkeypatch):
    monkeypatch.delenv("REPRO_BLOCK_SPAR_COST", raising=False)
    assert dispatch.block_size("spar_cost") == 256
    monkeypatch.setenv("REPRO_BLOCK_SPAR_COST", "64")
    assert dispatch.block_size("spar_cost") == 64
    assert dispatch.block_size("spar_cost", 128) == 128
    assert dispatch.block_size("spar_cost", cap=32) == 32
    assert dispatch.block_size("no_such_family") == 128


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    Cx, Cy, rows, cols, t, off = _inputs(10, 10, 20, seed=1)
    spar_cost.reset_launch_counts()
    out = spar_cost.spar_cost_cuda(_t(Cx), _t(Cy), _t(rows), _t(cols), _t(t),
                                   _t(off), loss="kl")
    want = spar_cost.spar_cost_plain(_t(Cx), _t(Cy), _t(rows), _t(cols),
                                     _t(t), _t(off), "kl")
    assert torch.equal(out, want)
    L = ref.materialize_loss(_t(Cx), _t(Cy), _t(rows), _t(cols), "kl")
    assert torch.equal(spar_cost.spar_matvec_cuda(L, _t(t), _t(off)),
                       L @ _t(t) + _t(off))
    assert spar_cost.LAUNCHES == {"spar_matvec": 0, "spar_cost_fused": 0}
    with pytest.raises(ValueError):
        spar_cost.spar_cost_cuda(_t(Cx), _t(Cy), _t(rows), _t(cols), _t(t),
                                 _t(off), loss="l3")


@pytest.mark.parametrize("loss", ["l1", "l2", "kl"])
def test_error_scale_bounds_reorder_error(loss):
    """The kernel checks' scale bounds a float64-vs-float32 difference."""
    Cx, Cy, rows, cols, t, off = _inputs(30, 30, 500, seed=2)
    T = [_t(x) for x in (Cx, Cy, rows, cols, t, off)]
    f32 = spar_cost.spar_cost_plain(*T, loss)
    f64 = spar_cost.spar_cost_plain(*[x.double() if x.is_floating_point()
                                      else x for x in T], loss)
    scale = ref.spar_cost_error_scale(*T, loss)
    assert torch.all((f32.double() - f64).abs() <= 1e-5 * scale)


@pytest.mark.parametrize("loss", ["l1", "l2", "kl"])
@pytest.mark.parametrize("s,dup", [(100, False), (33, True)])
def test_sorted_support_scattered_back_matches_reference(loss, s, dup):
    """The fused kernel's plain version on the support sorted by row, its
    outputs scattered back through the permutation, against the
    reference's fused kernel (interpret mode) on the support as drawn."""
    Cx, Cy, rows, cols, t, off = _inputs(50, 60, s, seed=s + 1, dup=dup)
    want = jops.spar_cost_fused(jnp.asarray(Cx), jnp.asarray(Cy),
                                jnp.asarray(rows), jnp.asarray(cols),
                                jnp.asarray(t), jnp.asarray(off), loss=loss,
                                block=32, interpret=True)
    perm, rows_s, cols_s = ops.sort_support(_t(rows), _t(cols))
    assert torch.all(rows_s[1:] >= rows_s[:-1])
    assert torch.equal(_t(rows)[perm], rows_s)
    got = spar_cost.launch_fused(_t(Cx), _t(Cy), rows_s, cols_s,
                                 _t(t)[perm], _t(off), loss, 256,
                                 perm=perm.int())
    _close(got, want)


def test_cost_fn_checks_the_support_once(monkeypatch):
    """The fused closure checks the index range (a host sync) once per
    support, when it is built, not on every call."""
    Cx, Cy, rows, cols, t, off = _inputs(20, 30, 64, seed=4)
    calls = []
    check = spar_cost.check_support_range
    monkeypatch.setattr(ops, "check_support_range",
                        lambda *a: calls.append(1) or check(*a))
    fn = ops.make_spar_cost_fn(_t(Cx), _t(Cy), _t(rows), _t(cols), "l2",
                               impl="pallas")
    for _ in range(3):
        got = fn(_t(t), _t(off))
    assert len(calls) == 1
    _close(got, spar_cost.spar_cost_plain(_t(Cx), _t(Cy), _t(rows),
                                          _t(cols), _t(t), _t(off), "l2"))
    with pytest.raises(IndexError):
        ops.make_spar_cost_fn(_t(Cx), _t(Cy), _t(rows) + 20, _t(cols), "l2",
                              impl="pallas")
    with pytest.raises(IndexError):
        spar_cost.check_support_range(_t(rows), _t(cols) - 31, 20, 30)
