"""Parity of the port's grid cost assembly (gw_cost) with the JAX reference.

The same numpy-seeded inputs go through the reference's Pallas kernel (in
interpret mode, as tests/test_kernels.py runs it), its ``ref.py`` oracle
and the port's ``kernels.gw_cost.ops.gw_cost``, whose wrapper runs the
plain chunked contraction for CPU tensors. The shapes are the reference's
own sweep, ragged ones included.

Tolerance: rtol 1e-5 of the output plus atol 1e-5 of the per-output error
scale Σ|terms of L|·|T| (``ref.gw_cost_error_scale``). Both sides
accumulate L·P fp32 terms in different orders (32-wide Pallas tiles or one
einsum vs the port's matrix-vector product); for l1 and l2 every term is
>= 0, so the sum itself bounds the rounding, and kl cancels, so its scale
is the sum of its terms' magnitudes. bfloat16 inputs are cast to float32
once on both sides and computed in float32, so the same bound holds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gw_cost.ops import gw_cost as j_gw_cost
from repro.kernels.gw_cost.ref import gw_cost_ref as j_gw_cost_ref
from repro_torch.kernels.gw_cost import gw_cost as kernel_mod
from repro_torch.kernels.gw_cost import ops, ref

RTOL, SCALE_ATOL = 1e-5, 1e-5
SHAPES = [(32, 32, 32, 32), (64, 48, 40, 56), (33, 17, 65, 9),
          (128, 96, 64, 80)]


def _inputs(shape, seed):
    K, L, M, P = shape
    rng = np.random.default_rng(seed)
    A = (rng.random((K, L)) + 0.1).astype(np.float32)
    B = (rng.random((M, P)) + 0.1).astype(np.float32)
    T = rng.random((L, P)).astype(np.float32)
    return A, B, T


def _close(got, want, A, B, T, loss):
    scale = ref.gw_cost_error_scale(*(torch.tensor(x) for x in (A, B, T)),
                                    loss).numpy()
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert np.all(err <= RTOL * np.abs(np.asarray(want)) + SCALE_ATOL * scale)


@pytest.mark.parametrize("loss", ["l1", "l2", "kl"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_reference_oracle(shape, loss):
    A, B, T = _inputs(shape, seed=sum(shape))
    want = j_gw_cost_ref(jnp.asarray(A), jnp.asarray(B), jnp.asarray(T), loss)
    got = ops.gw_cost(torch.from_numpy(A), torch.from_numpy(B),
                      torch.from_numpy(T), loss)
    assert got.dtype == torch.float32 and got.shape == (shape[0], shape[2])
    _close(got.numpy(), want, A, B, T, loss)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("loss", ["l1", "l2", "kl"])
@pytest.mark.parametrize("shape", [(32, 32, 32, 32), (33, 17, 65, 9)])
def test_plain_matches_reference_kernel(shape, loss, dtype):
    """Against the Pallas kernel itself (interpret mode), float32 and
    bfloat16 inputs, on an exact and a ragged shape."""
    A, B, T = _inputs(shape, seed=sum(shape) + 1)
    jA, jB, jT = (jnp.asarray(x).astype(dtype) for x in (A, B, T))
    want = j_gw_cost(jA, jB, jT, loss, interpret=True)
    tA, tB, tT = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (A, B, T))
    got = ops.gw_cost(tA, tB, tT, loss)
    # both sides compute on the same bf16-rounded values, in float32
    r = [np.asarray(jnp.asarray(x).astype(dtype).astype(jnp.float32))
         for x in (A, B, T)]
    _close(got.numpy(), want, *r, loss)


@pytest.mark.parametrize("loss", ["l1", "kl"])
def test_chunking_does_not_change_the_sum(loss):
    """A byte bound that forces ragged k-chunks gives the same sums up to
    the BLAS matvec's blocking, which depends on the row count: each
    output's (l, p) reduction never crosses a chunk (rtol 1e-6 for a sum
    of 91 positive-scale terms)."""
    A, B, T = (torch.from_numpy(x) for x in _inputs((29, 13, 11, 7), 3))
    full = ref.gw_cost_ref(A, B, T, loss)
    per_k = 11 * 13 * 7 * 4
    chunked = ref.gw_cost_ref(A, B, T, loss, chunk_bytes=3 * per_k)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert ref.gw_cost_ref(A, B, T, loss, chunk_bytes=1).shape == (29, 11)


@pytest.mark.parametrize("shape", [(5, 0, 4, 3), (0, 3, 4, 2), (3, 2, 0, 5)])
def test_empty_dimensions(shape):
    """An empty (l, p) sum is 0; an empty k or m gives an empty output."""
    A, B, T = (torch.from_numpy(x) for x in _inputs(shape, 6))
    got = ops.gw_cost(A, B, T, "l1")
    assert got.shape == (shape[0], shape[2]) and torch.all(got == 0)


def test_error_scale_matches_its_definition():
    """The closed forms equal Σ_{l,p} |terms of L|·|T| built in 4-D
    (float64); the scale is computed in float32, rtol 1e-6."""
    A, B, T = (torch.from_numpy(x).double()
               for x in _inputs((5, 4, 6, 3), 4))
    a, b = A[:, :, None, None], B[None, None, :, :]
    la = torch.log(torch.clamp_min(a, 1e-10)).abs()
    lb = torch.log(torch.clamp_min(b, 1e-10)).abs()
    terms = {"l1": a + b, "l2": (a + b) ** 2,
             "kl": a * (la + lb) + a + b}
    for loss, E in terms.items():
        want = torch.einsum("klmp,lp->km", E, T)
        got = ref.gw_cost_error_scale(A, B, T, loss)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    A, B, T = (torch.from_numpy(x) for x in _inputs((9, 8, 7, 6), 5))
    kernel_mod.reset_launch_counts()
    got = kernel_mod.gw_cost_cuda(A, B, T, "l2")
    assert torch.equal(got, kernel_mod.gw_cost_plain(A, B, T, "l2"))
    assert kernel_mod.LAUNCHES == {"gw_cost": 0}
    with pytest.raises(ValueError, match="unknown ground loss"):
        kernel_mod.gw_cost_cuda(A, B, T, "l3")
