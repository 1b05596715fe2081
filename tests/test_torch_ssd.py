"""Parity of the port's Mamba2 SSD intra-chunk block (K6) with the reference.

On the CPU ``repro_torch.kernels.ssd.ops.ssd_intra`` runs the kernel's
plain version (the masked decay block and one einsum, in float32). The
reference side runs its Pallas kernel in interpret mode and
``vmap(ssd_intra_ref)`` on the same numpy inputs.

Tolerance, port vs both: atol 1e-5 + rtol 1e-5. The outputs are sums of up
to k products of O(1) values (C·B over N terms times a decay ≤ 1 times a
unit normal), so their scale is ~√(kN) ≲ 100; float32 summation order and
the last ulp of exp differ, nothing else.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd_intra as ref_ssd_intra
from repro.kernels.ssd.ref import ssd_intra_ref as ref_oracle
from repro_torch.kernels.ssd import ssd as ssd_mod
from repro_torch.kernels.ssd.ops import ssd_intra
from repro_torch.kernels.ssd.ref import ssd_intra_error_scale, ssd_intra_ref

RTOL, ATOL = 1e-5, 1e-5


def _inputs(shape, seed):
    G, k, H, P, N = shape
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((G, k, H, P)).astype(np.float32)
    cs = -np.cumsum(rng.random((G, k, H)), axis=1).astype(np.float32)
    Bm = rng.standard_normal((G, k, N)).astype(np.float32)
    Cm = rng.standard_normal((G, k, N)).astype(np.float32)
    return xdt, cs, Bm, Cm


# the reference's sweep (tests/test_kernels.py) and zamba2-7b's head
# geometry (k = 128, P = 64, N = 64) with a few heads
@pytest.mark.parametrize("shape", [(2, 32, 8, 16, 8), (3, 64, 4, 32, 16),
                                   (1, 16, 6, 8, 4), (2, 128, 3, 64, 64)])
def test_ssd_intra_matches_reference(shape):
    arrays = _inputs(shape, sum(shape))
    got = ssd_intra(*(torch.tensor(a) for a in arrays), device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:4]
    got = got.numpy()
    pallas = np.asarray(ref_ssd_intra(*map(jnp.asarray, arrays)))
    oracle = np.asarray(jax.vmap(ref_oracle)(*map(jnp.asarray, arrays)))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)


def test_ssd_intra_casts_to_float32():
    """bfloat16 B and C (as in the bf16 prefill) are computed in float32,
    as the reference's kernel casts them."""
    xdt, cs, Bm, Cm = (torch.tensor(a) for a in _inputs((2, 16, 3, 8, 4), 1))
    Bb, Cb = Bm.bfloat16(), Cm.bfloat16()
    got = ssd_intra(xdt, cs, Bb, Cb, device="cpu")
    want = ssd_intra_ref(xdt, cs, Bb.float(), Cb.float())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_error_scale_bounds_the_output():
    xdt, cs, Bm, Cm = (torch.tensor(a) for a in _inputs((2, 32, 4, 8, 8), 2))
    scale = ssd_intra_error_scale(xdt, cs, Bm, Cm)
    assert torch.all(ssd_intra_ref(xdt, cs, Bm, Cm).abs() <= scale * 1.0001)


def test_ssd_intra_refusals(monkeypatch):
    arrays = [torch.tensor(a) for a in _inputs((1, 8, 2, 4, 4), 0)]
    ssd_mod.reset_launch_counts()
    ssd_intra(*arrays, device="cpu")
    assert ssd_mod.LAUNCHES == {"ssd_intra": 0}      # plain runs: no launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssd_intra(*arrays)
