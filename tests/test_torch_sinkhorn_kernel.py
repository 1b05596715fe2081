"""Parity of the port's resident-Sinkhorn entry point with the JAX reference.

``repro_torch.kernels.sinkhorn.ops.sinkhorn`` runs its plain version for
CPU tensors (the dense core loop at tol=0, with the reference's subnormal
flush). It is held against ``repro.kernels.sinkhorn.ops.sinkhorn`` (the
Pallas kernel in interpret mode below the reference's 8 MiB VMEM gate,
its jnp loop above it) and against the reference's ``sinkhorn_ref``, on
the reference's own sweep shapes and iteration counts, numpy-seeded.

Tolerance: rtol 1e-5 plus atol 1e-6 of the coupling's largest entry. Both
sides run the same fp32 iteration and differ in the order of each
matvec's sum, which the scaling iterations carry along but do not amplify
(Sinkhorn's map is a contraction in the Hilbert metric).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sinkhorn.ops import sinkhorn as j_sinkhorn
from repro.kernels.sinkhorn.ref import sinkhorn_ref as j_sinkhorn_ref
from repro_torch.kernels.sinkhorn import ops
from repro_torch.kernels.sinkhorn import sinkhorn as kernel_mod

RTOL, ATOL_REL = 1e-5, 1e-6


def _inputs(m, n, seed):
    rng = np.random.default_rng(seed)
    a = np.full(m, 1.0 / m, np.float32)
    b = np.full(n, 1.0 / n, np.float32)
    K = (rng.random((m, n)) + 0.01).astype(np.float32)
    return a, b, K


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())


def _port(a, b, K, iters):
    return ops.sinkhorn(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(K), iters=iters).numpy()


@pytest.mark.parametrize("iters", [10, 50])
@pytest.mark.parametrize("mn", [(64, 48), (128, 128), (96, 32)])
def test_matches_reference_kernel_and_oracle(mn, iters):
    a, b, K = _inputs(*mn, seed=mn[0] * mn[1] + iters)
    got = _port(a, b, K, iters)
    J = [jnp.asarray(x) for x in (a, b, K)]
    _close(got, j_sinkhorn(*J, iters=iters, interpret=True))
    _close(got, j_sinkhorn_ref(*J, iters))


def test_matches_reference_above_its_vmem_gate():
    """2048² f32 is 16 MiB, above the reference's 8 MiB gate: there it runs
    its jnp loop. The port has no gate; on the CPU it runs the same loop."""
    a, b, K = _inputs(2048, 2048, seed=7)
    got = _port(a, b, K, 3)
    _close(got, j_sinkhorn(*(jnp.asarray(x) for x in (a, b, K)), iters=3))


def test_subnormal_and_zero_entries_follow_reference_flush():
    """Subnormal kernel entries and marginal entries: XLA reads them as 0,
    a row of only subnormals is dead (scaling 0), and the port's flush
    gives the same coupling; a zero marginal entry kills its row too."""
    m, n = 40, 30
    rng = np.random.default_rng(3)
    a = (rng.random(m) + 0.1).astype(np.float32)
    b = (rng.random(n) + 0.1).astype(np.float32)
    a, b = a / a.sum(), b / b.sum()
    a[0], a[1] = np.float32(1e-40), 0.0
    K = np.exp(-rng.uniform(0, 95, (m, n))).astype(np.float32)
    K[2] = np.float32(5e-39)                        # a row of subnormals
    K[3, :5] = [1e-45, 1e-40, 1e-39, 1e-38, 1e-37]
    got = _port(a, b, K, 20)
    want = np.asarray(j_sinkhorn(*(jnp.asarray(x) for x in (a, b, K)),
                                 iters=20, interpret=True))
    assert np.all(want[:3] == 0.0)
    assert np.all(got[:3] == 0.0)
    _close(got, want)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    a, b, K = (torch.from_numpy(x) for x in _inputs(9, 7, 1))
    kernel_mod.reset_launch_counts()
    got = kernel_mod.sinkhorn_cuda(a, b, K, 5)
    assert torch.equal(got, kernel_mod.sinkhorn_plain(a, b, K, 5))
    assert torch.equal(kernel_mod.sinkhorn_cuda(a, b, K, 0), K)
    assert kernel_mod.LAUNCHES == {"sinkhorn_resident": 0,
                                   "sinkhorn_grid": 0}
    with pytest.raises(ValueError, match="iters"):
        kernel_mod.sinkhorn_cuda(a, b, K, -1)
