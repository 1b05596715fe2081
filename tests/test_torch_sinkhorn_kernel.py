"""Parity of the port's resident-Sinkhorn entry point with the JAX reference.

``repro_torch.kernels.sinkhorn.ops.sinkhorn`` runs its plain version with
``device="cpu"`` (the dense core loop at tol=0, with the reference's
subnormal flush). It is held against ``repro.kernels.sinkhorn.ops.sinkhorn``
(the Pallas kernel in interpret mode below the reference's 8 MiB VMEM
gate, its jnp loop above it) and against the reference's ``sinkhorn_ref``, on
the reference's own sweep shapes and iteration counts, numpy-seeded.

Tolerance: rtol 1e-5 plus atol 1e-6 of the coupling's largest entry. Both
sides run the same fp32 iteration and differ in the order of each
matvec's sum, which the scaling iterations carry along but do not amplify
(Sinkhorn's map is a contraction in the Hilbert metric).

It also holds the route function (which of the three CUDA kernels takes a
K of a given size) to the H100's numbers, and the entry point's device
rule: the card unless ``device`` is given, an error with neither.
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
                        torch.from_numpy(K), iters=iters, device="cpu").numpy()


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
    assert kernel_mod.LAUNCHES == {"sinkhorn_cluster": 0, "sinkhorn_card": 0,
                                   "sinkhorn_stream": 0}
    with pytest.raises(ValueError, match="iters"):
        kernel_mod.sinkhorn_cuda(a, b, K, -1)


def test_entry_point_needs_a_device_without_a_card(monkeypatch):
    """With no card and no ``device`` the entry point raises; with
    ``device="cpu"`` it runs the plain version on inputs of any float
    dtype, cast to float32."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b, K = (torch.from_numpy(x) for x in _inputs(9, 7, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.sinkhorn(a, b, K, iters=5)
    got = ops.sinkhorn(a.double(), b.double(), K.double(), iters=5,
                       device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert torch.equal(got, kernel_mod.sinkhorn_plain(a, b, K, 5))


# the H100's numbers: 232 448 B of shared memory a block, 132 SMs,
# clusters of up to 16 CTAs
H100 = (232448, 132, 16)


@pytest.mark.parametrize("m,n,card,want", [
    # the main shapes: the grid path's 181² K, the entry point's 2048², and
    # a 3000² K (36 MB) above the card's shared memory
    (181, 181, H100, ("sinkhorn_cluster", 16)),
    (2048, 2048, H100, ("sinkhorn_card", 128)),
    (3000, 3000, H100, ("sinkhorn_stream", 0)),
    # the cuda tests' shapes
    (1, 1, H100, ("sinkhorn_cluster", 16)),
    (9000, 7, H100, ("sinkhorn_cluster", 16)),
    (37, 1200, H100, ("sinkhorn_cluster", 16)),
    (613, 487, H100, ("sinkhorn_cluster", 16)),
    # edges. A cluster CTA holds its band of K (rows padded to 4 floats), u
    # and a on the band, v and b, both iterations' partials of every CTA
    # and two mbarriers: 16 CTAs of 46 rows of 724 floats,
    # 4·(46·724 + 2·48 + 2·724 + 32·724) + 16 = 232 080 B fit; at 725
    # (rows of 728 floats) 4·(46·728 + 2·48 + 2·728 + 32·728) + 16 =
    # 233 360 B do not, nor do 8 CTAs: the card route, 121 CTAs of
    # ceil(725/132) = 6 rows
    (724, 724, H100, ("sinkhorn_cluster", 16)),
    (725, 725, H100, ("sinkhorn_card", 121)),
    # wide and short, 16 rows: 16 CTAs of one row, 4·(35·1660 + 8) + 16 =
    # 232 448 B fit exactly; at 1661 (rows of 1664) 8 CTAs of two rows,
    # 4·(20·1664 + 8) + 16 = 133 168 B, take it, up to 2904 (232 368 B);
    # at 2905 4·(20·2908 + 8) + 16 = 232 688 B do not: the card route
    (16, 1660, H100, ("sinkhorn_cluster", 16)),
    (16, 1661, H100, ("sinkhorn_cluster", 8)),
    (16, 2904, H100, ("sinkhorn_cluster", 8)),
    (16, 2905, H100, ("sinkhorn_card", 16)),
    # card: 20 rows of 2636 floats, u, a, v and b,
    # 4·(20·2636 + 2·20 + 2·2636) = 232 128 B fit; at 2637 (rows of 2640
    # floats) 4·(20·2640 + 2·20 + 2·2640) = 232 480 B do not
    (2636, 2636, H100, ("sinkhorn_card", 132)),
    (2637, 2637, H100, ("sinkhorn_stream", 0)),
    # a card whose clusters stop at 8 takes 181² on 8 CTAs and gives 609²
    # (4·(77·612 + 2·80 + 18·612) + 16 = 233 216 B on 8) to the card
    # route; below 8, no cluster at all
    (181, 181, (232448, 132, 8), ("sinkhorn_cluster", 8)),
    (609, 609, (232448, 132, 8), ("sinkhorn_card", 122)),
    (181, 181, (232448, 132, 4), ("sinkhorn_card", 91)),
    # few rows, long rows: 10 CTAs of one row each
    (10, 14000, H100, ("sinkhorn_card", 10)),
])
def test_route_by_size(m, n, card, want):
    assert kernel_mod.sinkhorn_route(m, n, *card) == want
