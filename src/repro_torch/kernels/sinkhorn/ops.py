"""Public wrapper of the dense Sinkhorn loop with K resident on chip.

The reference's wrapper sends K to its TPU kernel while m·n·4 bytes fit
its 8 MiB VMEM budget and to its jnp loop above. Here both CUDA kernels
together take every size (shared memory up to the card's per-block limit,
L2 and a cooperative grid above it), so there is no gate: a CUDA tensor
always runs a kernel, a CPU tensor the plain loop.
"""
from __future__ import annotations

from repro_torch.kernels.sinkhorn.sinkhorn import sinkhorn_cuda


def sinkhorn(a, b, K, iters: int = 50):
    """H plain Sinkhorn iterations on K, then diag(u) K diag(v); (m, n)."""
    return sinkhorn_cuda(a.float().contiguous(), b.float().contiguous(),
                         K.float().contiguous(), iters=iters)
