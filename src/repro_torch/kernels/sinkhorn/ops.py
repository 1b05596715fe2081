"""Public wrapper of the dense Sinkhorn loop with K resident on chip.

The reference's wrapper sends K to its TPU kernel while m·n·4 bytes fit
its 8 MiB VMEM budget and to its jnp loop above. Here the three CUDA
kernels together take every size (a cluster's shared memory, the card's,
then L2 and a cooperative grid), so there is no gate: on the card a
kernel always runs, on the CPU the plain loop.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.sinkhorn.sinkhorn import sinkhorn_cuda


def sinkhorn(a, b, K, iters: int = 50, device=None):
    """H plain Sinkhorn iterations on K, then diag(u) K diag(v); (m, n)
    float32, on ``device`` (the card unless given; the CPU runs the
    kernels' plain version)."""
    dev = dispatch.resolve_device(device)
    a, b, K = (t.to(device=dev, dtype=torch.float32).contiguous()
               for t in (a, b, K))
    return sinkhorn_cuda(a, b, K, iters=iters)
