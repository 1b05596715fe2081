"""Plain PyTorch version of the resident Sinkhorn kernel.

H plain Sinkhorn iterations ``u = a/(Kv)``, ``v = b/(Kᵀu)`` (0 where the
denominator is <= 0) from v = 1, then ``diag(u) K diag(v)``: the dense core
loop at ``tol=0``, with the reference's subnormal flush.
"""
from __future__ import annotations

from repro_torch.core.sinkhorn import sinkhorn


def sinkhorn_ref(a, b, K, iters: int):
    """a (m,), b (n,), K (m, n) -> the coupling T (m, n)."""
    return sinkhorn(a, b, K, iters)
