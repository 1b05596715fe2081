"""Plain PyTorch version of the grid GW cost assembly.

C[k, m] = Σ_{l,p} L(A[k,l], B[m,p]) T[l,p] — the paper's O(s²) hotspot
restructured on the grid support. The 4-D loss tile is built for a chunk
of k at a time, in (k, m, l, p) order so that the contraction over (l, p)
is one matrix-vector product with no copy. The chunk is bounded by bytes
and the last one is ragged, so a prime side length costs nothing extra.
"""
from __future__ import annotations

import torch

from repro_torch.core import ground_cost as gc

# bound on the (chunk, M, L, P) float32 loss tile of one chunk: at the grid
# main path's 181⁴ a single k is 23.7 MB, so a chunk holds 5 rows of k
CHUNK_BYTES = 128 * 2**20


def gw_cost_ref(A, B, T, loss: str, chunk_bytes: int = CHUNK_BYTES):
    """A (K, L), B (M, P), T (L, P) -> C (K, M) float32, chunked over k."""
    A, B, T = A.float(), B.float(), T.float()
    L = gc.get_loss(loss)
    K, Ld = A.shape
    M, P = B.shape
    per_k = max(M * Ld * P * 4, 1)
    chunk = max(1, min(K, chunk_bytes // per_k))
    t = T.reshape(-1)
    out = []
    for lo in range(0, K, chunk):
        E = L(A[lo:lo + chunk, None, :, None], B[None, :, None, :])
        k = E.shape[0]
        out.append((E.reshape(k * M, Ld * P) @ t).reshape(k, M))
    if not out:
        return A.new_zeros((0, M))
    return torch.cat(out)


def gw_cost_error_scale(A, B, T, loss: str):
    """Per-output scale of fp32 rounding in the cost assembly, (K, M).

    Σ_{l,p} |terms of L(A[k,l], B[m,p])|·|T[l,p]|, in closed form: two
    correct fp32 evaluations that sum in different orders differ by at
    most about (sequential additions)·2⁻²⁴ times this scale. kl cancels,
    so |L| itself would be too small a scale.
    """
    A, B, T = A.float().abs(), B.float().abs(), T.float().abs()
    row, col = T.sum(dim=1), T.sum(dim=0)
    if loss == "l1":                       # |a| + |b|
        return (A @ row)[:, None] + (B @ col)[None, :]
    if loss == "l2":                       # (|a| + |b|)²
        return ((A * A) @ row)[:, None] + ((B * B) @ col)[None, :] \
            + 2.0 * A @ T @ B.t()
    if loss == "kl":                       # |a|(|log a| + |log b|) + |a| + |b|
        la = torch.log(torch.clamp_min(A, gc._KL_EPS)).abs()
        lb = torch.log(torch.clamp_min(B, gc._KL_EPS)).abs()
        return ((A * (la + 1.0)) @ row)[:, None] \
            + (B @ col)[None, :] + A @ T @ lb.t()
    raise ValueError(f"unknown ground loss {loss!r}")
