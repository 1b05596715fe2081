"""Peaks of the card and the least work of a SPAR-GW solve (l2 loss).

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its full
700 W power limit): 67 TFLOP/s in float32 outside the tensor cores and
3.35 TB/s of HBM3. A card set below 700 W (the run prints its limit)
reaches less, so a share read there is against the published peak.

The counts are those of the cheapest exact route known, not proven lower
bounds; a program that finds a cheaper one reads a share above its true
one, and has to bring a new count with it:

* a cost evaluation on a support of s pairs of two n-point clouds. For the
  l2 loss, L(T)_k = (Cx²u)[r_k] + (Cy²v)[c_k] - 2 (Cx D Cyᵀ)[r_k, c_k],
  where u, v are T's row and column sums and D the n x n matrix that holds
  T's s entries. D Cyᵀ by D's sparse rows is 2 s n float32 operations, the
  s dot products of length n that pick the cross term another 2 s n: 4 s n
  (the two matrix-vector products, 4 n², are left out). Its bytes are the
  two cost matrices read once, 8 n², and for each pair its two indices,
  its iterate and its output, 16 s. An (s, s) loss matrix that a program
  materializes is not an input and is not counted;
* a log-domain Sinkhorn iteration on s pairs: each half step adds a
  potential, takes the maximum out, exponentiates and sums into segments,
  8 s operations an iteration (an exp counted as one). Its 16 s bytes can
  stay in the card's cache and are not counted;
* a solve makes ``outer_iters`` cost evaluations and one more for its
  value, and ``outer_iters · inner_iters`` Sinkhorn iterations.
"""
from __future__ import annotations

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

SINKHORN_OPS_PER_PAIR = 8


def least_s(ops: float, nbytes: float) -> float:
    """The least time of ``ops`` float32 operations and ``nbytes`` of
    HBM traffic: the larger of the two bounds, in seconds."""
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)


def cost_eval_ops(s: int, n: int) -> float:
    """Float32 operations of one l2 cost evaluation (s pairs, n points)."""
    return 4.0 * s * n


def cost_eval_bytes(s: int, n: int) -> float:
    """HBM bytes of one l2 cost evaluation."""
    return 8.0 * n * n + 16.0 * s


def cost_eval_s(s: int, n: int) -> float:
    """Least time of one l2 cost evaluation."""
    return least_s(cost_eval_ops(s, n), cost_eval_bytes(s, n))


def solve_ops(s: int, n: int, outer_iters: int, inner_iters: int) -> float:
    """Float32 operations of one whole solve."""
    return ((outer_iters + 1) * cost_eval_ops(s, n)
            + outer_iters * inner_iters * SINKHORN_OPS_PER_PAIR * float(s))
