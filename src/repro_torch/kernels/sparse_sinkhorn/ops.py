"""The sparse log-domain Sinkhorn iteration through K7: two launches.

core/sinkhorn.py's ``sparse_sinkhorn_logdomain(_lanes)`` and
``sparse_sinkhorn_unbalanced_log`` run their iterations through
:func:`logdomain_body` on CUDA tensors: it builds the support's two
layouts (by row, by column) and the log-kernel in each layout's order
once, checks them once, and returns the body that maps (f, g) to the next
(f, g) with one half-step launch each (given the unbalanced exponent ρ,
each launch applies it). A flush's B lanes are one support over B·m rows
and B·n columns (each lane's indices offset by its lane), so the same
body runs them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sparse_sinkhorn.sparse_sinkhorn import (
    check_inputs,
    half_step,
    segment_layout,
)


def logdomain_body(la, lb, rows, cols, logvals, m: int, n: int, rho=None):
    """The body of the log-domain scaling loop on a support of s entries:
    la (m,), lb (n,), rows and cols (s,) in [0, m) and [0, n), logvals
    (s,); potentials f (m,), g (n,); ``rho`` None (balanced) or the
    unbalanced exponent, a float32 tensor of shape () or (1,). CUDA
    tensors only: K7 launches on the stream current at this call (the
    plain version is core's body)."""
    s = logvals.shape[0]
    if tuple(rows.shape) != (s,) or tuple(cols.shape) != (s,):
        raise ValueError(f"rows and cols must have shape ({s},), got "
                         f"{tuple(rows.shape)} and {tuple(cols.shape)}")
    by_row, perm = segment_layout(rows, cols, m, n)
    lv_r = logvals[perm]
    by_col, perm = segment_layout(cols, rows, n, m)
    lv_c = logvals[perm]
    check_inputs(by_row, lv_r, la, rho)
    check_inputs(by_col, lv_c, lb, rho)
    stream = (torch.cuda.current_stream(logvals.device).cuda_stream
              if logvals.is_cuda else None)   # CPU: the launch refuses

    def body(carry):
        f, g = carry
        f = half_step(by_row, lv_r, g, la, stream, rho)
        g = half_step(by_col, lv_c, f, lb, stream, rho)
        return (f, g)

    return body
