"""Public wrapper of the grid GW cost assembly.

``gw_cost`` takes float32 or bfloat16 inputs and computes in float32, as
the reference's kernel does; a bfloat16 input is cast once here. Nothing
is padded: the kernel masks its ragged edges itself.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.gw_cost.gw_cost import gw_cost_cuda

dispatch.register("gw_cost", default_block=256,
                  description="grid GW cost assembly (4-D contraction); "
                              "block = CUDA threads per block: 32, 64, 128 "
                              "or 256, one warp per range of p of a 32 x 32 "
                              "output tile (the split of l over blocks is "
                              "set by the shape and the card)")


def gw_cost(A, B, T, loss: str = "l1", block: Optional[int] = None,
            device=None):
    """C[k,m] = Σ_{l,p} L(A[k,l], B[m,p]) T[l,p], (K, M) float32, on
    ``device`` (the card unless given; the CPU runs the kernel's plain
    version)."""
    dev = dispatch.resolve_device(device)
    b = dispatch.block_size("gw_cost", block)
    A, B, T = (t.to(device=dev, dtype=torch.float32).contiguous()
               for t in (A, B, T))
    return gw_cost_cuda(A, B, T, loss=loss, threads=b)
