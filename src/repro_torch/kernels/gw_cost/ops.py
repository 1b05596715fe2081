"""Public wrapper of the grid GW cost assembly.

``gw_cost`` takes float32 or bfloat16 inputs and computes in float32, as
the reference's kernel does; a bfloat16 input is cast once here. Nothing
is padded: the kernel masks its ragged edges itself.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import dispatch
from repro_torch.kernels.gw_cost.gw_cost import gw_cost_cuda

dispatch.register("gw_cost", default_block=256,
                  description="grid GW cost assembly (4-D contraction); "
                              "block = CUDA threads per block, 16 output "
                              "groups x l-splits")


def gw_cost(A, B, T, loss: str = "l1", block: Optional[int] = None):
    """C[k,m] = Σ_{l,p} L(A[k,l], B[m,p]) T[l,p], (K, M) float32."""
    b = dispatch.block_size("gw_cost", block)
    return gw_cost_cuda(A.float().contiguous(), B.float().contiguous(),
                        T.float().contiguous(), loss=loss, threads=b)
