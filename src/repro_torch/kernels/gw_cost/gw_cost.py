"""CUDA kernel of the grid GW cost assembly, its wrapper and plain version.

    C[k, m] = Σ_{l,p} L(A[k,l], B[m,p]) T[l,p]

for l1, l2 and kl (``csrc/gw_cost.cu``, replaces ``gw_cost_pallas``). No
4-D tile is stored: each block stages chunks of A, B and T in shared
memory and keeps its outputs in registers.

A wrapper given CUDA tensors launches the kernel on the current stream or
raises; given CPU tensors it runs the plain PyTorch version
(:func:`ref.gw_cost_ref`). ``LAUNCHES`` counts kernel launches (plain runs
do not count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import LOSS_CODES, check_tensor, raise_on
from repro_torch.kernels.gw_cost.ref import gw_cost_ref

LAUNCHES = {"gw_cost": 0}

# threads per block = 16 output groups x l-splits; the kernel takes these
THREADS = (32, 64, 128, 256)

_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launch_counts() -> None:
    LAUNCHES["gw_cost"] = 0


@functools.lru_cache(maxsize=None)
def _fn():
    fn = cuda_lib.load("gw_cost").gw_cost_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


# the plain version of the kernel: the chunked 4-D contraction
gw_cost_plain = gw_cost_ref


def gw_cost_cuda(A, B, T, loss: str = "l1", threads: int = 256):
    """C (K, M) float32 from A (K, L), B (M, P), T (L, P), all float32 and
    contiguous. CUDA tensors launch the kernel; CPU tensors take
    :func:`gw_cost_plain`.
    """
    if loss not in LOSS_CODES:
        raise ValueError(f"unknown ground loss {loss!r}")
    if not A.is_cuda:
        return gw_cost_plain(A, B, T, loss)
    K, Ld = A.shape
    M, P = B.shape
    dev = A.device
    check_tensor("A", A, (K, Ld), torch.float32, dev)
    check_tensor("B", B, (M, P), torch.float32, dev)
    check_tensor("T", T, (Ld, P), torch.float32, dev)
    if threads not in THREADS:
        raise ValueError(f"threads per block must be one of {THREADS}, "
                         f"got {threads}")
    if M > 65535 * 16:          # m tiles run along the grid's y axis
        raise ValueError(f"gw_cost: M = {M} exceeds the kernel's grid")
    out = torch.empty((K, M), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    raise_on(_fn()(A.data_ptr(), B.data_ptr(), T.data_ptr(), out.data_ptr(),
                    K, Ld, M, P, LOSS_CODES[loss], threads, stream), "gw_cost")
    LAUNCHES["gw_cost"] += 1
    return out
