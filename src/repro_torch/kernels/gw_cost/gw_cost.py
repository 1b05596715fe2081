"""CUDA kernel of the grid GW cost assembly, its wrapper and plain version.

    C[k, m] = Σ_{l,p} L(A[k,l], B[m,p]) T[l,p]

for l1, l2 and kl (``csrc/gw_cost.cu``, replaces ``gw_cost_pallas``). No
4-D tile is stored: a block owns a 32 x 32 output tile and one of S ranges
of l (S chosen per shape and card so that the SMs get equal work), stages
A, B and T in shared memory and keeps its outputs in registers; with S > 1
the partial tiles go to a workspace and a second kernel adds them in split
order, so runs are bit-identical.

A wrapper given CUDA tensors launches the kernel on the current stream or
raises; given CPU tensors it runs the plain PyTorch version
(:func:`ref.gw_cost_ref`). ``LAUNCHES`` counts kernel launches (plain runs
do not count). Neither has a gradient: with grad enabled and an input
requiring grad the wrapper raises, as ``jax.grad`` through the reference's
kernel does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import LOSS_CODES, check_tensor, raise_on
from repro_torch.kernels.dispatch import refuse_grad
from repro_torch.kernels.gw_cost.ref import gw_cost_ref

LAUNCHES = {"gw_cost": 0}

# threads per block = 32 x the warps of a block, each warp one range of p;
# the kernel takes these
THREADS = (32, 64, 128, 256)

_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launch_counts() -> None:
    LAUNCHES["gw_cost"] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_lib.load("gw_cost")
    lib.gw_cost_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _P]
    lib.gw_cost_launch.restype = _I
    lib.gw_cost_splits.argtypes = [_I, _I, _I]
    lib.gw_cost_splits.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _splits(K: int, L: int, M: int, index: int) -> int:
    with torch.cuda.device(index):
        S = _lib().gw_cost_splits(K, L, M)
    if S < 1:
        raise RuntimeError("gw_cost: could not read the card's SM count")
    return S


def splits(K: int, L: int, M: int, device) -> int:
    """How many ranges of l a launch at this shape splits the (l, p) sum
    into on ``device`` (a CUDA device): fixed by the shape and the card's
    SM count, so every run sums in the same order."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _splits(K, L, M, index)


# the plain version of the kernel: the chunked 4-D contraction
gw_cost_plain = gw_cost_ref


def gw_cost_cuda(A, B, T, loss: str = "l1", threads: int = 256):
    """C (K, M) float32 from A (K, L), B (M, P), T (L, P), all float32 and
    contiguous. CUDA tensors launch the kernel; CPU tensors take
    :func:`gw_cost_plain`. Refuses a gradient, on either device, as the
    reference's Pallas kernel does (``dispatch.refuse_grad``).
    """
    if loss not in LOSS_CODES:
        raise ValueError(f"unknown ground loss {loss!r}")
    refuse_grad("gw_cost (K3)", A, B, T)
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
    out = torch.empty((K, M), dtype=torch.float32, device=dev)
    S = splits(K, Ld, M, dev)
    ws = torch.empty((S, K, M) if S > 1 else (0,), dtype=torch.float32,
                     device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    raise_on(_lib().gw_cost_launch(
        A.data_ptr(), B.data_ptr(), T.data_ptr(), out.data_ptr(),
        ws.data_ptr() if S > 1 else None, K, Ld, M, P, LOSS_CODES[loss],
        threads, S, stream), "gw_cost")
    LAUNCHES["gw_cost"] += 1
    return out
