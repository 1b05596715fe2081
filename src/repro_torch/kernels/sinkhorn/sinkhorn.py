"""CUDA kernels of the dense Sinkhorn loop, their wrapper and plain version.

``csrc/sinkhorn_resident.cu`` replaces ``sinkhorn_pallas`` with two
kernels, one launch per call either way:

- ``sinkhorn_resident`` — one block keeps K in shared memory for all H
  iterations; taken while K and the block's vectors fit in the card's
  per-block shared memory (:func:`fits_shared_memory`);
- ``sinkhorn_grid`` — a cooperative grid reads K through L2 with a
  grid-wide barrier between half-steps; takes every larger K.

A wrapper given CUDA tensors launches one of them on the current stream or
raises; given CPU tensors it runs the plain PyTorch version
(:func:`ref.sinkhorn_ref`). ``LAUNCHES`` counts launches per kernel (plain
runs do not count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import check_tensor, raise_on
from repro_torch.kernels.sinkhorn.ref import sinkhorn_ref

LAUNCHES = {"sinkhorn_resident": 0, "sinkhorn_grid": 0}

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_lib.load("sinkhorn_resident")
    lib.sinkhorn_resident_max_bytes.argtypes = [_I]
    lib.sinkhorn_resident_max_bytes.restype = _LL
    lib.sinkhorn_resident_bytes.argtypes = [_LL, _LL]
    lib.sinkhorn_resident_bytes.restype = _LL
    lib.sinkhorn_resident_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
    lib.sinkhorn_resident_launch.restype = _I
    lib.sinkhorn_grid_launch.argtypes = [_P, _P, _P, _P, _P, _P, _LL, _LL, _I,
                                         _P]
    lib.sinkhorn_grid_launch.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _max_shared_bytes(device_index: int) -> int:
    got = _lib().sinkhorn_resident_max_bytes(device_index)
    if got < 0:
        raise RuntimeError("could not read the card's shared memory per block")
    return got


def fits_shared_memory(m: int, n: int, device) -> bool:
    """True when the resident kernel can hold an (m, n) K on ``device``'s
    card: K, u, v and the column partials in one block's shared memory."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _lib().sinkhorn_resident_bytes(m, n) <= _max_shared_bytes(index)


# the plain version of both kernels: the dense core loop at tol=0
sinkhorn_plain = sinkhorn_ref


def sinkhorn_cuda(a, b, K, iters: int = 50):
    """T (m, n) float32 from a (m,), b (n,), K (m, n), all float32 and
    contiguous. CUDA tensors launch a kernel; CPU tensors take
    :func:`sinkhorn_plain`.
    """
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if not K.is_cuda:
        return sinkhorn_plain(a, b, K, iters)
    m, n = K.shape
    dev = K.device
    check_tensor("a", a, (m,), torch.float32, dev)
    check_tensor("b", b, (n,), torch.float32, dev)
    check_tensor("K", K, (m, n), torch.float32, dev)
    T = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return T
    stream = torch.cuda.current_stream(dev).cuda_stream
    if fits_shared_memory(m, n, dev):
        raise_on(_lib().sinkhorn_resident_launch(
            a.data_ptr(), b.data_ptr(), K.data_ptr(), T.data_ptr(), m, n,
            iters, stream), "sinkhorn_resident")
        LAUNCHES["sinkhorn_resident"] += 1
        return T
    u = torch.ones(m, dtype=torch.float32, device=dev)
    v = torch.ones(n, dtype=torch.float32, device=dev)
    raise_on(_lib().sinkhorn_grid_launch(
        a.data_ptr(), b.data_ptr(), K.data_ptr(), T.data_ptr(), u.data_ptr(),
        v.data_ptr(), m, n, iters, stream), "sinkhorn_grid")
    LAUNCHES["sinkhorn_grid"] += 1
    return T
