"""CUDA kernels of the dense Sinkhorn loop, their wrapper and plain version.

``csrc/sinkhorn.cu`` replaces ``sinkhorn_pallas`` with three kernels, one
launch per call, chosen by size (:func:`sinkhorn_route`):

- ``sinkhorn_cluster`` — one thread block cluster of 16 (or 8) CTAs keeps
  K in the CTAs' shared memory for all H iterations, one band of rows
  each; the CTAs exchange partial column sums through distributed shared
  memory, one mbarrier wait an iteration; taken while a band fits a CTA;
- ``sinkhorn_card`` — a cooperative grid of at most one CTA an SM keeps K
  in the shared memory of the whole card, with two grid barriers an
  iteration; taken while a band of ceil(m / SMs) rows fits a CTA;
- ``sinkhorn_stream`` — a cooperative grid reads K through L2 with a grid
  barrier between half-steps; takes every larger K.

A wrapper given CUDA tensors launches one of them on the current stream or
raises; given CPU tensors it runs the plain PyTorch version
(:func:`ref.sinkhorn_ref`). ``LAUNCHES`` counts launches per route (plain
runs do not count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import check_tensor, raise_on
from repro_torch.kernels.sinkhorn.ref import sinkhorn_ref

LAUNCHES = {"sinkhorn_cluster": 0, "sinkhorn_card": 0, "sinkhorn_stream": 0}

THREADS = 512                # a CTA of the cluster and card kernels
CLUSTER_SIZES = (16, 8)      # 16 needs the card's consent; 8 is portable

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def card_bytes(m: int, n: int, ctas: int) -> int:
    """Shared memory of a card-kernel CTA: its band of ceil(m/ctas) rows of
    K (rows padded to 4 floats), u and a on the band, v and b."""
    band, ld = -(-m // ctas), _round4(n)
    return 4 * (band * ld + 2 * _round4(band) + 2 * ld)


def cluster_bytes(m: int, n: int, ctas: int) -> int:
    """Shared memory of a cluster-kernel CTA: a card-kernel CTA's, the
    partial column sums of every CTA of two iterations, two mbarriers."""
    return card_bytes(m, n, ctas) + 4 * 2 * ctas * _round4(n) + 16


def sinkhorn_route(m: int, n: int, smem_per_block: int, sms: int,
                   max_cluster: int) -> tuple[str, int]:
    """The kernel that takes an (m, n) K, and its CTAs (0: the launcher
    sizes the grid), from the card's numbers: the shared memory one block
    may use, its SMs and its largest cluster.

    The largest cluster the card allows whose bands fit a CTA (16 CTAs
    halve the rows each walks, for 16 partial vectors instead of 8 to
    send and add); else the card kernel, with bands of ceil(m / sms) rows,
    if they fit; else the stream kernel.
    """
    for ctas in CLUSTER_SIZES:
        if ctas <= max_cluster and cluster_bytes(m, n, ctas) <= smem_per_block:
            return "sinkhorn_cluster", ctas
    ctas = -(-m // -(-m // sms))          # CTAs of ceil(m / sms) rows
    if card_bytes(m, n, ctas) <= smem_per_block:
        return "sinkhorn_card", ctas
    return "sinkhorn_stream", 0


def barriers(route: str, iters: int) -> dict:
    """The barriers a call of ``route`` waits at, by kind."""
    if route == "sinkhorn_cluster":
        return {"mbarrier_waits": iters, "cluster_barriers": 2}
    return {"grid_barriers": 2 * iters}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_lib.load("sinkhorn")
    lib.sinkhorn_card_numbers.argtypes = [_P]
    lib.sinkhorn_card_numbers.restype = _I
    lib.sinkhorn_cluster_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                            _P]
    lib.sinkhorn_cluster_launch.restype = _I
    lib.sinkhorn_card_launch.argtypes = [_P, _P, _P, _P, _P, _LL, _I, _I, _I,
                                         _I, _P]
    lib.sinkhorn_card_launch.restype = _I
    lib.sinkhorn_stream_launch.argtypes = [_P, _P, _P, _P, _P, _P, _LL, _LL,
                                           _I, _P]
    lib.sinkhorn_stream_launch.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def card_numbers(device_index: int) -> tuple[int, int, int]:
    """(shared memory one block may use, SMs, largest cluster) of a card,
    read once."""
    out = (ctypes.c_longlong * 3)()
    with torch.cuda.device(device_index):
        raise_on(_lib().sinkhorn_card_numbers(ctypes.addressof(out)),
                 "sinkhorn_card_numbers")
    return tuple(int(x) for x in out)


def route(m: int, n: int, device) -> tuple[str, int]:
    """:func:`sinkhorn_route` for an (m, n) K on ``device``'s card."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return sinkhorn_route(m, n, *card_numbers(index))


# the plain version of the three kernels: the dense core loop at tol=0
sinkhorn_plain = sinkhorn_ref


def sinkhorn_cuda(a, b, K, iters: int = 50):
    """T (m, n) float32 from a (m,), b (n,), K (m, n), all float32 and
    contiguous. CUDA tensors launch the kernel :func:`route` picks; CPU
    tensors take :func:`sinkhorn_plain`.
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
    name, ctas = route(m, n, dev)
    ptrs = (a.data_ptr(), b.data_ptr(), K.data_ptr(), T.data_ptr())
    if name == "sinkhorn_cluster":
        err = _lib().sinkhorn_cluster_launch(*ptrs, m, n, ctas, iters, stream)
    elif name == "sinkhorn_card":
        work = torch.empty((ctas + 1) * _round4(n), dtype=torch.float32,
                           device=dev)
        err = _lib().sinkhorn_card_launch(*ptrs, work.data_ptr(), work.numel(),
                                          m, n, ctas, iters, stream)
    else:
        u = torch.ones(m, dtype=torch.float32, device=dev)
        v = torch.ones(n, dtype=torch.float32, device=dev)
        err = _lib().sinkhorn_stream_launch(*ptrs, u.data_ptr(), v.data_ptr(),
                                            m, n, iters, stream)
    raise_on(err, name)
    LAUNCHES[name] += 1
    return T
