"""CUDA kernels of the COO spar_cost family, their wrappers and plain versions.

The paper's O(s²) hotspot on the COO support is

    C̃(T̃)_k = Σ_l L(Cx[r_k, r_l], Cy[c_k, c_l]) T̃_l,      k ∈ [s]

and the outer PGA step only consumes the log-kernel, so both kernels
compute the affine form ``out = L-matvec(t) + off`` with fp32 accumulation
(callers pre-scale ``t`` and fold the log terms into ``off``):

- :func:`spar_cost_cuda` — gather-fused (``csrc/spar_cost_fused.cu``,
  replaces ``spar_cost_pallas``); no (s, s) storage.
- :func:`spar_matvec_cuda` — materialized-support matvec
  (``csrc/spar_matvec.cu``, replaces ``spar_matvec_pallas``) over the
  iteration-invariant loss matrix.

A wrapper given CUDA tensors launches its kernel on the current stream or
raises; given CPU tensors it runs the plain PyTorch version beside it.
``LAUNCHES`` counts kernel launches per wrapper (plain runs do not count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import LOSS_CODES, check_tensor, raise_on
from repro_torch.kernels.spar_cost.ref import spar_cost_ref

LAUNCHES = {"spar_matvec": 0, "spar_cost_fused": 0}

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _matvec_fn():
    fn = cuda_lib.load("spar_matvec").spar_matvec_launch
    fn.argtypes = [_P, _P, _P, _P, _LL, _I, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _fused_fn():
    fn = cuda_lib.load("spar_cost_fused").spar_cost_fused_launch
    fn.argtypes = [_P, _LL, _P, _LL, _P, _P, _P, _P, _P, _LL, _I, _I, _P]
    fn.restype = _I
    return fn


def _check_threads(threads: int):
    if threads <= 0 or threads % 32 or threads > 1024:
        raise ValueError(f"threads per block must be a multiple of 32 in "
                         f"[32, 1024], got {threads}")


def spar_matvec_plain(Lmat, t, off):
    """Plain version of the matvec kernel: Lmat @ t + off."""
    return Lmat @ t + off


def spar_matvec_cuda(Lmat, t, off, threads: int = 256):
    """out = Lmat @ t + off, (s,) float32.

    Lmat (s, s), t and off (s,), all float32 and contiguous. CUDA tensors
    launch the kernel; CPU tensors take :func:`spar_matvec_plain`.
    """
    if not Lmat.is_cuda:
        return spar_matvec_plain(Lmat, t, off)
    s = Lmat.shape[0]
    dev = Lmat.device
    check_tensor("Lmat", Lmat, (s, s), torch.float32, dev)
    check_tensor("t", t, (s,), torch.float32, dev)
    check_tensor("off", off, (s,), torch.float32, dev)
    _check_threads(threads)
    out = torch.empty(s, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    raise_on(_matvec_fn()(Lmat.data_ptr(), t.data_ptr(), off.data_ptr(),
                           out.data_ptr(), s, threads, stream), "spar_matvec")
    LAUNCHES["spar_matvec"] += 1
    return out


def spar_cost_plain(Cx, Cy, rows, cols, t, off, loss: str,
                    chunk: int = 1024):
    """Plain version of the fused kernel: row-chunked L-matvec + off."""
    return spar_cost_ref(Cx, Cy, rows, cols, t, loss, chunk) + off


def spar_cost_cuda(Cx, Cy, rows, cols, t, off, loss: str = "l2",
                   threads: int = 256):
    """Gather-fused out = L(Cx[rows][:, rows], Cy[cols][:, cols]) @ t + off.

    Cx (m, m), Cy (n, n), t and off (s,) float32; rows and cols (s,) int32
    (int64 on the CPU path is fine too). CUDA tensors launch the kernel;
    CPU tensors take :func:`spar_cost_plain`.
    """
    if loss not in LOSS_CODES:
        raise ValueError(f"unknown ground loss {loss!r}")
    if not Cx.is_cuda:
        return spar_cost_plain(Cx, Cy, rows, cols, t, off, loss)
    m, n, s = Cx.shape[0], Cy.shape[0], rows.shape[0]
    dev = Cx.device
    check_tensor("Cx", Cx, (m, m), torch.float32, dev)
    check_tensor("Cy", Cy, (n, n), torch.float32, dev)
    check_tensor("rows", rows, (s,), torch.int32, dev)
    check_tensor("cols", cols, (s,), torch.int32, dev)
    check_tensor("t", t, (s,), torch.float32, dev)
    check_tensor("off", off, (s,), torch.float32, dev)
    _check_threads(threads)
    if s:   # the kernel reads Cx/Cy at these indices: keep them in range
        lo_r, hi_r = torch.aminmax(rows)
        lo_c, hi_c = torch.aminmax(cols)
        lo_r, hi_r, lo_c, hi_c = torch.stack(
            [lo_r, hi_r, lo_c, hi_c]).tolist()
        if lo_r < 0 or hi_r >= m or lo_c < 0 or hi_c >= n:
            raise IndexError(f"support indices out of range: rows in "
                             f"[{lo_r}, {hi_r}] for m={m}, cols in "
                             f"[{lo_c}, {hi_c}] for n={n}")
    out = torch.empty(s, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    raise_on(_fused_fn()(Cx.data_ptr(), m, Cy.data_ptr(), n, rows.data_ptr(),
                          cols.data_ptr(), t.data_ptr(), off.data_ptr(),
                          out.data_ptr(), s, LOSS_CODES[loss], threads,
                          stream), "spar_cost_fused")
    LAUNCHES["spar_cost_fused"] += 1
    return out
