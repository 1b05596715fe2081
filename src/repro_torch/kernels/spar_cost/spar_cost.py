"""CUDA kernels of the COO spar_cost family, their wrappers and plain versions.

The paper's O(s²) hotspot on the COO support is

    C̃(T̃)_k = Σ_l L(Cx[r_k, r_l], Cy[c_k, c_l]) T̃_l,      k ∈ [s]

and the outer PGA step only consumes the log-kernel, so both kernels
compute the affine form ``out = L-matvec(t) + off`` with fp32 accumulation
(callers pre-scale ``t`` and fold the log terms into ``off``):

- :func:`spar_cost_cuda` — gather-fused (``csrc/spar_cost_fused.cu``,
  replaces ``spar_cost_pallas``); no (s, s) storage. A block stages the
  Cx/Cy rows of a group of outputs in shared memory and streams the
  support past them; ``ops.make_spar_cost_fn`` sorts the support by row
  once so that the stream's Cx gathers are broadcasts, and passes the
  permutation that scatters the outputs back (``perm``).
- :func:`spar_matvec_cuda` — materialized-support matvec
  (``csrc/spar_matvec.cu``, replaces ``spar_matvec_pallas``) over the
  iteration-invariant loss matrix. It also takes a lane axis: Lmat
  (B, s, s), t and off (B, s), one launch for the B lanes of a server
  flush (the reference runs the Pallas kernel under ``vmap`` there), each
  lane bitwise what a single-lane launch gives it.

A wrapper given CUDA tensors launches its kernel on the current stream or
raises; given CPU tensors it runs the plain PyTorch version beside it.
``LAUNCHES`` counts kernel launches per wrapper (plain runs do not count).

Gradients. The matvec is differentiable: with grad enabled and an input
that requires grad, :func:`spar_matvec_cuda` goes through
:class:`SparMatvec`, whose forward is the kernel (or the plain version on
CPU tensors) and whose backward is plain torch (dLmat = g ⊗ t,
dt = Lmatᵀ g, doff = g; in ``bmm`` form over lanes), the gradient the
reference's CPU route (``Lmat @ t``) has. The reference has no backward
for any Pallas kernel, so no backward kernel is written. The
gather-fused kernel refuses a gradient as the reference's does
(``dispatch.refuse_grad``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import LOSS_CODES, check_tensor, raise_on
from repro_torch.kernels.dispatch import refuse_grad
from repro_torch.kernels.spar_cost.ref import spar_cost_ref
from repro_torch.obs.span import span

LAUNCHES = {"spar_matvec": 0, "spar_cost_fused": 0}

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# gridDim.y of the lanes launch
MAX_LANES = 65535


@functools.lru_cache(maxsize=None)
def _matvec_lib():
    lib = cuda_lib.load("spar_matvec")
    lib.spar_matvec_launch.argtypes = [_P, _P, _P, _P, _LL, _I, _P]
    lib.spar_matvec_launch.restype = _I
    lib.spar_matvec_lanes_launch.argtypes = [_P, _LL, _P, _P, _P, _LL, _I,
                                             _I, _P]
    lib.spar_matvec_lanes_launch.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _fused_lib():
    lib = cuda_lib.load("spar_cost_fused")
    lib.spar_cost_fused_launch.argtypes = [_P, _LL, _P, _LL, _P, _P, _P, _P,
                                           _P, _P, _LL, _I, _I, _P]
    lib.spar_cost_fused_launch.restype = _I
    lib.spar_cost_fused_rows_per_block.argtypes = [_LL, _LL, _LL, _I]
    lib.spar_cost_fused_rows_per_block.restype = _I
    return lib


def fused_rows_per_block(m: int, n: int, s: int, threads: int = 1024) -> int:
    """Outputs per block of the fused kernel's shared-memory rows path at
    this shape on the current card; 0 where (m + n) floats do not fit in a
    block's shared memory and the kernel reads the rows through L1/L2."""
    g = _fused_lib().spar_cost_fused_rows_per_block(m, n, s, threads)
    if g < 0:
        raise RuntimeError("spar_cost_fused: could not query the device")
    return g


def check_threads(threads: int):
    if threads <= 0 or threads % 32 or threads > 1024:
        raise ValueError(f"threads per block must be a multiple of 32 in "
                         f"[32, 1024], got {threads}")


def spar_matvec_plain(Lmat, t, off):
    """Plain version of the matvec kernel: Lmat @ t + off; with a lane
    axis, that of each lane (a lane's bits are then its single-lane bits,
    as the kernel's are)."""
    if Lmat.ndim == 3:
        return torch.stack([L @ x for L, x in zip(Lmat, t)]) + off
    return Lmat @ t + off


def spar_matvec_cuda(Lmat, t, off, threads: int = 256):
    """out = Lmat @ t + off, (s,) float32, or (B, s) over B lanes.

    Lmat (s, s), t and off (s,), all float32 and contiguous; or Lmat
    (B, s, s) with contiguous rows and 16-byte aligned lanes (a lane
    stride that is a multiple of 4 floats), t and off (B, s) contiguous,
    one launch for all lanes. CUDA tensors launch the kernel; CPU tensors
    take :func:`spar_matvec_plain`. With grad enabled and an input
    requiring grad the call goes through :class:`SparMatvec` and its
    output carries the gradient.
    """
    if torch.is_grad_enabled() and (Lmat.requires_grad or t.requires_grad
                                    or off.requires_grad):
        return SparMatvec.apply(Lmat, t, off, threads)
    return _spar_matvec_forward(Lmat, t, off, threads)


class SparMatvec(torch.autograd.Function):
    """out = Lmat @ t + off through the matvec kernel, with a plain torch
    backward: dLmat = g ⊗ t, dt = Lmatᵀ g, doff = g, each computed only
    for the inputs that need it (the same products autograd takes
    through :func:`spar_matvec_plain`)."""

    @staticmethod
    def forward(ctx, Lmat, t, off, threads):
        ctx.save_for_backward(Lmat if ctx.needs_input_grad[1] else None,
                              t if ctx.needs_input_grad[0] else None)
        return _spar_matvec_forward(Lmat, t, off, threads)

    @staticmethod
    def backward(ctx, g):
        Lmat, t = ctx.saved_tensors
        need_L, need_t, need_off, _ = ctx.needs_input_grad
        if g.ndim == 2:                                  # lanes: bmm form
            return (g[:, :, None] * t[:, None, :] if need_L else None,
                    (Lmat.transpose(1, 2) @ g[..., None])[..., 0]
                    if need_t else None,
                    g if need_off else None, None)
        return (torch.outer(g, t) if need_L else None,
                Lmat.t().mv(g) if need_t else None,
                g if need_off else None, None)


def _spar_matvec_forward(Lmat, t, off, threads: int):
    if not Lmat.is_cuda:
        return spar_matvec_plain(Lmat, t, off)
    if Lmat.ndim == 3:
        return _spar_matvec_lanes(Lmat, t, off, threads)
    s = Lmat.shape[0]
    dev = Lmat.device
    check_tensor("Lmat", Lmat, (s, s), torch.float32, dev)
    check_tensor("t", t, (s,), torch.float32, dev)
    check_tensor("off", off, (s,), torch.float32, dev)
    check_threads(threads)
    out = torch.empty(s, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    raise_on(_matvec_lib().spar_matvec_launch(
        Lmat.data_ptr(), t.data_ptr(), off.data_ptr(), out.data_ptr(), s,
        threads, stream), "spar_matvec")
    LAUNCHES["spar_matvec"] += 1
    return out


def _spar_matvec_lanes(Lmat, t, off, threads: int):
    """The lanes launch on (B, s, s) / (B, s) CUDA tensors, checked here."""
    B, s = Lmat.shape[0], Lmat.shape[1]
    dev = Lmat.device
    if tuple(Lmat.shape) != (B, s, s):
        raise ValueError(f"Lmat has shape {tuple(Lmat.shape)}, expected "
                         f"(B, s, s)")
    if Lmat.dtype != torch.float32:
        raise TypeError(f"Lmat has dtype {Lmat.dtype}, expected "
                        f"torch.float32")
    lane_stride = Lmat.stride(0)
    if (Lmat.stride(2) != 1 or Lmat.stride(1) != s or lane_stride < s * s
            or lane_stride % 4 or Lmat.data_ptr() % 16):
        raise ValueError("Lmat needs contiguous rows and 16-byte aligned "
                         "lanes (a lane stride that is a multiple of 4 "
                         "floats)")
    if not 1 <= B <= MAX_LANES:
        raise ValueError(f"lanes must be in [1, {MAX_LANES}], got {B}")
    check_tensor("t", t, (B, s), torch.float32, dev)
    check_tensor("off", off, (B, s), torch.float32, dev)
    check_threads(threads)
    out = torch.empty((B, s), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    raise_on(_matvec_lib().spar_matvec_lanes_launch(
        Lmat.data_ptr(), lane_stride, t.data_ptr(), off.data_ptr(),
        out.data_ptr(), s, B, threads, stream), "spar_matvec")
    LAUNCHES["spar_matvec"] += 1
    return out


def spar_cost_plain(Cx, Cy, rows, cols, t, off, loss: str,
                    chunk: int = 1024, perm=None):
    """Plain version of the fused kernel: row-chunked L-matvec + off.

    With ``perm``, the support (rows, cols, t) is in the kernel's order and
    output k goes to ``perm[k]`` with ``off[perm[k]]`` added, as in the
    kernel."""
    if perm is None:
        return spar_cost_ref(Cx, Cy, rows, cols, t, loss, chunk) + off
    perm = perm.long()
    out = torch.empty_like(off)
    out[perm] = spar_cost_ref(Cx, Cy, rows, cols, t, loss, chunk) + off[perm]
    return out


def spar_cost_cuda(Cx, Cy, rows, cols, t, off, loss: str = "l2",
                   threads: int = 1024):
    """Gather-fused out = L(Cx[rows][:, rows], Cy[cols][:, cols]) @ t + off.

    Cx (m, m), Cy (n, n), t and off (s,) float32; rows and cols (s,) int32
    (int64 on the CPU path is fine too). CUDA tensors launch the kernel;
    CPU tensors take :func:`spar_cost_plain`.
    """
    if loss not in LOSS_CODES:
        raise ValueError(f"unknown ground loss {loss!r}")
    refuse_grad("spar_cost_fused (K2)", Cx, Cy, t, off)
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
    check_threads(threads)
    check_support_range(rows, cols, m, n)
    return launch_fused(Cx, Cy, rows, cols, t, off, loss, threads)


def check_support_range(rows, cols, m: int, n: int):
    """Raise unless 0 <= rows < m and 0 <= cols < n: the kernel reads Cx
    and Cy at these indices. One host sync (a ``solver.host_read`` span,
    site ``cost_range``)."""
    if not rows.shape[0]:
        return
    lo_r, hi_r = torch.aminmax(rows)
    lo_c, hi_c = torch.aminmax(cols)
    with span("solver.host_read", site="cost_range"):
        lo_r, hi_r, lo_c, hi_c = torch.stack(
            [lo_r, hi_r, lo_c, hi_c]).tolist()
    if lo_r < 0 or hi_r >= m or lo_c < 0 or hi_c >= n:
        raise IndexError(f"support indices out of range: rows in "
                         f"[{lo_r}, {hi_r}] for m={m}, cols in "
                         f"[{lo_c}, {hi_c}] for n={n}")


def launch_fused(Cx, Cy, rows, cols, t, off, loss: str, threads: int,
                 perm=None):
    """The fused kernel on arguments already checked by the caller (the
    index range included), or its plain version on CPU tensors.

    ``perm`` (int32, optional): output k of the support as given goes to
    ``perm[k]``, with ``off[perm[k]]`` added. Refuses a gradient
    (``dispatch.refuse_grad``)."""
    refuse_grad("spar_cost_fused (K2)", Cx, Cy, t, off)
    if not Cx.is_cuda:
        return spar_cost_plain(Cx, Cy, rows, cols, t, off, loss, perm=perm)
    s = rows.shape[0]
    out = torch.empty(s, dtype=torch.float32, device=Cx.device)
    stream = torch.cuda.current_stream(Cx.device).cuda_stream
    raise_on(_fused_lib().spar_cost_fused_launch(
        Cx.data_ptr(), Cx.shape[0], Cy.data_ptr(), Cy.shape[0],
        rows.data_ptr(), cols.data_ptr(), t.data_ptr(), off.data_ptr(),
        None if perm is None else perm.data_ptr(), out.data_ptr(), s,
        LOSS_CODES[loss], threads, stream), "spar_cost_fused")
    LAUNCHES["spar_cost_fused"] += 1
    return out
