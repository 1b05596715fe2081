"""CUDA kernel of the Mamba2 SSD intra-chunk block, its wrapper and plain
version.

``csrc/ssd_intra.cu`` replaces ``ssd_intra_pallas``: one block per (chunk,
tile of 14 heads) forms C·Bᵀ once on the tensor cores (3xTF32), then
streams its (head, 64 columns of P) units through a two-stage cp.async
ring and multiplies each head's masked decay block, built straight into
the tensor cores' operand registers (exp never formed for t > s), with
xdt.

A wrapper given CUDA tensors launches the kernel on the current stream or
raises; given CPU tensors it runs the plain PyTorch version
(:func:`ref.ssd_intra_ref`). ``LAUNCHES`` counts kernel launches (plain
runs do not count).

The kernel has no backward, as the reference's has none: the reference
differentiates its plain jnp intra-chunk block (``_ssd_chunked``). With
grad enabled and an input requiring grad, the wrapper goes through
:class:`SsdIntra`, whose forward is the kernel and whose backward is the
VJP of the plain version, recomputed.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import check_tensor, raise_on
from repro_torch.kernels.ssd.ref import ssd_intra_ref

LAUNCHES = {"ssd_intra": 0}

MAX_CHUNK = 128           # the kernel's Gram tiles cover k <= 128

_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launch_counts() -> None:
    LAUNCHES["ssd_intra"] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_lib.load("ssd_intra")
    lib.ssd_intra_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _P]
    lib.ssd_intra_launch.restype = _I
    lib.ssd_intra_load_route.argtypes = [_P, _I]
    lib.ssd_intra_load_route.restype = _I
    return lib


# the plain version of the kernel: the masked decay block and one einsum
ssd_intra_plain = ssd_intra_ref


def load_route(xdt) -> str:
    """How the kernel copies the CUDA tensor xdt into shared memory, as its
    launcher decides: ``"16-byte"`` when P is a multiple of 4 and xdt
    starts on a 16-byte boundary, else ``"4-byte"``."""
    vec = _lib().ssd_intra_load_route(xdt.data_ptr(), xdt.shape[-1])
    return "16-byte" if vec else "4-byte"


def ssd_intra_cuda(xdt, cs, Bm, Cm):
    """y (G, k, H, P) float32 from xdt (G, k, H, P), cs (G, k, H), Bm and Cm
    (G, k, N), all float32 and contiguous. CUDA tensors launch the kernel
    (k <= 128, any P, N and H); CPU tensors take :func:`ssd_intra_plain`.
    With grad enabled and an input requiring grad the call goes through
    :class:`SsdIntra` and its output carries the gradient.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xdt, cs, Bm, Cm)):
        return SsdIntra.apply(xdt, cs, Bm, Cm)
    return _ssd_intra_forward(xdt, cs, Bm, Cm)


class SsdIntra(torch.autograd.Function):
    """The intra-chunk block through the kernel, with a plain torch
    backward: the VJP of :func:`ssd_intra_plain`, recomputed from the
    saved inputs (its (G, k, k, H) decay block lives only during the
    backward)."""

    @staticmethod
    def forward(ctx, xdt, cs, Bm, Cm):
        ctx.save_for_backward(xdt, cs, Bm, Cm)
        return _ssd_intra_forward(xdt, cs, Bm, Cm)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        need = ctx.needs_input_grad
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            y = ssd_intra_plain(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, g))
        return tuple(next(grads) if n else None for n in need)


def _ssd_intra_forward(xdt, cs, Bm, Cm):
    if not xdt.is_cuda:
        return ssd_intra_plain(xdt, cs, Bm, Cm)
    G, k, H, P = xdt.shape
    N = Bm.shape[-1]
    dev = xdt.device
    check_tensor("xdt", xdt, (G, k, H, P), torch.float32, dev)
    check_tensor("cs", cs, (G, k, H), torch.float32, dev)
    check_tensor("Bm", Bm, (G, k, N), torch.float32, dev)
    check_tensor("Cm", Cm, (G, k, N), torch.float32, dev)
    if k > MAX_CHUNK:
        raise ValueError(f"ssd_intra: chunk length {k} > {MAX_CHUNK}")
    y = torch.empty_like(xdt)
    stream = torch.cuda.current_stream(dev).cuda_stream
    raise_on(_lib().ssd_intra_launch(xdt.data_ptr(), cs.data_ptr(),
                                     Bm.data_ptr(), Cm.data_ptr(),
                                     y.data_ptr(), G, k, H, P, N, stream),
             "ssd_intra")
    LAUNCHES["ssd_intra"] += 1
    return y
