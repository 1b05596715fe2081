"""CUDA kernel of the sparse log-domain Sinkhorn half-step (K7), its
segment layout, wrapper and gradient.

``csrc/sparse_sinkhorn.cu`` computes in one launch, for every segment i of
a COO support made contiguous by one of its indices,

    out_i = _finite(lmarg_i - lse_{e in segment i}(lv_e + pot[idx_e]))

with exactly the branches of core/sinkhorn.py's ``segment_logsumexp`` and
``_finite``; given the unbalanced exponent ρ = λ/(λ+ε) (a float32 tensor
that stays on the device), ``_finite(ρ·(lmarg_i - lse_i))``, the
unbalanced loop's half-step in the same order of float32 operations. By
row it is the update of f from g; by column, of g from f. It replaces no
TPU kernel (the reference's sparse Sinkhorn is plain jnp segment ops); it
exists because on the card the plain half-step is ~32 launches, and the
host launching them paced every spar solve, balanced or unbalanced.

:func:`segment_layout` makes the segments contiguous with a stable sort
and ``searchsorted``, on the device and with no host read: a layout is
built once a Sinkhorn call (an outer step) and serves its iterations.

The wrapper takes CUDA tensors only and launches the kernel on the
current stream (or the one a loop fetched once). The plain version is
core/sinkhorn.py's body, which CPU tensors run there. ``LAUNCHES`` counts
launches.

Gradients. With grad enabled and an input requiring grad,
:func:`half_step` goes through :class:`HalfStep`, whose forward is the
kernel (also writing each segment's logsumexp) and whose backward is plain
torch: d lmarg = ρ·grad where ``_finite`` kept the value,
d x_e = -ρ·grad_i · exp(x_e - lse_i) where it kept it and the segment's
logsumexp was not ``NEG_INF``, then ``index_add_`` into the potential's
gradient, and d ρ = Σ_i grad_i · (lmarg_i - lse_i) over the kept segments
(without ρ: ρ = 1 and no d ρ). That is the gradient autograd takes through
the plain version, up to the rounding of exp(x - max) / sums against
exp(x - lse).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.core.utils import NEG_INF
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import raise_on

LAUNCHES = {"sparse_sinkhorn_half": 0}

THREADS = 256          # threads a block
MAX_GROUP = 32         # lanes a segment, at most a warp
_INT32_MAX = 2**31 - 1

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclass(frozen=True)
class SegmentLayout:
    """A support of s entries made contiguous by one of its indices.

    ``keys`` (s,) int32: each entry's segment, ascending; ``idx`` (s,)
    int32: each entry's other index, into a potential of ``other``;
    ``off`` (num + 1,) int32: segment i holds entries off[i] .. off[i+1]-1;
    ``group``: the kernel's lanes a segment (:func:`group_width`).
    """

    keys: torch.Tensor
    idx: torch.Tensor
    off: torch.Tensor
    num: int
    other: int
    group: int

    @property
    def s(self) -> int:
        return self.keys.shape[0]


def group_width(s: int, num: int) -> int:
    """Lanes a segment: the least power of two at or above the mean
    segment length ceil(s / num), at most a warp. It depends on the ratio
    alone, so the B lanes of a flush (B·s entries, B·num segments) take
    the width of their single-lane solves."""
    mean = -(-s // num) if num else 0
    g = 1
    while g < mean and g < MAX_GROUP:
        g *= 2
    return g


def segment_layout(keys, idx, num: int, other: int):
    """(layout, perm): the support's entries sorted by ``keys`` in [0, num),
    stably, so a segment keeps the support's order; ``perm`` (s,) int64
    maps layout entry k to support entry perm[k]. ``idx`` is the other
    index, in [0, other). On the device, with no host read; indices out
    of range are the kernel's to refuse (it traps, as torch's index
    kernels assert)."""
    s = keys.shape[0]
    if max(s, num + 1, other) > _INT32_MAX:
        raise ValueError(f"a support of {s} entries over {num} x {other} "
                         f"passes int32")
    sk, perm = torch.sort(keys.to(torch.int32), stable=True)
    bounds = torch.arange(num + 1, dtype=torch.int32, device=keys.device)
    off = torch.searchsorted(sk, bounds, out_int32=True)
    layout = SegmentLayout(sk, idx.to(torch.int32)[perm], off, num, other,
                           group_width(s, num))
    return layout, perm


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_lib.load("sparse_sinkhorn")
    lib.sparse_sinkhorn_half_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P,
                                                _P, _LL, _LL, _LL, _I, _I,
                                                _P]
    lib.sparse_sinkhorn_half_launch.restype = _I
    return lib


def _launch(layout, lv, pot, lmarg, want_lse: bool, stream, rho=None):
    """The kernel on arguments the caller checked, on ``stream`` (a CUDA
    stream handle; None: the current stream), with the exponent ``rho``
    or without (None: balanced): (out, lse or None)."""
    dev = lv.device
    if dev.type != "cuda":
        raise ValueError(f"K7 takes CUDA tensors, got {dev}; CPU tensors "
                         f"run core/sinkhorn.py's plain body")
    if stream is None:
        stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(layout.num, dtype=torch.float32, device=dev)
    lse = torch.empty_like(out) if want_lse else None
    raise_on(_lib().sparse_sinkhorn_half_launch(
        layout.off.data_ptr(), lv.data_ptr(), layout.idx.data_ptr(),
        pot.data_ptr(), lmarg.data_ptr(),
        None if rho is None else rho.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), layout.num, layout.s,
        layout.other, layout.group, THREADS, stream), "sparse_sinkhorn_half")
    LAUNCHES["sparse_sinkhorn_half"] += 1
    return out, lse


def half_step(layout, lv, pot, lmarg, stream=None, rho=None):
    """out (num,) = _finite(lmarg - lse(lv + pot[idx])) over the layout's
    segments, or _finite(rho·(lmarg - lse(...))) given ``rho``: lv (s,) in
    layout order, pot (other,), lmarg (num,), rho () or (1,), float32 and
    contiguous CUDA tensors, checked by the caller (:func:`check_inputs`).
    The kernel runs on ``stream`` (a handle a loop fetches once; None: the
    current stream). With grad enabled and an input requiring grad the call
    goes through :class:`HalfStep` and its output carries the gradient."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (lv, pot, lmarg, rho)):
        return HalfStep.apply(layout, lv, pot, lmarg, rho, stream)
    return _launch(layout, lv, pot, lmarg, False, stream, rho)[0]


def check_inputs(layout, lv, lmarg, rho=None):
    """Raise unless lv (s,) and lmarg (num,) are contiguous float32 tensors
    on the layout's device, and ``rho`` None or one of shape () or (1,):
    what :func:`half_step` takes, checked once for all the half-steps of a
    call. The potentials are the half-steps' own outputs."""
    dev = layout.keys.device
    cuda_lib.check_tensor("lv", lv, (layout.s,), torch.float32, dev)
    cuda_lib.check_tensor("lmarg", lmarg, (layout.num,), torch.float32, dev)
    if rho is not None:
        cuda_lib.check_tensor("rho", rho, (1,) if rho.dim() else (),
                              torch.float32, dev)


class HalfStep(torch.autograd.Function):
    """:func:`half_step` through the kernel, with the plain torch backward
    of the module's docstring, each gradient computed only for the inputs
    that need it."""

    @staticmethod
    def forward(ctx, layout, lv, pot, lmarg, rho, stream):
        out, lse = _launch(layout, lv, pot, lmarg, True, stream, rho)
        ctx.layout = layout
        ctx.save_for_backward(lv, pot, lmarg, rho, lse)
        return out

    @staticmethod
    def backward(ctx, grad):
        lv, pot, lmarg, rho, lse = ctx.saved_tensors
        layout = ctx.layout
        _, need_lv, need_pot, need_lmarg, need_rho, _ = ctx.needs_input_grad
        d = lmarg - lse
        v = d if rho is None else rho * d
        kept = torch.isfinite(v) & (v > NEG_INF / 2)     # what _finite kept
        g_d = grad if rho is None else rho * grad        # through ρ·d
        g_lv = g_pot = g_rho = None
        if need_lv or need_pot:
            seg, idx = layout.keys.long(), layout.idx.long()
            live = (kept & (lse > NEG_INF / 2))[seg]
            gx = torch.where(live, -g_d[seg] * torch.exp(
                lv + pot[idx] - lse[seg]), 0.0)
            g_lv = gx if need_lv else None
            if need_pot:
                g_pot = torch.zeros_like(pot).index_add_(0, idx, gx)
        g_lmarg = torch.where(kept, g_d, 0.0) if need_lmarg else None
        if need_rho:
            g_rho = torch.where(kept, grad * d, 0.0).sum().reshape(rho.shape)
        return None, g_lv, g_pot, g_lmarg, g_rho, None
