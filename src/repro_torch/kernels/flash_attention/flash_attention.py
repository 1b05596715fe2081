"""CUDA kernel of causal GQA flash attention, its wrapper and plain version.

``csrc/flash_attention.cu`` replaces ``flash_attention_pallas``. bfloat16
inputs (the LM main path) run on the tensor cores: one block of two
warpgroups per (batch·head, tile of 128 query rows) walks the key/value
tiles up to the diagonal, S = QKᵀ and O += PV as ``wgmma`` products with
the online softmax on the fp32 accumulators in registers and P rounded to
bfloat16 for the second product. float32 inputs run the fp32 SIMT kernel
(64 query rows per block). Both mask a ragged S themselves. (The
reference's grid of ``S // bq`` tiles never writes the rows past the last
whole tile; the kernels write every row.)

A wrapper given CUDA tensors launches the kernel on the current stream or
raises; given CPU tensors it runs the plain PyTorch version
(:func:`flash_attention_plain`). ``LAUNCHES`` counts kernel launches
(plain runs do not count).

The kernel has no backward, as the reference's has none: the reference
differentiates its plain XLA attention (``blockwise_gqa``). With grad
enabled and an input requiring grad, the wrapper goes through
:class:`FlashAttention`, whose forward is the kernel and whose backward
is plain torch (:func:`flash_attention_backward_plain`), KV chunk by KV
chunk as ``blockwise_gqa``'s rematerialized scan body runs.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import check_tensor, raise_on
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref

LAUNCHES = {"flash_attention": 0}

MAX_HEAD_DIM = 128        # the kernels' register tiles hold hd <= 128
# keys a chunk of the plain backward: the reference's blockwise KV chunk
# (``repro.models.attention._FLASH_CHUNK``); the last chunk may be ragged
BACKWARD_CHUNK = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launch_counts() -> None:
    LAUNCHES["flash_attention"] = 0


@functools.lru_cache(maxsize=None)
def _fn():
    fn = cuda_lib.load("flash_attention").flash_attention_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def flash_attention_plain(q, k, v, groups: int):
    """The kernel's function in plain PyTorch: q (B·H, S, hd), k and v
    (B·K, S, hd) with B·H = B·K·groups -> (B·H, S, hd) in q's dtype,
    computed in float32."""
    BH, S, hd = q.shape
    BK = k.shape[0]
    qg = q.float().reshape(BK, groups, S, hd).transpose(1, 2)
    out = attention_ref(qg, k.float()[:, :, None], v.float()[:, :, None])
    return out.transpose(1, 2).reshape(BH, S, hd).to(q.dtype)


def flash_attention_cuda(q, k, v, groups: int):
    """Causal attention on the flattened layout: q (B·H, S, hd), k and v
    (B·K, S, hd), float32 or bfloat16, contiguous; q head i reads kv head
    i // groups. Returns (B·H, S, hd) in q's dtype. CUDA tensors launch the
    kernel; CPU tensors take :func:`flash_attention_plain`. With grad
    enabled and an input requiring grad the call goes through
    :class:`FlashAttention` and its output carries the gradient.
    """
    BH = q.shape[0]
    if groups < 1 or BH != k.shape[0] * groups:
        raise ValueError(f"q has {BH} heads, k has {k.shape[0]}: not "
                         f"{groups} groups")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, groups)
    return _flash_attention_forward(q, k, v, groups)


class FlashAttention(torch.autograd.Function):
    """Causal GQA attention through the kernel, with a plain torch
    backward (:func:`flash_attention_backward_plain`) that recomputes the
    softmax from q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, groups):
        ctx.groups = groups
        ctx.save_for_backward(q, k, v)
        return _flash_attention_forward(q, k, v, groups)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward_plain(q, k, v, ctx.groups, g)
        need_q, need_k, need_v, _ = ctx.needs_input_grad
        return (dq if need_q else None, dk if need_k else None,
                dv if need_v else None, None)


def _causal_scores(qs, k_blk, j0: int, scale: float):
    """Scores of the query rows j0.. (BK, G, S - j0, hd) against the keys
    j0..j0 + c (BK, c, hd), key positions past a row's masked to NEG_INF."""
    s = torch.einsum("bgsd,btd->bgst", qs, k_blk) * scale
    S_rows, c = s.shape[2], s.shape[3]
    rows = torch.arange(j0, j0 + S_rows, device=s.device)
    cols = torch.arange(j0, j0 + c, device=s.device)
    return s.masked_fill(cols[None, :] > rows[:, None], NEG_INF)


def flash_attention_backward_plain(q, k, v, groups: int, g,
                                   chunk: int | None = None):
    """(dq, dk, dv) of causal attention at q (B·H, S, hd), k, v (B·K, S,
    hd) for the output cotangent g (B·H, S, hd), in the inputs' dtypes,
    computed in float32 in plain torch.

    Two passes over KV chunks of ``chunk`` keys (``BACKWARD_CHUNK`` unless
    given), each reading only the query rows that see the chunk (rows j0..
    for keys j0..): the first recomputes the row max, the row sum and the
    output with the online softmax; the second forms each chunk's
    probabilities from the log-sum-exp and takes dv = pᵀg, ds = p·(g vᵀ - Σ g·out), dq = ds k, dk = dsᵀq
    (times 1/√hd). No pass holds more than one chunk's (B·H, S, chunk)
    scores; the output is the float32 one recomputed here, not the
    forward's (a bfloat16 forward rounds it).
    """
    BH, S, hd = q.shape
    BK = k.shape[0]
    chunk = chunk or BACKWARD_CHUNK
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(BK, groups, S, hd)
    kf, vf = k.float(), v.float()
    gf = g.float().reshape(BK, groups, S, hd)
    m = torch.full((BK, groups, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for j0 in range(0, S, chunk):
        j1 = min(j0 + chunk, S)
        s = _causal_scores(qf[:, :, j0:], kf[:, j0:j1], j0, scale)
        m_old = m[..., j0:]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        corr = torch.exp(m_old - m_new)
        p = torch.exp(s - m_new[..., None])
        l[..., j0:] = l[..., j0:] * corr + p.sum(dim=-1)
        acc[:, :, j0:] = acc[:, :, j0:] * corr[..., None] + torch.einsum(
            "bgst,btd->bgsd", p, vf[:, j0:j1])
        m[..., j0:] = m_new
    out = acc / l[..., None]
    lse = m + torch.log(l)
    delta = (gf * out).sum(dim=-1)                       # (BK, G, S)
    del acc, out
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for j0 in range(0, S, chunk):
        j1 = min(j0 + chunk, S)
        qs, gs = qf[:, :, j0:], gf[:, :, j0:]
        p = torch.exp(_causal_scores(qs, kf[:, j0:j1], j0, scale)
                      - lse[..., j0:, None])
        dv[:, j0:j1] = torch.einsum("bgst,bgsd->btd", p, gs)
        dp = torch.einsum("bgsd,btd->bgst", gs, vf[:, j0:j1])
        ds = p * (dp - delta[..., j0:, None]) * scale
        dq[:, :, j0:] += torch.einsum("bgst,btd->bgsd", ds, kf[:, j0:j1])
        dk[:, j0:j1] = torch.einsum("bgst,bgsd->btd", ds, qs)
    return (dq.reshape(BH, S, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _flash_attention_forward(q, k, v, groups: int):
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, groups)
    BH, S, hd = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} outside [1, {MAX_HEAD_DIM}]")
    if BH > 65535:              # batch·heads run along the grid's y axis
        raise ValueError(f"flash_attention: {BH} heads exceed the grid")
    dev = q.device
    check_tensor("q", q, (BH, S, hd), q.dtype, dev)
    check_tensor("k", k, (BH // groups, S, hd), q.dtype, dev)
    check_tensor("v", v, (BH // groups, S, hd), q.dtype, dev)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    raise_on(_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    BH, S, hd, groups, _DTYPES[q.dtype], stream),
             "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
