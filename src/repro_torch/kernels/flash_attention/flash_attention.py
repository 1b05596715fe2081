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
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import check_tensor, raise_on
from repro_torch.kernels.flash_attention.ref import attention_ref

LAUNCHES = {"flash_attention": 0}

MAX_HEAD_DIM = 128        # the kernels' register tiles hold hd <= 128
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
    kernel; CPU tensors take :func:`flash_attention_plain`.
    """
    BH, S, hd = q.shape
    if groups < 1 or BH != k.shape[0] * groups:
        raise ValueError(f"q has {BH} heads, k has {k.shape[0]}: not "
                         f"{groups} groups")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, groups)
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
