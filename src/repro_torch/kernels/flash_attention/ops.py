"""Public wrapper: (B, S, H, hd) / (B, S, K, hd) layout and GQA flattening.

The counterpart of ``repro.kernels.flash_attention.ops.flash_attention``.
The kernel has no block-size knob: its tiles are fixed at 64 x 64.
"""
from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda,
)


def flash_attention(q, k, v, causal: bool = True, device=None):
    """q: (B, S, H, hd); k, v: (B, S, K, hd). Causal GQA attention,
    (B, S, H, hd) in q's dtype, on ``device`` (the card unless given; the
    CPU runs the kernel's plain version). DTensor inputs (the mesh path)
    run on each rank's shards, split over batch and q heads
    (``dispatch.gqa_on_local_shards``)."""
    if not causal:
        raise NotImplementedError("the kernel implements the causal (LM) "
                                  "case only")
    dev = dispatch.resolve_device(device)
    q, k, v = q.to(dev), k.to(dev), v.to(dev)
    return dispatch.gqa_on_local_shards(_flash_attention, q, k, v)


def _flash_attention(q, k, v):
    B, S, H, hd = q.shape
    K = k.shape[2]
    if H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    # (B, S, H, hd) -> (B·H, S, hd), head-major, so that q head b·H + h
    # maps to kv head (b·H + h) // G == b·K + h // G
    qf = q.transpose(1, 2).reshape(B * H, S, hd).contiguous()
    kf = k.transpose(1, 2).reshape(B * K, S, hd).contiguous()
    vf = v.transpose(1, 2).reshape(B * K, S, hd).contiguous()
    out = flash_attention_cuda(qf, kf, vf, groups=H // K)
    return out.reshape(B, H, S, hd).transpose(1, 2)
