"""Gradient compression for cross-pod data parallelism, the port of
``repro.distrib.compression``.

At multi-pod scale the cross-pod all-reduce dominates; int8 block-quantized
gradients cut its wire bytes 4x against float32 (2x against bfloat16) at a
bounded error: each shard's contribution is off by at most its own block
max / 127. The reference runs this under ``shard_map``; here it is per-rank
code over a process group: an ``all_gather_into_tensor`` of the int8
blocks and of the scales, then a local dequantize-and-sum in rank order.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_BLOCK = 256


def quantize_int8(x):
    """Block-wise symmetric int8 quantization: blocks of 256 (the tail
    zero-padded), scale = block max / 127 floored at 1e-12, round half to
    even (``torch.round``, as ``jnp.round``). Returns (q (n_blocks, 256)
    int8, scales (n_blocks, 1) float32)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % _BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q, scale, shape):
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def compressed_psum(x, group=None):
    """Sum of ``x`` over the ranks of ``group`` (the default group unless
    given) through int8: quantize, all-gather the blocks and the scales,
    then dequantize and sum the ranks' terms in rank order, on every
    rank. Wire payload: int8 plus one float32 scale per 256-block."""
    q, scale = quantize_int8(x)
    n = dist.get_world_size(group)
    q_all = torch.empty((n * q.shape[0], q.shape[1]), dtype=q.dtype,
                        device=q.device)
    s_all = torch.empty((n * scale.shape[0], 1), dtype=scale.dtype,
                        device=scale.device)
    dist.all_gather_into_tensor(q_all, q.contiguous(), group=group)
    dist.all_gather_into_tensor(s_all, scale.contiguous(), group=group)
    terms = q_all.float() * s_all                    # rank r's blocks: r-th
    total = torch.sum(terms.reshape((n,) + tuple(q.shape)), dim=0)
    return total.reshape(-1)[:x.numel()].reshape(x.shape)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def dp_allreduce_grads(grads, group=None, compress: bool = False):
    """Mean of a gradient tree over a data-parallel group (every rank gets
    it), through :func:`compressed_psum` when ``compress``."""
    n = dist.get_world_size(group)

    def mean(g):
        if compress:
            return compressed_psum(g, group) / n
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        return g / n

    return _map(mean, grads)
