"""Input stand-ins per (arch × shape) cell, with no allocation: the port
of ``repro.launch.specs``.

``input_specs`` mirrors the real batch structure from the data pipeline
and the serving front ends as tensors on the ``meta`` device (the
reference's ``ShapeDtypeStruct``\\ s), in its shapes and dtypes. The
modality front ends are stubs: VLM cells get precomputed patch
embeddings, audio cells multi-codebook token grids.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.attention import TensorSpec
from repro_torch.models.model_zoo import Model


def sds(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _meta(tree):
    if isinstance(tree, TensorSpec):
        return sds(tree.shape, tree.dtype)
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return type(tree)(_meta(t) for t in tree)


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                cache_dtype=torch.bfloat16) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    codebooks = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    img = {}
    if cfg.family == "vlm":
        img["image_embeds"] = sds((B, cfg.n_image_tokens, cfg.d_model),
                                  torch.bfloat16)
    if shape.kind == "train":
        tok = (B, S) + codebooks
        return {"tokens": sds(tok, torch.int32),
                "labels": sds(tok, torch.int32), **img}
    if shape.kind == "prefill":
        return {"tokens": sds((B, S) + codebooks, torch.int32), **img}
    # decode: one new token, cache of length S
    return {"tokens": sds((B, 1) + codebooks, torch.int32),
            "index": sds((), torch.int32),
            "cache": _meta(Model(cfg).cache_spec(B, S, cache_dtype)), **img}
