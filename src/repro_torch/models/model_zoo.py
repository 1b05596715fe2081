"""The decoder stack for block kinds ``attn`` and ``mamba2`` with the
zamba2-style shared block: the port of ``repro.models.model_zoo``.

A model is ``n_superblocks`` repetitions of a superblock (the config's
``block_pattern``), optional tail blocks, and an optional shared
attention + MLP block invoked once after each superblock (Zamba2). The
reference scans the superblocks with ``lax.scan``; here they run as a
Python loop, as the reference's ``unroll_layers`` path does, and the
caches come back stacked over superblocks as the scan returns them.
``sharding_ctx`` constraints are identities on one card and are left out.

Entry points: ``init``, ``forward`` (returns logits, final hidden, aux) and
``prefill`` (last-position logits and the fresh caches). They run on the
CUDA card unless ``device="cpu"`` is given, and raise without a card.
``decode_step``, ``init_cache``, MLA and the ``moe``, ``xattn``,
``mlstm``, ``slstm`` kinds wait for ROADMAP item 17.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import dispatch
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (
    embed,
    embed_params,
    mlp,
    mlp_params,
    rmsnorm,
    rmsnorm_params,
)
from repro_torch.models.module import Builder

PORTED_KINDS = ("attn", "mamba2")
_LATER = "is not ported yet (ROADMAP item 17)"


def _check_ported(cfg: ArchConfig):
    for kind in cfg.block_pattern + cfg.tail_blocks:
        if kind not in PORTED_KINDS:
            raise NotImplementedError(f"block kind {kind!r} {_LATER}")
    if cfg.attn_type != "gqa":
        raise NotImplementedError(f"attention type {cfg.attn_type!r} {_LATER}")
    if cfg.n_codebooks > 1:
        raise NotImplementedError(f"multi-codebook heads {_LATER}")


# ---------------------------------------------------------------------------
# Block level
# ---------------------------------------------------------------------------

def block_params(b: Builder, cfg: ArchConfig, kind: str):
    d = cfg.d_model
    if kind == "attn":
        return {"n1": rmsnorm_params(b, d), "attn": attn.gqa_params(b, cfg),
                "n2": rmsnorm_params(b, d), "mlp": mlp_params(b, d, cfg.d_ff)}
    if kind == "mamba2":
        return {"n1": rmsnorm_params(b, d), "mamba": ssm.mamba2_params(b, cfg)}
    raise NotImplementedError(f"block kind {kind!r} {_LATER}")


def block_apply(p, cfg: ArchConfig, kind: str, x, positions, use_flash,
                use_kernel):
    """Returns (x, new_cache). The ported kinds add no auxiliary loss."""
    eps = cfg.norm_eps
    if kind == "attn":
        h, new_cache = attn.gqa_attention(
            p["attn"], cfg, rmsnorm(p["n1"], x, eps), positions,
            use_flash=use_flash, use_kernel=use_kernel)
        x = x + h.to(x.dtype)
        x = x + mlp(p["mlp"], rmsnorm(p["n2"], x, eps)).to(x.dtype)
        return x, new_cache
    if kind == "mamba2":
        h, new_state = ssm.mamba2_block(p["mamba"], cfg,
                                        rmsnorm(p["n1"], x, eps),
                                        use_kernel=use_kernel)
        return x + h.to(x.dtype), new_state
    raise NotImplementedError(f"block kind {kind!r} {_LATER}")


# ---------------------------------------------------------------------------
# Superblock / stack
# ---------------------------------------------------------------------------

def superblock_params(b: Builder, cfg: ArchConfig):
    return {f"b{i}": block_params(b, cfg, kind)
            for i, kind in enumerate(cfg.block_pattern)}


def shared_block_params(b: Builder, cfg: ArchConfig):
    """Zamba2-style shared attention+MLP block (one copy, many invocations)."""
    d = cfg.d_model
    return {"n1": rmsnorm_params(b, d), "attn": attn.gqa_params(b, cfg),
            "n2": rmsnorm_params(b, d), "mlp": mlp_params(b, d, cfg.d_ff)}


def superblock_apply(p, shared_p, cfg: ArchConfig, x, positions, use_flash,
                     use_kernel):
    """Returns (x, new_caches, new_shared_cache)."""
    new_caches = []
    for i, kind in enumerate(cfg.block_pattern):
        x, nc = block_apply(p[f"b{i}"], cfg, kind, x, positions, use_flash,
                            use_kernel)
        new_caches.append(nc)
    new_shared = None
    if shared_p is not None:
        h, new_shared = attn.gqa_attention(
            shared_p["attn"], cfg, rmsnorm(shared_p["n1"], x, cfg.norm_eps),
            positions, use_flash=use_flash, use_kernel=use_kernel)
        x = x + h.to(x.dtype)
        x = x + mlp(shared_p["mlp"],
                    rmsnorm(shared_p["n2"], x, cfg.norm_eps)).to(x.dtype)
    return x, tuple(new_caches), new_shared


def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {key: _map_tensors(fn, val) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, val) for val in tree)
    return fn(tree)


def _stack_trees(trees):
    """Stack same-shaped cache trees leafwise on a new leading axis."""
    first = trees[0]
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_trees([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


class Model:
    """Functional model for one architecture config; parameters are nested
    dicts of tensors, ``blocks`` a list with one dict per superblock."""

    def __init__(self, cfg: ArchConfig):
        _check_ported(cfg)
        self.cfg = cfg

    # -- parameters ---------------------------------------------------------

    def _build(self, b: Builder):
        cfg = self.cfg
        p: Dict[str, Any] = {}
        p["embed"] = embed_params(b, cfg.vocab_size, cfg.d_model)
        p["blocks"] = [superblock_params(b, cfg)
                       for _ in range(cfg.resolved_superblocks)]
        if cfg.tail_blocks:
            p["tail"] = [block_params(b, cfg, k) for k in cfg.tail_blocks]
        if cfg.shared_block_every:
            p["shared"] = shared_block_params(b, cfg)
        p["final_norm"] = rmsnorm_params(b, cfg.d_model)
        if not cfg.tie_embeddings:
            p["head"] = b.param((cfg.d_model, cfg.vocab_size))
        return p

    def init(self, generator: torch.Generator, device=None,
             dtype=torch.float32):
        """Random parameters on ``device`` (the card unless given), drawn in
        float32 from ``generator`` (which must live on that device) and
        stored in ``dtype``."""
        return self._build(Builder(generator, dispatch.resolve_device(device),
                                   dtype))

    def decode_step(self, *args, **kwargs):
        raise NotImplementedError(f"decode_step {_LATER}")

    def init_cache(self, *args, **kwargs):
        raise NotImplementedError(f"init_cache {_LATER}")

    # -- embedding / head ----------------------------------------------------

    @staticmethod
    def _cast_params(params, act_dtype, device):
        """Compute copy of the params in the activation dtype on ``device``
        (no copy where they already are)."""
        return _map_tensors(
            lambda t: t.to(device=device, dtype=act_dtype)
            if t.is_floating_point() else t.to(device), params)

    def _logits(self, params, x):
        x = x.float()
        if self.cfg.tie_embeddings:
            return x @ params["embed"]["table"].float().t()
        return x @ params["head"].float()

    # -- core stack ----------------------------------------------------------

    def _stack(self, params, x, positions, use_flash, use_kernel,
               want_cache):
        cfg = self.cfg
        shared_p = params.get("shared")
        sb_caches, sh_caches = [], []
        for blk_p in params["blocks"]:
            x, new_sb, new_sh = superblock_apply(
                blk_p, shared_p, cfg, x, positions, use_flash, use_kernel)
            if want_cache:
                sb_caches.append(new_sb)
                sh_caches.append(new_sh)

        new_tail = []
        for i, kind in enumerate(cfg.tail_blocks):
            x, nc = block_apply(params["tail"][i], cfg, kind, x, positions,
                                use_flash, use_kernel)
            new_tail.append(nc)

        cache_out = None
        if want_cache:
            cache_out = {"blocks": _stack_trees(sb_caches)}
            if shared_p is not None:
                cache_out["shared"] = _stack_trees(sh_caches)
            if cfg.tail_blocks:
                cache_out["tail"] = tuple(new_tail)
        return x, cache_out

    def _run(self, params, tokens, act_dtype, use_flash, use_kernel, device,
             want_cache):
        dev = dispatch.resolve_device(device)
        tokens = tokens.to(dev)
        B, S = tokens.shape[0], tokens.shape[1]
        params = self._cast_params(params, act_dtype, dev)
        positions = torch.arange(S, device=dev)[None].expand(B, S)
        x = embed(params["embed"], tokens).to(act_dtype)
        x, cache = self._stack(params, x, positions, use_flash, use_kernel,
                               want_cache)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return params, x, cache

    # -- public entry points --------------------------------------------------

    def forward(self, params, tokens, act_dtype=torch.float32,
                use_flash: bool = False, use_kernel: bool = True,
                device=None):
        """Training forward. Returns (logits, final_hidden, aux_loss); the
        aux loss is 0 (only MoE blocks add one).

        ``use_kernel=False`` runs the plain versions of the kernels instead
        of the kernels (on the card too), to hold one against the other.
        """
        params, x, _ = self._run(params, tokens, act_dtype, use_flash,
                                 use_kernel, device, want_cache=False)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._logits(params, x), x, aux

    def prefill(self, params, tokens, act_dtype=torch.bfloat16,
                use_flash: bool = False, use_kernel: bool = True,
                device=None):
        """Prefill forward; returns (last-position logits, cache) with the
        caches built at ``cache_len == S`` by each block's fresh-cache path:
        ``{"blocks": per pattern position, stacked over superblocks,
        "shared": (k, v) stacked over invocations, "tail": per tail block}``.
        """
        params, x, cache = self._run(params, tokens, act_dtype, use_flash,
                                     use_kernel, device, want_cache=True)
        return self._logits(params, x[:, -1:]), cache


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
