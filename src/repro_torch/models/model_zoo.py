"""The decoder stack for block kinds ``attn`` and ``mamba2`` with the
zamba2-style shared block: the port of ``repro.models.model_zoo``.

A model is ``n_superblocks`` repetitions of a superblock (the config's
``block_pattern``), optional tail blocks, and an optional shared
attention + MLP block invoked once after each superblock (Zamba2). The
reference scans the superblocks with ``lax.scan``; here they run as a
Python loop, as the reference's ``unroll_layers`` path does, and the
caches come back stacked over superblocks as the scan returns them.
``sharding_ctx`` constraints are identities on one card and are left out.

Entry points: ``init``, ``forward`` (returns logits, final hidden, aux),
``loss`` (the causal LM loss, optionally with the GW alignment loss),
``prefill`` (last-position logits and the fresh caches), ``init_cache``
(zero caches) and ``decode_step`` (one token against the caches, which it
updates in place). They run on the CUDA card unless ``device="cpu"`` is
given, and raise without a card. ``forward(remat=True)`` recomputes each
superblock in the backward (``torch.utils.checkpoint``), where the
reference checkpoints its scan body. MLA and the ``moe``, ``xattn``,
``mlstm``, ``slstm`` kinds wait for ROADMAP item 17b.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import dispatch
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (
    cross_entropy,
    embed,
    embed_params,
    mlp,
    mlp_params,
    rmsnorm,
    rmsnorm_params,
)
from repro_torch.models.module import Builder

PORTED_KINDS = ("attn", "mamba2")
_LATER = "is not ported yet (ROADMAP item 17b)"


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
                use_kernel, cache=None, cache_index=None):
    """Returns (x, new_cache). The ported kinds add no auxiliary loss.
    ``cache`` is the block's decode cache (None for train and prefill)."""
    eps = cfg.norm_eps
    if kind == "attn":
        h, new_cache = attn.gqa_attention(
            p["attn"], cfg, rmsnorm(p["n1"], x, eps), positions,
            cache=cache, cache_index=cache_index, use_flash=use_flash,
            use_kernel=use_kernel)
        x = x + h.to(x.dtype)
        x = x + mlp(p["mlp"], rmsnorm(p["n2"], x, eps)).to(x.dtype)
        return x, new_cache
    if kind == "mamba2":
        h, new_state = ssm.mamba2_block(p["mamba"], cfg,
                                        rmsnorm(p["n1"], x, eps),
                                        state=cache, use_kernel=use_kernel)
        return x + h.to(x.dtype), new_state
    raise NotImplementedError(f"block kind {kind!r} {_LATER}")


def block_cache_spec(cfg: ArchConfig, kind: str, batch: int, cache_len: int,
                     dtype):
    if kind == "attn":
        return attn.gqa_cache_spec(cfg, batch, cache_len, dtype)
    if kind == "mamba2":
        return ssm.mamba2_state_spec(cfg, batch, dtype)
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
                     use_kernel, caches=None, shared_cache=None,
                     cache_index=None):
    """Returns (x, new_caches, new_shared_cache)."""
    new_caches = []
    for i, kind in enumerate(cfg.block_pattern):
        c = None if caches is None else caches[i]
        x, nc = block_apply(p[f"b{i}"], cfg, kind, x, positions, use_flash,
                            use_kernel, c, cache_index)
        new_caches.append(nc)
    new_shared = None
    if shared_p is not None:
        h, new_shared = attn.gqa_attention(
            shared_p["attn"], cfg, rmsnorm(shared_p["n1"], x, cfg.norm_eps),
            positions, cache=shared_cache, cache_index=cache_index,
            use_flash=use_flash, use_kernel=use_kernel)
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


def _stack_specs(tree, n: int):
    """A cache spec with a leading axis of ``n`` on every tensor."""
    if isinstance(tree, attn.TensorSpec):
        return attn.TensorSpec((n,) + tuple(tree.shape), tree.dtype)
    return type(tree)(_stack_specs(t, n) for t in tree)


def _zeros(tree, device):
    if isinstance(tree, attn.TensorSpec):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
    return type(tree)(_zeros(t, device) for t in tree)


def _write(dst_tree, src_tree):
    """Copy each tensor of ``src_tree`` into ``dst_tree`` where they are
    not the same tensor (the attention caches are written in place)."""
    if isinstance(dst_tree, torch.Tensor):
        if src_tree is not dst_tree:
            dst_tree.copy_(src_tree)
        return
    for d, s_ in zip(dst_tree, src_tree):
        _write(d, s_)


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

    # -- caches -------------------------------------------------------------

    def cache_spec(self, batch: int, cache_len: int, dtype=torch.bfloat16):
        """The caches' shapes and dtypes: ``{"blocks": per pattern position,
        stacked over superblocks, "tail": per tail block, "shared": the
        shared block's (k, v) stacked over its invocations}``."""
        cfg = self.cfg
        n_sb = cfg.resolved_superblocks
        sb = tuple(block_cache_spec(cfg, k, batch, cache_len, dtype)
                   for k in cfg.block_pattern)
        spec: Dict[str, Any] = {"blocks": _stack_specs(sb, n_sb)}
        if cfg.tail_blocks:
            spec["tail"] = tuple(
                block_cache_spec(cfg, k, batch, cache_len, dtype)
                for k in cfg.tail_blocks)
        if cfg.shared_block_every:
            spec["shared"] = _stack_specs(
                attn.gqa_cache_spec(cfg, batch, cache_len, dtype), n_sb)
        return spec

    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   device=None):
        """Zero caches of :meth:`cache_spec` on ``device`` (the card unless
        given). The ported kinds have no state that starts elsewhere than
        0 (the reference starts only LSTM stabilizers at -1e30)."""
        dev = dispatch.resolve_device(device)
        return {key: _zeros(val, dev) for key, val in
                self.cache_spec(batch, cache_len, dtype).items()}

    def decode_step(self, params, tokens, cache, index: int,
                    act_dtype=torch.bfloat16, device=None):
        """One decode step. tokens: (B, 1); ``index``: the absolute
        position, the caches' write offset. Returns (logits (B, 1, V),
        cache): the caches of :meth:`init_cache` (or :meth:`prefill`'s,
        padded by the caller) are updated in place and come back as the
        same tensors. Attention runs the scores path, Mamba2 its
        single-step recurrence; no kernel is launched, as in the
        reference."""
        dev = dispatch.resolve_device(device)
        tokens = tokens.to(dev)
        B = tokens.shape[0]
        params = self._cast_params(params, act_dtype, dev)
        positions = torch.full((B, 1), int(index), dtype=torch.int64,
                               device=dev)
        x = self._embed_tokens(params, tokens, act_dtype)
        x, _ = self._stack(params, x, positions, False, True, True,
                           caches=cache, cache_index=int(index))
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return self._logits(params, x), cache

    # -- embedding / head ----------------------------------------------------

    @staticmethod
    def _cast_params(params, act_dtype, device):
        """Compute copy of the params in the activation dtype on ``device``
        (no copy where they already are)."""
        return _map_tensors(
            lambda t: t.to(device=device, dtype=act_dtype)
            if t.is_floating_point() else t.to(device), params)

    def _embed_tokens(self, params, tokens, act_dtype):
        return embed(params["embed"], tokens).to(act_dtype)

    def _logits(self, params, x):
        x = x.float()
        if self.cfg.tie_embeddings:
            return x @ params["embed"]["table"].float().t()
        return x @ params["head"].float()

    # -- core stack ----------------------------------------------------------

    def _stack(self, params, x, positions, use_flash, use_kernel,
               want_cache, caches=None, cache_index=None, remat=False):
        """The superblocks, then the tail. With ``caches`` (decode) each
        block reads its slice of the stacked caches and the new states are
        written back into them; otherwise the fresh caches are stacked
        (``want_cache``). ``remat`` (training, no caches) keeps only each
        superblock's input for the backward and runs the superblock again
        there."""
        cfg = self.cfg
        shared_p = params.get("shared")
        sb_caches, sh_caches = [], []
        for i, blk_p in enumerate(params["blocks"]):
            if remat and caches is None and not want_cache:
                # the blocks draw no random numbers: no RNG state to stash
                x = checkpoint(self._superblock_x, blk_p, shared_p, x,
                               positions, use_flash, use_kernel,
                               use_reentrant=False, preserve_rng_state=False)
                continue
            sb_in = sh_in = None
            if caches is not None:
                sb_in = _map_tensors(lambda t: t[i], caches["blocks"])
                if shared_p is not None:
                    sh_in = _map_tensors(lambda t: t[i], caches["shared"])
            x, new_sb, new_sh = superblock_apply(
                blk_p, shared_p, cfg, x, positions, use_flash, use_kernel,
                sb_in, sh_in, cache_index)
            if caches is not None:
                _write(sb_in, new_sb)
            elif want_cache:
                sb_caches.append(new_sb)
                sh_caches.append(new_sh)

        new_tail = []
        for i, kind in enumerate(cfg.tail_blocks):
            c = None if caches is None else caches["tail"][i]
            x, nc = block_apply(params["tail"][i], cfg, kind, x, positions,
                                use_flash, use_kernel, c, cache_index)
            if caches is not None:
                _write(c, nc)
            new_tail.append(nc)

        if caches is not None or not want_cache:
            return x, caches
        cache_out = {"blocks": _stack_trees(sb_caches)}
        if shared_p is not None:
            cache_out["shared"] = _stack_trees(sh_caches)
        if cfg.tail_blocks:
            cache_out["tail"] = tuple(new_tail)
        return x, cache_out

    def _superblock_x(self, blk_p, shared_p, x, positions, use_flash,
                      use_kernel):
        return superblock_apply(blk_p, shared_p, self.cfg, x, positions,
                                use_flash, use_kernel)[0]

    def _run(self, params, tokens, act_dtype, use_flash, use_kernel, device,
             want_cache, remat=False):
        dev = dispatch.resolve_device(device)
        tokens = tokens.to(dev)
        B, S = tokens.shape[0], tokens.shape[1]
        params = self._cast_params(params, act_dtype, dev)
        positions = torch.arange(S, device=dev)[None].expand(B, S)
        x = self._embed_tokens(params, tokens, act_dtype)
        x, cache = self._stack(params, x, positions, use_flash, use_kernel,
                               want_cache, remat=remat)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return params, x, cache

    # -- public entry points --------------------------------------------------

    def forward(self, params, tokens, act_dtype=torch.float32,
                use_flash: bool = False, use_kernel: bool = True,
                device=None, remat: bool = False):
        """Training forward. Returns (logits, final_hidden, aux_loss); the
        aux loss is 0 (only MoE blocks add one).

        ``use_kernel=False`` runs the plain versions of the kernels instead
        of the kernels (on the card too), to hold one against the other.
        ``remat`` recomputes each superblock in the backward instead of
        keeping its activations (the same values, bit for bit).
        """
        params, x, _ = self._run(params, tokens, act_dtype, use_flash,
                                 use_kernel, device, want_cache=False,
                                 remat=remat)
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

    # -- loss -----------------------------------------------------------------

    def loss(self, params, batch, act_dtype=torch.float32,
             use_flash: bool = False, remat: bool = False,
             gw_align: bool = False, gw_generator=None, gw_draws=None,
             use_kernel: bool = True, device=None):
        """Causal LM loss (+ optional GW alignment auxiliary loss).

        ``batch`` holds ``tokens`` and ``labels`` (B, S), tensors or numpy
        arrays. Returns (loss, {"ce", "aux"}): loss = ce + 0.01·aux, plus
        0.1·``gw_alignment_loss(hidden, emb)`` with ``gw_align``, which
        aligns the final hidden geometry to the token embeddings' (the
        paper's technique as a training loss). Its token draws come from
        ``gw_generator`` (a ``torch.Generator`` on the device), or are
        given as ``gw_draws=(R, C)`` (the parity tests pass the
        reference's).
        """
        from repro_torch.core.align import gw_alignment_loss

        dev = dispatch.resolve_device(device)
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        labels = torch.as_tensor(batch["labels"]).to(dev)
        logits, hidden, aux = self.forward(
            params, tokens, act_dtype=act_dtype, use_flash=use_flash,
            use_kernel=use_kernel, device=dev, remat=remat)
        ce = cross_entropy(logits, labels)
        loss = ce + 0.01 * aux
        if gw_align:
            if gw_generator is None and gw_draws is None:
                raise ValueError("gw_align needs gw_generator or gw_draws")
            emb = self._embed_tokens(
                _map_tensors(lambda t: t.to(dev), {"embed": params["embed"]}),
                tokens, act_dtype)
            loss = loss + 0.1 * gw_alignment_loss(gw_generator, hidden, emb,
                                                  draws=gw_draws)
        return loss, {"ce": ce, "aux": aux}


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
