"""The decoder stack for every block kind of the reference, with the
zamba2-style shared block: the port of ``repro.models.model_zoo``.

A model is ``n_superblocks`` repetitions of a superblock (the config's
``block_pattern``), optional tail blocks, and an optional shared
attention + MLP block invoked once after each superblock (Zamba2). Block
kinds: ``attn`` (self-attention + MLP), ``moe`` (self-attention + MoE
MLP), ``xattn`` (cross-attention to the image embeddings + MLP),
``mamba2``, ``mlstm`` and ``slstm``; self-attention is GQA or MLA as the
config's ``attn_type`` says. Multi-codebook models (musicgen) sum one
embedding a codebook at the input and have one head a codebook.
The reference scans the superblocks with ``lax.scan``; here they run as a
Python loop, as the reference's ``unroll_layers`` path does, and the
caches come back stacked over superblocks as the scan returns them.
``sharding_ctx`` constraints are identities on one card and are left out.

Entry points: ``init``, ``forward`` (returns logits, final hidden and the
MoE blocks' aux loss), ``loss`` (the causal LM loss with 0.01·aux,
optionally with the GW alignment loss), ``prefill`` (last-position logits
and the fresh caches), ``init_cache`` and ``decode_step`` (one token
against the caches, which it updates in place). ``img`` carries a VLM's
image embeddings (B, N_img, D) to its cross-attention blocks. They run on
the CUDA card unless ``device="cpu"`` is given, and raise without a card.
``forward(remat=True)`` recomputes each superblock in the backward
(``torch.utils.checkpoint``), where the reference checkpoints its scan
body.
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
from repro_torch.models.moe import moe_mlp, moe_params


# ---------------------------------------------------------------------------
# Block level
# ---------------------------------------------------------------------------

def _attn_params(b: Builder, cfg: ArchConfig):
    return attn.mla_params(b, cfg) if cfg.attn_type == "mla" \
        else attn.gqa_params(b, cfg)


def _attn_apply(p, cfg, x, positions, cache, cache_index, use_flash,
                use_kernel):
    if cfg.attn_type == "mla":
        return attn.mla_attention(p, cfg, x, positions, cache=cache,
                                  cache_index=cache_index,
                                  use_flash=use_flash)
    return attn.gqa_attention(p, cfg, x, positions, cache=cache,
                              cache_index=cache_index, use_flash=use_flash,
                              use_kernel=use_kernel)


def block_params(b: Builder, cfg: ArchConfig, kind: str):
    d = cfg.d_model
    if kind == "attn":
        return {"n1": rmsnorm_params(b, d), "attn": _attn_params(b, cfg),
                "n2": rmsnorm_params(b, d), "mlp": mlp_params(b, d, cfg.d_ff)}
    if kind == "moe":
        return {"n1": rmsnorm_params(b, d), "attn": _attn_params(b, cfg),
                "n2": rmsnorm_params(b, d), "moe": moe_params(b, cfg)}
    if kind == "xattn":
        return {"n1": rmsnorm_params(b, d), "xattn": attn.xattn_params(b, cfg),
                "n2": rmsnorm_params(b, d), "mlp": mlp_params(b, d, cfg.d_ff)}
    if kind == "mamba2":
        return {"n1": rmsnorm_params(b, d), "mamba": ssm.mamba2_params(b, cfg)}
    if kind == "mlstm":
        return {"n1": rmsnorm_params(b, d), "lstm": ssm.mlstm_params(b, cfg)}
    if kind == "slstm":
        return {"n1": rmsnorm_params(b, d), "lstm": ssm.slstm_params(b, cfg)}
    raise ValueError(kind)


def block_apply(p, cfg: ArchConfig, kind: str, x, positions, use_flash,
                use_kernel, cache=None, cache_index=None, img=None):
    """Returns (x, new_cache, aux loss). ``cache`` is the block's decode
    cache (None for train and prefill); ``img`` the image embeddings of
    the ``xattn`` blocks. Only ``moe`` blocks have an aux loss (None for
    the others, where the reference adds 0); they drop no token in decode
    (S == 1), as the reference's do."""
    eps = cfg.norm_eps
    if kind in ("attn", "moe"):
        h, new_cache = _attn_apply(p["attn"], cfg, rmsnorm(p["n1"], x, eps),
                                   positions, cache, cache_index, use_flash,
                                   use_kernel)
        x = x + h.to(x.dtype)
        if kind == "attn":
            x = x + mlp(p["mlp"], rmsnorm(p["n2"], x, eps)).to(x.dtype)
            return x, new_cache, None
        h, aux = moe_mlp(p["moe"], cfg, rmsnorm(p["n2"], x, eps),
                         no_drop=(x.shape[1] == 1))
        return x + h.to(x.dtype), new_cache, aux
    if kind == "xattn":
        x = x + attn.cross_attention(p["xattn"], cfg,
                                     rmsnorm(p["n1"], x, eps), img).to(x.dtype)
        x = x + mlp(p["mlp"], rmsnorm(p["n2"], x, eps)).to(x.dtype)
        return x, (), None
    if kind == "mamba2":
        h, new_state = ssm.mamba2_block(p["mamba"], cfg,
                                        rmsnorm(p["n1"], x, eps),
                                        state=cache, use_kernel=use_kernel)
        return x + h.to(x.dtype), new_state, None
    if kind in ("mlstm", "slstm"):
        fn = ssm.mlstm_block if kind == "mlstm" else ssm.slstm_block
        h, new_state = fn(p["lstm"], cfg, rmsnorm(p["n1"], x, eps),
                          state=cache)
        return x + h.to(x.dtype), new_state, None
    raise ValueError(kind)


def block_cache_spec(cfg: ArchConfig, kind: str, batch: int, cache_len: int,
                     dtype):
    if kind in ("attn", "moe"):
        return attn.mla_cache_spec(cfg, batch, cache_len, dtype) \
            if cfg.attn_type == "mla" \
            else attn.gqa_cache_spec(cfg, batch, cache_len, dtype)
    if kind == "xattn":
        return ()
    if kind == "mamba2":
        return ssm.mamba2_state_spec(cfg, batch, dtype)
    if kind == "mlstm":
        return ssm.mlstm_state_spec(cfg, batch, dtype)
    if kind == "slstm":
        return ssm.slstm_state_spec(cfg, batch, dtype)
    raise ValueError(kind)


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


def _add_aux(total, a):
    """total + a, where None stands for the reference's 0 (adding 0 to a
    float32 sum changes no bit)."""
    if a is None:
        return total
    return a if total is None else total + a


def superblock_apply(p, shared_p, cfg: ArchConfig, x, positions, use_flash,
                     use_kernel, caches=None, shared_cache=None,
                     cache_index=None, img=None):
    """Returns (x, new_caches, new_shared_cache, aux), aux None where no
    block of the superblock has one."""
    new_caches = []
    aux = None
    for i, kind in enumerate(cfg.block_pattern):
        c = None if caches is None else caches[i]
        x, nc, a = block_apply(p[f"b{i}"], cfg, kind, x, positions,
                               use_flash, use_kernel, c, cache_index, img)
        new_caches.append(nc)
        aux = _add_aux(aux, a)
    new_shared = None
    if shared_p is not None:
        h, new_shared = attn.gqa_attention(
            shared_p["attn"], cfg, rmsnorm(shared_p["n1"], x, cfg.norm_eps),
            positions, cache=shared_cache, cache_index=cache_index,
            use_flash=use_flash, use_kernel=use_kernel)
        x = x + h.to(x.dtype)
        x = x + mlp(shared_p["mlp"],
                    rmsnorm(shared_p["n2"], x, cfg.norm_eps)).to(x.dtype)
    return x, tuple(new_caches), new_shared, aux


def _on(img, device):
    """The image embeddings on ``device`` (None stays None)."""
    return None if img is None else torch.as_tensor(img).to(device)


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
        self.cfg = cfg

    # -- parameters ---------------------------------------------------------

    def _build(self, b: Builder):
        cfg = self.cfg
        p: Dict[str, Any] = {}
        p["embed"] = embed_params(b, cfg.vocab_size, cfg.d_model)
        if cfg.n_codebooks > 1:
            p["codebook_embeds"] = b.param(
                (cfg.n_codebooks - 1, cfg.vocab_size, cfg.d_model),
                scale=0.02)
        p["blocks"] = [superblock_params(b, cfg)
                       for _ in range(cfg.resolved_superblocks)]
        if cfg.tail_blocks:
            p["tail"] = [block_params(b, cfg, k) for k in cfg.tail_blocks]
        if cfg.shared_block_every:
            p["shared"] = shared_block_params(b, cfg)
        p["final_norm"] = rmsnorm_params(b, cfg.d_model)
        if cfg.n_codebooks > 1:
            p["heads"] = b.param((cfg.n_codebooks, cfg.d_model,
                                  cfg.vocab_size))
        elif not cfg.tie_embeddings:
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
        shared block's (k, v) stacked over its invocations}``. A block's
        cache is GQA's (k, v), MLA's latent (c_kv, k_rope), Mamba2's
        state, mLSTM's (C, n, m), sLSTM's (c, n, m, h), or () for
        cross-attention."""
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
        """Caches of :meth:`cache_spec` on ``device`` (the card unless
        given): zeros, except the mLSTM and sLSTM stabilisers m, which
        start at -1e30 (an empty history), so that the first recurrent
        step matches the parallel form."""
        dev = dispatch.resolve_device(device)
        cache = {key: _zeros(val, dev) for key, val in
                 self.cache_spec(batch, cache_len, dtype).items()}
        for key, kinds in (("blocks", self.cfg.block_pattern),
                           ("tail", self.cfg.tail_blocks)):
            for kind, c in zip(kinds, cache.get(key, ())):
                if kind in ("mlstm", "slstm"):
                    c[2].fill_(-1e30)
        return cache

    def decode_step(self, params, tokens, cache, index: int, img=None,
                    act_dtype=torch.bfloat16, device=None):
        """One decode step. tokens: (B, 1), or (B, 1, n_codebooks);
        ``index``: the absolute position, the caches' write offset; ``img``:
        a VLM's image embeddings. Returns (logits (B, 1, V), or (B, 1,
        n_codebooks, V), and cache): the caches of :meth:`init_cache` (or
        :meth:`prefill`'s, padded by the caller) are updated in place and
        come back as the same tensors. Attention runs the scores path, the
        recurrent blocks their single step, MoE drops no token; no kernel
        is launched, as in the reference."""
        dev = dispatch.resolve_device(device)
        tokens = tokens.to(dev)
        B = tokens.shape[0]
        params = self._cast_params(params, act_dtype, dev)
        positions = torch.full((B, 1), int(index), dtype=torch.int64,
                               device=dev)
        x = self._embed_tokens(params, tokens, act_dtype)
        x, _, _ = self._stack(params, x, positions, False, True, True,
                              caches=cache, cache_index=int(index),
                              img=_on(img, dev))
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
        """Token embeddings in ``act_dtype``; with codebooks, tokens are
        (B, S, n_codebooks) and the codebooks' embeddings are summed (the
        stub EnCodec frontend)."""
        if self.cfg.n_codebooks > 1:
            x = embed(params["embed"], tokens[..., 0])
            for cb in range(self.cfg.n_codebooks - 1):
                x = x + params["codebook_embeds"][cb][tokens[..., cb + 1]]
            return x.to(act_dtype)
        return embed(params["embed"], tokens).to(act_dtype)

    def _logits(self, params, x):
        x = x.float()
        if self.cfg.n_codebooks > 1:
            return torch.einsum("bsd,cdv->bscv", x, params["heads"].float())
        if self.cfg.tie_embeddings:
            return x @ params["embed"]["table"].float().t()
        return x @ params["head"].float()

    # -- core stack ----------------------------------------------------------

    def _stack(self, params, x, positions, use_flash, use_kernel,
               want_cache, caches=None, cache_index=None, remat=False,
               img=None):
        """The superblocks, then the tail; returns (x, aux, caches). With
        ``caches`` (decode) each block reads its slice of the stacked
        caches and the new states are written back into them; otherwise
        the fresh caches are stacked (``want_cache``). ``remat`` (training,
        no caches) keeps only each superblock's input for the backward and
        runs the superblock again there. aux sums the MoE blocks' aux
        losses in the reference's order (float32 0 without any)."""
        cfg = self.cfg
        shared_p = params.get("shared")
        sb_caches, sh_caches = [], []
        aux = None
        for i, blk_p in enumerate(params["blocks"]):
            if remat and caches is None and not want_cache:
                # the blocks draw no random numbers: no RNG state to stash
                x, a = checkpoint(self._superblock_x, blk_p, shared_p, x,
                                  positions, use_flash, use_kernel, img,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
                aux = _add_aux(aux, a)
                continue
            sb_in = sh_in = None
            if caches is not None:
                sb_in = _map_tensors(lambda t: t[i], caches["blocks"])
                if shared_p is not None:
                    sh_in = _map_tensors(lambda t: t[i], caches["shared"])
            x, new_sb, new_sh, a = superblock_apply(
                blk_p, shared_p, cfg, x, positions, use_flash, use_kernel,
                sb_in, sh_in, cache_index, img)
            aux = _add_aux(aux, a)
            if caches is not None:
                _write(sb_in, new_sb)
            elif want_cache:
                sb_caches.append(new_sb)
                sh_caches.append(new_sh)

        new_tail = []
        for i, kind in enumerate(cfg.tail_blocks):
            c = None if caches is None else caches["tail"][i]
            x, nc, a = block_apply(params["tail"][i], cfg, kind, x,
                                   positions, use_flash, use_kernel, c,
                                   cache_index, img)
            aux = _add_aux(aux, a)
            if caches is not None:
                _write(c, nc)
            new_tail.append(nc)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)

        if caches is not None or not want_cache:
            return x, aux, caches
        cache_out = {"blocks": _stack_trees(sb_caches)}
        if shared_p is not None:
            cache_out["shared"] = _stack_trees(sh_caches)
        if cfg.tail_blocks:
            cache_out["tail"] = tuple(new_tail)
        return x, aux, cache_out

    def _superblock_x(self, blk_p, shared_p, x, positions, use_flash,
                      use_kernel, img):
        out = superblock_apply(blk_p, shared_p, self.cfg, x, positions,
                               use_flash, use_kernel, img=img)
        return out[0], out[3]

    def _run(self, params, tokens, img, act_dtype, use_flash, use_kernel,
             device, want_cache, remat=False):
        dev = dispatch.resolve_device(device)
        tokens = tokens.to(dev)
        B, S = tokens.shape[0], tokens.shape[1]
        params = self._cast_params(params, act_dtype, dev)
        positions = torch.arange(S, device=dev)[None].expand(B, S)
        x = self._embed_tokens(params, tokens, act_dtype)
        x, aux, cache = self._stack(params, x, positions, use_flash,
                                    use_kernel, want_cache, remat=remat,
                                    img=_on(img, dev))
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return params, x, aux, cache

    # -- public entry points --------------------------------------------------

    def forward(self, params, tokens, img=None, act_dtype=torch.float32,
                use_flash: bool = False, use_kernel: bool = True,
                device=None, remat: bool = False):
        """Training forward. tokens: (B, S), or (B, S, n_codebooks); img:
        a VLM's image embeddings (B, N_img, D). Returns (logits (B, S, V)
        or (B, S, n_codebooks, V), final_hidden, aux_loss): the aux loss
        sums the MoE blocks' Switch losses (0 without MoE).

        ``use_kernel=False`` runs the plain versions of the kernels instead
        of the kernels (on the card too), to hold one against the other.
        ``remat`` recomputes each superblock in the backward instead of
        keeping its activations (the same values, bit for bit).
        """
        params, x, aux, _ = self._run(params, tokens, img, act_dtype,
                                      use_flash, use_kernel, device,
                                      want_cache=False, remat=remat)
        return self._logits(params, x), x, aux

    def prefill(self, params, tokens, img=None, act_dtype=torch.bfloat16,
                use_flash: bool = False, use_kernel: bool = True,
                device=None):
        """Prefill forward; returns (last-position logits, cache) with the
        caches built at ``cache_len == S`` by each block's fresh-cache path:
        ``{"blocks": per pattern position, stacked over superblocks,
        "shared": (k, v) stacked over invocations, "tail": per tail block}``.
        """
        params, x, _, cache = self._run(params, tokens, img, act_dtype,
                                        use_flash, use_kernel, device,
                                        want_cache=True)
        return self._logits(params, x[:, -1:]), cache

    # -- loss -----------------------------------------------------------------

    def loss(self, params, batch, act_dtype=torch.float32,
             use_flash: bool = False, remat: bool = False,
             gw_align: bool = False, gw_generator=None, gw_draws=None,
             use_kernel: bool = True, device=None):
        """Causal LM loss (+ optional GW alignment auxiliary loss).

        ``batch`` holds ``tokens`` and ``labels`` ((B, S), or (B, S,
        n_codebooks)) and, for a VLM, ``image_embeds``: tensors or numpy
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
            params, tokens, img=batch.get("image_embeds"),
            act_dtype=act_dtype, use_flash=use_flash,
            use_kernel=use_kernel, device=dev, remat=remat)
        ce = cross_entropy(logits, labels)
        loss = ce + 0.01 * aux
        if gw_align:
            if gw_generator is None and gw_draws is None:
                raise ValueError("gw_align needs gw_generator or gw_draws")
            tables = {k: params[k] for k in ("embed", "codebook_embeds")
                      if k in params}
            emb = self._embed_tokens(_map_tensors(lambda t: t.to(dev), tables),
                                     tokens, act_dtype)
            loss = loss + 0.1 * gw_alignment_loss(gw_generator, hidden, emb,
                                                  draws=gw_draws)
        return loss, {"ce": ce, "aux": aux}


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
