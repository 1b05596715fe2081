"""Parity of the port's MoE, MLA, cross-attention, mLSTM and sLSTM blocks
with ``repro.models`` on the reference's weights (reduced configs, CPU,
float32), at ``MODULE_REL`` 1e-5 of each output's largest entry (the
module rule of ``tests/test_torch_models.py``).

MoE: both dispatches (``gshard``, ``sort``) with a capacity that drops
tokens, with ``no_drop``, and with a router whose logits tie (experts 0
and 1 equal and largest for every token: ``lax.top_k`` takes the lower
index, so must the port). MLA: both branches of ``mla_attention``,
``blockwise_mla`` at chunk 16, and decode steps against its latent
cache. Cross-attention with a non-zero gate. mLSTM and sLSTM in the
parallel form and step by step from the empty-history state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attention
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro_torch.models import attention, moe, ssm
from test_torch_models import MODULE_REL, _close, _reference
from test_torch_solve import _one_torch_thread  # noqa: F401 — autouse


def _block(name, path, i=0):
    """The reference's and the port's parameters of superblock i at
    ``path`` (a tuple of keys below the superblock)."""
    _, rcfg, _, rparams, cfg, params = _reference(name)
    p_ref, p = rparams["blocks"], params["blocks"][i]
    for key in path:
        p_ref, p = p_ref[key], p[key]
    return rcfg, jax.tree.map(lambda a: a[i], p_ref), cfg, p


def _x(cfg, B=2, S=32, seed=0, nonneg=False):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return np.abs(x) if nonneg else x


def _as_ref(p):
    return jax.tree.map(jnp.asarray, p)


def _as_port(p):
    return {k: _as_port(v) if isinstance(v, dict) else torch.tensor(
        np.asarray(v)) for k, v in p.items()}


# -- MoE -------------------------------------------------------------------

MOE_ARCHS = ("llama4_scout_17b_a16e", "phi3_5_moe_42b_a6_6b")
# the "drops" case's capacity factor: each expert's capacity is 3/4 of its
# mean load, so tokens drop whatever the routing
TIGHT = 0.75


def _tight(cfg):
    return dataclasses.replace(cfg, capacity_factor=TIGHT)


def _tied(p_ref):
    """Experts 0 and 1 tie at logit 0 for every nonnegative token, above
    all others (negative columns): the top-k must take expert 0 first."""
    router = np.array(p_ref["router"])
    router[:, :2] = 0.0
    router[:, 2:] = -np.abs(router[:, 2:]) - 0.01
    return {**{k: np.asarray(v) if not isinstance(v, dict) else
               jax.tree.map(np.asarray, v) for k, v in p_ref.items()},
            "router": router}


@pytest.mark.parametrize("impl", ["gshard", "sort"])
@pytest.mark.parametrize("case", ["drops", "no_drop", "tied"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_matches_reference(name, case, impl):
    rcfg, p_ref, cfg, _ = _block(name, ("b0", "moe"))
    x = _x(cfg, seed=1, nonneg=(case == "tied"))
    if case == "tied":
        p_ref = _tied(p_ref)
    if case == "drops":
        rcfg, cfg = _tight(rcfg), _tight(cfg)
    p = _as_port(p_ref)
    no_drop = case == "no_drop"
    rout, raux = ref_moe.moe_mlp(_as_ref(p_ref), rcfg, jnp.asarray(x),
                                 no_drop=no_drop, impl=impl)
    out, aux = moe.moe_mlp(p, cfg, torch.tensor(x), no_drop=no_drop,
                           impl=impl)
    _close(out, rout, MODULE_REL)
    _close(aux, raux, MODULE_REL)
    assert aux.dtype == torch.float32 and aux.dim() == 0


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_capacity_drops_and_ties_route_low(name):
    """The cases above exercise what they claim: the tight capacity
    drops tokens (the output differs from ``no_drop``'s) and the tied
    router sends every first choice to expert 0."""
    _, p_ref, cfg, _ = _block(name, ("b0", "moe"))
    cfg = _tight(cfg)
    x = torch.tensor(_x(cfg, seed=1))
    p = _as_port(p_ref)
    dropped, _ = moe.moe_mlp(p, cfg, x)
    kept, _ = moe.moe_mlp(p, cfg, x, no_drop=True)
    assert not torch.allclose(dropped, kept)
    _, _, sel = moe._route(_as_port(_tied(p_ref)), torch.tensor(
        _x(cfg, seed=1, nonneg=True)), cfg.experts_per_token)
    assert torch.all(sel[..., 0] == 0)
    if cfg.experts_per_token > 1:
        assert torch.all(sel[..., 1] == 1)


def test_moe_gshard_groups_and_aux_count_kept():
    """T = 48·2 is no power of two: the group halves to 32 (G = 3); the
    aux loss of gshard (kept assignments) and sort (all of them) differ
    where tokens drop, as the reference's do."""
    rcfg, p_ref, cfg, p = _block("phi3_5_moe_42b_a6_6b", ("b0", "moe"))
    rcfg, cfg = _tight(rcfg), _tight(cfg)
    x = _x(cfg, S=48, seed=2)
    for impl in ("gshard", "sort"):
        rout, raux = ref_moe.moe_mlp(_as_ref(p_ref), rcfg, jnp.asarray(x),
                                     impl=impl)
        out, aux = moe.moe_mlp(p, cfg, torch.tensor(x), impl=impl)
        _close(out, rout, MODULE_REL)
        _close(aux, raux, MODULE_REL)
    g = moe.moe_mlp(p, cfg, torch.tensor(x))[1]
    s = moe.moe_mlp(p, cfg, torch.tensor(x), impl="sort")[1]
    assert float(g) < float(s)
    with pytest.raises(ValueError, match="unknown MoE impl"):
        moe.moe_mlp(p, cfg, torch.tensor(x), impl="dense")


def test_moe_gshard_gradients_match_reference():
    rcfg, p_ref, cfg, _ = _block("llama4_scout_17b_a16e", ("b0", "moe"))
    x = _x(cfg, seed=3)

    def ref_loss(pr, xr):
        out, aux = ref_moe.moe_mlp(pr, rcfg, xr)
        return jnp.sum(out * out) + aux

    rg_p, rg_x = jax.grad(ref_loss, argnums=(0, 1))(_as_ref(p_ref),
                                                    jnp.asarray(x))
    p = {k: v.requires_grad_(True) if torch.is_tensor(v) else v
         for k, v in _as_port(p_ref).items()}
    p["shared"] = {k: v.requires_grad_(True) for k, v in p["shared"].items()}
    xt = torch.tensor(x, requires_grad=True)
    out, aux = moe.moe_mlp(p, cfg, xt)
    (out * out).sum().add(aux).backward()
    _close(xt.grad, rg_x, MODULE_REL)
    for k in ("router", "w_gate", "w_up", "w_down"):
        _close(p[k].grad, rg_p[k], MODULE_REL)
    for k in ("w_gate", "w_up", "w_down"):
        _close(p["shared"][k].grad, rg_p["shared"][k], MODULE_REL)


# -- MLA -------------------------------------------------------------------

def _positions(B, S, start=0):
    return np.broadcast_to(np.arange(start, start + S)[None], (B, S))


@pytest.mark.parametrize("use_flash", [False, True])
def test_mla_attention_matches_reference(use_flash):
    rcfg, p_ref, cfg, p = _block("minicpm3_4b", ("b0", "attn"))
    x = _x(cfg, S=48, seed=4)
    pos = _positions(2, 48)
    rout, (rc, rr) = ref_attention.mla_attention(
        p_ref, rcfg, jnp.asarray(x), jnp.asarray(pos), use_flash=use_flash)
    out, (c, r) = attention.mla_attention(p, cfg, torch.tensor(x),
                                          torch.tensor(pos),
                                          use_flash=use_flash)
    _close(out, rout, MODULE_REL)
    _close(c, rc, MODULE_REL)
    _close(r, rr, MODULE_REL)
    assert tuple(c.shape) == (2, 48, cfg.mla_kv_rank)
    assert tuple(r.shape) == (2, 48, cfg.mla_rope_dim)


@pytest.mark.parametrize("chunk", [16, 20])
def test_blockwise_mla_matches_reference(chunk):
    """chunk 16 splits S = 48 in three; 20 halves to 10 (five chunks), as
    the reference's chunk rule does."""
    rcfg, p_ref, cfg, p = _block("minicpm3_4b", ("b0", "attn"), i=1)
    x = _x(cfg, S=48, seed=5)
    pos = _positions(2, 48)
    rq = ref_attention._mla_qkv(p_ref, rcfg, jnp.asarray(x), jnp.asarray(pos))
    q = attention._mla_qkv(p, cfg, torch.tensor(x), torch.tensor(pos))
    for got, want in zip(q, rq):
        _close(got, want, MODULE_REL)
    want = ref_attention.blockwise_mla(p_ref, rcfg, *rq, chunk=chunk)
    got = attention.blockwise_mla(p, cfg, *q, chunk=chunk)
    _close(got, want, MODULE_REL)
    # the same function as the masked scores path
    mask = torch.ones((48, 48), dtype=torch.bool).tril()
    _close(got, attention._mla_attend(p, cfg, *q, mask).numpy(), MODULE_REL)


def test_mla_decode_cache_matches_reference():
    """Six decode steps against a latent cache of 8 written in place at
    the step's offset; every step's output and the cache after it."""
    rcfg, p_ref, cfg, p = _block("minicpm3_4b", ("b0", "attn"))
    B, T = 2, 8
    x = _x(cfg, S=6, seed=6)
    rcache = (jnp.zeros((B, T, cfg.mla_kv_rank)),
              jnp.zeros((B, T, cfg.mla_rope_dim)))
    cache = (torch.zeros((B, T, cfg.mla_kv_rank)),
             torch.zeros((B, T, cfg.mla_rope_dim)))
    for t in range(6):
        pos = _positions(B, 1, t)
        rout, rcache = ref_attention.mla_attention(
            p_ref, rcfg, jnp.asarray(x[:, t:t + 1]), jnp.asarray(pos),
            cache=rcache, cache_index=jnp.int32(t))
        out, new = attention.mla_attention(
            p, cfg, torch.tensor(x[:, t:t + 1]), torch.tensor(pos),
            cache=cache, cache_index=t)
        assert new[0] is cache[0] and new[1] is cache[1]
        _close(out, rout, MODULE_REL)
        _close(cache[0], rcache[0], MODULE_REL)
        _close(cache[1], rcache[1], MODULE_REL)
    spec = attention.mla_cache_spec(cfg, B, T, torch.bfloat16)
    assert [tuple(s.shape) for s in spec] == [tuple(c.shape) for c in cache]


# -- cross-attention -------------------------------------------------------

@pytest.mark.parametrize("img_dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(img_dtype):
    """A non-zero gate (0 at init would hide the attention), and in
    bfloat16 text against float32 embeddings (the pipeline's) the keys
    and output promote to float32, as jnp does."""
    rcfg, p_ref, cfg, _ = _block("llama_3_2_vision_90b", ("b4", "xattn"))
    p_ref = {**jax.tree.map(np.asarray, p_ref),
             "gate": np.array([0.7], np.float32)}
    x = _x(cfg, S=12, seed=7)
    img = np.random.default_rng(8).standard_normal(
        (2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    act = getattr(jnp, img_dtype)
    want = ref_attention.cross_attention(
        jax.tree.map(lambda a: jnp.asarray(a, act), p_ref), rcfg,
        jnp.asarray(x, act), jnp.asarray(img))
    tact = getattr(torch, img_dtype)
    got = attention.cross_attention(
        {k: torch.tensor(v).to(tact) for k, v in p_ref.items()}, cfg,
        torch.tensor(x).to(tact), torch.tensor(img))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _close(got, want, MODULE_REL if img_dtype == "float32" else 1e-2)
    with pytest.raises(ValueError, match="image embeddings"):
        attention.cross_attention({}, cfg, torch.tensor(x), None)


# -- mLSTM and sLSTM -------------------------------------------------------

@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_lstm_parallel_form_matches_reference(kind):
    i = 0 if kind == "mlstm" else 3
    rcfg, p_ref, cfg, p = _block("xlstm_125m", (f"b{i}", "lstm"))
    x = _x(cfg, S=24, seed=9)
    ref_fn = getattr(ref_ssm, f"{kind}_block")
    fn = getattr(ssm, f"{kind}_block")
    rout, rstate = ref_fn(p_ref, rcfg, jnp.asarray(x))
    out, state = fn(p, cfg, torch.tensor(x))
    _close(out, rout, MODULE_REL)
    assert len(state) == len(rstate)
    for got, want in zip(state, rstate):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        _close(got, want, MODULE_REL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_lstm_steps_match_reference(kind):
    """Eight single steps from the empty-history state (m at -1e30); each
    step's output and state against the reference's, and the last state
    against the port's own parallel form's hand-off."""
    i = 0 if kind == "mlstm" else 3
    rcfg, p_ref, cfg, p = _block("xlstm_125m", (f"b{i}", "lstm"))
    B, S = 2, 8
    x = _x(cfg, S=S, seed=10)
    spec = getattr(ssm, f"{kind}_state_spec")(cfg, B, torch.float32)
    state = tuple(torch.zeros(s.shape, dtype=s.dtype) for s in spec)
    state[2].fill_(-1e30)
    rstate = tuple(jnp.asarray(s.numpy()) for s in state)
    ref_fn = getattr(ref_ssm, f"{kind}_block")
    fn = getattr(ssm, f"{kind}_block")
    for t in range(S):
        rout, rstate = ref_fn(p_ref, rcfg, jnp.asarray(x[:, t:t + 1]),
                              rstate)
        out, state = fn(p, cfg, torch.tensor(x[:, t:t + 1]), state)
        _close(out, rout, MODULE_REL)
        for got, want in zip(state, rstate):
            _close(got, want, MODULE_REL)
    _, handoff = fn(p, cfg, torch.tensor(x))
    for got, want in zip(state, handoff):
        _close(got, want.numpy(), MODULE_REL)
