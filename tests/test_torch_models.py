"""Parity of the port's LM slice (``repro_torch.models``, ``configs``) with
the reference ``repro.models`` on the reference's own weights.

The reference's ``Model.init(PRNGKey(0))`` tree goes through numpy into
the port (``models.interop.model_params_from_jax``), so both packages run
the same function on the same parameters, in float32 on the CPU, where the
port's kernels run their plain versions.

Tolerances, as max |port - reference| over max |reference| of each output:

* one layer or module (``rmsnorm``, RoPE, MLP, ``_ssd_chunked``,
  ``mamba2_block``, ``gqa_attention``): 1e-5. XLA's CPU matmuls, exp and
  rsqrt differ from torch's by up to ~4e-7 relative per op (measured), and
  a module chains a few of them.
* the whole stack (logits, final hidden, aux loss, every prefill cache
  leaf): 1e-4. Reduced zamba2-7b chains 5 Mamba2 layers and 2
  shared-block invocations (~40 ops in sequence) on random weights; the
  measured gap is 1.3e-5 on its logits, 8e-6 on reduced xlstm-125m's,
  ~1e-6 on the others'.

Every id of ``configs.ARCH_IDS`` runs here. The reduced vision model's
cross-attention gate, 0 at init (which would hide the attention), is set
to 0.5 on both sides before the weights cross; its inputs carry image
embeddings, musicgen's carry (B, S, n_codebooks) tokens.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_configs
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.models import ssm as ref_ssm
from repro_torch.configs import base as configs
from repro_torch.models import Model, attention, layers, ssm
from repro_torch.models.interop import model_params_from_jax

MODULE_REL, STACK_REL = 1e-5, 1e-4
PORTED = ("zamba2_7b", "llama3_8b", "smollm_135m", "phi4_mini_3_8b",
          "llama4_scout_17b_a16e", "phi3_5_moe_42b_a6_6b", "minicpm3_4b",
          "llama_3_2_vision_90b", "xlstm_125m", "musicgen_medium")
# the architectures whose first block has GQA self-attention
GQA = tuple(n for n in PORTED if n not in ("minicpm3_4b", "xlstm_125m"))
XATTN_GATE = 0.5


def _close(got, want, rel):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, f"max rel err {err:.3g} > {rel}"


def _flatten(tree):
    """Leaves in JAX's order: dicts by sorted key, sequences in order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _flatten(tree[key])]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "dtype"):
        return [leaf for item in tree for leaf in _flatten(item)]
    return [tree]                       # a tensor, array or TensorSpec


@functools.lru_cache(maxsize=None)
def _reference(name):
    rcfg = ref_configs.get_reduced(name)
    rmodel = ref_build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    for i, kind in enumerate(rcfg.block_pattern):
        if kind == "xattn":
            blk = rparams["blocks"][f"b{i}"]["xattn"]
            blk["gate"] = jnp.full_like(blk["gate"], XATTN_GATE)
    cfg = configs.get_reduced(name)
    params = model_params_from_jax(cfg, jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    return name, rcfg, rmodel, rparams, cfg, params


@pytest.fixture(params=PORTED)
def reference(request):
    return _reference(request.param)


def _tokens(cfg, B=2, S=64, seed=0):
    """(B, S) token ids, or (B, S, n_codebooks) for a codebook model."""
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, S)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _img(cfg, B=2, seed=0):
    """Image embeddings (B, N_img, D) for a VLM, else None."""
    if not cfg.n_image_tokens:
        return None
    return np.random.default_rng(seed + 100).standard_normal(
        (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)


def _ref_in(a):
    return None if a is None else jnp.asarray(a)


def _port_in(a):
    return None if a is None else torch.tensor(a)


# -- configs ---------------------------------------------------------------

@pytest.mark.parametrize("name", PORTED)
def test_configs_match_reference(name):
    for get in ("get_arch", "get_reduced"):
        want = dataclasses.asdict(getattr(ref_configs, get)(name))
        assert dataclasses.asdict(getattr(configs, get)(name)) == want
    assert configs.SHAPES["train_4k"].seq_len == 4096
    assert [s.name for s in configs.shapes_for(configs.get_arch(name))] == [
        s.name for s in ref_configs.shapes_for(ref_configs.get_arch(name))]


def test_every_architecture_resolves_and_unknown_ids_raise():
    assert sorted(PORTED) == sorted(configs.ARCH_IDS)
    for name in configs.ARCH_IDS:
        Model(configs.get_arch(name))
    for alias, name in configs.CLI_ALIASES.items():
        assert configs.get_arch(alias) == configs.get_arch(name)
    with pytest.raises(ValueError, match="unknown"):
        configs.get_reduced("gpt-17")
    assert configs.get_arch("zamba2-7b").name == "zamba2-7b"     # CLI alias


def test_unknown_block_kind_raises():
    from repro_torch.models import model_zoo
    cfg = configs.get_reduced("llama3_8b")
    with pytest.raises(ValueError, match="conv"):
        model_zoo.block_cache_spec(cfg, "conv", 2, 16, torch.float32)
    with pytest.raises(ValueError, match="conv"):
        Model(configs.scale_down(cfg, block_pattern=("conv",))).init(
            torch.Generator().manual_seed(0), device="cpu")


# -- parameters ------------------------------------------------------------

def test_init_matches_reference_tree(reference):
    """Model.init builds the reference's tree (blocks as a list of
    superblocks), with its init rules: norms 1, a_log and dt_bias 0,
    fan-in scaled normals."""
    name, rcfg, rmodel, _, cfg, _ = reference
    port = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    shapes = rmodel.abstract_params()
    shapes["blocks"] = [jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape[1:], s.dtype),
        shapes["blocks"])] * cfg.resolved_superblocks
    want = [s.shape for s in _flatten(shapes)]
    got = _flatten(port)
    assert [tuple(t.shape) for t in got] == want
    assert all(t.dtype == torch.float32 for t in got)
    blk = port["blocks"][0]
    assert torch.all(blk["b0"]["n1"]["scale"] == 1)
    assert torch.all(port["final_norm"]["scale"] == 1)
    if name == "zamba2_7b":
        assert torch.all(blk["b0"]["mamba"]["a_log"] == 0)
        w = blk["b0"]["mamba"]["in_proj"]
        assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1) < 0.05
    if name == "minicpm3_4b":
        assert torch.all(blk["b0"]["attn"]["q_norm"] == 1)
        assert torch.all(blk["b0"]["attn"]["kv_norm"] == 1)
    if name == "llama_3_2_vision_90b":
        assert torch.all(blk["b4"]["xattn"]["gate"] == 0)
    if name == "xlstm_125m":
        r = blk["b3"]["lstm"]["r"]
        assert abs(float(r.std()) * np.sqrt(r.shape[-1]) / 0.5 - 1) < 0.1
    if name == "musicgen_medium":
        assert abs(float(port["codebook_embeds"].std()) - 0.02) < 0.002
    assert abs(float(port["embed"]["table"].std()) - 0.02) < 0.002


def test_params_carried_across(reference):
    _, _, _, rparams, cfg, params = reference
    assert len(params["blocks"]) == cfg.resolved_superblocks
    for i, blk in enumerate(params["blocks"]):
        want = _flatten(jax.tree.map(lambda a: np.asarray(a[i]),
                                     rparams["blocks"]))
        for got, w in zip(_flatten(blk), want):
            np.testing.assert_array_equal(got.numpy(), w)


# -- layers and modules ----------------------------------------------------

def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    scale = rng.random(16).astype(np.float32)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12))
    tx = torch.tensor(x)
    _close(layers.rmsnorm({"scale": torch.tensor(scale)}, tx),
           ref_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
           MODULE_REL)
    for arr in (x, x[:, :, 0]):                 # with and without a head axis
        _close(layers.apply_rope(torch.tensor(arr), torch.tensor(pos), 1e4),
               ref_layers.apply_rope(jnp.asarray(arr), jnp.asarray(pos), 1e4),
               MODULE_REL)
    w = {k: rng.standard_normal(s).astype(np.float32) / 4 for k, s in
         (("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16)))}
    _close(layers.mlp({k: torch.tensor(v) for k, v in w.items()}, tx),
           ref_layers.mlp({k: jnp.asarray(v) for k, v in w.items()},
                          jnp.asarray(x)), MODULE_REL)
    logits = 3 * rng.standard_normal((2, 12, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 12))
    _close(layers.cross_entropy(torch.tensor(logits), torch.tensor(labels)),
           ref_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    50), MODULE_REL)


def test_ssd_chunked_matches_reference():
    B, L, H, P, N, chunk = 2, 64, 4, 32, 16, 8
    rng = np.random.default_rng(1)
    arrays = (rng.standard_normal((B, L, H, P)).astype(np.float32),
              rng.random((B, L, H)).astype(np.float32),
              0.3 * rng.standard_normal(H).astype(np.float32),
              rng.standard_normal((B, L, N)).astype(np.float32),
              rng.standard_normal((B, L, N)).astype(np.float32))
    y, state = ssm._ssd_chunked(*map(torch.tensor, arrays), chunk)
    ry, rstate = ref_ssm._ssd_chunked(*map(jnp.asarray, arrays), chunk)
    _close(y, ry, MODULE_REL)
    _close(state, rstate, MODULE_REL)
    y_plain, _ = ssm._ssd_chunked(*map(torch.tensor, arrays), chunk,
                                  use_kernel=False)
    torch.testing.assert_close(y_plain, y, rtol=0, atol=0)


def test_mamba2_block_matches_reference():
    _, rcfg, _, rparams, cfg, params = _reference("zamba2_7b")
    x = np.random.default_rng(2).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    for i in range(cfg.resolved_superblocks):
        p_ref = jax.tree.map(lambda a: a[i], rparams["blocks"]["b1"]["mamba"])
        ry, rstate = ref_ssm.mamba2_block(p_ref, rcfg, jnp.asarray(x))
        y, state = ssm.mamba2_block(params["blocks"][i]["b1"]["mamba"], cfg,
                                    torch.tensor(x))
        _close(y, ry, MODULE_REL)
        _close(state, rstate, MODULE_REL)


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("name", GQA)
def test_gqa_attention_matches_reference(name, use_flash):
    """zamba2's shared block (G = 1), the others' first block (G = 1, 2
    or 3)."""
    name, rcfg, _, rparams, cfg, params = _reference(name)
    if name == "zamba2_7b":
        p_ref, p = rparams["shared"]["attn"], params["shared"]["attn"]
    else:
        p_ref = jax.tree.map(lambda a: a[0], rparams["blocks"]["b0"]["attn"])
        p = params["blocks"][0]["b0"]["attn"]
    B, S = 2, 48
    x = np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    rout, (rk, rv) = ref_attention.gqa_attention(
        p_ref, rcfg, jnp.asarray(x), jnp.asarray(pos), use_flash=use_flash)
    out, (k, v) = attention.gqa_attention(p, cfg, torch.tensor(x),
                                          torch.tensor(pos),
                                          use_flash=use_flash)
    _close(out, rout, MODULE_REL)
    _close(k, rk, MODULE_REL)
    _close(v, rv, MODULE_REL)


# -- the whole slice -------------------------------------------------------

@pytest.mark.parametrize("use_flash", [True, False])
def test_forward_matches_reference(reference, use_flash):
    _, _, rmodel, rparams, cfg, params = reference
    toks, img = _tokens(cfg), _img(cfg)
    rlogits, rhidden, raux = rmodel.forward(rparams, jnp.asarray(toks),
                                            img=_ref_in(img),
                                            use_flash=use_flash)
    logits, hidden, aux = Model(cfg).forward(params, torch.tensor(toks),
                                             img=_port_in(img),
                                             use_flash=use_flash,
                                             device="cpu")
    assert logits.shape == rlogits.shape
    _close(logits, rlogits, STACK_REL)
    _close(hidden, rhidden, STACK_REL)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    if cfg.n_experts:
        assert float(raux) > 0
        _close(aux, raux, STACK_REL)
    else:
        assert float(aux) == float(raux) == 0.0


def test_prefill_matches_reference(reference):
    _, _, rmodel, rparams, cfg, params = reference
    toks, img = _tokens(cfg, S=48, seed=1), _img(cfg, seed=1)
    rlogits, rcache = rmodel.prefill(rparams, jnp.asarray(toks),
                                     img=_ref_in(img),
                                     act_dtype=jnp.float32, use_flash=True)
    logits, cache = Model(cfg).prefill(params, torch.tensor(toks),
                                       img=_port_in(img),
                                       act_dtype=torch.float32,
                                       use_flash=True, device="cpu")
    _close(logits, rlogits, STACK_REL)
    assert sorted(cache) == sorted(rcache)
    want, got = jax.tree.leaves(rcache), _flatten(cache)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, STACK_REL)


def test_prefill_in_bfloat16_is_finite(reference):
    """The reference's prefill default: bfloat16 activations and weights;
    each cache leaf in its spec's dtype (bfloat16 but the LSTM
    stabilisers and sLSTM states, float32)."""
    _, _, _, _, cfg, params = reference
    model = Model(cfg)
    logits, cache = model.prefill(params, torch.tensor(_tokens(cfg)),
                                  img=_port_in(_img(cfg)), use_flash=True,
                                  device="cpu")
    assert logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    spec = _flatten(model.cache_spec(2, 64, torch.bfloat16))
    assert [t.dtype for t in _flatten(cache)] == [s.dtype for s in spec]
    assert [tuple(t.shape) for t in _flatten(cache)] == [
        tuple(s.shape) for s in spec]


def test_entry_points_raise_without_a_card(reference, monkeypatch):
    _, _, _, rparams, cfg, params = reference
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, toks = Model(cfg), torch.tensor(_tokens(cfg, S=16))
    img = _port_in(_img(cfg))
    for call in (lambda: model.init(torch.Generator().manual_seed(0)),
                 lambda: model.forward(params, toks, img=img),
                 lambda: model.prefill(params, toks, img=img),
                 lambda: model_params_from_jax(
                     cfg, jax.tree.map(np.asarray, rparams))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
