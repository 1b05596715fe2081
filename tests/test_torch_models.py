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
* the whole stack (logits, final hidden, every prefill cache leaf): 1e-4.
  Reduced zamba2-7b chains 5 Mamba2 layers and 2 shared-block invocations
  (~40 ops in sequence) on random weights; the measured gap is 1.3e-5 on
  its logits, 1.1e-6 on reduced llama3-8b's.
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
PORTED = ("zamba2_7b", "llama3_8b", "smollm_135m", "phi4_mini_3_8b")


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
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _flatten(item)]
    return [tree]


@functools.lru_cache(maxsize=None)
def _reference(name):
    rcfg = ref_configs.get_reduced(name)
    rmodel = ref_build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    cfg = configs.get_reduced(name)
    params = model_params_from_jax(cfg, jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    return name, rcfg, rmodel, rparams, cfg, params


@pytest.fixture(params=PORTED)
def reference(request):
    return _reference(request.param)


def _tokens(cfg, B=2, S=64, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


# -- configs ---------------------------------------------------------------

@pytest.mark.parametrize("name", PORTED)
def test_configs_match_reference(name):
    for get in ("get_arch", "get_reduced"):
        want = dataclasses.asdict(getattr(ref_configs, get)(name))
        assert dataclasses.asdict(getattr(configs, get)(name)) == want
    assert configs.SHAPES["train_4k"].seq_len == 4096
    assert [s.name for s in configs.shapes_for(configs.get_arch(name))] == [
        s.name for s in ref_configs.shapes_for(ref_configs.get_arch(name))]


def test_unported_architectures_raise():
    for name in configs.ARCH_IDS:
        if name not in PORTED:
            with pytest.raises(NotImplementedError, match="ROADMAP item 17"):
                configs.get_arch(name)
    with pytest.raises(ValueError, match="unknown"):
        configs.get_reduced("gpt-17")
    assert configs.get_arch("zamba2-7b").name == "zamba2-7b"     # CLI alias


def test_unported_model_paths_raise():
    # decode_step and init_cache are ported for attn and mamba2 (held in
    # tests/test_torch_decode.py); the caches of other kinds still raise
    from repro_torch.models import model_zoo
    cfg = configs.get_reduced("zamba2_7b")
    for kind in ("moe", "mlstm", "slstm", "xattn"):
        with pytest.raises(NotImplementedError, match="ROADMAP item 17"):
            model_zoo.block_cache_spec(cfg, kind, 2, 16, torch.float32)
    for bad in (configs.scale_down(cfg, block_pattern=("moe",)),
                configs.scale_down(cfg, tail_blocks=("mlstm",)),
                configs.scale_down(cfg, attn_type="mla")):
        with pytest.raises(NotImplementedError, match="ROADMAP item 17"):
            Model(bad)


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
def test_gqa_attention_matches_reference(reference, use_flash):
    """zamba2's shared block (G = 1) and llama3's first block (G = 2)."""
    name, rcfg, _, rparams, cfg, params = reference
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
    toks = _tokens(cfg)
    rlogits, rhidden, raux = rmodel.forward(rparams, jnp.asarray(toks),
                                            use_flash=use_flash)
    logits, hidden, aux = Model(cfg).forward(params, torch.tensor(toks),
                                             use_flash=use_flash,
                                             device="cpu")
    assert logits.shape == (2, 64, cfg.vocab_size)
    _close(logits, rlogits, STACK_REL)
    _close(hidden, rhidden, STACK_REL)
    assert float(aux) == float(raux) == 0.0


def test_prefill_matches_reference(reference):
    _, _, rmodel, rparams, cfg, params = reference
    toks = _tokens(cfg, S=48, seed=1)
    rlogits, rcache = rmodel.prefill(rparams, jnp.asarray(toks),
                                     act_dtype=jnp.float32, use_flash=True)
    logits, cache = Model(cfg).prefill(params, torch.tensor(toks),
                                       act_dtype=torch.float32,
                                       use_flash=True, device="cpu")
    _close(logits, rlogits, STACK_REL)
    assert sorted(cache) == sorted(rcache)
    want, got = jax.tree.leaves(rcache), _flatten(cache)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, STACK_REL)


def test_prefill_in_bfloat16_is_finite(reference):
    """The reference's prefill default: bfloat16 activations and weights."""
    _, _, _, _, cfg, params = reference
    logits, cache = Model(cfg).prefill(params, torch.tensor(_tokens(cfg)),
                                       use_flash=True, device="cpu")
    assert logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    assert all(t.dtype == torch.bfloat16 for t in _flatten(cache))


def test_entry_points_raise_without_a_card(reference, monkeypatch):
    _, _, _, rparams, cfg, params = reference
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, toks = Model(cfg), torch.tensor(_tokens(cfg, S=16))
    for call in (lambda: model.init(torch.Generator().manual_seed(0)),
                 lambda: model.forward(params, toks),
                 lambda: model.prefill(params, toks),
                 lambda: model_params_from_jax(
                     cfg, jax.tree.map(np.asarray, rparams))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
