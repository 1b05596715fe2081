"""The hill-climbing levers of the model code against the reference's:
``set_mamba_options(split_proj=)``, ``set_moe_options(bf16_dispatch=)``
and ``set_flash_chunk``. Each is the reference's global dict, set on both
sides and reset in a ``finally``.

* ``split_proj``: ``mamba2_block`` (prefill and its decode step) on the
  reference's ``split_proj`` weights (a Builder run with the lever on),
  at the LM modules' 1e-5 of the largest output
  (``tests/test_torch_models.py``'s ``MODULE_REL``); and the split and
  fused layouts against each other on weights split from one
  ``in_proj``, at the same bound.
* ``bf16_dispatch``: the gshard MoE on reduced llama4-scout and
  phi3.5-moe with the lever on, at 1e-5.
* ``set_flash_chunk(256)``: ``blockwise_gqa`` at S = 1024 (four chunks)
  and ``blockwise_mla``, at 1e-5; and ``gqa_attention``'s ``use_flash``
  plain route against the reference's ``use_flash`` path.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attention
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.models.module import Builder as RefBuilder
from repro_torch.models import attention, moe, ssm
from test_torch_blocks import _as_port, _as_ref, _block, _x
from test_torch_models import MODULE_REL, _close, _reference
from test_torch_solve import _one_torch_thread  # noqa: F401 — autouse


@contextlib.contextmanager
def _lever(ref_set, port_set, **on):
    off = {k: False if isinstance(v, bool) else 512 for k, v in on.items()}
    ref_set(**on)
    port_set(**on)
    try:
        yield
    finally:
        ref_set(**off)
        port_set(**off)


def split_in_proj(p, cfg):
    """A fused Mamba2 block's weights in the split layout: in_proj's
    columns [z, x] as in_zx, [B, C, dt] as in_bcdt."""
    d_in = cfg.ssm_expand * cfg.d_model
    out = {k: v for k, v in p.items() if k != "in_proj"}
    out["in_zx"] = p["in_proj"][:, :2 * d_in].contiguous()
    out["in_bcdt"] = p["in_proj"][:, 2 * d_in:].contiguous()
    return out


def test_split_proj_mamba2_matches_reference():
    _, rcfg, _, _, cfg, _ = _reference("zamba2_7b")
    with _lever(ref_ssm.set_mamba_options, ssm.set_mamba_options,
                split_proj=True):
        p_ref = ref_ssm.mamba2_params(
            RefBuilder("init", jax.random.PRNGKey(3)), rcfg)
        assert set(p_ref) >= {"in_zx", "in_bcdt"} and "in_proj" not in p_ref
        p = _as_port(p_ref)
        x = _x(cfg, S=32, seed=4)
        ry, rstate = ref_ssm.mamba2_block(p_ref, rcfg, jnp.asarray(x))
        y, state = ssm.mamba2_block(p, cfg, torch.tensor(x))
        _close(y, ry, MODULE_REL)
        _close(state, rstate, MODULE_REL)
        x1 = _x(cfg, S=1, seed=5)
        ry1, rs1 = ref_ssm.mamba2_block(p_ref, rcfg, jnp.asarray(x1),
                                        state=rstate)
        y1, s1 = ssm.mamba2_block(p, cfg, torch.tensor(x1), state=state)
        _close(y1, ry1, MODULE_REL)
        _close(s1, rs1, MODULE_REL)


def test_split_and_fused_layouts_agree():
    _, _, cfg, p = _block("zamba2_7b", ("b1", "mamba"))
    p_split = split_in_proj(p, cfg)
    x = torch.tensor(_x(cfg, S=32, seed=6))
    y, state = ssm.mamba2_block(p, cfg, x)
    ys, states = ssm.mamba2_block(p_split, cfg, x)
    _close(ys, y.numpy(), MODULE_REL)
    _close(states, state.numpy(), MODULE_REL)
    x1 = torch.tensor(_x(cfg, S=1, seed=7))
    _close(ssm.mamba2_block(p_split, cfg, x1, state=state)[0],
           ssm.mamba2_block(p, cfg, x1, state=state)[0].numpy(), MODULE_REL)


@pytest.mark.parametrize("name", ["llama4_scout_17b_a16e",
                                  "phi3_5_moe_42b_a6_6b"])
def test_moe_bf16_dispatch_matches_reference(name):
    rcfg, p_ref, cfg, _ = _block(name, ("b0", "moe"))
    p = _as_port(p_ref)
    x = _x(cfg, seed=1)
    with _lever(ref_moe.set_moe_options, moe.set_moe_options,
                bf16_dispatch=True):
        rout, raux = ref_moe.moe_mlp(_as_ref(p_ref), rcfg, jnp.asarray(x))
        out, aux = moe.moe_mlp(p, cfg, torch.tensor(x))
    _close(out, rout, MODULE_REL)
    _close(aux, raux, MODULE_REL)
    # the lever rounds the combine weights: off, the output moves (top-1
    # routing's weight is exactly 1, which bfloat16 keeps)
    off, _ = moe.moe_mlp(p, cfg, torch.tensor(x))
    assert torch.equal(off, out) == (cfg.experts_per_token == 1)


def test_flash_chunk_blockwise_attention_matches_reference():
    rng = np.random.default_rng(8)
    B, S, K, G, hd = 1, 1024, 2, 2, 16
    q = rng.standard_normal((B, S, K, G, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, K, hd)).astype(np.float32)
            for _ in range(2))
    with _lever(ref_attention.set_flash_chunk, attention.set_flash_chunk,
                size=256):
        want = ref_attention.blockwise_gqa(*map(jnp.asarray, (q, k, v)))
        got = attention.blockwise_gqa(*map(torch.tensor, (q, k, v)))
        _close(got, want, MODULE_REL)
        # the default chunk is read, not fixed: an explicit 256 agrees
        torch.testing.assert_close(
            attention.blockwise_gqa(*map(torch.tensor, (q, k, v)),
                                    chunk=256), got, rtol=0, atol=0)
    assert attention._FLASH_CHUNK["size"] == 512


def test_flash_chunk_mla_and_the_use_flash_routes():
    rcfg_g, p_ref, cfg_g, p = _block("llama3_8b", ("b0", "attn"))
    x = _x(cfg_g, S=64, seed=9)
    pos = np.broadcast_to(np.arange(64)[None], (2, 64))
    with _lever(ref_attention.set_flash_chunk, attention.set_flash_chunk,
                size=16):
        want, _ = ref_attention.gqa_attention(
            _as_ref(p_ref), rcfg_g, jnp.asarray(x), jnp.asarray(pos),
            use_flash=True)
        got, _ = attention.gqa_attention(p, cfg_g, torch.tensor(x),
                                         torch.tensor(pos), use_flash=True,
                                         use_kernel=False)
        _close(got, want, MODULE_REL)
        rcfg_m, pm_ref, cfg_m, pm = _block("minicpm3_4b", ("b0", "attn"))
        xm = _x(cfg_m, S=64, seed=10)
        want, _ = ref_attention.mla_attention(
            _as_ref(pm_ref), rcfg_m, jnp.asarray(xm), jnp.asarray(pos),
            use_flash=True)
        got, _ = attention.mla_attention(pm, cfg_m, torch.tensor(xm),
                                         torch.tensor(pos), use_flash=True)
        _close(got, want, MODULE_REL)
