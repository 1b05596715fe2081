"""The LM decode path against ``repro.models`` / ``repro.launch.serve``,
CPU: ``init_cache``, ``decode_step``, ``generate``, ``gw_similarity`` and
``launch.serve --mode lm``, on every reduced architecture (GQA and MLA
caches written in place, the Mamba2, mLSTM and sLSTM recurrences, MoE
without drops, cross-attention to the image embeddings at every step,
musicgen's (B, 1, n_codebooks) tokens), with the reference's
``init(PRNGKey(0))`` weights carried across by ``model_params_from_jax``.
Decode against the port's own forward runs the MoE models at capacity
factor 100, as tests/test_models.py does, so that the forward drops no
token either.

Tolerances, as max |port - reference| over max |reference| of an output:
decode logits and every cache leaf 1e-4 (the stack rule of
``tests/test_torch_models.py``: a decode step chains as many ops as a
forward); decode against the port's own forward at
``tests/test_models.py``'s atol 2e-2 + rtol 1e-2; ``gw_similarity`` rtol
1e-5 on the reference's draws.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.align import gw_alignment_loss as ref_gw_alignment_loss
from repro.launch import serve as ref_serve
from repro_torch.launch import serve
from repro_torch.models import Model
from test_torch_models import (
    PORTED,
    STACK_REL,
    _close,
    _img,
    _port_in,
    _reference,
    _ref_in,
    _tokens,
)
from test_torch_solve import _one_torch_thread  # noqa: F401 — autouse

B, S0, STEPS, NEW = 2, 8, 8, 6


@pytest.fixture(scope="module", params=PORTED)
def case(request):
    """The reference model and weights, the port's, the prompt, and the
    reference's 8 teacher-forced decode steps (logits of each, the caches
    after the last) and its greedy ``generate`` continuation."""
    name, rcfg, rmodel, rparams, cfg, params = _reference(request.param)
    tokens, img = _tokens(cfg, B, 16, seed=5), _img(cfg, B, seed=5)
    decode = jax.jit(lambda p, tok, c, idx: rmodel.decode_step(
        p, tok, c, idx, img=_ref_in(img), act_dtype=jnp.float32))
    cache = rmodel.init_cache(B, STEPS, dtype=jnp.float32)
    logits = []
    for t in range(STEPS):
        lg, cache = decode(rparams, jnp.asarray(tokens[:, t:t + 1]), cache,
                           jnp.int32(t))
        logits.append(np.asarray(lg))
    seqs = np.asarray(ref_serve.generate(rmodel, rparams,
                                         jnp.asarray(tokens[:, :S0]), NEW,
                                         img=_ref_in(img)))
    return dict(name=name, rmodel=rmodel, rparams=rparams, cfg=cfg,
                params=params, tokens=tokens, img=img, logits=logits,
                cache=jax.tree.map(np.asarray, cache), seqs=seqs)


def _leaves(tree):
    """(path, leaf) pairs in a fixed order: dicts by key, then sequences."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", x) for k in sorted(tree)
                for p, x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "dtype"):
        return [(f"{i}/{p}", x) for i, item in enumerate(tree)
                for p, x in _leaves(item)]
    return [("", tree)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_reference(case, dtype):
    model = Model(case["cfg"])
    got = model.init_cache(B, 12, dtype=getattr(torch, dtype), device="cpu")
    want = case["rmodel"].init_cache(B, 12, dtype=getattr(jnp, dtype))
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, x), (_, y) in zip(g, w):
        assert tuple(x.shape) == tuple(y.shape), path
        assert str(x.dtype).split(".")[-1] == str(y.dtype), path
        # zeros, the LSTM stabilisers -1e30
        np.testing.assert_array_equal(x.float().numpy(),
                                      np.asarray(y, np.float32), path)
    spec = model.cache_spec(B, 12)
    assert [tuple(s.shape) for _, s in _leaves(spec)] == [
        tuple(y.shape) for _, y in w]


def _port_decode(case, steps, cache=None, cfg=None):
    model = Model(cfg or case["cfg"])
    if cache is None:
        cache = model.init_cache(B, steps, dtype=torch.float32,
                                 device="cpu")
    logits = []
    tokens = torch.as_tensor(case["tokens"])
    for t in range(steps):
        lg, new = model.decode_step(case["params"], tokens[:, t:t + 1],
                                    cache, t, img=_port_in(case["img"]),
                                    act_dtype=torch.float32, device="cpu")
        assert new is cache
        logits.append(lg)
    return model, logits, cache


def test_decode_steps_match_reference(case):
    _, logits, cache = _port_decode(case, STEPS)
    for got, want in zip(logits, case["logits"]):
        _close(got, want, STACK_REL)
    g, w = _leaves(cache), _leaves(case["cache"])
    assert [p for p, _ in g] == [p for p, _ in w]
    for (_, x), (_, y) in zip(g, w):
        _close(x, y, STACK_REL)


def test_decode_matches_own_forward(case):
    cfg = case["cfg"]
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=100.0)
    model, logits, _ = _port_decode(case, STEPS, cfg=cfg)
    full, _, _ = model.forward(case["params"],
                               torch.as_tensor(case["tokens"][:, :STEPS]),
                               img=_port_in(case["img"]), device="cpu")
    np.testing.assert_allclose(torch.cat(logits, 1).numpy(), full.numpy(),
                               atol=2e-2, rtol=1e-2)


def test_generate_matches_reference(case):
    model = Model(case["cfg"])
    img = _port_in(case["img"])
    got = serve.generate(model, case["params"],
                         torch.as_tensor(case["tokens"][:, :S0]), NEW,
                         img=img, device="cpu").numpy()
    want = case["seqs"]
    assert got.shape == want.shape == (B, S0 + NEW) + want.shape[2:]
    assert np.array_equal(got[:, :S0], want[:, :S0])
    if np.array_equal(got, want):
        return
    # a differing token is only allowed where the reference's top-2 logits
    # are nearer than the logit bound; there the step's logits are compared
    t = int(np.argmax((got != want).reshape(B, got.shape[1], -1)
                      .any(axis=(0, 2))))
    rcache = case["rmodel"].init_cache(B, S0 + NEW, dtype=jnp.float32)
    pcache = model.init_cache(B, S0 + NEW, dtype=torch.float32, device="cpu")
    for i in range(t):
        rl, rcache = case["rmodel"].decode_step(
            case["rparams"], jnp.asarray(want[:, i:i + 1]), rcache,
            jnp.int32(i), img=_ref_in(case["img"]), act_dtype=jnp.float32)
        pl, pcache = model.decode_step(
            case["params"], torch.as_tensor(want[:, i:i + 1]), pcache, i,
            img=img, act_dtype=torch.float32, device="cpu")
    rl = np.asarray(rl)[:, -1]                  # (B, V) or (B, C, V)
    top2 = np.sort(rl, axis=-1)[..., -2:]
    gap = float((top2[..., 1] - top2[..., 0]).min())
    bound = STACK_REL * np.abs(rl).max()
    print(f"token {t}: top-2 logit gap {gap:.3g} under the logit bound "
          f"{bound:.3g}; that step's logits are compared instead")
    assert gap < bound
    _close(pl[:, -1], rl, STACK_REL)


def test_generate_samples_from_its_generator(case):
    model = Model(case["cfg"])
    prompts = torch.as_tensor(case["tokens"][:, :S0])

    def sample(seed):
        return serve.generate(model, case["params"], prompts, NEW,
                              temperature=0.8, img=_port_in(case["img"]),
                              device="cpu",
                              generator=torch.Generator().manual_seed(seed))

    a, b = sample(0), sample(0)
    assert torch.equal(a, b) and torch.equal(a[:, :S0], prompts)
    assert bool(((a >= 0) & (a < case["cfg"].vocab_size)).all())


# gw_similarity's value against the reference's: rtol 1e-5 on the four
# architectures first held to it. On the others the alignment loss's own
# float32 reach (tests/test_torch_legacy.py's ``_unrolled_bound`` at
# s_r = s_c = 8, unit tokens |C| <= 4, 3 outer x 10 inner steps, ε 0.05),
# twice over for two float32 sides: 5.1e-4. Even on the reference's own
# hidden states the two losses part by 1.0e-5 (reduced phi3.5-moe), and
# the hidden states' gap, which the stack rule holds, adds to it (2.8e-5
# read on xlstm-125m).
GW_SIM_RTOL = {"zamba2_7b": 1e-5, "llama3_8b": 1e-5, "smollm_135m": 1e-5,
               "phi4_mini_3_8b": 1e-5}
ALIGN_REACH = 2 * 3 * (10 + 4.0 / 0.05) * (8 + 8) * 2.0 ** -24


def test_gw_similarity_matches_reference(case):
    """The reference's gw_similarity takes no image embeddings: for the
    VLM its two forwards (with them) and its alignment loss stand in."""
    from repro_torch.core.align import gw_alignment_loss
    S = 16
    a = case["tokens"][:, :S]
    b = a[::-1].copy()
    _, h_a, _ = case["rmodel"].forward(case["rparams"], jnp.asarray(a),
                                       img=_ref_in(case["img"]))
    _, h_b, _ = case["rmodel"].forward(case["rparams"], jnp.asarray(b),
                                       img=_ref_in(case["img"]))
    want = float(ref_gw_alignment_loss(jax.random.PRNGKey(0), h_a, h_b,
                                       s_r=8, s_c=8))
    if case["img"] is None:
        assert want == float(ref_serve.gw_similarity(
            case["rmodel"], case["rparams"], jnp.asarray(a), jnp.asarray(b),
            s=8))
    R, C = [], []          # gw_alignment_loss's split / randint draws
    for k in jax.random.split(jax.random.PRNGKey(0), B):
        kr, kc = jax.random.split(k)
        R.append(np.asarray(jax.random.randint(kr, (8,), 0, S)))
        C.append(np.asarray(jax.random.randint(kc, (8,), 0, S)))
    got = serve.gw_similarity(Model(case["cfg"]), case["params"],
                              torch.as_tensor(a), torch.as_tensor(b), s=8,
                              draws=(np.stack(R), np.stack(C)),
                              img=_port_in(case["img"]), device="cpu")
    rtol = GW_SIM_RTOL.get(case["name"], ALIGN_REACH)
    np.testing.assert_allclose(float(got), want, rtol=rtol)
    on_ref = gw_alignment_loss(None, torch.tensor(np.asarray(h_a)),
                               torch.tensor(np.asarray(h_b)), s_r=8, s_c=8,
                               draws=(np.stack(R), np.stack(C)))
    np.testing.assert_allclose(float(on_ref), want, rtol=rtol)


def test_lm_cli_runs_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--mode", "lm", "--arch", "zamba2-7b", "--reduced",
                    "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                    "--gen", "4", "--metric", "gw"])
    text = out.getvalue()
    assert "generated (2, 12)" in text and "GW(batch, reversed-batch)" in text


@pytest.mark.parametrize("arch", ["xlstm-125m", "minicpm3-4b",
                                  "phi3.5-moe-42b-a6.6b",
                                  "llama4-scout-17b-a16e"])
def test_lm_cli_runs_every_arch_the_reference_runs(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--mode", "lm", "--arch", arch, "--reduced",
                    "--device", "cpu", "--batch", "2", "--prompt-len", "4",
                    "--gen", "3", "--metric", "gw"])
    text = out.getvalue()
    assert "generated (2, 7)" in text and "GW(batch, reversed-batch)" in text


def test_lm_cli_raises_without_a_card(monkeypatch):
    """No card: RuntimeError. The two architectures on which the
    reference's lm_main fails (2-D prompts, no image embeddings) raise
    ValueError naming that failure, card or not."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--mode", "lm", "--arch", "zamba2-7b", "--reduced"])
    with pytest.raises(ValueError, match=r"n_codebooks\) prompts.*"
                                         r"not enough values to unpack"):
        serve.main(["--mode", "lm", "--arch", "musicgen-medium",
                    "--reduced", "--device", "cpu"])
    with pytest.raises(ValueError, match=r"image embeddings.*unsupported "
                                         r"operand type"):
        serve.main(["--mode", "lm", "--arch", "llama-3.2-vision-90b",
                    "--reduced"])
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            serve.main(["--mode", "lm"])
