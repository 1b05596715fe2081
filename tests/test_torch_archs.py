"""The training path of the six architectures the port added last (MoE,
MLA, cross-attention, xLSTM, musicgen codebooks) against the reference,
on the CPU: ``Model.loss`` with its gradient, one
``launch.steps.make_train_step`` step, and ``launch.train.train``.

Each runs on the reference's ``init(PRNGKey(0))`` weights carried across
by ``model_params_from_jax`` (the vision model's cross-attention gate set
to 0.5 on both sides, ``tests/test_torch_models._reference``), on the
token pipeline's batches (image embeddings for the VLM, (B, S, 4) tokens
for musicgen). Tolerances (``tests/test_torch_train.py``'s):

* the loss, its ce and aux: rtol 1e-5 (``LOSS_RTOL``); the gradient
  within 1e-4 of each leaf's largest entry + 1e-6;
* one train step's ``loss``, ``ce``, ``aux``, ``gnorm`` and ``lr``: rtol
  1e-4 (``HISTORY_RTOL``, the stack rule);
* with ``gw_align`` on the reference's draws, the loss at rtol 1e-4: the
  alignment loss's float32 reach (5.1e-4 of its value, see
  ``tests/test_torch_decode.py``) times its weight 0.1 is below 1e-4 of
  a loss whose ce is ~ln V.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as ref_steps
from repro.optim import adamw as ref_adamw
from repro_torch.data import TokenPipeline
from repro_torch.launch import steps, train
from repro_torch.models import Model
from repro_torch.models.interop import model_params_from_jax
from repro_torch.optim import adamw
from test_torch_models import _reference
from test_torch_solve import _one_torch_thread  # noqa: F401 — autouse
from test_torch_train import (
    GRAD_ATOL,
    GRAD_REL,
    HISTORY_RTOL,
    LOSS_RTOL,
    _grad_within,
    _pairs,
    _ref_gw_draws,
)

NEW = ("llama4_scout_17b_a16e", "phi3_5_moe_42b_a6_6b", "minicpm3_4b",
       "llama_3_2_vision_90b", "xlstm_125m", "musicgen_medium")
B, S = 2, 32


@pytest.fixture(scope="module", params=NEW)
def case(request):
    """The reference's step-0 loss, parts and jax.grad (use_flash, float32)
    on the pipeline's batch 0, its loss with gw_align on the step-0 draws,
    and one step of its make_train_step (remat, flash, jitted)."""
    name, rcfg, rmodel, rparams, cfg, params = _reference(request.param)
    batch = TokenPipeline(cfg, S, B).global_batch_at(0)
    rbatch = jax.tree.map(jnp.asarray, batch)
    gw_key = jax.random.fold_in(jax.random.PRNGKey(17), 0)

    def loss_fn(p):
        return rmodel.loss(p, rbatch, act_dtype=jnp.float32, use_flash=True)

    (loss, parts), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(rparams)
    align_loss, _ = jax.jit(lambda p: rmodel.loss(
        p, rbatch, act_dtype=jnp.float32, use_flash=True, gw_align=True,
        gw_key=gw_key))(rparams)
    step_fn = jax.jit(ref_steps.make_train_step(
        rmodel, act_dtype=jnp.float32, remat=True, use_flash=True,
        warmup=2, total_steps=10))
    _, _, metrics = step_fn(rparams, ref_adamw.init(rparams), rbatch)
    return dict(name=name, cfg=cfg, params=params, batch=batch,
                loss=float(loss), ce=float(parts["ce"]),
                aux=float(parts["aux"]), align_loss=float(align_loss),
                grads=jax.tree.map(np.asarray, grads),
                metrics={k: float(v) for k, v in metrics.items()})


def test_loss_and_grads_match_reference(case):
    cfg = case["cfg"]
    live = adamw.tree_map(lambda t: t.clone().requires_grad_(True),
                          case["params"])
    loss, parts = Model(cfg).loss(live, case["batch"], use_flash=True,
                                  device="cpu")
    np.testing.assert_allclose(float(loss.detach()), case["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["ce"].detach()), case["ce"],
                               rtol=LOSS_RTOL)
    if cfg.n_experts:
        assert case["aux"] > 0
        np.testing.assert_allclose(float(parts["aux"].detach()),
                                   case["aux"], rtol=LOSS_RTOL)
    else:
        assert float(parts["aux"]) == case["aux"] == 0.0
    grads = iter(torch.autograd.grad(loss, adamw.tree_leaves(live)))
    got = adamw.tree_map(lambda p: next(grads), case["params"])
    want = model_params_from_jax(cfg, case["grads"], device="cpu")
    for path, g, w in _pairs(got, want):
        try:
            _grad_within(g, w.numpy(), GRAD_REL, GRAD_ATOL)
        except AssertionError as e:
            raise AssertionError(f"{path}: {e}") from None


def test_loss_with_gw_align_matches_reference(case):
    """The alignment loss between the final hidden states and the token
    embeddings (summed over codebooks for musicgen)."""
    loss, _ = Model(case["cfg"]).loss(
        case["params"], case["batch"], use_flash=True, gw_align=True,
        gw_draws=_ref_gw_draws(0, B, S), device="cpu")
    assert float(loss) != pytest.approx(case["loss"], rel=1e-3)
    np.testing.assert_allclose(float(loss), case["align_loss"],
                               rtol=HISTORY_RTOL)


def test_train_step_matches_reference(case):
    step_fn = steps.make_train_step(Model(case["cfg"]),
                                    act_dtype=torch.float32, remat=True,
                                    use_flash=True, warmup=2, total_steps=10)
    params = case["params"]
    new, state, m = step_fn(params, adamw.init(params), case["batch"])
    for key in ("loss", "ce", "aux", "gnorm", "lr"):
        np.testing.assert_allclose(float(m[key]), case["metrics"][key],
                                   rtol=HISTORY_RTOL, err_msg=key)
    assert int(state.step) == 1
    assert all(not torch.equal(a, b) for a, b in
               zip(adamw.tree_leaves(params), adamw.tree_leaves(new)))


@pytest.mark.parametrize("name", NEW)
def test_train_loop_runs_every_new_arch(name, capsys):
    """``launch.train.train`` on the pipeline (image embeddings and
    codebook tokens included): finite losses, aux > 0 for MoE."""
    cfg = _reference(name)[4]
    _, state, hist = train.train(cfg, 3, 2, 16, use_flash=True,
                                 log_every=1, device="cpu")
    assert len(hist) == 3 and int(state.step) == 3
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert all((h["aux"] > 0) == bool(cfg.n_experts) for h in hist)
    assert capsys.readouterr().out.count("step ") == 3
