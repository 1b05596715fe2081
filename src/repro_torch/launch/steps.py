"""Step functions shared by the trainer and the server (counterpart of
``repro.launch.steps``).

A train step takes the loss and its gradient with respect to every
parameter (autograd through the model, K5 and K6 included through their
``autograd.Function``\\ s), clips and applies AdamW, and reads the
learning rate of the step the optimizer is about to take. The reference
jits these; here they run eagerly.

The reference draws each step's alignment tokens from
``fold_in(PRNGKey(17), step)``. Threefry has no torch counterpart, so the
port seeds a ``torch.Generator`` on the parameters' device with
:func:`gw_seed` = 17·2³² + step: the same (17, step) pair, a fixed seed
per step, so a resumed run draws what a straight run draws. Parity tests
pass the reference's draws instead (``gw_draws``).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.distrib.sharding import is_dtensor
from repro_torch.models.model_zoo import Model
from repro_torch.optim import adamw

GW_KEY = 17


def gw_seed(step: int) -> int:
    """The seed of step ``step``'s alignment draws."""
    return (GW_KEY << 32) + int(step)


def make_train_step(model: Model, base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, act_dtype=torch.bfloat16,
                    remat: bool = True, use_flash: bool = False,
                    gw_align: bool = False, use_kernel: bool = True):
    """``train_step(params, opt_state, batch, gw_draws=None)`` ->
    (new_params, new_opt_state, metrics) with metrics ``loss``, ``ce``,
    ``aux``, ``gnorm`` (before clipping) and ``lr``, 0-d tensors. The
    batch's ``image_embeds``, where a VLM's batch has them, reach the
    loss with it. The parameters (float tensors on one device) are not
    modified; the new ones are new tensors."""
    lr_fn = adamw.cosine_schedule(base_lr, warmup, total_steps)

    def train_step(params, opt_state, batch, gw_draws=None):
        with mesh_context(params):
            return _step(params, opt_state, batch, gw_draws)

    def _step(params, opt_state, batch, gw_draws):
        leaves = adamw.tree_leaves(params)
        dev = leaves[0].device
        gen = None
        if gw_align and gw_draws is None:
            gen = torch.Generator(device=dev).manual_seed(
                gw_seed(int(opt_state.step)))
        live = adamw.tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
        loss, parts = model.loss(live, batch, act_dtype=act_dtype,
                                 use_flash=use_flash, remat=remat,
                                 gw_align=gw_align, gw_generator=gen,
                                 use_kernel=use_kernel,
                                 gw_draws=gw_draws, device=dev)
        flat = adamw.tree_leaves(live)
        grads = iter(torch.autograd.grad(loss, flat))
        grads = adamw.tree_map(lambda p: next(grads), live)
        lr = lr_fn(opt_state.step + 1)      # step counter increments in update
        new_params, new_state, gnorm = adamw.update(grads, opt_state, params,
                                                    lr)
        metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                   "aux": parts["aux"].detach(), "gnorm": gnorm, "lr": lr}
        return new_params, new_state, metrics

    return train_step


def make_prefill_step(model: Model, act_dtype=torch.bfloat16,
                      use_flash: bool = False, use_kernel: bool = True):
    def prefill_step(params, batch):
        with mesh_context(params):
            return model.prefill(params, torch.as_tensor(batch["tokens"]),
                                 img=batch.get("image_embeds"),
                                 act_dtype=act_dtype, use_flash=use_flash,
                                 use_kernel=use_kernel,
                                 device=adamw.tree_leaves(params)[0].device)
    return prefill_step


def make_decode_step(model: Model, act_dtype=torch.bfloat16):
    def decode_step(params, batch):
        with mesh_context(params):
            return model.decode_step(
                params, torch.as_tensor(batch["tokens"]), batch["cache"],
                int(batch["index"]), img=batch.get("image_embeds"),
                act_dtype=act_dtype,
                device=adamw.tree_leaves(params)[0].device)
    return decode_step


def mesh_context(params):
    """Where the parameters are DTensors (the mesh path), plain tensors
    met in the step (the batch, masks, positions) count as replicated
    (``implicit_replication``); elsewhere no context."""
    if not is_dtensor(adamw.tree_leaves(params)[0]):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()
