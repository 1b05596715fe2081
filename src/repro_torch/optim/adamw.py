"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule (counterpart of ``repro.optim.adamw``).

A functional optimizer over a tree of tensors (a tensor, or dicts, lists
and tuples of them), as the reference's is over a pytree: ``init``
builds the state, ``update`` returns the new parameters, the new state
and the global gradient norm before clipping. The arithmetic is the
reference's, step for step (``torch.optim.AdamW`` orders its update
differently: it decays the parameters before the Adam step and folds the
bias corrections into the step size, so it does not match bit for bit).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32: updates taken
    m: Any                  # first moments, a tree like the parameters
    v: Any                  # second moments


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of ``tree`` (and of the trees ``rest`` of
    the same structure): dicts, lists and tuples are walked."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def init(params) -> AdamWState:
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return AdamWState(step, tree_map(torch.zeros_like, params),
                      tree_map(torch.zeros_like, params))


def abstract_state(abstract_params) -> AdamWState:
    """The state's shapes and dtypes without memory: tensors on the
    ``meta`` device (the reference returns ``ShapeDtypeStruct``\\ s)."""
    z = tree_map(lambda p: torch.empty_like(p, device="meta"),
                 abstract_params)
    return AdamWState(torch.empty((), dtype=torch.int32, device="meta"), z, z)


def state_axes(param_axes) -> AdamWState:
    """Optimizer state shards exactly like its parameters."""
    return AdamWState((), param_axes, param_axes)


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global ℓ2 norm is at most ``max_norm``;
    returns the scaled grads and the norm before scaling."""
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2)
                        for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


def update(grads, state: AdamWState, params, lr, b1=0.9, b2=0.95, eps=1e-8,
           weight_decay=0.1, max_grad_norm=1.0):
    """One AdamW step: ``(new_params, new_state, grad_norm)``. Runs without
    autograd (the update is not part of any loss)."""
    with torch.no_grad():
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        t = step.float()
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        m = tree_map(lambda mu, g: b1 * mu + (1 - b1) * g, state.m, grads)
        v = tree_map(lambda nu, g: b2 * nu + (1 - b2) * g * g, state.v,
                     grads)

        def upd(p, mu, nu):
            mh = mu / bc1
            vh = nu / bc2
            return p - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * p)

        new_params = tree_map(upd, params, m, v)
    return new_params, AdamWState(step, m, v), gnorm


def cosine_schedule(base_lr: float, warmup: int, total: int, min_frac=0.1):
    """Linear warm-up to ``base_lr``, then a cosine decay to
    ``min_frac·base_lr`` at ``total``; a function of the step tensor."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr
