"""Training launcher: the train loop with fault tolerance (counterpart of
``repro.launch.train``).

  · auto-resume from the latest valid checkpoint, bit for bit: the data
    pipeline's state rides in the checkpoint, and the step's alignment
    draws are seeded from the step (``steps.gw_seed``);
  · async checkpointing every N steps, atomic publish, keep-k GC;
  · straggler watchdog: per-step wall-time EMA, slow steps logged.

``mesh`` (a ``DeviceMesh`` over the default process group, e.g.
``launch.mesh.make_host_mesh``) runs the reference's sharded step:
activation sharding on, the parameters and the AdamW moments placed as
DTensors by ``distrib.sharding.param_shardings`` (FSDP over 'data', TP and
EP over 'model'), the batch replicated, the step eager with DTensor
propagation, and resume through ``restore(shardings=)``. Every rank runs
``train`` with the same arguments. The reference's XLA latency-hiding
scheduler flags (TPU compute and communication overlap, set in the
environment before JAX starts) have no counterpart: the eager step has
no compiler to pass them to.

On the card a resumed run matches a straight one bit for bit only under
``torch.use_deterministic_algorithms(True)`` (with
``CUBLAS_WORKSPACE_CONFIG`` set before the first cuBLAS call): the
embedding's backward otherwise sums with atomics.

Every id of ``configs.ARCH_IDS`` trains: the pipeline's batches carry a
VLM's image embeddings and musicgen's codebook tokens to ``Model.loss``,
whose aux term weighs the MoE blocks' Switch loss.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 20 --batch 8 --seq 512 --use-flash --gw-align --ckpt-dir D
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --device cpu --steps 50 --batch 8 --seq 64
"""
from __future__ import annotations

import argparse
import math
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import base as cb
from repro_torch.data import TokenPipeline
from repro_torch.distrib import sharding as shd
from repro_torch.kernels import dispatch
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model_zoo import Model, set_activation_sharding
from repro_torch.optim import adamw

INIT_SEED = 0      # parameters drawn from torch.Generator(device).manual_seed


class StragglerWatchdog:
    """Flags steps slower than factor x EMA (at pod scale: host attribution
    + preemption hooks; here: detection + logging, tested)."""

    def __init__(self, factor: float = 2.0, alpha: float = 0.2):
        self.factor = factor
        self.alpha = alpha
        self.ema = None
        self.events = []

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        if slow:
            self.events.append((step, dt, self.ema))
        self.ema = dt if self.ema is None else \
            (1 - self.alpha) * self.ema + self.alpha * dt
        return slow


def _scalar(v) -> float:
    """A metric as a float (a DTensor's full value)."""
    if shd.is_dtensor(v):
        v = v.full_tensor()
    return float(v)


def _state_target(params, opt_state):
    """A tree of the train state's shapes, dtypes and devices to restore
    into (uninitialized tensors)."""
    return {"params": adamw.tree_map(torch.empty_like, params),
            "opt": adamw.AdamWState(*(adamw.tree_map(torch.empty_like, x)
                                      for x in opt_state))}


def train(cfg, steps: int, global_batch: int, seq_len: int,
          ckpt_dir: str | None = None, ckpt_every: int = 20,
          mesh=None, act_dtype=torch.float32, use_flash: bool = False,
          gw_align: bool = False, log_every: int = 10, keep: int = 3,
          schedule_total: int | None = None, base_lr: float = 3e-4,
          device=None):
    """Train ``cfg`` for ``steps`` steps (from the latest checkpoint in
    ``ckpt_dir`` if there is one) on the synthetic token pipeline; returns
    (params, opt_state, history) with one dict a step run: the step's
    float metrics and its host wall time ``step_s`` (the step and the
    read of its metrics, which waits for the device). Runs on the card unless ``device`` says otherwise. Parameters
    are drawn from ``torch.Generator(device).manual_seed(INIT_SEED)`` in
    float32 (the reference draws them from ``PRNGKey(0)``)."""
    dev = dispatch.resolve_device(device)
    model = Model(cfg)
    pipe = TokenPipeline(cfg, seq_len, global_batch)
    total = schedule_total or steps
    step_fn = make_train_step(model, base_lr=base_lr, act_dtype=act_dtype,
                              remat=True, use_flash=use_flash,
                              gw_align=gw_align,
                              warmup=max(1, min(100, total // 10)),
                              total_steps=total)
    mgr = CheckpointManager(ckpt_dir, keep=keep) if ckpt_dir else None

    state_sh = None
    if mesh is not None:
        if not dist.is_initialized():
            raise ValueError("train(mesh=) needs the default process group "
                             "that the mesh is built over")
        if mesh.size() != dist.get_world_size():
            raise ValueError(f"the mesh has {mesh.size()} ranks, the "
                             f"default process group "
                             f"{dist.get_world_size()}")
        if mesh.device_type != dev.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the "
                             f"step on {dev}")
        dp = shd.data_axes(mesh)
        sizes = shd.axis_sizes(mesh)
        set_activation_sharding(
            True, dp=dp, dp_size=math.prod(sizes[a] for a in dp),
            model_size=sizes["model"])
        param_sh = shd.param_shardings(model.param_axes(),
                                       model.abstract_params(), mesh)
        state_sh = {"params": param_sh,
                    "opt": adamw.AdamWState(shd.replicated(mesh), param_sh,
                                            param_sh)}

    # ---- init or resume ----------------------------------------------------
    params = model.init(torch.Generator(device=dev).manual_seed(INIT_SEED),
                        device=dev)
    opt_state = adamw.init(params)
    if state_sh is not None:
        params = shd.shard(params, state_sh["params"])
        opt_state = shd.shard(adamw.init(params), state_sh["opt"])
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        start = mgr.latest_step()
        target = _state_target(params, opt_state)
        del params, opt_state
        restored, extra = mgr.restore(start, target, state_sh)
        params, opt_state = restored["params"], restored["opt"]
        pipe.load_state_dict(extra["pipeline"])
        print(f"[resume] from step {start}")

    watchdog = StragglerWatchdog()
    history = []
    for step in range(start, steps):
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in pipe.global_batch_at(step).items()}
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        metrics = {k: _scalar(v) for k, v in metrics.items()}
        dt = time.time() - t0
        if watchdog.observe(step, dt):
            print(f"[straggler] step {step}: {dt:.2f}s vs ema "
                  f"{watchdog.ema:.2f}s")
        history.append({**metrics, "step_s": dt})
        if log_every and step % log_every == 0:
            print(f"step {step:5d} loss {metrics['loss']:.4f} "
                  f"ce {metrics['ce']:.4f} gnorm {metrics['gnorm']:.2f} "
                  f"{dt*1e3:.0f}ms")
        pipe.step = step + 1
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state},
                     extra={"pipeline": pipe.state_dict()}, blocking=False)
    if mgr is not None:
        mgr.wait()
        mgr.save(steps, {"params": params, "opt": opt_state},
                 extra={"pipeline": pipe.state_dict()})
    if mesh is not None:
        set_activation_sharding(False)
    return params, opt_state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--gw-align", action="store_true",
                    help="enable the SPAR-GW representation alignment loss")
    ap.add_argument("--use-flash", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    cfg = cb.get_reduced(args.arch) if args.reduced else cb.get_arch(args.arch)
    return train(cfg, args.steps, args.batch, args.seq,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 gw_align=args.gw_align, use_flash=args.use_flash,
                 device=args.device)


if __name__ == "__main__":
    main()
