"""Training on a mesh: the port's sharded step, ``train(mesh=)``, the
elastic restore and the resume, on the CPU over gloo.

Four spawned processes (a ``FileStore`` under ``tmp_path``) form a 2 x 2
("data", "model") mesh and run, as ``tests/test_distrib.py`` and
``tests/test_elastic.py`` ask of the reference:

* one sharded train step of reduced llama3-8b (batch (4, 16), the
  reference's ``init(PRNGKey(0))`` weights carried across, warm-up 1 so
  that the step takes the full learning rate), held to the reference's
  *unsharded* step at rtol 1e-4 for ``loss``, ``ce``, ``gnorm`` and
  ``lr`` (the reference's own sharded step fails on this jax, ROADMAP
  §3); every leaf's gradient on the mesh to the port's unsharded one at
  1e-5 of the leaf's largest entry, and every leaf after the step to
  AdamW's step from those gradients, with planted faults (a dropped
  update, a doubled gradient) shown to fail;
* attention with q split over 'model' by heads where the kv heads split
  less far or not at all: each rank runs its own q heads, forward and
  gradients equal to the unsharded plain route at 1e-5;
* ``train(mesh=)`` on reduced smollm-135m with ``use_flash``, 8 steps,
  against ``train(mesh=None)`` at rtol 1e-5 and leaf by leaf, and a run
  of 4 steps, a checkpoint and a resume to 8 against the straight run at
  rtol 1e-5 (``test_resume_is_bit_exact``'s bound);
* a checkpoint saved from the 2 x 2 mesh restored onto a (4, 1) mesh of
  the same ranks, and in this process onto a (1, 1) mesh at world size
  1: bitwise.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import base as ref_configs
from repro.launch import steps as ref_steps
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import base as configs
from repro_torch.distrib import sharding as shd
from repro_torch.launch import steps, train
from repro_torch.models import Model
from repro_torch.models.interop import model_params_from_jax
from repro_torch.optim import adamw
from test_torch_solve import _one_torch_thread  # noqa: F401 — autouse

ROOT = Path(__file__).resolve().parents[1]
METRIC_RTOL = 1e-4
GRAD_REL = 1e-5
UPDATE_ULPS = 8
TRAINED_REL = 1e-2
ATTN_REL = 1e-5
LOSS_RTOL = 1e-5
STEPS, BATCH, SEQ = 8, 4, 32
# warm-up of the single step: 1, so that its learning rate is the full
# 3e-4 and each update lies far above float32's rounding of the weights
WARMUP = 1
# (q heads, kv heads) x route of the local-heads attention cases
GQA = [((H, K), route) for H, K in ((4, 1), (6, 3), (4, 2), (3, 1))
       for route in ("kernel", "plain")]

WORKER = textwrap.dedent("""
    import pickle, sys, warnings
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, sys.argv[4])
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import base as cb
    from repro_torch.distrib import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import Model
    from repro_torch.models.interop import model_params_from_jax
    from repro_torch.models.model_zoo import set_activation_sharding
    from repro_torch.optim import adamw
    warnings.simplefilter("ignore")
    torch.set_num_threads(1)
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    res = {}
    with open(out + "/inputs.pkl", "rb") as f:
        d = pickle.load(f)
    mesh = make_host_mesh((2, 2), device="cpu")

    # one sharded step of reduced llama3-8b on the reference's weights
    cfg = cb.get_reduced("llama3_8b")
    model = Model(cfg)
    params = model_params_from_jax(cfg, d["params"], device="cpu")
    psh = shd.param_shardings(model.param_axes(), model.abstract_params(),
                              mesh)
    set_activation_sharding(True, dp=("data",), dp_size=2, model_size=2)
    sp = shd.shard(params, psh)
    step = steps.make_train_step(model, act_dtype=torch.float32,
                                 remat=False, warmup={warmup}, total_steps=5)
    batch = {"tokens": torch.tensor(d["toks"][:, :-1]),
             "labels": torch.tensor(d["toks"][:, 1:])}
    p2, _, m = step(sp, adamw.init(sp), batch)
    live = adamw.tree_map(lambda t: t.detach().requires_grad_(True), sp)
    with steps.mesh_context(sp):
        loss, _ = model.loss(live, batch, act_dtype=torch.float32,
                             remat=False, device="cpu")
        grads = torch.autograd.grad(loss, adamw.tree_leaves(live))
    set_activation_sharding(False)
    res["metrics"] = {k: float(getattr(v, "full_tensor", lambda: v)())
                      for k, v in m.items()}
    res["params"] = adamw.tree_map(lambda t: t.full_tensor().numpy(), p2)
    res["grads"] = [g.full_tensor().numpy() for g in grads]

    # attention on the local q heads where the kv heads split less far
    # (4 / 1: one kv head for a rank's 2 q heads; 6 / 3: one a q head;
    # 4 / 2: both split; 3 / 1: no head split), the kernel's wrapper and
    # the plain route, forward and the gradients of q, k and v
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels.dispatch import gqa_on_local_shards
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.attention import _blockwise_plain
    res["gqa"] = {}
    for (H, K), route in d["gqa"]:
        q, k, v, w = (torch.tensor(x) for x in d["gqa_in"][H, K])
        q = distribute_tensor(q, mesh, [Shard(0), Shard(2)])
        k, v = (distribute_tensor(x, mesh, [Shard(0), Replicate()])
                for x in (k, v))
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        if route == "kernel":
            o = flash_attention(q, k, v, device="cpu")
        else:
            o = gqa_on_local_shards(_blockwise_plain, q, k, v)
        loss = (o * distribute_tensor(w, mesh, o.placements)).sum()
        gr = torch.autograd.grad(loss, (q, k, v))
        res["gqa"][H, K, route] = {
            "local_heads": o.to_local().shape[2],
            "out": o.full_tensor().detach().numpy(),
            "grads": [g.full_tensor().numpy() for g in gr]}

    # elastic: save from the 2 x 2 mesh, restore onto (4, 1)
    mgr = CheckpointManager(out + "/elastic", keep=2)
    mgr.save(1, sp)
    mesh_b = make_host_mesh((4, 1), device="cpu")
    psh_b = shd.param_shardings(model.param_axes(), model.abstract_params(),
                                mesh_b)
    restored, _ = mgr.restore(1, params, psh_b)
    res["elastic_b"] = all(
        torch.equal(r.full_tensor(), x) and r.device_mesh is mesh_b
        for r, x in zip(adamw.tree_leaves(restored),
                        adamw.tree_leaves(params)))

    # train(mesh=): straight, then 4 + checkpoint + resume
    scfg = cb.get_reduced("smollm_135m")
    kw = dict(mesh=mesh, device="cpu", log_every=0, use_flash=True)
    pt, _, hist = train(scfg, {steps}, {batch}, {seq}, **kw)
    res["losses"] = [h["loss"] for h in hist]
    res["trained"] = [t.full_tensor().numpy()
                      for t in adamw.tree_leaves(pt)]
    train(scfg, 4, {batch}, {seq}, ckpt_dir=out + "/ck", ckpt_every=4,
          schedule_total={steps}, **kw)
    _, _, hist_b = train(scfg, {steps}, {batch}, {seq},
                         ckpt_dir=out + "/ck", ckpt_every=4, **kw)
    res["resumed"] = [h["loss"] for h in hist_b]
    if rank == 0:
        with open(out + "/out.pkl", "wb") as f:
            pickle.dump(res, f)
    dist.destroy_process_group()
""").replace("{steps}", str(STEPS)).replace("{batch}", str(BATCH)).replace(
    "{seq}", str(SEQ)).replace("{warmup}", str(WARMUP))


def _reference_step():
    """The reference's reduced llama3-8b weights, the (4, 17) tokens of
    test_distrib.py and its unsharded step's metrics."""
    rcfg = ref_configs.get_reduced("llama3_8b")
    model = ref_build_model(rcfg)
    params = model.init(jax.random.PRNGKey(0))
    step = ref_steps.make_train_step(model, act_dtype=jax.numpy.float32,
                                     remat=False, warmup=WARMUP,
                                     total_steps=5)
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, 17), 0,
                              rcfg.vocab_size)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    _, _, m = jax.jit(step)(params, ref_adamw.init(params), batch)
    return (jax.tree.map(np.asarray, params), np.asarray(toks),
            {k: float(v) for k, v in m.items()})


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_train")
    params, toks, ref_metrics = _reference_step()
    rng = np.random.default_rng(5)
    gqa_in = {(H, K): [rng.standard_normal((2, 8, n, 4)).astype(np.float32)
                       for n in (H, K, K, H)] for (H, K), _ in GQA}
    with open(path / "inputs.pkl", "wb") as f:
        pickle.dump({"params": params, "toks": toks, "gqa": GQA,
                     "gqa_in": gqa_in}, f)
    env = {**os.environ, "PYTHONWARNINGS": "ignore"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(rank), str(path / "store"),
         str(path), str(ROOT / "src")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(4)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    with open(path / "out.pkl", "rb") as f:
        out = pickle.load(f)
    return path, params, toks, ref_metrics, out, gqa_in


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("one") / "s"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _worst(got, want, scale):
    """Per leaf: max |got - want| over the largest entry of its scale."""
    return [float(np.abs(g - w).max() / np.abs(c).max())
            for g, w, c in zip(got, want, scale)]


def _unsharded_step(params, toks):
    """The port's unsharded step on the reference's weights: the leaves
    before it, their gradients, and AdamW's first step as a function of
    the gradients (on plain tensors)."""
    cfg = configs.get_reduced("llama3_8b")
    model = Model(cfg)
    p = model_params_from_jax(cfg, params, device="cpu")
    batch = {"tokens": torch.tensor(toks[:, :-1]),
             "labels": torch.tensor(toks[:, 1:])}
    live = adamw.tree_map(lambda t: t.detach().requires_grad_(True), p)
    loss, _ = model.loss(live, batch, act_dtype=torch.float32, remat=False,
                         device="cpu")
    grads = torch.autograd.grad(loss, adamw.tree_leaves(live))

    def first_step(leaf_grads, lr):
        it = iter(torch.tensor(g) for g in leaf_grads)
        tree = adamw.tree_map(lambda t: next(it), p)
        new = adamw.update(tree, adamw.init(p), p,
                           torch.tensor(lr, dtype=torch.float32))[0]
        return [t.numpy() for t in adamw.tree_leaves(new)]

    return ([t.numpy() for t in adamw.tree_leaves(p)],
            [g.numpy() for g in grads], first_step)


def test_sharded_step_matches_unsharded(mesh_run):
    """The metrics against the reference's unsharded step; each leaf's
    gradient on the mesh against the port's unsharded gradient, relative
    to the leaf's largest entry; and each leaf after the sharded step
    against AdamW's step applied on plain tensors to the mesh's own
    gradients, within UPDATE_ULPS float32 spacings of the leaf's largest
    weight (readings: gradients 1.2e-6, updates 2.6 spacings, on entries
    whose gradient is near AdamW's eps, 2 x 2 mesh, gloo). (Adam's first step is about ±lr an entry, far above that
    spacing, but it is no function to compare across two gradients that
    differ by rounding: an entry whose gradient is near 0 may take either
    sign.) A leaf whose update the mesh dropped, or whose gradient it
    reduced twice, must fail these checks."""
    _, params, toks, ref_metrics, out, _ = mesh_run
    for k in ("loss", "ce", "gnorm", "lr"):
        np.testing.assert_allclose(out["metrics"][k], ref_metrics[k],
                                   rtol=METRIC_RTOL, err_msg=k)
    before, grads, first_step = _unsharded_step(params, toks)
    got = adamw.tree_leaves(out["params"])
    assert len(got) == len(before) == len(out["grads"]) == len(grads)
    grad_err = _worst(out["grads"], grads, grads)
    assert max(grad_err) <= GRAD_REL, grad_err
    want = first_step(out["grads"], out["metrics"]["lr"])
    spacing = [np.spacing(np.abs(b).max()) for b in before]

    def ulps(after):
        return [float(np.abs(a - w).max() / sp)
                for a, w, sp in zip(after, want, spacing)]

    assert max(ulps(got)) <= UPDATE_ULPS, ulps(got)
    # the update is far above the bound: lr 3e-4 an entry
    assert min(float(np.abs(w - b).max() / sp) for w, b, sp in
               zip(want, before, spacing)) > 100 * UPDATE_ULPS
    # planted faults: one leaf's update dropped, one gradient doubled
    dropped = [b if i == 3 else a for i, (a, b) in enumerate(zip(got,
                                                                  before))]
    assert max(ulps(dropped)) > UPDATE_ULPS
    doubled = [2 * g if i == 3 else g for i, g in enumerate(out["grads"])]
    assert max(_worst(doubled, grads, grads)) > GRAD_REL


def test_attention_runs_on_the_local_q_heads(mesh_run):
    """On the 2 x 2 mesh, q split over 'model' by heads and k, v
    replicated there: the output keeps the head split (each rank ran H / 2
    q heads, or all 3 where 2 does not divide them), and it and the
    gradients of q, k and v equal the unsharded plain route's."""
    from repro_torch.models.attention import _blockwise_plain

    out, gqa_in = mesh_run[4], mesh_run[5]
    for (H, K), route in GQA:
        got = out["gqa"][H, K, route]
        assert got["local_heads"] == (H // 2 if H % 2 == 0 else H)
        q, k, v, w = (torch.tensor(x).requires_grad_(True)
                      for x in gqa_in[H, K])
        want = _blockwise_plain(q, k, v)
        grads = torch.autograd.grad((want * w).sum(), (q, k, v))
        for name, g, x in zip(("out", "dq", "dk", "dv"),
                              [got["out"], *got["grads"]],
                              [want.detach(), *grads]):
            x = x.numpy()
            assert np.abs(g - x).max() <= ATTN_REL * np.abs(x).max(), \
                (H, K, route, name)


def test_train_on_a_mesh_matches_one_device_and_resumes(mesh_run):
    """The losses of train(mesh=) and of its resume against train on one
    device (the losses move by ~5e-3 a step, 500x LOSS_RTOL), and every
    trained leaf against the one-device run's, relative to the leaf's
    largest change over the 8 steps, at TRAINED_REL. That bound is set
    from readings (at most 2.0e-3 on this run, 2 x 2 mesh, gloo): AdamW
    normalizes each entry's step, so an entry whose gradient is near 0
    takes a step of either sign on either side of a rounding difference,
    and that compounds over the steps. A leaf left untrained reads 1."""
    out = mesh_run[4]
    cfg = configs.get_reduced("smollm_135m")
    p, _, hist = train.train(cfg, STEPS, BATCH, SEQ, device="cpu",
                             log_every=0, use_flash=True)
    np.testing.assert_allclose(out["losses"], [h["loss"] for h in hist],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["resumed"], out["losses"][4:],
                               rtol=LOSS_RTOL)
    init = Model(cfg).init(torch.Generator().manual_seed(train.INIT_SEED),
                           device="cpu")
    moved = [a.numpy() - b.numpy() for a, b in zip(
        adamw.tree_leaves(p), adamw.tree_leaves(init))]
    trained = [t.numpy() for t in adamw.tree_leaves(p)]
    err = _worst(out["trained"], trained, moved)
    assert max(err) <= TRAINED_REL, err
    # planted fault: one leaf left at its initial weights
    stuck = [b.numpy() if i == 3 else a for i, (a, b) in enumerate(zip(
        out["trained"], adamw.tree_leaves(init)))]
    assert max(_worst(stuck, trained, moved)) > TRAINED_REL


def test_elastic_restore_onto_other_meshes(mesh_run, world_of_one):
    from torch.distributed.device_mesh import init_device_mesh

    path, params, _, _, out, _ = mesh_run
    assert out["elastic_b"]
    cfg = configs.get_reduced("llama3_8b")
    model = Model(cfg)
    p = model_params_from_jax(cfg, params, device="cpu")
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    sh = shd.param_shardings(model.param_axes(), model.abstract_params(),
                             mesh)
    restored, _ = CheckpointManager(str(path / "elastic")).restore(1, p, sh)
    for r, x in zip(adamw.tree_leaves(restored), adamw.tree_leaves(p)):
        assert type(r).__name__ == "DTensor"
        assert torch.equal(r.full_tensor(), x)


def test_train_refuses_a_mesh_of_another_size(world_of_one):
    stub = types.SimpleNamespace(size=lambda: 4, device_type="cpu")
    with pytest.raises(ValueError, match="mesh has 4 ranks"):
        train.train(configs.get_reduced("smollm_135m"), 1, 4, 16,
                    mesh=stub, device="cpu")
