"""The dry run of the port (``launch/specs``, ``launch/dryrun``,
``launch/hillclimb``) against the reference's, on the CPU.

``input_specs`` of every arch × shape of ``shapes_for`` equals the
reference's ``ShapeDtypeStruct``\\ s, shape and dtype. The fake process
group is process-wide, so the cells run in a spawned process with the
``fake`` group at 16 x 16 (256 ranks): ``run_cell`` on reduced
smollm-135m ``train_4k`` writes a record with the reference's keys
(``repro/launch/dryrun.py``: ``run_cell`` and ``_add_cost_fields``); its
``n_params`` is the reference's count, its ``argument_bytes`` the sum of
rank 0's local shards (worked out here from the sharding rules), its
``flops_per_device`` lies between the same step's unsharded
``FlopCounterMode`` count / 256 and that count, and the data-parallel
gradient reduction shows as collectives. ``run_gw_cell`` runs at
s = 512. ``hillclimb.apply_variant`` sets and resets each lever.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import base as ref_configs
from repro.launch import specs as ref_specs
from repro.models.model_zoo import Model as RefModel
from repro_torch.configs import base as configs
from repro_torch.distrib import sharding as shd
from repro_torch.launch import hillclimb, specs
from repro_torch.models import attention, moe, sharding_ctx, ssm
from repro_torch.models.model_zoo import Model

ROOT = Path(__file__).resolve().parents[1]
# the keys of the reference's records (repro/launch/dryrun.py run_cell
# with _add_cost_fields, and run_gw_cell)
CELL_KEYS = {"arch", "shape", "mesh", "mesh_shape", "kind", "tag",
             "n_params", "lower_s", "compile_s", "memory", "flops_raw",
             "bytes_raw", "collectives", "hlo_lines", "flops_per_device",
             "bytes_unblocked_per_device", "cost_points", "bytes_per_device",
             "cost_points_flash"}
GW_KEYS = {"arch", "shape", "mesh", "mesh_shape", "kind", "tag", "n_params",
           "lower_s", "compile_s", "memory", "flops_raw", "bytes_raw",
           "flops_per_device", "bytes_per_device", "collectives",
           "hlo_lines"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "code_bytes"}
# a rank's FLOPs x 256 over the unsharded step's, at most (reduced llama3
# with 16 q heads, 2 kv heads, d_ff 256, vocabulary 512 on (16, 16))
TP_FLOPS_EXCESS = 1.1
KINDS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute"}


def _reduced_overrides(name):
    red = configs.get_reduced(name)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if f.name != "name"}


WORKER = textwrap.dedent("""
    import json, sys, warnings
    from pathlib import Path
    import torch
    sys.path.insert(0, sys.argv[1])
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import base as cb
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    warnings.simplefilter("ignore")
    torch.set_num_threads(1)
    out, overrides = Path(sys.argv[2]), json.loads(sys.argv[3])
    if sys.argv[4] == "full":         # the first run at full depth
        trace = dryrun._trace
        dryrun._trace = lambda *a, **k: trace(*a, warm_depth=None, **k)
        rec = dryrun.run_cell("smollm-135m", "train_4k", "single", out,
                              device="cpu", cfg_overrides=overrides,
                              tag="full")
        json.dump(rec, open(out / "result_full.json", "w"))
        sys.exit(0)
    rec = dryrun.run_cell("smollm-135m", "train_4k", "single", out,
                          device="cpu", cfg_overrides=overrides)
    gw = dryrun.run_gw_cell("single", out, s_r=512, s_c=512, outer=2,
                            inner=3, device="cpu")
    # the same step unsharded, counted by FlopCounterMode
    cfg = cb.get_reduced("smollm-135m")
    model = Model(cfg)
    step = steps.make_train_step(model, use_flash=True, use_kernel=False)
    with FakeTensorMode():
        params = adamw.tree_map(lambda t: torch.empty(t.shape),
                                model.abstract_params())
        toks = torch.zeros((256, 4096), dtype=torch.int32)
        with FlopCounterMode(display=False) as fc:
            step(params, adamw.init(params),
                 {"tokens": toks, "labels": toks})
    # a llama3 cell whose q heads, d_ff and vocabulary divide 'model' and
    # whose 2 kv heads do not, against the same step unsharded
    import dataclasses
    tp = dict(overrides, n_heads=16, n_kv_heads=2, head_dim=4, d_model=64,
              d_ff=256, vocab_size=512)
    tp_rec = dryrun.run_cell("llama3-8b", "train_4k", "single", out,
                             device="cpu", cfg_overrides=tp)
    tp_model = Model(dataclasses.replace(cb.get_arch("llama3-8b"), **tp))
    tp_step = steps.make_train_step(tp_model, use_flash=True,
                                    use_kernel=False)
    with FakeTensorMode():
        params = adamw.tree_map(lambda t: torch.empty(t.shape),
                                tp_model.abstract_params())
        toks = torch.zeros((256, 4096), dtype=torch.int32)
        with FlopCounterMode(display=False) as tp_fc:
            tp_step(params, adamw.init(params),
                    {"tokens": toks, "labels": toks})
    json.dump({"cell": rec, "gw": gw, "unsharded_flops":
               fc.get_total_flops(), "tp_cell": tp_rec,
               "tp_unsharded_flops": tp_fc.get_total_flops()},
              open(out / "result.json", "w"))
""")


@pytest.fixture(scope="module")
def fake_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(ROOT / "src"), str(out),
         json.dumps(_reduced_overrides("smollm-135m")), warm],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONWARNINGS": "ignore"})
        for warm in ("default", "full")]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    with open(out / "result.json") as f:
        res = json.load(f)
    with open(out / "result_full.json") as f:
        res["cell_full_warm"] = json.load(f)
    return out, res


def test_input_specs_match_reference():
    n = 0
    for arch in configs.CLI_ALIASES:
        cfg, rcfg = configs.get_arch(arch), ref_configs.get_arch(arch)
        for shape in ref_configs.shapes_for(rcfg):
            want = ref_specs.input_specs(rcfg, shape)
            got = specs.input_specs(cfg, configs.SHAPES[shape.name])
            assert list(got) == list(want)
            wl = jax.tree.leaves(want)
            gl = [t for t in jax.tree.leaves(
                got, is_leaf=lambda x: isinstance(x, torch.Tensor))]
            assert len(gl) == len(wl)
            for g, w in zip(gl, wl):
                assert g.device.type == "meta"
                assert tuple(g.shape) == tuple(w.shape), (arch, shape)
                assert str(g.dtype).replace("torch.", "") == str(w.dtype)
                n += 1
    assert n > 100


def _local_numel(shape, spec, sizes):
    n = 1
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        n *= dim // math.prod(sizes[a] for a in axes)
    return n


def test_run_cell_record(fake_cells):
    out, res = fake_cells
    rec = res["cell"]
    assert set(rec) == CELL_KEYS
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["collectives"]) == KINDS
    with open(out / "smollm-135m__train_4k__single.json") as f:
        assert json.load(f) == rec
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    for key in ("compile_s", "hlo_lines", "cost_points",
                "cost_points_flash"):
        assert rec[key] is None
    assert rec["memory"]["alias_bytes"] is None
    assert rec["memory"]["code_bytes"] is None
    rcfg = ref_configs.get_reduced("smollm-135m")
    assert rec["n_params"] == sum(
        math.prod(s.shape)
        for s in jax.tree.leaves(RefModel(rcfg).abstract_params()))
    # rank 0's shards: params, AdamW m and v, the step, tokens and labels
    mesh = shd.AbstractMesh((16, 16), ("data", "model"))
    sizes = shd.axis_sizes(mesh)
    model = Model(configs.get_reduced("smollm-135m"))
    sh = shd.param_shardings(model.param_axes(), model.abstract_params(),
                             mesh)
    leaves = zip(jax.tree.leaves(model.abstract_params()),
                 jax.tree.leaves(sh, is_leaf=lambda x: isinstance(
                     x, shd.NamedSharding)))
    param_bytes = sum(4 * _local_numel(t.shape, s.spec, sizes)
                      for t, s in leaves)
    batch_bytes = 2 * 4 * _local_numel(
        (256, 4096), shd.batch_sharding(mesh, 2, 256).spec, sizes)
    assert rec["memory"]["argument_bytes"] == 3 * param_bytes + 4 + \
        batch_bytes
    full = res["unsharded_flops"]
    assert full / 256 <= rec["flops_per_device"] <= full
    assert rec["flops_per_device"] == rec["flops_raw"]
    assert rec["memory"]["temp_bytes"] > 0 and rec["bytes_per_device"] > 0
    grads = rec["collectives"]
    assert grads["reduce-scatter"]["count"] + grads["all-reduce"]["count"] \
        > 0
    assert all(v["wire_bytes"] >= 0 for v in grads.values())


def test_no_rank_repeats_the_model_parallel_work(fake_cells):
    """Where the q heads, d_ff and the vocabulary divide 'model' (16) and
    the kv heads do not (2), a rank's FLOPs are a 256th of the unsharded
    step's, within TP_FLOPS_EXCESS (reading 1.026: the gathered kv heads'
    share and the replicated norms): attention runs on the rank's own q
    heads, the MLP and the LM head on its slices, the cross entropy on its
    slice of the vocabulary."""
    _, res = fake_cells
    ratio = res["tp_cell"]["flops_per_device"] * 256 / \
        res["tp_unsharded_flops"]
    assert 1.0 <= ratio <= TP_FLOPS_EXCESS, ratio


def test_tally_after_a_one_superblock_warm_up_is_exact(fake_cells):
    """The record after the first run at one superblock of three equals
    the record after a first run at full depth (another process, since
    DTensor's caches are process-wide): no op signature of the step is
    first met below the first superblock."""
    _, res = fake_cells
    one, full = res["cell"], res["cell_full_warm"]
    for key in ("flops_per_device", "bytes_per_device", "collectives",
                "memory"):
        assert one[key] == full[key], key


def test_run_gw_cell(fake_cells):
    _, res = fake_cells
    rec = res["gw"]
    assert set(rec) == GW_KEYS
    assert rec["shape"] == "grid512x512" and rec["kind"] == "gw"
    assert rec["flops_per_device"] > 0
    assert rec["collectives"]["all-reduce"]["count"] > 0
    assert rec["collectives"]["all-gather"]["count"] > 0
    # the inputs' whole (s, s) matrices on every rank, as given
    assert rec["memory"]["argument_bytes"] == 4 * (3 * 512 * 512 + 2 * 512)


def test_hillclimb_sets_and_resets_each_lever():
    mesh = shd.AbstractMesh((16, 16), ("data", "model"))
    try:
        rules = hillclimb.apply_variant(
            "sp+moe_bf16+mamba_split+fc256+embed_repl", mesh)
        assert rules["vocab"] == (None,)
        assert rules["embed"] == shd.DEFAULT_RULES["embed"]
        assert sharding_ctx._ACT_SHARD == {
            "enabled": True, "dp": ("data",), "dp_size": 16,
            "model_size": 16, "sp": True}
        assert moe._MOE_OPTS["bf16_dispatch"]
        assert ssm._MAMBA_OPTS["split_proj"]
        assert attention._FLASH_CHUNK["size"] == 256
        assert hillclimb.apply_variant("moe_bf16", mesh) is None
        assert not ssm._MAMBA_OPTS["split_proj"]
        assert not sharding_ctx._ACT_SHARD["sp"]
        assert attention._FLASH_CHUNK["size"] == 512
    finally:
        hillclimb.reset_levers()
    assert not sharding_ctx.enabled()
    assert not moe._MOE_OPTS["bf16_dispatch"]
    rec = {"arch": "smollm-135m", "shape": "train_4k", "mesh": "single",
           "kind": "train",
           "n_params": 10, "mesh_shape": {"data": 16, "model": 16},
           "flops_per_device": 989e12, "bytes_per_device": 3.35e12,
           "collectives": {"all-reduce": {"wire_bytes": 0.0}},
           "memory": {"temp_bytes": 2**30, "argument_bytes": 0}}
    a = hillclimb.analyze(rec)
    assert a["t_compute_s"] == pytest.approx(1.0)
    assert a["t_memory_s"] == pytest.approx(1.0)
    assert a["temp_GiB"] == 1.0
    n = hillclimb.active_params(configs.get_arch("smollm-135m"))
    assert a["model_flops"] == 6.0 * n * 4096 * 256


@pytest.mark.parametrize("arch, billions", [
    ("llama4-scout-17b-a16e", 17.0), ("phi3.5-moe-42b-a6.6b", 6.6),
    ("llama3-8b", 8.0)])
def test_active_parameters_match_the_published_counts(arch, billions):
    """The roofline's active parameters, from the config's experts per
    token, against the count each name publishes (to 5 %)."""
    n = hillclimb.active_params(configs.get_arch(arch))
    assert abs(n / 1e9 - billions) <= 0.05 * billions


def test_fake_process_group_store_imports():
    """The dry run's fake group comes from a torch-internal module; a
    move of that path must fail here, not skip."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert FakeStore is not None
