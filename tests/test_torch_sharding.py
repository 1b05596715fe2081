"""The sharding rules of the port against the reference's, with no devices.

``Model.param_axes()`` and ``Model.abstract_params()`` of all ten
architectures at published size (axes and shape modes allocate nothing),
with and without ``split_proj``, leaf for leaf. The reference stacks the
superblocks (``vmapped``: a leading ``None`` axis and a leading
``n_superblocks`` dim); the port keeps one dict a superblock, so each of
its block leaves maps onto the reference's stacked leaf with that prefix.

``spec_for`` (every leaf of every architecture, default rules and the
``embed_repl`` rules), ``batch_sharding``, ``cache_sharding`` and the dry
run's ``_cache_sharding`` against the reference's ``PartitionSpec``\\ s,
entry for entry, on (16, 16), (2, 16, 16), (2, 2), (4, 1) and (1, 1)
meshes: ``jax.sharding.AbstractMesh`` on the reference's side,
``distrib.sharding.AbstractMesh`` on the port's.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as ref_configs
from repro.distrib import sharding as ref_shd
from repro.models import ssm as ref_ssm
from repro.models.model_zoo import Model as RefModel
from repro_torch.configs import base as configs
from repro_torch.distrib import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.models import ssm
from repro_torch.models.model_zoo import Model

ARCHS = tuple(configs.CLI_ALIASES)
MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")), ((4, 1), ("data", "model")),
          ((1, 1), ("data", "model")))


def _ref_dryrun():
    """``repro.launch.dryrun`` sets ``XLA_FLAGS`` at import; jax's backend
    is started first and the variable put back, so that nothing else in
    this process sees 512 host devices."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref_dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref_dryrun


def _leaves(tree, prefix=()):
    """[(path, leaf)] with tuples of axis names as leaves."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], prefix + (k,))]
    if isinstance(tree, list) or (isinstance(tree, tuple) and not all(
            isinstance(e, (str, type(None))) for e in tree)):
        return [kv for i, x in enumerate(tree)
                for kv in _leaves(x, prefix + (i,))]
    return [(prefix, tree)]


def _port_as_reference(tree, stacked_leaf):
    """The port's tree in the reference's layout: ``blocks[i]`` leaves
    stacked by ``stacked_leaf`` (checking every superblock agrees)."""
    out = {}
    for path, leaf in _leaves(tree):
        if path[0] == "blocks":
            key = ("blocks",) + path[2:]
            if key in out:
                assert _same(out[key][1], leaf), (path, leaf)
                out[key] = (out[key][0] + 1, leaf)
            else:
                out[key] = (1, leaf)
        else:
            out[path] = (None, leaf)
    return {k: (leaf if n is None else stacked_leaf(n, leaf))
            for k, (n, leaf) in out.items()}


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return _meta_key(a) == _meta_key(b)
    return a == b


def _meta_key(t):
    return (tuple(t.shape), str(t.dtype).replace("torch.", ""))


@pytest.fixture(params=[False, True], ids=["fused", "split_proj"])
def split_proj(request):
    ref_ssm.set_mamba_options(split_proj=request.param)
    ssm.set_mamba_options(split_proj=request.param)
    try:
        yield request.param
    finally:
        ref_ssm.set_mamba_options(split_proj=False)
        ssm.set_mamba_options(split_proj=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_and_abstract_params_match_reference(arch, split_proj):
    cfg, rcfg = configs.get_arch(arch), ref_configs.get_arch(arch)
    ref_axes = dict(_leaves(RefModel(rcfg).param_axes()))
    axes = _port_as_reference(Model(cfg).param_axes(),
                              lambda n, a: (None,) + tuple(a))
    assert axes == ref_axes
    if split_proj and "mamba2" in cfg.block_pattern:
        assert any(p[-1] == "in_zx" for p in axes)
    ref_abs = {p: (tuple(s.shape), str(s.dtype)) for p, s in _leaves(
        jax.tree.map(lambda s: s, RefModel(rcfg).abstract_params()))}
    abstract = _port_as_reference(
        {k: v for k, v in Model(cfg).abstract_params().items()},
        lambda n, t: t)
    got = {}
    for p, t in abstract.items():
        shape, dtype = _meta_key(t)
        assert t.device.type == "meta"
        if p[0] == "blocks":
            shape = (cfg.resolved_superblocks,) + shape
        got[p] = (shape, dtype)
    assert got == ref_abs


def _shape_leaves(arch):
    """(axes, shape) of every parameter of ``arch`` in the port's layout."""
    model = Model(configs.get_arch(arch))
    axes = dict(_leaves(model.param_axes()))
    shapes = dict(_leaves(model.abstract_params()))
    return [(axes[p], tuple(shapes[p].shape)) for p in axes]


def _strip(entries):
    entries = list(entries)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


@pytest.mark.parametrize("mesh_shape,names", MESHES,
                         ids=[str(m[0]) for m in MESHES])
def test_spec_for_every_leaf_matches_reference(mesh_shape, names):
    ref_mesh = jax.sharding.AbstractMesh(mesh_shape, names)
    mesh = shd.AbstractMesh(mesh_shape, names)
    repl = dict(shd.DEFAULT_RULES, vocab=(None,))
    ref_repl = dict(ref_shd.DEFAULT_RULES, vocab=(None,))
    n = 0
    for arch in ARCHS:
        for axes, shape in _shape_leaves(arch):
            for rules, ref_rules in ((None, None), (repl, ref_repl)):
                got = shd.spec_for(axes, shape, mesh, rules)
                want = ref_shd.spec_for(axes, shape, ref_mesh, ref_rules)
                assert tuple(got) == tuple(want), (arch, axes, shape)
                # and the stacked leaf of the reference's layout
                want_st = ref_shd.spec_for((None,) + axes, (3,) + shape,
                                           ref_mesh, ref_rules)
                assert _strip((None,) + tuple(got)) == tuple(want_st)
                n += 1
    assert n > 1000


@pytest.mark.parametrize("mesh_shape,names", MESHES,
                         ids=[str(m[0]) for m in MESHES])
def test_batch_and_cache_shardings_match_reference(mesh_shape, names):
    ref_dryrun = _ref_dryrun()
    ref_mesh = jax.sharding.AbstractMesh(mesh_shape, names)
    mesh = shd.AbstractMesh(mesh_shape, names)
    assert shd.data_axes(mesh) == ref_shd.data_axes(ref_mesh)
    assert tuple(shd.replicated(mesh).spec) == tuple(
        ref_shd.replicated(ref_mesh).spec)
    for ndim in (1, 2, 3):
        for batch in (1, 4, 32, 128, 256, 6):
            for seq_axis, seq_len in ((None, 0), ("model", 4096),
                                      ("model", 7)):
                got = shd.batch_sharding(mesh, ndim, batch, seq_axis,
                                         seq_len)
                want = ref_shd.batch_sharding(ref_mesh, ndim, batch,
                                              seq_axis, seq_len)
                assert tuple(got.spec) == tuple(want.spec)
    for arch in ("llama3-8b", "zamba2-7b", "minicpm3-4b", "xlstm-125m",
                 "musicgen-medium", "llama-3.2-vision-90b"):
        rcfg = ref_configs.get_arch(arch)
        for shape in ref_configs.shapes_for(rcfg):
            B, S = shape.global_batch, shape.seq_len
            leaves = jax.tree.leaves(RefModel(rcfg).cache_spec(B, S))
            for s in leaves:
                shp = tuple(s.shape)
                got = shd.cache_sharding(mesh, shp, B)
                want = ref_shd.cache_sharding(ref_mesh, shp, B)
                assert tuple(got.spec) == tuple(want.spec), (arch, shp)
                got = dryrun._cache_sharding(mesh, shp, B, S)
                want = ref_dryrun._cache_sharding(ref_mesh, shp, B, S)
                assert tuple(got.spec) == tuple(want.spec), (arch, shp)


def test_spec_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = shd.AbstractMesh((2, 4, 4), ("pod", "data", "model"))
    assert shd.Spec(("pod", "data"), None, "model").placements(mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.Spec().placements(mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        shd.Spec(("data", "pod")).placements(mesh)


def test_builder_modes_allocate_nothing_and_agree():
    cfg = configs.get_reduced("zamba2_7b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    abstract = model.abstract_params()
    axes = model.param_axes()
    lp, la, lx = _leaves(params), _leaves(abstract), _leaves(axes)
    assert [p for p, _ in lp] == [p for p, _ in la] == [p for p, _ in lx]
    for (_, t), (_, m), (_, a) in zip(lp, la, lx):
        assert m.device.type == "meta" and m.shape == t.shape
        assert m.dtype == t.dtype and len(a) == t.ndim
    assert np.isfinite(sum(float(t.sum()) for _, t in lp))
