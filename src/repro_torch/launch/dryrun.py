"""The dry run: one (arch × shape × mesh) cell's step traced on fake
tensors on a fake mesh, in one process: the port of
``repro.launch.dryrun``.

The reference lowers and compiles each cell for a 256- or 512-device
host mesh and reads XLA's cost and memory analyses. Here one process
initializes ``torch.distributed``'s ``fake`` process group at the mesh's
world size (256 single, 512 multi), builds the mesh over it as rank 0,
and, under ``FakeTensorMode`` (shapes, dtypes and devices, no memory),
places the cell's parameters, AdamW state and batch as DTensors by the
sharding rules. It then runs the cell's step once: the train step with
its backward, the prefill step or the decode step. On fake tensors the
step takes the plain routes of K5 and K6 (``use_kernel=False``: the
blockwise attention and the SSD's plain intra-chunk block), as the
reference's dry run takes ``blockwise_gqa`` and not its Pallas kernel.
A dispatch mode of its own (:class:`Tally`) watches rank 0's local ops
under the DTensors and writes ``artifacts/dryrun/<arch>__<shape>__<mesh>
[__tag].json`` with the reference's keys:

  · ``flops_per_device`` (= ``flops_raw``): ``FlopCounterMode``'s
    formulas summed over rank 0's local ops;
  · ``bytes_per_device`` (= ``bytes_raw``, ``bytes_unblocked_per_device``):
    the bytes each local op reads and writes, summed, as XLA's
    unfused "bytes accessed" counts them;
  · ``collectives``: per kind (all-gather, all-reduce, reduce-scatter,
    all-to-all, collective-permute) the count, the output bytes and the
    wire bytes by the reference's ring model, over the ``c10d_functional``
    ops DTensor issues (and ``c10d`` ones called directly);
  · ``memory.argument_bytes``: the exact sum of rank 0's local shards of
    the step's inputs; ``output_bytes`` that of its outputs;
    ``temp_bytes``: the peak of the fake storage alive during the step
    that the step itself made (its outputs included).

No counterpart, written as ``null``: ``compile_s``, ``hlo_lines``,
``memory.code_bytes`` and ``memory.alias_bytes`` (nothing is compiled),
and ``cost_points`` / ``cost_points_flash``. The reference's
``cost_extrapolate`` and ``_slstm_correction_flops`` exist because XLA's
cost analysis counts a loop body once; the eager trace counts every
layer and every sLSTM step, so they have none. ``lower_s`` is the wall
time of the tallied run of the step on fake tensors (after a first run
that fills DTensor's caches, see ``_trace``).

The fake group is process-wide: the dry run runs in its own process.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k --mesh single [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --gw --mesh single
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import base as cb
from repro_torch.distrib import sharding as shd
from repro_torch.kernels import dispatch
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models.model_zoo import Model, set_activation_sharding
from repro_torch.optim import adamw

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun"

_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")
# op name (c10d_functional or _dtensor as DTensor issues them, c10d as
# core.sharded_gw calls them) -> the reference's kind
_COLL = {"all_gather_into_tensor": "all-gather",
         "_allgather_base_": "all-gather",
         "all_reduce": "all-reduce", "allreduce_": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all",
         "shard_dim_alltoall": "all-to-all"}


def wire_bytes(kind: str, out_bytes: float, g: int) -> float:
    """The reference's ring model (``repro.launch.dryrun.parse_collectives``):
    bytes a device puts on the wire for one collective of ``out_bytes``
    output over a group of ``g``."""
    if kind == "all-gather":
        return out_bytes * (g - 1) / g
    if kind == "all-reduce":
        return out_bytes * 2 * (g - 1) / g
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)
    if kind == "all-to-all":
        return out_bytes * (g - 1) / g
    return out_bytes


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args) -> int:
    """The group size of a collective op from its arguments."""
    from torch._C._distributed_c10d import _resolve_process_group

    for a in reversed(args):                  # the group name comes last
        if isinstance(a, str):
            return _resolve_process_group(a).size()
        if isinstance(a, dist.ProcessGroup):
            return a.size()
    return 2


class Tally(TorchDispatchMode):
    """Counts rank 0's local work under a step: FLOPs (``FlopCounterMode``'s
    formulas), bytes read and written, collectives by kind, and the peak
    of the storage the step allocates. A DTensor op is let through
    (``NotImplemented``), so the mode sees the local ops and the
    collectives it turns into."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode

        self._flops = FlopCounterMode(display=False)
        self.bytes = 0
        self.collectives = {k: {"count": 0, "out_bytes": 0,
                                "wire_bytes": 0.0} for k in _KINDS}
        self.live = 0
        self.peak = 0
        self._storages = {}           # storage key -> [nbytes, tensors]

    @property
    def flops(self) -> int:
        return self._flops.get_total_flops()

    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        rec = self._storages.get(key)
        if rec is None:
            rec = self._storages[key] = [st.nbytes(), 0]
            self.live += rec[0]
            self.peak = max(self.peak, self.live)
        rec[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key):
        rec = self._storages.get(key)
        if rec is None:
            return
        rec[1] -= 1
        if rec[1] == 0:
            self.live -= rec[0]
            del self._storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        name = func._overloadpacket.__name__
        outs = list(_tensors(out))
        kind = _COLL.get(name)
        if kind is not None:
            g = _group_size(func, list(args) + list(kwargs.values()))
            ob = sum(_nbytes(t) for t in outs)
            if g > 1:
                rec = self.collectives[kind]
                rec["count"] += 1
                rec["out_bytes"] += ob
                rec["wire_bytes"] += wire_bytes(kind, ob, g)
        else:
            self._flops._count_flops(func._overloadpacket, out, args, kwargs)
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        inputs = {id(t) for t in _tensors(args)}
        for t in outs:
            if id(t) not in inputs:
                self._track(t)
        return out


def fake_world(world: int) -> None:
    """(Re)initialize the default process group as the ``fake`` backend
    with ``world`` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _mesh_for(mesh_kind: str, device):
    dispatch.resolve_device(device)             # before any group exists
    multi = mesh_kind == "multi"
    fake_world(512 if multi else 256)
    return make_production_mesh(multi_pod=multi, device=device)


def _cache_sharding(mesh, shape, batch, seq_len):
    """Caches: stacked (L, B, S, ...) or unstacked (B, S, ...) or states
    (L, B, ...). Batch -> data axes; seq dim -> 'model' (plus data axes
    when batch is unshardable, e.g. the long-context B=1 cells)."""
    dp = shd.data_axes(mesh)
    sizes = shd.axis_sizes(mesh)
    dp_size = math.prod(sizes[a] for a in dp)
    model_size = sizes["model"]
    spec = [None] * len(shape)
    bdim = None
    for cand in (1, 0):
        if len(shape) > cand and shape[cand] == batch:
            bdim = cand
            break
    if bdim is not None and batch % dp_size == 0 and batch > 1:
        spec[bdim] = dp
        sdim = bdim + 1
        if len(shape) > sdim and shape[sdim] == seq_len \
                and seq_len % model_size == 0:
            spec[sdim] = "model"
    elif bdim is not None:
        sdim = bdim + 1
        if len(shape) > sdim and shape[sdim] == seq_len:
            if seq_len % (dp_size * model_size) == 0:
                spec[sdim] = tuple(dp) + ("model",)
            elif seq_len % model_size == 0:
                spec[sdim] = "model"
    return shd.NamedSharding(mesh, shd.Spec(*spec))


def _batch_shardings(mesh, batch_specs, global_batch, seq_len):
    out = {}
    for k, v in batch_specs.items():
        if k == "cache":
            out[k] = shd.tree_map(
                lambda s: _cache_sharding(mesh, tuple(s.shape),
                                          global_batch, seq_len), v)
        elif k == "index":
            out[k] = shd.replicated(mesh)
        else:
            out[k] = shd.batch_sharding(mesh, v.ndim, global_batch)
    return out


def _fake_placed(meta_tree, shardings, device):
    """Fake DTensors laid out by ``shardings`` for a tree of meta tensors
    (called under ``FakeTensorMode``)."""
    return shd.tree_map(
        lambda m, sh: shd.place(torch.empty(m.shape, dtype=m.dtype,
                                            device=device), sh),
        meta_tree, shardings)


def _local_bytes(tree) -> int:
    total = 0
    for t in _tensors(tree):
        local = t.to_local() if shd.is_dtensor(t) else t
        total += _nbytes(local)
    return total


def _trace(cfg, shape, mesh, use_flash, rules, device, warm_depth=1):
    """Run the cell's step on fake DTensors; returns (n_params, argument
    bytes, output bytes, Tally, wall seconds of the tallied run).

    The step runs twice, the second time under the :class:`Tally`: the
    first time DTensor meets an op signature, its sharding propagation
    runs the op once more on fake tensors to learn the output's shape,
    which the tally would count as the step's work; the second run finds
    every signature in its cache. A train step's first run takes
    ``warm_depth`` superblocks (None: all): its superblocks repeat one
    another's signatures, and a train step stacks no per-superblock
    caches, so one meets every signature (``tests/test_torch_dryrun.py``
    holds the tally to the one after a full-depth run). Prefill and
    decode steps stack or index their caches by depth, and run at full
    depth first."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    model = Model(cfg)
    abstract = model.abstract_params()
    param_sh = shd.param_shardings(model.param_axes(), abstract, mesh, rules)
    batch_meta = sp.input_specs(cfg, shape)
    batch_sh = _batch_shardings(mesh, batch_meta, shape.global_batch,
                                shape.seq_len)
    n_params = sum(t.numel() for t in _tensors(abstract))
    dev = torch.device(mesh.device_type)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = _fake_placed(abstract, param_sh, dev)
        index = batch_meta.pop("index", None)
        batch_sh.pop("index", None)
        batch = _fake_placed(batch_meta, batch_sh, dev)
        if index is not None:
            batch["index"] = shape.seq_len - 1     # the last cache slot
        if shape.kind == "train":
            step = make_train_step(model, use_flash=use_flash,
                                   use_kernel=False)
            args = (params, adamw.init(params), batch)
            if warm_depth is not None \
                    and warm_depth < cfg.resolved_superblocks:
                warm = {**params, "blocks": params["blocks"][:warm_depth]}
                make_train_step(
                    Model(dataclasses.replace(cfg, n_superblocks=warm_depth)),
                    use_flash=use_flash, use_kernel=False)(
                        warm, adamw.init(warm), batch)
            else:
                step(*args)
        else:
            if shape.kind == "prefill":
                step = make_prefill_step(model, use_flash=use_flash,
                                         use_kernel=False)
            else:
                step = make_decode_step(model)
            args = (params, batch)
            step(*args)
        arg_bytes = _local_bytes(args)
        tally = Tally()
        t0 = time.perf_counter()
        with tally:
            out = step(*args)
        wall = time.perf_counter() - t0
        out_bytes = _local_bytes(out)
    return n_params, arg_bytes, out_bytes, tally, wall


def _apply_sharding(mesh, sp_on: bool = False):
    dp = shd.data_axes(mesh)
    sizes = shd.axis_sizes(mesh)
    set_activation_sharding(True, dp=dp,
                            dp_size=math.prod(sizes[a] for a in dp),
                            model_size=sizes["model"], sp=sp_on)


def _write(rec, out_dir: Path, fname: str):
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / (fname + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def _cell_name(arch, shape_name, mesh_kind, tag=""):
    fname = f"{arch.replace('/', '_')}__{shape_name}__{mesh_kind}"
    return fname + (f"__{tag}" if tag else "")


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path,
             use_flash: bool = True, rules=None, tag: str = "",
             sp: bool = False, cfg_overrides=None, device=None):
    """Dry-run one cell and write its record; returns the record.
    ``cfg_overrides`` replaces config fields (``n_superblocks`` cuts the
    depth; hill-climbing's ``ssm_chunk``). On the card's device type
    unless ``device`` says otherwise (fake tensors either way)."""
    cfg = cb.get_arch(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = cb.SHAPES[shape_name]
    mesh = _mesh_for(mesh_kind, device)
    _apply_sharding(mesh, sp)
    try:
        n_params, arg_b, out_b, tally, wall = _trace(cfg, shape, mesh,
                                                     use_flash, rules, device)
    finally:
        set_activation_sharding(False)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "mesh_shape": shd.axis_sizes(mesh), "kind": shape.kind,
           "tag": tag, "n_params": n_params, "lower_s": wall,
           "compile_s": None,
           "memory": {"argument_bytes": arg_b, "output_bytes": out_b,
                      "temp_bytes": tally.peak, "alias_bytes": None,
                      "code_bytes": None},
           "flops_raw": tally.flops, "bytes_raw": tally.bytes,
           "collectives": tally.collectives, "hlo_lines": None,
           "flops_per_device": tally.flops,
           "bytes_unblocked_per_device": tally.bytes, "cost_points": None,
           "bytes_per_device": tally.bytes}
    if shape.kind != "decode":
        rec["cost_points_flash"] = None
    _write(rec, out_dir, _cell_name(arch, shape_name, mesh_kind, tag))
    print(f"[ok] {arch} {shape_name} {mesh_kind}{' ' + tag if tag else ''}: "
          f"traced {wall:.1f}s flops/dev {tally.flops:.3g} "
          f"temp {tally.peak / 2**30:.2f}GiB "
          f"args {arg_b / 2**30:.2f}GiB")
    return rec


def run_gw_cell(mesh_kind: str, out_dir: Path, s_r: int = 8192,
                s_c: int = 8192, outer: int = 10, inner: int = 30,
                tag: str = "", comm_dtype=None, submesh=None, device=None):
    """Dry-run the paper's own technique at pod scale: the sharded
    Grid-SPAR-GW solver (``core.sharded_gw``) on an s_r x s_c grid block
    over the whole mesh, or a ``submesh=(d, m)`` of it (many independent
    problems, one a submesh). With the pod axis the mesh is folded to
    (32, 16) (pure row sharding), as the reference does."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.sharded_gw import make_sharded_grid_gw

    dev = dispatch.resolve_device(device)
    fake_world(512 if mesh_kind == "multi" else 256)
    shape = submesh or ((32, 16) if mesh_kind == "multi" else (16, 16))
    mesh = init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=("data", "model"))
    solver = make_sharded_grid_gw(mesh, s_r, s_c, "l2", 1e-2, outer, inner,
                                  comm_dtype=comm_dtype)
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = tuple(torch.empty(s, dtype=torch.float32, device=dev)
                     for s in ((s_r, s_r), (s_c, s_c), (s_r,), (s_c,),
                               (s_r, s_c)))
        solver(*args)                                # warm, as in _trace
        tally = Tally()
        t0 = time.perf_counter()
        with tally:
            val, T = solver(*args)
        wall = time.perf_counter() - t0
        out_b = _nbytes(val) + _nbytes(T)
    rec = {"arch": "spargw-engine", "shape": f"grid{s_r}x{s_c}",
           "mesh": mesh_kind, "mesh_shape": shd.axis_sizes(mesh),
           "kind": "gw", "tag": tag, "n_params": 0, "lower_s": wall,
           "compile_s": None,
           "memory": {"argument_bytes": sum(_nbytes(a) for a in args),
                      "output_bytes": out_b, "temp_bytes": tally.peak,
                      "alias_bytes": None, "code_bytes": None},
           "flops_raw": tally.flops, "bytes_raw": tally.bytes,
           "flops_per_device": tally.flops,
           "bytes_per_device": tally.bytes,
           "collectives": tally.collectives, "hlo_lines": None}
    name = f"spargw-engine__grid{s_r}x{s_c}__{mesh_kind}"
    _write(rec, out_dir, name + (f"__{tag}" if tag else ""))
    print(f"[ok] spargw-engine grid{s_r}x{s_c} {mesh_kind}: traced "
          f"{wall:.1f}s flops/dev {tally.flops:.3g} "
          f"temp {tally.peak / 2**30:.2f}GiB")
    return rec


def recost_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path,
                use_flash: bool = True, rules=None, device=None):
    """Recount an existing cell record's FLOPs and bytes (its other fields
    are kept)."""
    fname = out_dir / (_cell_name(arch, shape_name, mesh_kind) + ".json")
    with open(fname) as f:
        rec = json.load(f)
    mesh = _mesh_for(mesh_kind, device)
    _apply_sharding(mesh)
    try:
        _, _, _, tally, wall = _trace(cb.get_arch(arch),
                                      cb.SHAPES[shape_name], mesh,
                                      use_flash, rules, device)
    finally:
        set_activation_sharding(False)
    rec.update(flops_raw=tally.flops, flops_per_device=tally.flops,
               bytes_raw=tally.bytes, bytes_per_device=tally.bytes,
               bytes_unblocked_per_device=tally.bytes)
    with open(fname, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[recost] {arch} {shape_name} {mesh_kind}: "
          f"flops/dev {tally.flops:.3g} bytes/dev {tally.bytes:.3g} "
          f"({wall:.0f}s)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", type=str, default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--cost-only", action="store_true")
    ap.add_argument("--gw", action="store_true",
                    help="dry-run the sharded GW engine instead of LM cells")
    ap.add_argument("--out", type=str, default=str(ART))
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    dispatch.resolve_device(args.device)         # no card, no --device: raise
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.gw:
        for mk in meshes:
            run_gw_cell(mk, out_dir, device=args.device)
        return 0

    archs = list(cb.CLI_ALIASES) if args.all else [args.arch]
    failures = []
    for arch in archs:
        cfg = cb.get_arch(arch)
        shapes = [s.name for s in cb.shapes_for(cfg)] \
            if args.shape is None else [args.shape]
        for shape_name in shapes:
            for mesh_kind in meshes:
                fname = out_dir / (_cell_name(arch, shape_name, mesh_kind)
                                   + ".json")
                try:
                    if args.cost_only:
                        recost_cell(arch, shape_name, mesh_kind, out_dir,
                                    device=args.device)
                        continue
                    if args.skip_existing and fname.exists():
                        print(f"[skip] {arch} {shape_name} {mesh_kind}")
                        continue
                    run_cell(arch, shape_name, mesh_kind, out_dir,
                             device=args.device)
                except Exception as e:  # noqa: BLE001 — record, go on
                    traceback.print_exc()
                    failures.append((arch, shape_name, mesh_kind,
                                     str(e)[:200]))
    if failures:
        print("FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("all cells passed")
    return 0


if __name__ == "__main__":
    main()
