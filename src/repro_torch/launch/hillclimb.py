"""Hill climbing over the dry run: the port of ``repro.launch.hillclimb``.

Runs a named optimization variant of one (arch × shape × mesh) cell
through the dry run (``launch.dryrun``), records a tagged artifact and
prints the before/after roofline terms.

Variants (joined with ``+``):
  sp          — sequence-parallel residual stream (saved activations under
                remat split over 'model'; an all-gather at layer entry)
  moe_bf16    — bfloat16 MoE combine weights
  mamba_split — Mamba2's input projection as a TP-shardable ``in_zx`` and
                a replicated ``in_bcdt``
  fc256       — blockwise attention chunks of 256 keys
  embed_repl  — replicate the token embedding over 'model' (no vocab-TP
                gather, at the cost of a replicated table)
  ssmchunkN   — Mamba2's SSD chunk of N positions

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --arch llama-3.2-vision-90b --shape train_4k --mesh single --variant sp
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

from repro_torch.configs import base as cb
from repro_torch.distrib import sharding as shd
from repro_torch.kernels import dispatch
from repro_torch.launch import dryrun as dr
from repro_torch.models import Model
from repro_torch.models.attention import set_flash_chunk
from repro_torch.models.moe import set_moe_options
from repro_torch.models.sharding_ctx import set_activation_sharding
from repro_torch.models.ssm import set_mamba_options
from repro_torch.optim.adamw import tree_leaves as leaves

# Published H100 SXM figures (the roofline's peaks, not measurements),
# from NVIDIA's H100 Tensor Core GPU datasheet, SXM5 column: 989 TFLOP/s
# dense BF16 tensor-core throughput, 3.35 TB/s HBM3 bandwidth, and NVLink
# 4's 900 GB/s per GPU (the total of both directions, so the collective
# term is optimistic by up to 2x for a ring that sends one way).
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 900e9


def active_params(cfg) -> float:
    """The parameters a token passes through: every leaf, with each
    expert leaf (its first axis ``expert``) counted at the share of its
    experts a token is routed to (``experts_per_token / n_experts``)."""
    model = Model(cfg)
    counts = shd.tree_map(
        lambda axes, t: t.numel() * (
            cfg.experts_per_token / cfg.n_experts
            if axes and axes[0] == "expert" else 1.0),
        model.param_axes(), model.abstract_params(), is_leaf=shd.is_axes)
    return sum(leaves(counts))


def model_flops(rec) -> float:
    """6·N·D for train, 2·N·D forward-only, with N the active parameters
    and D the shape's tokens (a decode step's: its batch)."""
    if rec["kind"] == "gw":
        return 0.0
    shape = cb.SHAPES[rec["shape"]]
    tokens = shape.global_batch * (
        shape.seq_len if shape.kind in ("train", "prefill") else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active_params(cb.get_arch(rec["arch"])) * tokens


def analyze(rec):
    """The roofline terms of one dry-run record at the H100 peaks above."""
    chips = math.prod(rec["mesh_shape"].values())
    t_comp = rec["flops_per_device"] / PEAK_FLOPS
    t_mem = rec["bytes_per_device"] / HBM_BW
    wire = sum(v["wire_bytes"] for v in rec["collectives"].values())
    t_coll = wire / NVLINK_BW
    dom = max((("compute", t_comp), ("memory", t_mem),
               ("collective", t_coll)), key=lambda kv: kv[1])[0]
    mf = model_flops(rec)
    flops_global = rec["flops_per_device"] * chips
    bound = max(t_comp, t_mem, t_coll)
    return {"arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "t_compute_s": t_comp, "t_memory_s": t_mem,
            "t_collective_s": t_coll, "dominant": dom,
            "model_flops": mf, "flops_global": flops_global,
            "useful_ratio": mf / flops_global if flops_global else 0.0,
            "roofline_fraction": t_comp / bound if bound else 0.0,
            "temp_GiB": rec["memory"]["temp_bytes"] / 2**30,
            "args_GiB": rec["memory"]["argument_bytes"] / 2**30}


def apply_variant(variant: str, mesh):
    """Set each lever the variant names (and reset the others); returns
    the sharding rules (None: the defaults)."""
    rules = None
    parts = variant.split("+")
    dp = shd.data_axes(mesh)
    sizes = shd.axis_sizes(mesh)
    set_activation_sharding(True, dp=dp,
                            dp_size=math.prod(sizes[a] for a in dp),
                            model_size=sizes["model"], sp="sp" in parts)
    set_moe_options(bf16_dispatch="moe_bf16" in parts)
    set_mamba_options(split_proj="mamba_split" in parts)
    set_flash_chunk(256 if "fc256" in parts else 512)
    if "embed_repl" in parts:
        rules = dict(shd.DEFAULT_RULES)
        rules["vocab"] = (None,)
    return rules


def reset_levers():
    set_activation_sharding(False)
    set_moe_options(bf16_dispatch=False)
    set_mamba_options(split_proj=False)
    set_flash_chunk(512)


def run_variant(arch, shape, mesh_kind, variant, out_dir, device=None):
    overrides = {}
    for p in variant.split("+"):
        if p.startswith("ssmchunk"):
            overrides["ssm_chunk"] = int(p[len("ssmchunk"):])
    mesh = dr._mesh_for(mesh_kind, device)
    rules = apply_variant(variant, mesh)
    try:
        return dr.run_cell(arch, shape, mesh_kind, out_dir, rules=rules,
                           tag=variant, sp="sp" in variant.split("+"),
                           cfg_overrides=overrides or None, device=device)
    finally:
        reset_levers()


def compare(arch, shape, mesh_kind, variant, out_dir):
    base = json.load(open(out_dir / f"{arch}__{shape}__{mesh_kind}.json"))
    var = json.load(
        open(out_dir / f"{arch}__{shape}__{mesh_kind}__{variant}.json"))
    a, b = analyze(base), analyze(var)
    print(f"\n{arch} {shape} {mesh_kind} — baseline -> {variant}")
    for k in ("t_compute_s", "t_memory_s", "t_collective_s", "temp_GiB"):
        delta = (b[k] - a[k]) / a[k] * 100 if a[k] else 0.0
        print(f"  {k:16s} {a[k]:10.3e} -> {b[k]:10.3e}  ({delta:+.1f}%)")
    print(f"  dominant: {a['dominant']} -> {b['dominant']}; "
          f"roofline frac {a['roofline_fraction']:.3f} -> "
          f"{b['roofline_fraction']:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--variant", required=True)
    ap.add_argument("--out", default=str(dr.ART))
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = Path(args.out)
    dispatch.resolve_device(args.device)         # no card, no --device: raise
    run_variant(args.arch, args.shape, args.mesh, args.variant, out,
                device=args.device)
    compare(args.arch, args.shape, args.mesh, args.variant, out)


if __name__ == "__main__":
    main()
