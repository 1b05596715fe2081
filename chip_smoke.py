#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases; any failure raises and exits non-zero with no result line:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the CUDA kernels from src/repro_torch/csrc with nvcc (all
   sources at once) and print the build time and the ptxas report;
3. hold each kernel against its plain PyTorch version at ragged shapes;
4. drive the main path: ``repro_torch.solve`` with auto-selection on an
   n = 2048 Moon pair (spar_gw, s = 16n = 32768, cost_impl "auto" =
   the materialized matvec kernel), then the same support with the
   gather-fused kernel forced; both kernels must launch, both values be
   finite and healthy and agree; then a small solve on the card against
   the plain CPU path on the same support;
5. time both kernels at the main path's shapes against their plain
   versions, their bound and, for the matvec, one library call.

The line before the last is the kernel JSON; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the JAX
package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_MAIN = 2048          # largest size select_solver routes to spar_gw
N_SMALL = 300          # card-vs-CPU agreement check

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32
# (non-tensor-core) flop/s; the kernels' work is fp32 FMAs and gathers
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# fp32 operations per (k, l) pair of the fused kernel: the loss plus the
# FMA (2). l1: sub, abs; l2: sub, mul; kl: 2 max, 2 log, sub, mul, sub, add
FUSED_OPS_PER_PAIR = {"l1": 4, "l2": 4, "kl": 10}

# kernel-vs-plain: a lane adds s/32 terms in sequence and the warp 5 more
# levels; two correct fp32 sums differ by at most (s/32 + 5)·2^-24 of the
# error scale (6.1e-5 at s = 32768)
KERNEL_RTOL = 1e-4
# the two impls on one support: same math, other summation order, carried
# through 20 outer x 50 inner iterations
IMPL_VALUE_RTOL = 1e-4
# card vs CPU on one support: index_add_ on the card sums with atomics
SMALL_VALUE_RTOL = 1e-4


def moon(n: int, seed: int = 0):
    """The paper's Moon pair (§6.1): two noisy interleaved half circles,
    Gaussian marginals N(n/3, n/20) and N(n/2, n/20) floored at 1e-9,
    Euclidean distance matrices as costs (benchmarks/datasets.py)."""
    def points(rng):
        n1 = n // 2
        t1, t2 = np.pi * rng.random(n1), np.pi * rng.random(n - n1)
        pts = np.concatenate([np.stack([np.cos(t1), np.sin(t1)], 1),
                              np.stack([1 - np.cos(t2), 0.5 - np.sin(t2)], 1)])
        return pts + 0.05 * rng.standard_normal(pts.shape)

    def weights(mean_frac):
        idx = np.arange(n)
        w = np.exp(-0.5 * ((idx - mean_frac * n) / (n / 20)) ** 2) + 1e-9
        return (w / w.sum()).astype(np.float32)

    def dist(x):
        sq = (x * x).sum(1)
        d2 = np.maximum(sq[:, None] + sq[None, :] - 2 * x @ x.T, 0.0)
        return np.sqrt(d2).astype(np.float32)

    rng = np.random.default_rng(seed)
    x = points(rng)
    y = points(np.random.default_rng(seed + 1))
    return dist(x), weights(1 / 3), dist(y), weights(1 / 2)


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check(torch, name, got, want, scale, rtol=KERNEL_RTOL) -> float:
    """Raise unless |got - want| <= rtol·scale everywhere; max abs error."""
    torch.cuda.synchronize()
    err = (got - want).abs()
    worst = float((err / scale.clamp_min(1e-30)).max())
    if not bool(torch.all(err <= rtol * scale)):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: max err/scale {worst:.3g} > {rtol}")
    return float(err.max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.api.solvers import SparGWSolver
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.spar_cost import ops, ref, spar_cost

    dev = torch.device("cuda")

    # -- 1. the card -------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    reports = cuda_lib.build(["spar_matvec", "spar_cost_fused"])
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(reports) or 'already built'})")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "ptxas info" in line and ("registers" in line
                                         or "Compiling" in line):
                print(f"  {name}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, lo=0.0):
        return torch.rand(*shape, generator=gen, device=dev) + lo

    # -- 3. kernels vs plain versions at ragged shapes ---------------------
    s = 3001
    L, t, off = rand(s, s), rand(s) - 0.5, rand(s, lo=-3.0)
    check(torch, "spar_matvec s=3001", spar_cost.spar_matvec_cuda(L, t, off),
          spar_cost.spar_matvec_plain(L, t, off),
          L.abs() @ t.abs() + off.abs())
    m, n = 777, 555
    Cx, Cy = rand(m, m, lo=0.05), rand(n, n, lo=0.05)
    rows = torch.randint(0, m, (s,), generator=gen, device=dev)
    cols = torch.randint(0, n, (s,), generator=gen, device=dev)
    rows[-700:], cols[-700:] = rows[:700], cols[:700]     # duplicate pairs
    for loss in ("l1", "l2", "kl"):
        check(torch, f"spar_cost_fused {loss} s=3001",
              spar_cost.spar_cost_cuda(Cx, Cy, rows.int(), cols.int(), t, off,
                                       loss=loss),
              spar_cost.spar_cost_plain(Cx, Cy, rows, cols, t, off, loss),
              ref.spar_cost_error_scale(Cx, Cy, rows, cols, t, off, loss))
    del L, Cx, Cy
    print("kernel checks at ragged shapes: ok")

    # -- 4. the main path --------------------------------------------------
    Cx_np, a_np, Cy_np, b_np = moon(N_MAIN, seed=0)
    problem = repro_torch.QuadraticProblem(repro_torch.Geometry(Cx_np, a_np),
                                           repro_torch.Geometry(Cy_np, b_np))
    auto = repro_torch.select_solver(problem)
    s_main = auto.s
    if not (isinstance(auto, SparGWSolver) and s_main == 16 * N_MAIN
            and ops.resolve_impl(auto.cost_impl, s_main, dev)
            == "materialized"):
        raise AssertionError(f"auto-selection gave {auto}")
    forced = dataclasses.replace(auto, cost_impl="pallas")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spar_cost.reset_launch_counts()
    t0 = time.perf_counter()
    out_auto = repro_torch.solve(problem,
                                 generator=torch.Generator(dev).manual_seed(0))
    v_auto = float(out_auto.value)
    torch.cuda.synchronize()
    wall_auto = time.perf_counter() - t0
    support = (out_auto.coupling.rows, out_auto.coupling.cols)
    t0 = time.perf_counter()
    out_fused = repro_torch.solve(problem, forced, support=support)
    v_fused = float(out_fused.value)
    torch.cuda.synchronize()
    wall_fused = time.perf_counter() - t0
    launches = dict(spar_cost.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    for name, out in (("auto", out_auto), ("pallas", out_fused)):
        vals = out.coupling.vals
        if not (math.isfinite(float(out.value))
                and bool(torch.isfinite(vals).all())
                and tuple(vals.shape) == (s_main,)):
            raise AssertionError(f"main path ({name}): non-finite output")
        if not out.status.is_healthy:
            raise AssertionError(f"main path ({name}): status {out.status}")
    if abs(v_auto - v_fused) > IMPL_VALUE_RTOL * abs(v_auto):
        raise AssertionError(f"main path: impls disagree: {v_auto} vs "
                             f"{v_fused}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"main path never launched {name}")
    print(json.dumps({"main_path": {
        "n": N_MAIN, "s": s_main, "loss": problem.loss,
        "value_auto": v_auto, "value_pallas": v_fused,
        "status": out_auto.status.describe(), "n_iters": out_auto.n_iters,
        "last_err": out_auto.status.last_err,
        "wall_s_auto": wall_auto, "wall_s_pallas": wall_fused,
        "max_memory_allocated_gib": peak_gib, "launches": launches}}))

    # a small solve on the card against the plain CPU path, same support
    sx, sa, sy, sb = moon(N_SMALL, seed=1)
    small = repro_torch.QuadraticProblem(repro_torch.Geometry(sx, sa),
                                         repro_torch.Geometry(sy, sb))
    for impl in ("materialized", "pallas"):
        solver = SparGWSolver(s=16 * N_SMALL, cost_impl=impl)
        on_card = repro_torch.solve(
            small, solver, generator=torch.Generator(dev).manual_seed(1))
        on_cpu = repro_torch.solve(
            small, solver, device="cpu",
            support=(on_card.coupling.rows.cpu(), on_card.coupling.cols.cpu()))
        vc, vp = float(on_card.value), float(on_cpu.value)
        if not (math.isfinite(vc) and on_card.status.code == on_cpu.status.code
                and on_card.n_iters == on_cpu.n_iters
                and abs(vc - vp) <= SMALL_VALUE_RTOL * abs(vp)):
            raise AssertionError(f"small solve ({impl}): card {vc} "
                                 f"{on_card.status} vs CPU {vp} "
                                 f"{on_cpu.status}")
    print(f"small solve n={N_SMALL}: card agrees with CPU (value rtol "
          f"{SMALL_VALUE_RTOL})")

    # -- 5. kernels at the main path's shapes ------------------------------
    rows, cols = support
    Cx, Cy = problem.geom_x.cost.to(dev), problem.geom_y.cost.to(dev)
    t = (-1.0 / auto.epsilon) * out_auto.coupling.vals     # the step's t
    off = torch.randn(s_main, generator=gen, device=dev)
    kernels = []

    Lmat = ref.materialize_loss(Cx, Cy, rows, cols, problem.loss)
    err = check(torch, "spar_matvec main shape",
                spar_cost.spar_matvec_cuda(Lmat, t, off),
                spar_cost.spar_matvec_plain(Lmat, t, off),
                Lmat.abs() @ t.abs() + off.abs())
    ms = time_ms(torch, lambda: spar_cost.spar_matvec_cuda(Lmat, t, off), 20)
    plain_ms = time_ms(torch, lambda: spar_cost.spar_matvec_plain(
        Lmat, t, off), 20)
    lib_ms = time_ms(torch, lambda: torch.addmv(off, Lmat, t), 20)
    mv_bytes = 4 * (s_main * s_main + 3 * s_main)
    mv_ops = 2 * s_main * s_main
    kernels.append({
        "name": "spar_matvec", "route": "cuda",
        "source": "src/repro_torch/csrc/spar_matvec.cu",
        "replaces": "src/repro/kernels/spar_cost/spar_cost.py:132",
        "launches": launches["spar_matvec"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(mv_bytes / HBM_BYTES_PER_S, mv_ops / FP32_FLOPS),
        "bound_by": ("bytes" if mv_bytes / HBM_BYTES_PER_S
                     >= mv_ops / FP32_FLOPS else "operations"),
        "library_ms": lib_ms})
    del Lmat
    torch.cuda.empty_cache()

    rows32, cols32 = rows.int().contiguous(), cols.int().contiguous()
    err = check(torch, "spar_cost_fused main shape",
                spar_cost.spar_cost_cuda(Cx, Cy, rows32, cols32, t, off,
                                         loss=problem.loss),
                spar_cost.spar_cost_plain(Cx, Cy, rows, cols, t, off,
                                          problem.loss),
                ref.spar_cost_error_scale(Cx, Cy, rows, cols, t, off,
                                          problem.loss))
    ms = time_ms(torch, lambda: spar_cost.spar_cost_cuda(
        Cx, Cy, rows32, cols32, t, off, loss=problem.loss), 10)
    plain_ms = time_ms(torch, lambda: spar_cost.spar_cost_plain(
        Cx, Cy, rows, cols, t, off, problem.loss), 3, warmup=1)
    fu_bytes = 4 * (N_MAIN * N_MAIN * 2 + 5 * s_main)
    fu_ops = FUSED_OPS_PER_PAIR[problem.loss] * s_main * s_main
    kernels.append({
        "name": "spar_cost_fused", "route": "cuda",
        "source": "src/repro_torch/csrc/spar_cost_fused.cu",
        "replaces": "src/repro/kernels/spar_cost/spar_cost.py:79",
        "launches": launches["spar_cost_fused"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(fu_bytes / HBM_BYTES_PER_S, fu_ops / FP32_FLOPS),
        "bound_by": ("bytes" if fu_bytes / HBM_BYTES_PER_S
                     >= fu_ops / FP32_FLOPS else "operations"),
        "library_ms": None})

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
