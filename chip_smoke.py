#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases; any failure raises and exits non-zero with no result line:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the CUDA kernels from src/repro_torch/csrc with nvcc (all
   sources at once) and print the build time and the ptxas report;
3. hold each kernel against its plain PyTorch version at ragged shapes;
4. drive the spar main path: ``repro_torch.solve`` with auto-selection
   on an n = 2048 Moon pair (spar_gw, s = 16n = 32768, cost_impl "auto"
   = the materialized matvec kernel), then the same support with the
   gather-fused kernel forced; both kernels must launch, both values be
   finite and healthy and agree; then a small solve on the card against
   the plain CPU path on the same support;
5. drive the grid main path: ``repro_torch.solve`` with
   ``GridGWSolver.default_config(2048)`` (s_r = s_c = 181) and
   ``use_kernel=True`` on the same Moon pair with the l1 loss; the
   gw_cost kernel must launch 21 times (20 steps and the final value),
   the value be finite and healthy and agree with ``use_kernel=False``
   (the plain chunked contraction on the card) on the same support; then
   a small grid solve on the card against the CPU path;
6. drive the resident Sinkhorn's own entry point
   (``repro_torch.kernels.sinkhorn.ops.sinkhorn``) on the 181 x 181 K of
   the grid path's first stable=False prox step (the shared-memory
   kernel) and on a 2048 x 2048 K (the cooperative grid kernel);
7. time every kernel at its path's shapes against its plain version,
   its bound and, where one exists, one library call;
8. trace one grid solve and one spar solve (gather-fused) on their
   main-path supports with ``torch.profiler`` and print each one's wall
   time, device-busy time, idle share and the kernels that take the most
   device time.

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
# (the same counts per (k, l, m, p) evaluation of the gw_cost kernel)
FUSED_OPS_PER_PAIR = {"l1": 4, "l2": 4, "kl": 10}
GRID_LOSS = "l1"       # the loss that reaches the gw_cost kernel
SINKHORN_ITERS = 50    # H of the grid path's inner loop
N_SINKHORN_LARGE = 2048   # the reference's above-its-VMEM-gate shape

# kernel-vs-plain: a lane adds s/32 terms in sequence and the warp 5 more
# levels; two correct fp32 sums differ by at most (s/32 + 5)·2^-24 of the
# error scale (6.1e-5 at s = 32768)
KERNEL_RTOL = 1e-4
# the two impls on one support: same math, other summation order, carried
# through 20 outer x 50 inner iterations
IMPL_VALUE_RTOL = 1e-4
# card vs CPU on one support: index_add_ on the card sums with atomics
SMALL_VALUE_RTOL = 1e-4
# gw_cost kernel-vs-plain: a thread adds ceil(L/16)·P terms in sequence
# and the block 16 more: (12·181 + 16)·2^-24 = 1.3e-4 at 181⁴
GW_COST_RTOL = 2e-4
# sinkhorn kernel-vs-plain: both flush the same subnormals and differ only
# in each matvec's summation order; rtol 1e-4 plus 1e-6 of the largest
# coupling entry
SINKHORN_RTOL, SINKHORN_ATOL_REL = 1e-4, 1e-6


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


def bound(bytes_moved: float, ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over HBM rate and fp32
    operations over the fp32 peak, and which of the two it is."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_coupling(torch, name, got, want) -> float:
    """Raise unless |got - want| <= rtol·|want| + atol·max|want|."""
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = SINKHORN_RTOL * want.abs() + SINKHORN_ATOL_REL * want.abs().max()
    if not bool(torch.all(err <= tol)):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: max abs err {float(err.max()):.3g}")
    return float(err.max())


def check_solve(name, out, shape):
    """Raise unless a solve's value and coupling are finite, of the
    expected shape, and its status healthy."""
    vals = out.coupling[2]
    if not (math.isfinite(float(out.value)) and bool(vals.isfinite().all())
            and tuple(vals.shape) == shape):
        raise AssertionError(f"{name}: non-finite or misshapen output")
    if not out.status.is_healthy:
        raise AssertionError(f"{name}: status {out.status}")


def profile_solve(torch, fn, top: int = 8) -> dict:
    """Trace ``fn()`` with torch.profiler: wall time, the summed device
    time of its CUDA kernels, the device's idle share, the top kernels.

    Kernels run on one stream, so their device times do not overlap; the
    profiler's own overhead lengthens the wall time, so the idle share is
    an upper bound on the unprofiled one.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us, e.count, e.key))
    busy = sum(r[0] for r in rows) / 1e6
    if busy <= 0:
        raise AssertionError("profiler recorded no device time")
    rows.sort(reverse=True)
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "kernel_launches": sum(r[1] for r in rows),
            "top": [{"kernel": k[:80], "calls": c, "ms": us / 1e3}
                    for us, c, k in rows[:top]]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.api import solvers
    from repro_torch.api.solvers import GridGWSolver, SparGWSolver
    from repro_torch.core.grid_gw import grid_cost
    from repro_torch.core.utils import flush_subnormal
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.gw_cost import gw_cost
    from repro_torch.kernels.gw_cost import ref as gw_ref
    from repro_torch.kernels.sinkhorn import ops as sinkhorn_ops
    from repro_torch.kernels.sinkhorn import sinkhorn
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
    reports = cuda_lib.build(["spar_matvec", "spar_cost_fused", "gw_cost",
                              "sinkhorn_resident"])
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
    A, B = rand(177, 93, lo=0.05), rand(131, 205, lo=0.05)
    Tg = rand(93, 205)
    for loss in ("l1", "l2", "kl"):
        check(torch, f"gw_cost {loss} 177x93x131x205",
              gw_cost.gw_cost_cuda(A, B, Tg, loss=loss),
              gw_cost.gw_cost_plain(A, B, Tg, loss),
              gw_ref.gw_cost_error_scale(A, B, Tg, loss), rtol=GW_COST_RTOL)
    for m, n, variant in ((150, 173, "sinkhorn_resident"),
                          (613, 487, "sinkhorn_grid")):
        a, b = rand(m, lo=0.1), rand(n, lo=0.1)
        Kr = torch.exp(-3.0 * rand(m, n))
        sinkhorn.reset_launch_counts()
        got = sinkhorn.sinkhorn_cuda(a / a.sum(), b / b.sum(), Kr, 30)
        if sinkhorn.LAUNCHES[variant] != 1:
            raise AssertionError(f"{m}x{n} did not run {variant}")
        check_coupling(torch, f"{variant} {m}x{n}", got,
                       sinkhorn.sinkhorn_plain(a / a.sum(), b / b.sum(), Kr,
                                               30))
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
        check_solve(f"main path ({name})", out, (s_main,))
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

    # -- 5. the grid main path ---------------------------------------------
    grid_problem = repro_torch.QuadraticProblem(
        repro_torch.Geometry(Cx_np, a_np), repro_torch.Geometry(Cy_np, b_np),
        loss=GRID_LOSS)
    grid_solver = dataclasses.replace(GridGWSolver.default_config(N_MAIN),
                                      use_kernel=True)
    side = grid_solver.s_r
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()    # what phase 4 still holds
    gw_cost.reset_launch_counts()
    t0 = time.perf_counter()
    out_grid = repro_torch.solve(grid_problem, grid_solver,
                                 generator=torch.Generator(dev).manual_seed(0))
    v_grid = float(out_grid.value)
    torch.cuda.synchronize()
    wall_grid = time.perf_counter() - t0
    grid_launches = dict(gw_cost.LAUNCHES)
    grid_peak_gib = (torch.cuda.max_memory_allocated() - base_bytes) / 2**30
    grid_support = (out_grid.coupling.rows, out_grid.coupling.cols)
    t0 = time.perf_counter()
    out_plain = repro_torch.solve(
        grid_problem, dataclasses.replace(grid_solver, use_kernel=False),
        support=grid_support)
    v_plain = float(out_plain.value)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    for name, out in (("kernel", out_grid), ("plain", out_plain)):
        check_solve(f"grid main path ({name})", out, (side, side))
    if grid_launches["gw_cost"] != grid_solver.outer_iters + 1:
        raise AssertionError(f"grid main path: gw_cost launched "
                             f"{grid_launches['gw_cost']} times, expected "
                             f"{grid_solver.outer_iters + 1}")
    if abs(v_grid - v_plain) > IMPL_VALUE_RTOL * abs(v_plain):
        raise AssertionError(f"grid main path: kernel {v_grid} vs plain "
                             f"{v_plain}")
    print(json.dumps({"grid_main_path": {
        "n": N_MAIN, "s_r": side, "s_c": grid_solver.s_c, "loss": GRID_LOSS,
        "value_kernel": v_grid, "value_plain": v_plain,
        "status": out_grid.status.describe(), "n_iters": out_grid.n_iters,
        "last_err": out_grid.status.last_err,
        "wall_s_kernel": wall_grid, "wall_s_plain": wall_plain,
        "peak_memory_gib_above_start": grid_peak_gib,
        "launches": grid_launches}}))

    # a small grid solve on the card against the CPU path, same (R, C)
    small_grid = repro_torch.QuadraticProblem(small.geom_x, small.geom_y,
                                              loss=GRID_LOSS)
    small_solver = dataclasses.replace(GridGWSolver.default_config(N_SMALL),
                                       use_kernel=True)
    on_card = repro_torch.solve(small_grid, small_solver,
                                generator=torch.Generator(dev).manual_seed(1))
    on_cpu = repro_torch.solve(
        small_grid, small_solver, device="cpu",
        support=(on_card.coupling.rows.cpu(), on_card.coupling.cols.cpu()))
    vc, vp = float(on_card.value), float(on_cpu.value)
    if not (math.isfinite(vc) and on_card.status.code == on_cpu.status.code
            and on_card.n_iters == on_cpu.n_iters
            and abs(vc - vp) <= SMALL_VALUE_RTOL * abs(vp)):
        raise AssertionError(f"small grid solve: card {vc} {on_card.status} "
                             f"vs CPU {vp} {on_cpu.status}")
    print(f"small grid solve n={N_SMALL} side={small_solver.s_r}: card "
          f"agrees with CPU (value rtol {SMALL_VALUE_RTOL})")

    # -- 6. the resident Sinkhorn's own entry point --------------------------
    # K of the grid path's first stable=False prox step on the main support
    R, C = grid_support
    CxR, CyC, aR, bC, w = solvers._grid_block_data(grid_problem.to(dev), R,
                                                   C, grid_solver.shrink)
    T0 = flush_subnormal(aR[:, None] * bC[None, :])
    K_step = solvers._grid_plain_kernel(
        grid_cost(CxR, CyC, T0, GRID_LOSS, use_kernel=True), w, T0,
        grid_solver.epsilon, "prox").contiguous()
    a_big = torch.full((N_SINKHORN_LARGE,), 1.0 / N_SINKHORN_LARGE,
                       device=dev)
    K_big = torch.exp(-3.0 * rand(N_SINKHORN_LARGE, N_SINKHORN_LARGE))
    sinkhorn_paths = {}
    for variant, (sa, sb, sK) in (("sinkhorn_resident", (aR, bC, K_step)),
                                  ("sinkhorn_grid", (a_big, a_big, K_big))):
        torch.cuda.synchronize()
        sinkhorn.reset_launch_counts()
        T_k = sinkhorn_ops.sinkhorn(sa, sb, sK, iters=SINKHORN_ITERS)
        torch.cuda.synchronize()
        counts = dict(sinkhorn.LAUNCHES)
        if counts[variant] != 1:
            raise AssertionError(f"sinkhorn path {tuple(sK.shape)}: "
                                 f"launches {counts}, expected {variant}")
        if not bool(T_k.isfinite().all()):
            raise AssertionError(f"{variant}: non-finite coupling")
        err = check_coupling(torch, f"{variant} {tuple(sK.shape)}", T_k,
                             sinkhorn.sinkhorn_plain(sa, sb, sK,
                                                     SINKHORN_ITERS))
        sinkhorn_paths[variant] = (sa, sb, sK, counts[variant], err)
    print(f"sinkhorn entry point: {side}x{side} K of the first prox step "
          f"-> sinkhorn_resident, {N_SINKHORN_LARGE}x{N_SINKHORN_LARGE} -> "
          f"sinkhorn_grid; both agree with the plain loop")

    # -- 7. kernels at their paths' shapes ----------------------------------
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
    bound_ms, bound_by = bound(4 * (s_main * s_main + 3 * s_main),
                               2 * s_main * s_main)
    kernels.append({
        "name": "spar_matvec", "route": "cuda",
        "source": "src/repro_torch/csrc/spar_matvec.cu",
        "replaces": "src/repro/kernels/spar_cost/spar_cost.py:132",
        "launches": launches["spar_matvec"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib_ms})
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
    bound_ms, bound_by = bound(
        4 * (N_MAIN * N_MAIN * 2 + 5 * s_main),
        FUSED_OPS_PER_PAIR[problem.loss] * s_main * s_main)
    kernels.append({
        "name": "spar_cost_fused", "route": "cuda",
        "source": "src/repro_torch/csrc/spar_cost_fused.cu",
        "replaces": "src/repro/kernels/spar_cost/spar_cost.py:79",
        "launches": launches["spar_cost_fused"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None})
    del Cx, Cy
    torch.cuda.empty_cache()

    # gw_cost at 181⁴ on the grid main path's blocks and final coupling
    T_main = out_grid.coupling.block
    err = check(torch, "gw_cost main shape",
                gw_cost.gw_cost_cuda(CxR, CyC, T_main, loss=GRID_LOSS),
                gw_cost.gw_cost_plain(CxR, CyC, T_main, GRID_LOSS),
                gw_ref.gw_cost_error_scale(CxR, CyC, T_main, GRID_LOSS),
                rtol=GW_COST_RTOL)
    ms = time_ms(torch, lambda: gw_cost.gw_cost_cuda(CxR, CyC, T_main,
                                                     loss=GRID_LOSS), 50)
    plain_ms = time_ms(torch, lambda: gw_cost.gw_cost_plain(
        CxR, CyC, T_main, GRID_LOSS), 5, warmup=1)
    bound_ms, bound_by = bound(4 * 4 * side * side,
                               FUSED_OPS_PER_PAIR[GRID_LOSS] * side ** 4)
    kernels.append({
        "name": "gw_cost", "route": "cuda",
        "source": "src/repro_torch/csrc/gw_cost.cu",
        "replaces": "src/repro/kernels/gw_cost/gw_cost.py:58",
        "launches": grid_launches["gw_cost"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None})

    # both sinkhorn kernels at their paths' shapes, H = 50
    for variant, (sa, sb, sK, count, err) in sinkhorn_paths.items():
        m, n = sK.shape
        ms = time_ms(torch, lambda: sinkhorn.sinkhorn_cuda(
            sa, sb, sK, SINKHORN_ITERS), 20)
        plain_ms = time_ms(torch, lambda: sinkhorn.sinkhorn_plain(
            sa, sb, sK, SINKHORN_ITERS), 3, warmup=1)
        bound_ms, bound_by = bound(4 * (m + n + 2 * m * n),
                                   4 * m * n * SINKHORN_ITERS + 2 * m * n)
        kernels.append({
            "name": variant, "route": "cuda",
            "source": "src/repro_torch/csrc/sinkhorn_resident.cu",
            "replaces": "src/repro/kernels/sinkhorn/sinkhorn.py:44",
            "launches": count, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})

    # -- 8. where the time goes ---------------------------------------------
    print(json.dumps({"profile": {
        "grid": profile_solve(torch, lambda: repro_torch.solve(
            grid_problem, grid_solver, support=grid_support).value.item()),
        "spar_pallas": profile_solve(torch, lambda: repro_torch.solve(
            problem, forced, support=support).value.item())}}))

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
