#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --parent DIR

``--parent DIR`` (a checkout of an earlier commit) also times that
commit's dense Sinkhorn kernel (K4) in phase 8 on the same inputs against
this tree's, each tree in a child process of its own, in the order
parent, this tree, this tree, parent.

Phases; any failure raises and exits non-zero with no result line:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the CUDA kernels from src/repro_torch/csrc with nvcc (all
   sources at once) and print the build time and the ptxas report
   (registers of every kernel, spills of gw_cost and ssd_intra); check
   that the flash attention library's SASS holds HGMMA and the SSD
   library's HMMA (tensor cores);
3. hold each kernel against its plain PyTorch version at ragged shapes
   (the gather-fused kernel also on a support sorted by row, as the
   main path runs it; the dense Sinkhorn on each of its three routes);
4. drive the spar main path: ``repro_torch.solve`` with auto-selection
   on an n = 2048 Moon pair (spar_gw, s = 16n = 32768, cost_impl "auto"
   = the materialized matvec kernel), then the same support with the
   gather-fused kernel forced; both kernels must launch, both values be
   finite and healthy and agree; then a small solve on the card against
   the plain CPU path on the same support;
4b. drive the unbalanced spar path (Alg. 3): the same Moon pair with the
   second marginal times 1.5, λ = 1, ``SparGWSolver.default_config(2048)``
   once under cost_impl "auto" (the matvec kernel must launch 21 times)
   and once under "pallas" on the same support (the gather-fused kernel,
   21 times); the values agree, the solves are finite and healthy; then
   an n = 300 unbalanced solve on the card against the CPU path;
4c. drive ``dense_gw`` through the front door: ``repro_torch.solve``
   with no solver at n = 256 (balanced l2, balanced l1 with its chunked
   O(n⁴) cost, unbalanced l2); the route must be dense_gw; then an
   n = 48 solve on the card against the CPU path;
4d. drive ``lowrank_gw`` through the front door: ``repro_torch.solve``
   with no solver on examples/lowrank.py's n = 10 000 Gaussian clouds
   (d = 3, uniform weights, ``Geometry.from_points``); the route must be
   lowrank_gw with its anchor init, and the peak memory far below one
   n x n float32 matrix; then an n = 150 solve (20 outer steps) on the
   card against the CPU path on the same draws;
4e. drive ``quantized_gw`` through the front door: ``repro_torch.solve``
   with no solver on two 3-D Gaussian clouds as precomputed Euclidean
   distances (benchmarks/bench_multiscale.py's recipe): l2 at n = 8192
   (blocks 364 x 271 x 271) and l1 at n = 10 000 (400 x 300 x 300, the
   profile-cost branch); the route must be quantized_gw, the blocks of
   that shape, value and marginals finite and the status healthy; then
   examples/multiscale.py's n = 150, k = 75 problem polished (K1 6 times)
   and with a spar_gw base, each launching K1 and agreeing with the CPU
   on the same draws; then a persistent NaN on spar_gw at n = 300:
   ``on_failure="raise"`` raises, ``"fallback"`` recovers on the CPU
   port's rung;
5. drive the grid main path: ``repro_torch.solve`` with
   ``GridGWSolver.default_config(2048)`` (s_r = s_c = 181) and
   ``use_kernel=True`` on the same Moon pair with the l1 loss; the
   gw_cost kernel must launch 21 times (20 steps and the final value),
   the value be finite and healthy and agree with ``use_kernel=False``
   (the plain chunked contraction on the card) on the same support; then
   a small grid solve on the card against the CPU path;
6. drive the dense Sinkhorn's own entry point
   (``repro_torch.kernels.sinkhorn.ops.sinkhorn``) on the 181 x 181 K of
   the grid path's first stable=False prox step (the cluster route), on a
   2048 x 2048 K (the card route) and on a 3000 x 3000 K (the stream
   route); each must launch its route once;
7. drive the LM main path: zamba2-7b at its published widths, weights
   drawn on the card from a torch generator (the script imports no JAX).
   First one float32 ``Model.forward`` at reduced depth (1 superblock and
   the 3 tail layers) through the flash attention (K5) and SSD (K6)
   kernels, held against the same forward through their plain versions
   (K5 alone within 1e-4 of the largest logit, K5 and K6 within 12 x
   1e-4 for K6's 3xTF32 products), and a single-pass TF32 stand-in for
   K6 must miss that bound; the distances of both fp32 routes from one
   with K6's plain version in float64 are printed;
   then the full-depth (81 Mamba2 layers, 13 shared-block invocations)
   bfloat16 ``Model.prefill(..., use_flash=True)`` at B = 1, S = 4096: K5
   must launch 13 times and K6 81 times, the logits be finite; K5 is held
   against its plain version on the q, k, v of the first shared-block
   invocation; the prefill's wall time (median after a warm-up), tokens/s
   and peak memory;
8. time every kernel at its path's shapes against its plain version,
   its bound and, where one exists, one library call (K5 also at
   llama3-8b's attention shape); print each Sinkhorn route's CTAs,
   shared memory a CTA and barriers a call;
9. trace one grid solve, one spar solve (gather-fused), one unbalanced
   spar solve ("auto"), the low-rank solve cut to 3 outer steps and the
   n = 8192 quantized solve with its coarse solve cut to 1 outer step
   (both also timed once unprofiled), and one zamba2-7b prefill with
   ``torch.profiler`` and print each one's wall time, device-busy time,
   idle share and the kernels that take the most device time; then each
   phase's wall time.

The line before the last is the kernel JSON; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the JAX
package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_MAIN = 2048          # largest size select_solver routes to spar_gw
N_SMALL = 300          # card-vs-CPU agreement check
UGW_MASS_Y = 1.5       # the unbalanced pair's second marginal, times this
UGW_LAM = 1.0          # λ of the unbalanced main path
N_DENSE = 256          # largest size select_solver routes to dense_gw
N_DENSE_SMALL = 48     # dense card-vs-CPU agreement check
N_LOWRANK = 10_000     # examples/lowrank.py's large problem
N_LOWRANK_SMALL = 150  # low-rank card-vs-CPU agreement check
# the profile of phase 9 cuts the low-rank solve to this many outer steps
# (each step runs the same work: ~200 Dykstra iterations of ~150 launches;
# the full solve would give the profiler ~9 million kernel events)
LOWRANK_PROFILE_STEPS = 3
# quantized_gw's main path (benchmarks/bench_multiscale.py's 3-D Gaussian
# clouds as precomputed Euclidean distances): the largest size select_solver
# sends a precomputed l2 problem to quantized_gw, and the reference's n = 10k
# acceptance size on the profile-cost (l1) branch; the block shapes
# (pairs, cap_x, cap_y) their default sizing gives
N_QUANT_L2 = 8192
N_QUANT_L1 = 10_000
QUANT_BLOCKS = {"l2": (364, 271, 271), "l1": (400, 300, 300)}
N_QUANT_SMALL = 150    # examples/multiscale.py's problem, k = n/2: K1's path
QUANT_VALUE_RTOL = 1e-4   # card vs CPU, same draws (tests/test_torch_quantized)
# the profile of phase 9 cuts the quantized l2 solve's coarse dense solve
# to this many outer steps (each runs ~2000 inner iterations of ~25
# launches and a host read; the full solve took 50, ~99 000 iterations)
QUANT_PROFILE_OUTER = 1

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32
# (non-tensor-core) flop/s and dense bf16 tensor-core flop/s. The GW
# kernels' work is fp32 FMAs and gathers; flash attention on bf16 inputs is
# bounded by the bf16 peak, whatever the kernel computes in
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

# fp32 operations per (k, l) pair of the fused kernel: the loss plus the
# FMA (2). l1: sub, abs; l2: sub, mul; kl: 2 max, 2 log, sub, mul, sub, add
# (the same counts per (k, l, m, p) evaluation of the gw_cost kernel)
FUSED_OPS_PER_PAIR = {"l1": 4, "l2": 4, "kl": 10}
GRID_LOSS = "l1"       # the loss that reaches the gw_cost kernel
SINKHORN_ITERS = 50    # H of the grid path's inner loop
N_SINKHORN_LARGE = 2048   # the reference's above-its-VMEM-gate shape
N_SINKHORN_STREAM = 3000  # 36 MB: above the card's shared memory

# kernel-vs-plain: a lane adds s/32 terms in sequence and the warp 5 more
# levels; two correct fp32 sums differ by at most (s/32 + 5)·2^-24 of the
# error scale (6.1e-5 at s = 32768)
KERNEL_RTOL = 1e-4
# the two impls on one support: same math, other summation order, carried
# through 20 outer x 50 inner iterations
IMPL_VALUE_RTOL = 1e-4
# card vs CPU on one support: index_add_ on the card sums with atomics
SMALL_VALUE_RTOL = 1e-4
# gw_cost kernel-vs-plain: a thread adds ceil(L/S)·ceil(P/warps) terms in
# sequence (S ranges of l over blocks, one range of p per warp), the block
# `warps` more in warp order and the split sum S more: (17·23 + 8 + 11)·2^-24
# = 2.4e-5 at 181⁴ (S = 11 on 132 SMs); 2e-4 also covers the plain
# version's matvec order
GW_COST_RTOL = 2e-4
# sinkhorn kernel-vs-plain: both flush the same subnormals and differ only
# in each matvec's summation order; rtol 1e-4 plus 1e-6 of the largest
# coupling entry
SINKHORN_RTOL, SINKHORN_ATOL_REL = 1e-4, 1e-6
# flash attention kernel-vs-plain (float32 plain on the same inputs): a
# score sums hd products and an output up to S terms, on each side, so
# |err| <= 2·(S + hd^1.5)·2^-24 of Σ_t p_st·|v_t| (hd^1.5 bounds the
# score's error scale for unit inputs); bf16 adds the output's rounding,
# 2^-8 of |plain| (twice the half ulp), and the rounding of P to bf16 for
# the tensor cores' PV product: each p_st is off by at most 2^-9 of itself
# (half a bf16 ulp) while l sums the unrounded p, so the output moves by at
# most 2^-9·Σ_t p_st·|v_t|; the bound takes twice that, 2^-8 of the scale
BF16_OUT_RTOL = 2.0 ** -8
BF16_P_RTOL = 2.0 ** -8


def attention_rtol(S: int, hd: int) -> float:
    return 2 * (S + hd ** 1.5) * 2.0 ** -24


# SSD kernel-vs-plain: a Gram entry sums N products and an output k terms,
# on each side: |err| <= 2·(k + N + 8)·2^-24 of the output over |terms|; the
# kernel's 3xTF32 products (each within 12·2^-24 of |a||b|, rounded once
# per 8 terms and split term) fit the same bound
def ssd_rtol(k: int, N: int) -> float:
    return 2 * (k + N + 8) * 2.0 ** -24


# the LM main path: zamba2-7b prefill at train_4k's sequence length
LM_ARCH, LM_BATCH, LM_SEQ = "zamba2_7b", 1, 4096
LM_PREFILL_REPS = 3
# full-width, reduced-depth fp32 forward, kernels vs plain versions, in
# max |difference| over the plain route's largest logit. The routes differ
# only in K5's and K6's arithmetic, carried through 10 blocks; the CPU
# parity tests hold the whole stack to 1e-4 of the largest logit, and so
# does this for fp32 arithmetic (2^-24 a product): K5 alone is held to it.
# K6 takes its products as 3xTF32, each within 12·2^-24 of |a||b| (the
# dropped lo·lo term and the rounding of both lo parts: 3·2^-22), so the
# route through K6 is held to 12 x 1e-4. Single-pass TF32 (2^-11 a
# product, 8192·2^-24) must miss that bound: a stand-in for it takes K6's
# place on the plain route and is held to fail
LM_LOGIT_REL = 1e-4
LM_LOGIT_REL_3XTF32 = 12 * LM_LOGIT_REL


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


def bound(bytes_moved: float, ops: float, peak: float = FP32_FLOPS) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over ``peak`` (the fp32 peak unless given), and which of the
    two it is."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / peak
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
    """Raise unless a solve's value and coupling (the COO values, the grid
    block or the dense matrix) are finite, of the expected shape, and its
    status healthy."""
    vals = out.coupling[2] if isinstance(out.coupling, tuple) else out.coupling
    if not (math.isfinite(float(out.value)) and bool(vals.isfinite().all())
            and tuple(vals.shape) == shape):
        raise AssertionError(f"{name}: non-finite or misshapen output")
    if not out.status.is_healthy:
        raise AssertionError(f"{name}: status {out.status}")


def agree(name, on_card, on_cpu):
    """Raise unless a solve on the card and the same solve on the CPU give
    a finite value within SMALL_VALUE_RTOL, one status, one step count."""
    vc, vp = float(on_card.value), float(on_cpu.value)
    if not (math.isfinite(vc) and on_card.status.code == on_cpu.status.code
            and on_card.n_iters == on_cpu.n_iters
            and abs(vc - vp) <= SMALL_VALUE_RTOL * abs(vp)):
        raise AssertionError(f"{name}: card {vc} {on_card.status} vs CPU "
                             f"{vp} {on_cpu.status}")


def gaussian_clouds(repro_torch, n: int, seed: int):
    """examples/lowrank.py's problem: two standard Gaussian clouds in 3-D
    with uniform weights, as point-cloud geometries (on the CPU)."""
    rng = np.random.default_rng(seed)
    w = np.full(n, 1.0 / n, np.float32)
    return repro_torch.QuadraticProblem(
        repro_torch.Geometry.from_points(
            rng.standard_normal((n, 3)).astype(np.float32), w),
        repro_torch.Geometry.from_points(
            rng.standard_normal((n, 3)).astype(np.float32), w))


def cloud_dists(seed: int, n: int, d: int = 3, chunk: int = 2048):
    """benchmarks/bench_multiscale.py's (n, n) float32 Euclidean distance
    matrix of a standard Gaussian cloud in d dimensions, built in row
    chunks (no n² float64 array)."""
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    sq = (x ** 2).sum(1)
    D = np.empty((n, n), np.float32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        g = sq[lo:hi, None] + sq[None, :] - 2.0 * (x[lo:hi] @ x.T)
        D[lo:hi] = np.sqrt(np.maximum(g, 0.0))
    return D


def cloud_problem(repro_torch, n: int, loss: str = "l2"):
    """Two such clouds (seeds 0 and 1), uniform weights, on the CPU."""
    w = np.full(n, 1.0 / n, np.float32)
    return repro_torch.QuadraticProblem(
        repro_torch.Geometry(cloud_dists(0, n), w),
        repro_torch.Geometry(cloud_dists(1, n), w), loss=loss)


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


def leaves(tree) -> list:
    """The tensors of a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def sinkhorn_ms(torch, sinkhorn, inputs: dict) -> dict:
    """Device ms of ``sinkhorn.sinkhorn_cuda`` on each {name: (a, b, K)}."""
    return {name: time_ms(torch, lambda: sinkhorn.sinkhorn_cuda(
        a, b, K, SINKHORN_ITERS), 20) for name, (a, b, K) in inputs.items()}


def time_sinkhorn_child(inputs_path: str, src: str) -> int:
    """``--time-sinkhorn FILE --src DIR``: time the Sinkhorn kernel of the
    package under DIR on the inputs saved in FILE; one JSON line."""
    import torch

    sys.path.insert(0, src)
    from repro_torch.kernels.sinkhorn import sinkhorn

    inputs = {name: tuple(x.cuda() for x in abK)
              for name, abK in torch.load(inputs_path).items()}
    print(json.dumps(sinkhorn_ms(torch, sinkhorn, inputs)))
    return 0


def tree_sinkhorn_ms(tree: Path, inputs_path: Path) -> dict:
    """:func:`sinkhorn_ms` of the checkout at ``tree``, in a child process
    (two trees' packages are both named repro_torch)."""
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--time-sinkhorn",
         str(inputs_path), "--src", str(tree / "src")],
        capture_output=True, text=True, check=True, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(parent: Path | None = None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.api import solvers
    from repro_torch.api.solvers import (
        DenseGWSolver,
        GridGWSolver,
        SparGWSolver,
    )
    from repro_torch.configs import get_arch, scale_down
    from repro_torch.core.grid_gw import grid_cost
    from repro_torch.core.utils import flush_subnormal
    from repro_torch.kernels import cuda_lib, dispatch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_error_scale
    from repro_torch.kernels.gw_cost import gw_cost
    from repro_torch.kernels.gw_cost import ref as gw_ref
    from repro_torch.kernels.sinkhorn import ops as sinkhorn_ops
    from repro_torch.kernels.sinkhorn import sinkhorn
    from repro_torch.kernels.spar_cost import ops, ref, spar_cost
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.ssd.ref import ssd_intra_error_scale
    from repro_torch.lowrank import solver as lowrank_solver
    from repro_torch.lowrank.init import LowRankDraws
    from repro_torch.core import sampling
    from repro_torch.core import sinkhorn as sinkhorn_loops
    from repro_torch.health import FaultSpec, SolveDivergedError
    from repro_torch.lowrank.solver import LowRankGWSolver
    from repro_torch.multiscale import (
        QuantizedDraws,
        QuantizedGWSolver,
        compress_problem,
        select_anchors,
    )
    from repro_torch.multiscale.anchors import draw_anchors, draw_start
    from repro_torch.models import Model
    from repro_torch.models import ssm as ssm_mod

    dev = torch.device("cuda")

    # -- 1. the card -------------------------------------------------------
    stamps = [("1", time.perf_counter())]    # (phase, its start), host clock
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- 2. build ----------------------------------------------------------
    stamps.append(("2", time.perf_counter()))
    t0 = time.perf_counter()
    reports = cuda_lib.build(["spar_matvec", "spar_cost_fused", "gw_cost",
                              "sinkhorn", "flash_attention", "ssd_intra"])
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(reports) or 'already built'})")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Compiling" in line or "registers" in line or (
                    "spill" in line and name in ("gw_cost", "ssd_intra")):
                print(f"  {name}: {line.strip()}")

    # the bf16 attention kernel must run on the tensor cores (wgmma), the
    # SSD kernel's products on them too (mma.sync TF32)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name, op in (("flash_attention", "HGMMA"), ("ssd_intra", "HMMA")):
        sass = subprocess.run([cuobjdump, "-sass",
                               str(cuda_lib.library_path(name))],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        n_op = sass.count(op)
        if not n_op:
            raise AssertionError(f"{name}: no {op} in the library's SASS")
        print(f"{name} SASS: {n_op} {op} instructions")

    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, lo=0.0):
        return torch.rand(*shape, generator=gen, device=dev) + lo

    # -- 3. kernels vs plain versions at ragged shapes ---------------------
    stamps.append(("3", time.perf_counter()))
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
    perm, rows_s, cols_s = ops.sort_support(rows, cols)
    for loss in ("l1", "l2", "kl"):
        want = spar_cost.spar_cost_plain(Cx, Cy, rows, cols, t, off, loss)
        scale = ref.spar_cost_error_scale(Cx, Cy, rows, cols, t, off, loss)
        check(torch, f"spar_cost_fused {loss} s=3001",
              spar_cost.spar_cost_cuda(Cx, Cy, rows.int(), cols.int(), t, off,
                                       loss=loss), want, scale)
        check(torch, f"spar_cost_fused {loss} s=3001 sorted by row",
              spar_cost.launch_fused(Cx, Cy, rows_s.int(), cols_s.int(),
                                     t[perm], off, loss, 256,
                                     perm=perm.int()), want, scale)
    del L, Cx, Cy
    A, B = rand(177, 93, lo=0.05), rand(131, 205, lo=0.05)
    Tg = rand(93, 205)
    for loss in ("l1", "l2", "kl"):
        check(torch, f"gw_cost {loss} 177x93x131x205",
              gw_cost.gw_cost_cuda(A, B, Tg, loss=loss),
              gw_cost.gw_cost_plain(A, B, Tg, loss),
              gw_ref.gw_cost_error_scale(A, B, Tg, loss), rtol=GW_COST_RTOL)
    for m, n, variant in ((150, 173, "sinkhorn_cluster"),
                          (700, 690, "sinkhorn_cluster"),
                          (16, 2001, "sinkhorn_cluster"),     # 8 CTAs
                          (1531, 1201, "sinkhorn_card"),
                          (3001, 2999, "sinkhorn_stream")):
        a, b = rand(m, lo=0.1), rand(n, lo=0.1)
        Kr = torch.exp(-3.0 * rand(m, n))
        sinkhorn.reset_launch_counts()
        got = sinkhorn.sinkhorn_cuda(a / a.sum(), b / b.sum(), Kr, 30)
        if sinkhorn.LAUNCHES[variant] != 1:
            raise AssertionError(f"{m}x{n} did not run {variant}: "
                                 f"{sinkhorn.LAUNCHES}")
        check_coupling(torch, f"{variant} {m}x{n}", got,
                       sinkhorn.sinkhorn_plain(a / a.sum(), b / b.sum(), Kr,
                                               30))

    def check_attention(name, q, k, v, groups):
        """K5 against its plain version in float32 on the same inputs, on
        the flattened (B·H, S, hd) layout with B = 1; max abs error."""
        got = fa.flash_attention_cuda(q, k, v, groups=groups).float()
        q32, k32, v32 = q.float(), k.float(), v.float()
        want = fa.flash_attention_plain(q32, k32, v32, groups)
        S, hd = q.shape[1], q.shape[2]
        scale = attention_error_scale(q32.transpose(0, 1)[None],
                                      k32.transpose(0, 1)[None],
                                      v32.transpose(0, 1)[None])
        scale = scale[0].transpose(0, 1)
        tol = attention_rtol(S, hd) * scale
        if q.dtype == torch.bfloat16:
            tol = tol + BF16_OUT_RTOL * want.abs() + BF16_P_RTOL * scale
        torch.cuda.synchronize()
        err = (got - want).abs()
        if not bool(torch.all(err <= tol)):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version: max abs err {float(err.max()):.3g}")
        return float(err.max())

    def check_ssd(name, xdt, cs, Bm, Cm):
        got = ssd.ssd_intra_cuda(xdt, cs, Bm, Cm)
        return check(torch, name, got, ssd.ssd_intra_plain(xdt, cs, Bm, Cm),
                     ssd_intra_error_scale(xdt, cs, Bm, Cm),
                     rtol=ssd_rtol(xdt.shape[1], Bm.shape[-1]))

    def normal(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    for hd in (112, 128):                 # S = 1000: a ragged last tile
        for dtype in (torch.float32, torch.bfloat16):
            check_attention(f"flash_attention S=1000 hd={hd} G=4 {dtype}",
                            normal(8, 1000, hd, dtype=dtype),
                            normal(2, 1000, hd, dtype=dtype),
                            normal(2, 1000, hd, dtype=dtype), 4)
    check_ssd("ssd_intra G=5 H=12", normal(5, 128, 12, 64),
              -torch.cumsum(rand(5, 128, 12), dim=1), normal(5, 128, 64),
              normal(5, 128, 64))
    # the 4-byte load route: P = 100 (two units of columns), xdt 4 bytes
    # past a 16-byte boundary, H = 17 ragged against the head tile of 14
    x_off = normal(3 * 120 * 17 * 100 + 1)[1:].view(3, 120, 17, 100)
    if ssd.load_route(x_off) != "4-byte":
        raise AssertionError("ssd_intra: expected the 4-byte load route")
    check_ssd("ssd_intra G=3 k=120 H=17 P=100 unaligned", x_off,
              -torch.cumsum(rand(3, 120, 17), dim=1), normal(3, 120, 40),
              normal(3, 120, 40))
    print("kernel checks at ragged shapes: ok")

    # -- 4. the main path --------------------------------------------------
    stamps.append(("4", time.perf_counter()))
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
        agree(f"small solve ({impl})", on_card, on_cpu)
    print(f"small solve n={N_SMALL}: card agrees with CPU (value rtol "
          f"{SMALL_VALUE_RTOL})")

    # -- 4b. the unbalanced spar path (Alg. 3) ------------------------------
    stamps.append(("4b", time.perf_counter()))
    ugw_problem = repro_torch.QuadraticProblem(
        repro_torch.Geometry(Cx_np, a_np),
        repro_torch.Geometry(Cy_np, UGW_MASS_Y * b_np), lam=UGW_LAM)
    ugw_solver = SparGWSolver.default_config(N_MAIN)
    if ops.resolve_impl(ugw_solver.cost_impl, ugw_solver.s, dev) \
            != "materialized":
        raise AssertionError(f"unbalanced path: {ugw_solver} does not "
                             f"resolve to the matvec kernel")
    ugw_runs, ugw_support = {}, None
    for impl, kernel in (("auto", "spar_matvec"),
                         ("pallas", "spar_cost_fused")):
        solver = dataclasses.replace(ugw_solver, cost_impl=impl)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        spar_cost.reset_launch_counts()
        t0 = time.perf_counter()
        out = repro_torch.solve(ugw_problem, solver, support=ugw_support,
                                generator=torch.Generator(dev).manual_seed(0))
        value = float(out.value)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(spar_cost.LAUNCHES)
        check_solve(f"unbalanced path ({impl})", out, (ugw_solver.s,))
        if counts[kernel] != ugw_solver.outer_iters + 1 or sum(
                counts.values()) != counts[kernel]:
            raise AssertionError(f"unbalanced path ({impl}): launches "
                                 f"{counts}, expected {kernel} "
                                 f"{ugw_solver.outer_iters + 1} times")
        ugw_support = (out.coupling.rows, out.coupling.cols)
        ugw_runs[impl] = {
            "value": value, "status": out.status.describe(),
            "n_iters": out.n_iters, "last_marginal_err": out.status.last_err,
            "mass": float(out.coupling.vals.sum()), "wall_s": wall,
            "peak_memory_gib_above_start": (
                torch.cuda.max_memory_allocated() - base_bytes) / 2**30,
            "launches": counts}
    ugw_launches = {
        "spar_matvec": ugw_runs["auto"]["launches"]["spar_matvec"],
        "spar_cost_fused": ugw_runs["pallas"]["launches"]["spar_cost_fused"]}
    v_auto, v_fused = ugw_runs["auto"]["value"], ugw_runs["pallas"]["value"]
    if abs(v_auto - v_fused) > IMPL_VALUE_RTOL * abs(v_auto):
        raise AssertionError(f"unbalanced path: impls disagree: {v_auto} vs "
                             f"{v_fused}")
    print(json.dumps({"unbalanced_path": {
        "n": N_MAIN, "s": ugw_solver.s, "loss": ugw_problem.loss,
        "lam": UGW_LAM, "mass_x": float(a_np.sum()),
        "mass_y": float(UGW_MASS_Y * b_np.sum()), **ugw_runs}}))

    small_ugw = repro_torch.QuadraticProblem(
        small.geom_x, repro_torch.Geometry(sy, UGW_MASS_Y * sb), lam=UGW_LAM)
    solver = SparGWSolver.default_config(N_SMALL)
    on_card = repro_torch.solve(small_ugw, solver,
                                generator=torch.Generator(dev).manual_seed(1))
    on_cpu = repro_torch.solve(
        small_ugw, solver, device="cpu",
        support=(on_card.coupling.rows.cpu(), on_card.coupling.cols.cpu()))
    agree("small unbalanced solve", on_card, on_cpu)
    print(f"small unbalanced solve n={N_SMALL}: card agrees with CPU "
          f"(value rtol {SMALL_VALUE_RTOL})")

    # -- 4c. dense_gw through the front door --------------------------------
    stamps.append(("4c", time.perf_counter()))
    dx, da, dy, db = moon(N_DENSE, seed=2)
    dense_runs = {}
    for name, loss, lam in (("l2", "l2", None), ("l1", "l1", None),
                            ("l2_unbalanced", "l2", UGW_LAM)):
        dp = repro_torch.QuadraticProblem(
            repro_torch.Geometry(dx, da),
            repro_torch.Geometry(dy, db if lam is None else UGW_MASS_Y * db),
            loss=loss, lam=lam)
        if not isinstance(repro_torch.select_solver(dp), DenseGWSolver):
            raise AssertionError(f"dense {name}: auto-selection gave "
                                 f"{repro_torch.select_solver(dp)}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = repro_torch.solve(dp)
        value = float(out.value)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_solve(f"dense {name}", out, (N_DENSE, N_DENSE))
        dense_runs[name] = {
            "value": value, "status": out.status.describe(),
            "n_iters": out.n_iters, "last_marginal_err": out.status.last_err,
            "wall_s": wall, "peak_memory_gib_above_start": (
                torch.cuda.max_memory_allocated() - base_bytes) / 2**30}
    print(json.dumps({"dense_path": {"n": N_DENSE, **dense_runs}}))
    dx, da, dy, db = moon(N_DENSE_SMALL, seed=3)
    for loss in ("l2", "l1"):
        dp = repro_torch.QuadraticProblem(repro_torch.Geometry(dx, da),
                                          repro_torch.Geometry(dy, db),
                                          loss=loss)
        agree(f"small dense solve {loss}", repro_torch.solve(dp),
              repro_torch.solve(dp, device="cpu"))
    print(f"small dense solve n={N_DENSE_SMALL}: card agrees with CPU "
          f"(value rtol {SMALL_VALUE_RTOL})")

    # -- 4d. lowrank_gw through the front door ------------------------------
    stamps.append(("4d", time.perf_counter()))
    lr_problem = gaussian_clouds(repro_torch, N_LOWRANK, seed=0)
    lr_solver = repro_torch.select_solver(lr_problem)
    if not (isinstance(lr_solver, LowRankGWSolver)
            and lr_solver.init == "anchors"):
        raise AssertionError(f"lowrank: auto-selection gave {lr_solver}")
    anchor_inits = []
    real_anchor_init = lowrank_solver.anchor_init

    def counted_anchor_init(*args, **kw):
        anchor_inits.append(1)
        return real_anchor_init(*args, **kw)

    lowrank_solver.anchor_init = counted_anchor_init
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out_lr = repro_torch.solve(lr_problem,
                               generator=torch.Generator(dev).manual_seed(0))
    v_lr = float(out_lr.value)
    torch.cuda.synchronize()
    wall_lr = time.perf_counter() - t0
    lowrank_solver.anchor_init = real_anchor_init
    lr_peak = torch.cuda.max_memory_allocated() - base_bytes
    mu, nu = out_lr.coupling.marginals()
    lr_err = float((mu - lr_problem.geom_x.weights.to(dev)).abs().sum()
                   + (nu - lr_problem.geom_y.weights.to(dev)).abs().sum())
    if not (math.isfinite(v_lr) and out_lr.status.is_healthy
            and all(bool(x.isfinite().all()) for x in out_lr.coupling)):
        raise AssertionError(f"lowrank: value {v_lr} {out_lr.status}")
    if anchor_inits != [1]:
        raise AssertionError("lowrank: the anchor init did not run once")
    if lr_peak >= N_LOWRANK * N_LOWRANK * 4 / 10:
        raise AssertionError(f"lowrank: peak {lr_peak} bytes above the start "
                             f"is not far below one n x n matrix")
    print(json.dumps({"lowrank_path": {
        "n": N_LOWRANK, "d": 3, "rank": out_lr.coupling.rank,
        "value": v_lr, "status": out_lr.status.describe(),
        "n_iters": out_lr.n_iters, "marginal_err": lr_err, "wall_s": wall_lr,
        "peak_memory_mib_above_start": lr_peak / 2**20,
        "n_by_n_float32_mib": N_LOWRANK * N_LOWRANK * 4 / 2**20}}))

    lr_small = gaussian_clouds(repro_torch, N_LOWRANK_SMALL, seed=1)
    lr_gen = torch.Generator(dev).manual_seed(2)
    lr_draws = LowRankDraws(
        start_x=draw_start(lr_gen, lr_small.geom_x.weights.to(dev)),
        start_y=draw_start(lr_gen, lr_small.geom_y.weights.to(dev)))
    solver = LowRankGWSolver(outer_iters=20, tol=0.0)
    agree("small lowrank solve", repro_torch.solve(lr_small, solver,
                                                   draws=lr_draws),
          repro_torch.solve(lr_small, solver, device="cpu", draws=LowRankDraws(
              *(None if x is None else x.cpu() for x in lr_draws))))
    print(f"small lowrank solve n={N_LOWRANK_SMALL} (20 outer steps): card "
          f"agrees with CPU (value rtol {SMALL_VALUE_RTOL})")
    del out_lr, mu, nu
    torch.cuda.empty_cache()

    # -- 4e. quantized_gw through the front door ----------------------------
    stamps.append(("4e", time.perf_counter()))
    quant_runs, quant_problem = {}, None
    # count the scaling iterations of the dense (tol-stopped) Sinkhorn
    # loops: the coarse solve's inner loops, one host read each
    real_scaling_loop = sinkhorn_loops._scaling_loop
    scaling_iters = []

    def counted_scaling_loop(body, init, iters, tol):
        def counted(carry):
            scaling_iters.append(1)
            return body(carry)
        return real_scaling_loop(counted, init, iters, tol)

    sinkhorn_loops._scaling_loop = counted_scaling_loop
    for loss, n_q in (("l2", N_QUANT_L2), ("l1", N_QUANT_L1)):
        qp = cloud_problem(repro_torch, n_q, loss)
        if repro_torch.select_solver(qp) != QuantizedGWSolver():
            raise AssertionError(f"quantized {loss}: auto-selection gave "
                                 f"{repro_torch.select_solver(qp)}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        scaling_iters.clear()
        t0 = time.perf_counter()
        out = repro_torch.solve(qp, generator=torch.Generator(dev).manual_seed(0))
        value = float(out.value)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base_bytes
        blocks = out.coupling.blocks
        mu, nu = out.coupling.marginals(n_q, n_q)
        w = qp.geom_x.weights.to(dev)
        q_err = float((mu - w).abs().sum() + (nu - w).abs().sum())
        if tuple(blocks.shape) != QUANT_BLOCKS[loss]:
            raise AssertionError(f"quantized {loss}: blocks {blocks.shape}, "
                                 f"expected {QUANT_BLOCKS[loss]}")
        if not (math.isfinite(value) and out.status.is_healthy
                and bool(blocks.isfinite().all()) and math.isfinite(q_err)):
            raise AssertionError(f"quantized {loss}: value {value} "
                                 f"{out.status}, marginal err {q_err}")
        quant_runs[loss] = {
            "n": n_q, "blocks": list(blocks.shape), "value": value,
            "status": out.status.describe(), "n_iters": out.n_iters,
            "marginal_err": q_err, "mass": float(blocks.sum()),
            "dense_sinkhorn_iterations": len(scaling_iters),
            "wall_s": wall, "peak_memory_mib_above_start": peak / 2**20}
        if loss == "l2":
            quant_problem = qp
        del out, blocks, mu, nu
        torch.cuda.empty_cache()
    sinkhorn_loops._scaling_loop = real_scaling_loop
    print(json.dumps({"quantized_path": quant_runs}))

    # K1 on this path: examples/multiscale.py's problem (n = 150, k = n/2)
    # polished (5 steps and the value on the 300 x 8 x 8 support), and with
    # a spar_gw base (K1 in the coarse solve as well); the card against the
    # CPU on the same draws
    qsmall = cloud_problem(repro_torch, N_QUANT_SMALL)
    k_q = N_QUANT_SMALL // 2
    polished = QuantizedGWSolver(k_x=k_q, k_y=k_q)
    spar_based = QuantizedGWSolver(k_x=k_q, k_y=k_q, base=SparGWSolver(
        tol=1e-6, inner_tol=1e-8))
    qgen = torch.Generator(dev).manual_seed(3)
    qs_dev = qsmall.to(dev)
    starts = [draw_anchors(qgen, g.weights, k_q)
              for g in (qs_dev.geom_x, qs_dev.geom_y)]
    coarse = compress_problem(qs_dev, *(
        select_anchors(st, g.cost, g.weights, k_q)
        for st, g in zip(starts, (qs_dev.geom_x, qs_dev.geom_y))))
    sized = spar_based._sized_base(k_q, k_q)
    base_support = sampling.sample_pairs(qgen, sampling.balanced_probs(
        coarse.geom_x.weights, coarse.geom_y.weights, sized.shrink), sized.s)
    quant_launches, quant_small = {}, {}
    for name, solver, draws in (
            ("polished", polished, QuantizedDraws(*starts)),
            ("spar_base", spar_based, QuantizedDraws(*starts, base_support))):
        spar_cost.reset_launch_counts()
        on_card = repro_torch.solve(qsmall, solver, draws=draws)
        vc = float(on_card.value)
        torch.cuda.synchronize()
        quant_launches[name] = dict(spar_cost.LAUNCHES)
        on_cpu = repro_torch.solve(qsmall, solver, device="cpu",
                                   draws=QuantizedDraws(
                                       *(x.cpu() for x in starts),
                                       None if draws.base is None else
                                       tuple(x.cpu() for x in draws.base)))
        vp = float(on_cpu.value)
        if quant_launches[name]["spar_matvec"] <= 0:
            raise AssertionError(f"quantized {name}: K1 never launched")
        if (name == "polished" and on_card.status.n_rescues == 0
                and quant_launches[name]["spar_matvec"] != 6):
            raise AssertionError(f"quantized polished: K1 launched "
                                 f"{quant_launches[name]} times, expected 6")
        if not (math.isfinite(vc) and on_card.status.is_healthy
                and on_card.status.code == on_cpu.status.code
                and abs(vc - vp) <= QUANT_VALUE_RTOL * abs(vp)):
            raise AssertionError(f"quantized {name}: card {vc} "
                                 f"{on_card.status} vs CPU {vp} "
                                 f"{on_cpu.status}")
        # the refined pairs in order, and as a set (equal coarse masses
        # may come out of the card's atomics in another order)
        keys = [c.pair_rows.cpu() * k_q + c.pair_cols.cpu()
                for c in (on_card.coupling, on_cpu.coupling)]
        quant_small[name] = {
            "value_card": vc, "value_cpu": vp,
            "status": on_card.status.describe(),
            "same_pair_order": torch.equal(*keys),
            "same_pair_set": torch.equal(*(k.sort().values for k in keys)),
            "launches": quant_launches[name]}
    print(json.dumps({"quantized_small": {"n": N_QUANT_SMALL, "k": k_q,
                                          **quant_small}}))
    print(f"small quantized solves n={N_QUANT_SMALL}: card agrees with CPU "
          f"(value rtol {QUANT_VALUE_RTOL})")

    # the failure path: a persistent NaN on spar_gw; "raise" raises, and
    # "fallback" recovers on the rung the CPU port recovers on (a fused
    # problem, so the ladder is quantized -> dense)
    fcx, fwx, fcy, fwy = moon(N_SMALL, seed=4)
    fused = repro_torch.QuadraticProblem(
        repro_torch.Geometry(fcx, fwx), repro_torch.Geometry(fcy, fwy),
        M=np.random.default_rng(4).random((N_SMALL, N_SMALL)).astype(
            np.float32), fused_penalty=0.6)
    faulted = SparGWSolver(s=16 * N_SMALL, max_rescues=0, fault=FaultSpec(
        at_iter=1, kind="nan", persistent=True))
    try:
        repro_torch.solve(fused, faulted, torch.Generator(dev).manual_seed(5),
                          on_failure="raise")
        raise AssertionError("on_failure='raise' did not raise")
    except SolveDivergedError as exc:
        if not exc.output.status.is_diverged:
            raise AssertionError(f"raised with {exc.output.status}") from exc
    rungs = {}
    for where, fgen in (("card", torch.Generator(dev).manual_seed(5)),
                       ("cpu", torch.Generator().manual_seed(5))):
        out = repro_torch.solve(fused, faulted, fgen, on_failure="fallback",
                                device=None if where == "card" else "cpu")
        if not (out.status.is_healthy and math.isfinite(float(out.value))):
            raise AssertionError(f"fallback on the {where}: {out.status}")
        rungs[where] = type(out.coupling).__name__
    if rungs["card"] != rungs["cpu"]:
        raise AssertionError(f"fallback rungs differ: {rungs}")
    print(json.dumps({"failure_path": {"n": N_SMALL, "raise": "raised",
                                       "fallback_rung": rungs}}))

    # -- 5. the grid main path ---------------------------------------------
    stamps.append(("5", time.perf_counter()))
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
    agree("small grid solve", on_card, on_cpu)
    print(f"small grid solve n={N_SMALL} side={small_solver.s_r}: card "
          f"agrees with CPU (value rtol {SMALL_VALUE_RTOL})")

    # -- 6. the dense Sinkhorn's own entry point ------------------------------
    stamps.append(("6", time.perf_counter()))
    # K of the grid path's first stable=False prox step on the main support
    R, C = grid_support
    CxR, CyC, aR, bC, w = solvers._grid_block_data(grid_problem.to(dev), R,
                                                   C, grid_solver.shrink)
    T0 = flush_subnormal(aR[:, None] * bC[None, :])
    K_step = solvers._plain_kernel(
        grid_cost(CxR, CyC, T0, GRID_LOSS, use_kernel=True), w, T0,
        grid_solver.epsilon, "prox").contiguous()
    a_big = torch.full((N_SINKHORN_LARGE,), 1.0 / N_SINKHORN_LARGE,
                       device=dev)
    K_big = torch.exp(-3.0 * rand(N_SINKHORN_LARGE, N_SINKHORN_LARGE))
    a_huge = torch.full((N_SINKHORN_STREAM,), 1.0 / N_SINKHORN_STREAM,
                        device=dev)
    K_huge = torch.exp(-3.0 * rand(N_SINKHORN_STREAM, N_SINKHORN_STREAM))
    sinkhorn_paths = {}
    for variant, (sa, sb, sK) in (("sinkhorn_cluster", (aR, bC, K_step)),
                                  ("sinkhorn_card", (a_big, a_big, K_big)),
                                  ("sinkhorn_stream",
                                   (a_huge, a_huge, K_huge))):
        torch.cuda.synchronize()
        sinkhorn.reset_launch_counts()
        T_k = sinkhorn_ops.sinkhorn(sa, sb, sK, iters=SINKHORN_ITERS)
        torch.cuda.synchronize()
        counts = dict(sinkhorn.LAUNCHES)
        if counts != {**{k: 0 for k in counts}, variant: 1}:
            raise AssertionError(f"sinkhorn path {tuple(sK.shape)}: "
                                 f"launches {counts}, expected {variant}")
        if not bool(T_k.isfinite().all()):
            raise AssertionError(f"{variant}: non-finite coupling")
        err = check_coupling(torch, f"{variant} {tuple(sK.shape)}", T_k,
                             sinkhorn.sinkhorn_plain(sa, sb, sK,
                                                     SINKHORN_ITERS))
        sinkhorn_paths[variant] = (sa, sb, sK, counts[variant], err)
    print(f"sinkhorn entry point: {side}x{side} K of the first prox step "
          f"-> sinkhorn_cluster, {N_SINKHORN_LARGE}x{N_SINKHORN_LARGE} -> "
          f"sinkhorn_card, {N_SINKHORN_STREAM}x{N_SINKHORN_STREAM} -> "
          f"sinkhorn_stream; all agree with the plain loop")

    # -- 7. the LM main path: zamba2-7b ------------------------------------
    stamps.append(("7", time.perf_counter()))
    torch.cuda.empty_cache()
    held_gib = torch.cuda.memory_allocated() / 2**30   # earlier phases' tensors
    cfg = get_arch(LM_ARCH)
    model = Model(cfg)
    lm_gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(lm_gen, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                           generator=lm_gen, device=dev)

    def lm_counts():
        torch.cuda.synchronize()
        return {"flash_attention": fa.LAUNCHES["flash_attention"],
                "ssd_intra": ssd.LAUNCHES["ssd_intra"]}

    def reset_lm_counts():
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        ssd.reset_launch_counts()

    # full width, reduced depth, float32: kernels against plain versions
    short_cfg = scale_down(cfg, n_superblocks=1,
                           n_layers=len(cfg.block_pattern)
                           + len(cfg.tail_blocks))
    short = Model(short_cfg)
    short_params = {**params, "blocks": params["blocks"][:1]}
    plain_ssd = ssm_mod.ssd_intra_ref

    def short_logits(use_kernel, k6=None):
        """the reduced-depth fp32 forward's logits; k6, if given, takes the
        place of K6 (use_kernel) or of its plain version for this run"""
        name = "ssd_intra" if use_kernel else "ssd_intra_ref"
        saved = getattr(ssm_mod, name)
        setattr(ssm_mod, name, k6 or saved)
        try:
            return short.forward(short_params, tokens,
                                 act_dtype=torch.float32, use_flash=True,
                                 use_kernel=use_kernel)[0]
        finally:
            setattr(ssm_mod, name, saved)

    def tf32(x):                      # rounded to TF32, to nearest
        return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    def ssd_single_pass_tf32(xdt, cs, Bm, Cm):
        """K6's function with each product's operands rounded to TF32 and
        fp32 sums: the arithmetic of one TF32 mma pass"""
        k = xdt.shape[1]
        decay = torch.exp(cs[:, :, None, :] - cs[:, None, :, :])
        tri = torch.ones((k, k), dtype=torch.bool, device=xdt.device).tril()
        Gm = tf32(Cm) @ tf32(Bm).transpose(1, 2)
        M = torch.where(tri[:, :, None], Gm[..., None] * decay, 0.0)
        return torch.einsum("gsth,gthp->gshp", tf32(M), tf32(xdt))

    reset_lm_counts()
    logits_k = short_logits(True)
    short_counts = lm_counts()
    logits = {
        "plain": short_logits(False),
        "k5_alone": short_logits(True, lambda *a, device: plain_ssd(*a)),
        "single_pass_tf32": short_logits(False, ssd_single_pass_tf32),
        "float64_k6": short_logits(False, lambda *a: plain_ssd(
            *(x.double() for x in a)).float())}
    # the other four routes launch K5 once (K5 alone) and K6 never
    other_counts = {name: n - short_counts[name]
                    for name, n in lm_counts().items()}
    plain_max = logits["plain"].abs().max()
    short_err = {name: float((x - logits["plain"]).abs().max() / plain_max)
                 for name, x in (("kernels", logits_k),
                                 ("k5_alone", logits["k5_alone"]),
                                 ("single_pass_tf32",
                                  logits["single_pass_tf32"]))}
    vs_float64_k6 = {
        name: float((x - logits["float64_k6"]).abs().max() / plain_max)
        for name, x in (("kernels", logits_k), ("plain", logits["plain"]))}
    want_short = {"flash_attention": 1,
                  "ssd_intra": len(short_cfg.block_pattern)
                  + len(short_cfg.tail_blocks)}
    if short_counts != want_short or other_counts != {
            "flash_attention": 1, "ssd_intra": 0} \
            or not bool(logits_k.isfinite().all()) \
            or short_err["k5_alone"] > LM_LOGIT_REL \
            or short_err["kernels"] > LM_LOGIT_REL_3XTF32 \
            or not short_err["single_pass_tf32"] > LM_LOGIT_REL_3XTF32:
        raise AssertionError(f"reduced-depth fp32 forward: launches "
                             f"{short_counts} (expected {want_short}), "
                             f"other routes {other_counts}; max rel err vs "
                             f"plain {short_err} (bounds: K5 alone "
                             f"{LM_LOGIT_REL}, kernels "
                             f"{LM_LOGIT_REL_3XTF32}, which single-pass "
                             f"TF32 must exceed)")
    del logits_k, logits, short_params
    torch.cuda.empty_cache()

    # full depth, bfloat16 prefill: the main path
    n_sb = cfg.resolved_superblocks
    want_lm = {"flash_attention": n_sb,
               "ssd_intra": n_sb * len(cfg.block_pattern)
               + len(cfg.tail_blocks)}
    # the first (cold) prefill also keeps a copy of q, k, v of the first
    # shared-block invocation: K5 is held against its plain version on
    # those real activations below
    captured = []
    launch_k5 = fa_ops.flash_attention_cuda

    def capture_first(q, k, v, groups):
        if not captured:
            captured.append((q.clone(), k.clone(), v.clone(), groups))
        return launch_k5(q, k, v, groups)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lm_base = torch.cuda.memory_allocated()
    reset_lm_counts()
    fa_ops.flash_attention_cuda = capture_first
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, tokens, use_flash=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    fa_ops.flash_attention_cuda = launch_k5
    lm_launches = lm_counts()
    if lm_launches != want_lm:
        raise AssertionError(f"prefill launches {lm_launches}, expected "
                             f"{want_lm}")
    if not (bool(logits.isfinite().all())
            and tuple(logits.shape) == (LM_BATCH, 1, cfg.vocab_size)):
        raise AssertionError("prefill: non-finite or misshapen logits")
    cache_leaves = leaves(cache)
    if len(cache_leaves) != len(cfg.block_pattern) + 2 + len(
            cfg.tail_blocks) or not all(bool(t.isfinite().all())
                                        for t in cache_leaves):
        raise AssertionError("prefill: malformed or non-finite cache")
    del logits, cache, cache_leaves
    walls = []
    for _ in range(LM_PREFILL_REPS):
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, tokens, use_flash=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del logits, cache
    lm_peak_gib = (torch.cuda.max_memory_allocated() - lm_base) / 2**30
    prefill_s = sorted(walls)[len(walls) // 2]
    # after the peak is read: the plain version forms every score
    q_act, k_act, v_act, g_act = captured.pop()
    if q_act.dtype != torch.bfloat16:
        raise AssertionError(f"prefill attention ran in {q_act.dtype}")
    act_err = check_attention("flash_attention on the prefill's first "
                              "shared-block q, k, v", q_act, k_act, v_act,
                              g_act)
    print(json.dumps({"lm_main_path": {
        "arch": cfg.name, "batch": LM_BATCH, "seq_len": LM_SEQ,
        "n_layers": cfg.n_layers, "n_params": n_params,
        "act_dtype": "bfloat16", "use_flash": True, "init_s": init_s,
        "earlier_phases_gib": held_gib,
        "reduced_depth_fp32_logit_rel_err": short_err,
        "reduced_depth_fp32_vs_float64_k6": vs_float64_k6,
        "reduced_depth_launches": short_counts,
        "k5_on_prefill_activations": {
            "shape": list(q_act.shape), "groups": g_act,
            "max_abs_err": act_err,
            "max_abs_out": float(fa.flash_attention_plain(
                q_act, k_act, v_act, g_act).float().abs().max())},
        "prefill_first_s": first_s, "prefill_walls_s": walls,
        "prefill_median_s": prefill_s,
        "tokens_per_s": LM_BATCH * LM_SEQ / prefill_s,
        "peak_memory_gib_above_start": lm_peak_gib,
        "params_gib": sum(t.numel() * t.element_size()
                          for t in leaves(params)) / 2**30,
        "launches": lm_launches}}))

    # -- 8. kernels at their paths' shapes ----------------------------------
    stamps.append(("8", time.perf_counter()))
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
        "launches": launches["spar_matvec"],
        "launches_unbalanced": ugw_launches["spar_matvec"],
        "launches_quantized": quant_launches["polished"]["spar_matvec"],
        "launches_quantized_spar_base": quant_launches["spar_base"][
            "spar_matvec"],
        "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib_ms})
    del Lmat
    torch.cuda.empty_cache()

    # as the main path calls it: the support sorted by row once, t in the
    # sorted order, outputs scattered back through the permutation
    perm, rows_s, cols_s = ops.sort_support(rows, cols)
    rows_s, cols_s = rows_s.int().contiguous(), cols_s.int().contiguous()
    perm32, t_s = perm.int().contiguous(), t[perm].contiguous()
    threads = dispatch.block_size("spar_cost_fused")
    want = spar_cost.spar_cost_plain(Cx, Cy, rows, cols, t, off, problem.loss)
    scale = ref.spar_cost_error_scale(Cx, Cy, rows, cols, t, off,
                                      problem.loss)
    err = check(torch, "spar_cost_fused main shape",
                spar_cost.launch_fused(Cx, Cy, rows_s, cols_s, t_s, off,
                                       problem.loss, threads, perm=perm32),
                want, scale)
    ms = time_ms(torch, lambda: spar_cost.launch_fused(
        Cx, Cy, rows_s, cols_s, t_s, off, problem.loss, threads,
        perm=perm32), 10)
    plain_ms = time_ms(torch, lambda: spar_cost.spar_cost_plain(
        Cx, Cy, rows, cols, t, off, problem.loss), 3, warmup=1)
    # off the path: the support in its sampled order (no Cx broadcasts)
    rows32, cols32 = rows.int().contiguous(), cols.int().contiguous()
    err_unsorted = check(torch, "spar_cost_fused main shape, unsorted",
                         spar_cost.spar_cost_cuda(Cx, Cy, rows32, cols32, t,
                                                  off, loss=problem.loss),
                         want, scale)
    unsorted_ms = time_ms(torch, lambda: spar_cost.spar_cost_cuda(
        Cx, Cy, rows32, cols32, t, off, loss=problem.loss), 10)
    del want, scale
    bound_ms, bound_by = bound(
        4 * (N_MAIN * N_MAIN * 2 + 5 * s_main),
        FUSED_OPS_PER_PAIR[problem.loss] * s_main * s_main)
    kernels.append({
        "name": "spar_cost_fused", "route": "cuda",
        "source": "src/repro_torch/csrc/spar_cost_fused.cu",
        "replaces": "src/repro/kernels/spar_cost/spar_cost.py:79",
        "launches": launches["spar_cost_fused"],
        "launches_unbalanced": ugw_launches["spar_cost_fused"],
        "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None})
    other_shapes = [{**kernels[-1], "ms": unsorted_ms, "launches": None,
                     "max_abs_err": err_unsorted,
                     "shape": f"n={N_MAIN} s={s_main} {problem.loss}, "
                              f"support in sampled order"}]
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

    # the three sinkhorn routes at their entry-point shapes, H = 50; with
    # --parent, the parent's kernel and this tree's on the same inputs,
    # each in a child process, in turns
    k4_inputs = {variant: path[:3] for variant, path in sinkhorn_paths.items()}
    k4_ms = sinkhorn_ms(torch, sinkhorn, k4_inputs)
    k4_turns = []
    if parent is not None:
        inputs_path = ROOT / "build" / "sinkhorn_inputs.pt"
        inputs_path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: tuple(x.cpu() for x in v)
                    for k, v in k4_inputs.items()}, inputs_path)
        for name, tree in (("parent", parent), ("change", ROOT),
                           ("change", ROOT), ("parent", parent)):
            k4_turns.append({name: tree_sinkhorn_ms(tree, inputs_path)})
    k4_routes = {}
    for variant, (sa, sb, sK, count, err) in sinkhorn_paths.items():
        m, n = sK.shape
        name, ctas = sinkhorn.route(m, n, dev)
        k4_routes[variant] = {
            "shape": [m, n], "route": name, "threads": (
                sinkhorn.THREADS if ctas else 256),
            "ctas": ctas or "as many as fit, up to a warp a row",
            "cluster": ctas if name == "sinkhorn_cluster" else None,
            "shared_bytes_per_cta": (
                sinkhorn.cluster_bytes(m, n, ctas)
                if name == "sinkhorn_cluster" else
                sinkhorn.card_bytes(m, n, ctas) if name == "sinkhorn_card"
                else 1024),
            "barriers_per_call": sinkhorn.barriers(name, SINKHORN_ITERS)}
        plain_ms = time_ms(torch, lambda: sinkhorn.sinkhorn_plain(
            sa, sb, sK, SINKHORN_ITERS), 3, warmup=1)
        bound_ms, bound_by = bound(4 * (m + n + 2 * m * n),
                                   4 * m * n * SINKHORN_ITERS + 2 * m * n)
        kernels.append({
            "name": variant, "route": "cuda",
            "source": "src/repro_torch/csrc/sinkhorn.cu",
            "replaces": "src/repro/kernels/sinkhorn/sinkhorn.py:44",
            "launches": count, "max_abs_err": err,
            "ms": k4_ms[variant], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    print(json.dumps({"sinkhorn_routes": k4_routes}))
    if k4_turns:
        print(json.dumps({"sinkhorn_ms_parent_vs_change": k4_turns}))

    # flash attention at zamba2-7b's shape (the main path's) and, off the
    # path, llama3-8b's attention shape; bf16, B = 1, S = 4096
    import torch.nn.functional as F
    for arch, H, K, hd in (("zamba2-7b", cfg.n_heads, cfg.n_kv_heads,
                            cfg.resolved_head_dim), ("llama3-8b", 32, 8, 128)):
        S = LM_SEQ
        q = normal(H, S, hd, dtype=torch.bfloat16)
        k = normal(K, S, hd, dtype=torch.bfloat16)
        v = normal(K, S, hd, dtype=torch.bfloat16)
        err = check_attention(f"flash_attention {arch} shape", q, k, v, H // K)
        ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, H // K),
                     10)
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, H // K), 3, warmup=1)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True, enable_gqa=True), 10)
        bound_ms, bound_by = bound(2 * (2 * H + 2 * K) * S * hd,
                                   4 * H * hd * S * (S + 1) / 2, BF16_FLOPS)
        row = {"name": "flash_attention", "route": "cuda",
               "source": "src/repro_torch/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention/"
                           "flash_attention.py:61",
               "launches": lm_launches["flash_attention"],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms}
        if arch == "zamba2-7b":
            kernels.append(row)
        else:
            other_shapes.append({**row, "shape": f"{arch} B=1 S={S} H={H} "
                                                 f"K={K} hd={hd} bf16",
                                 "launches": None})
        del q, k, v

    # the SSD intra-chunk block at zamba2-7b's layer shape (B = 1, S = 4096)
    Gc, kc = LM_BATCH * LM_SEQ // cfg.ssm_chunk, cfg.ssm_chunk
    Hs, Ns = cfg.ssm_heads, cfg.ssm_state
    Ps = cfg.ssm_expand * cfg.d_model // Hs
    xdt, Bm, Cm = normal(Gc, kc, Hs, Ps), normal(Gc, kc, Ns), normal(Gc, kc, Ns)
    cs = -torch.cumsum(rand(Gc, kc, Hs), dim=1)
    err = check_ssd("ssd_intra zamba2-7b shape", xdt, cs, Bm, Cm)
    # accuracy: kernel and plain version against a float64 evaluation, rms
    # and max of |err| over the output's rounding scale
    want64 = ssd.ssd_intra_plain(xdt.double(), cs.double(), Bm.double(),
                                 Cm.double())
    scale64 = ssd_intra_error_scale(xdt, cs, Bm, Cm).double()
    accuracy = {}
    for name, got in (("kernel", ssd.ssd_intra_cuda(xdt, cs, Bm, Cm)),
                      ("plain", ssd.ssd_intra_plain(xdt, cs, Bm, Cm))):
        rel = (got.double() - want64).abs() / scale64
        accuracy[name] = {"rms": float(rel.pow(2).mean().sqrt()),
                          "max": float(rel.max())}
    print(json.dumps({"ssd_intra_vs_float64": accuracy}))
    del want64, scale64, rel
    ms = time_ms(torch, lambda: ssd.ssd_intra_cuda(xdt, cs, Bm, Cm), 20)
    plain_ms = time_ms(torch, lambda: ssd.ssd_intra_plain(xdt, cs, Bm, Cm),
                       5, warmup=1)
    tri = kc * (kc + 1) / 2
    bound_ms, bound_by = bound(
        4 * (2 * xdt.numel() + cs.numel() + Bm.numel() + Cm.numel()),
        Gc * tri * (2 * Ns + Hs * (2 * Ps + 3)))
    kernels.append({
        "name": "ssd_intra", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_intra.cu",
        "replaces": "src/repro/kernels/ssd/ssd.py:43",
        "launches": lm_launches["ssd_intra"], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None})
    del xdt, Bm, Cm, cs
    print(json.dumps({"kernel_timings_off_path": other_shapes}))

    # -- 9. where the time goes ---------------------------------------------
    stamps.append(("9", time.perf_counter()))
    # the cut low-rank solve has no unprofiled run elsewhere: time one
    lr_cut = dataclasses.replace(lr_solver, outer_iters=LOWRANK_PROFILE_STEPS)

    def lowrank_cut():
        return repro_torch.solve(lr_problem, lr_cut, generator=torch.Generator(
            dev).manual_seed(0)).value.item()

    t0 = time.perf_counter()
    lowrank_cut()
    lowrank_cut_wall = time.perf_counter() - t0
    q_cut = QuantizedGWSolver(base=dataclasses.replace(
        QuantizedGWSolver().base, outer_iters=QUANT_PROFILE_OUTER))

    def quantized_cut():
        return repro_torch.solve(quant_problem, q_cut, generator=torch.Generator(
            dev).manual_seed(0)).value.item()

    t0 = time.perf_counter()
    quantized_cut()
    quantized_cut_wall = time.perf_counter() - t0
    print(json.dumps({"profile": {
        "grid": profile_solve(torch, lambda: repro_torch.solve(
            grid_problem, grid_solver, support=grid_support).value.item()),
        "spar_pallas": profile_solve(torch, lambda: repro_torch.solve(
            problem, forced, support=support).value.item()),
        "spar_unbalanced_auto": profile_solve(torch, lambda: repro_torch.solve(
            ugw_problem, ugw_solver, support=ugw_support).value.item()),
        f"lowrank_{LOWRANK_PROFILE_STEPS}_steps": {
            **profile_solve(torch, lowrank_cut),
            "unprofiled_wall_s": lowrank_cut_wall},
        f"quantized_l2_{QUANT_PROFILE_OUTER}_outer_steps": {
            **profile_solve(torch, quantized_cut, top=10),
            "unprofiled_wall_s": quantized_cut_wall},
        "zamba2_prefill": profile_solve(torch, lambda: model.prefill(
            params, tokens, use_flash=True)[0].sum().item(), top=12)}}))

    stamps.append(("end", time.perf_counter()))
    print(json.dumps({"phase_wall_s": {
        name: t1 - t0 for (name, t0), (_, t1) in zip(stamps, stamps[1:])}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import argparse

    cli = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    cli.add_argument("--parent", type=Path, help="a checkout of an earlier "
                     "commit whose Sinkhorn kernel phase 8 also times")
    cli.add_argument("--time-sinkhorn", help=argparse.SUPPRESS)
    cli.add_argument("--src", help=argparse.SUPPRESS)
    args = cli.parse_args()
    if args.time_sinkhorn:
        sys.exit(time_sinkhorn_child(args.time_sinkhorn, args.src))
    sys.exit(main(args.parent.resolve() if args.parent else None))
