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
   the matvec kernel's ``autograd.Function`` against autograd through
   its plain version at s = 1003 (dLmat and doff exactly, dt within the
   kernel bound);
4. drive the spar main path: ``repro_torch.solve`` with auto-selection
   on an n = 2048 Moon pair (spar_gw, s = 16n = 32768, cost_impl "auto"
   = the materialized matvec kernel), then the same support with the
   gather-fused kernel forced; both kernels must launch, both values be
   finite and healthy and agree; each solve's Sinkhorn must launch K7
   2 · 50 · 20 times (phases 4b-4h count K7 too: 2 · 50 · 20 on the
   unbalanced path, with ρ, none on the grid shim, some on the quantized
   and ``gw_loss`` paths, 2 · 50 · 20 a flush and a spar shim); then a
   small solve on the card against the plain CPU path on the same support;
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
4f. drive ``repro_torch.diff`` and ``repro_torch.obs``: ``gw_loss`` on
   the n = 2048 Moon point clouds with no solver (auto-selected spar_gw,
   s = 32768, the matvec kernel K1) and its gradient with respect to
   both clouds: K1 launches the loop's steps plus one in the forward and
   nothing in the backward, the gradient is finite and agrees with the
   same gradient through K1's plain version on the card (walls and peak
   memory printed); an n = 300 gradient on the card against the CPU;
   ``fgw_loss`` with features at n = 2048, whose quadratic part must be
   nonzero; a gradient through the gather-fused kernel (K2) and through
   gw_cost (K3) must raise; the envelope gradient against
   ``unrolled_value``'s at converged fixed points (dense and full-support
   spar, n = 10) within the reference's bound, and at
   benchmarks/bench_diff.py --quick's spar size (n = 200, s = 8n, not
   converged in its budget: gap, walls and memory printed); a 10-step
   ``gw_barycenter`` of two n = 300 clouds through spar_gw must descend;
   one ``trace=True`` solve on each route (spar, grid, dense, low rank
   cut to 3 steps, quantized polished at n = 150) must record n_iters
   iterations, ``repro_solves_total`` count them, and ``obs.report()``
   of that run is printed;
4g. drive ``repro_torch.serve``: benchmarks/bench_serve.py's full
   catalog stream (64 dense_gw requests, 10 recurring queries of 12-60
   points against one 32-point reference) through ``GWServer(max_batch=8,
   max_wait_s=0.02)``, a warm pass then a measured one (the cache hit rate
   must be 1.0), beside the same stream as a sequential
   ``repro_torch.solve`` loop; every served value within 1e-4 of its solo
   solve of the padded problem; then 16 spar_gw requests (n in 400-512
   against one 512-point reference, s = 8192, a generator seeded per
   request) in two flushes of 8 lanes: K1 must launch 21 times a flush,
   each lane agree with its solo solve on the same generator state; one
   flush and the 8 solo solves it replaces timed, the flush and one solo
   solve profiled; K1's lane
   launch at (8, 8192) bitwise against 8 single-lane launches; width-1
   lane bits against width 2 and the solo solve (printed); a flush of 4
   fused dense requests with a persistent NaN in one: it fails and falls
   back, its mates come back healthy;
4h. drive the legacy core (``repro_torch.core``): the ``spar_gw`` shim
   at n = 2048, s = 16n on a generator state, bit for bit the
   ``repro_torch.solve`` call on the same state (torch's deterministic
   algorithms on for both), K1 21 launches; ``spar_fgw`` with
   cost_impl "pallas" (K2 21 launches), bit for bit its solve;
   ``grid_spar_gw(use_kernel=True, loss="l1")`` at s_r = s_c = 181, bit
   for bit phase 5's solve on the same state, K3 21 launches; ``sagrow``
   at n = 2048 with s' = 256 (benchmarks/bench_fig2.py's budget): a
   finite value and its wall; ``emd_gw`` at n = 40 (cost on the card, LP
   on the host) against the same on the CPU; ``gw_alignment_loss`` and
   its gradient on two (4, 512, 3584) hidden tensors against the CPU
   within 1e-4 of the largest gradient entry; ``make_sharded_grid_gw`` at
   world size 1 over NCCL (a ``file://`` store in a temporary directory)
   against the unsharded loop on the card;
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
7b. drive the LM decode path on phase 7's weights: at reduced depth in
   float32, 32 teacher-forced ``decode_step`` logits against
   ``Model.forward`` through K5 and K6 on the same tokens, within the
   reference's decode-vs-forward bound (tests/test_models.py: atol 2e-2,
   rtol 1e-2; the distance is printed); at full depth in bfloat16,
   ``launch.serve.generate`` at B = 4, prompt 32, 16 new tokens, twice
   (tokens in range, logits finite; tokens/s cold and warm, the cache's
   bytes and the peak memory printed); ``gw_similarity`` at full depth in bfloat16, whose two
   forwards must each launch K6 81 times; and the CLI, ``launch.serve
   --mode lm --arch zamba2-7b --reduced --metric gw``, to its end;
7c. drive the other six architectures (minicpm3-4b: MLA; llama4-scout
   and phi3.5-moe: MoE; llama-3.2-vision-90b: cross-attention to 1024
   image embeddings; xlstm-125m: mLSTM and sLSTM; musicgen-medium: 4
   codebooks) at their published widths, weights drawn on the card in
   float32 from a torch generator, each at the depth of ``ARCHS`` (all of
   minicpm3's 62 and musicgen's 48 superblocks, 2 of llama4's 48, 4 of
   phi3.5's 32, 1 of vision's 20, xLSTM's 3), one after the other: (a) a
   1-superblock float32 ``Model.forward`` at S = 1024 through K5 against
   K5's plain version, within 1e-4 of the largest logit (MoE at capacity
   factor 100); (c) 32 teacher-forced ``decode_step`` logits against the
   forward at 1 superblock (atol 2e-2 + rtol 1e-2); (b) the bfloat16
   ``Model.prefill(use_flash=True)`` at B = 1, S = 4096 (xLSTM 1024, and
   one sLSTM block alone at 4096): K5 must launch once a GQA
   self-attention layer (0, 2, 4, 4, 0, 48), the logits be finite; wall
   (median of 3 after a cold run), tokens/s, peak memory; llama4-scout's
   prefill is profiled (idle share, top kernels, the MoE dispatch ops'
   device time); (c) ``launch.serve.generate`` at B = 4, prompt 32, 16
   new tokens (vision with ``img=``, musicgen on (4, 32, 4) prompts):
   tokens in range, tokens/s; (d) one ``make_train_step`` step at the
   reduced config: finite loss, every parameter changed, aux > 0 for
   MoE; and phi3.5-moe's loss gradient at published width, 1
   superblock, B = 2, S = 512, fp32, capacity factor 100, through K5
   against its plain version within the train phase's limit, which the
   route dropping K5's gradient must miss;
train. drive the training path: (a) the loss gradient of
   smollm-135m at its published width and depth (B = 2, S = 512, fp32)
   through K5 (30 launches, its ``autograd.Function``'s plain backward)
   against the gradient through K5's plain version, and of phase 7's
   1-superblock zamba2-7b through K6 (9 launches) against K6's plain
   version, each within a relative norm limit that the route dropping the
   kernel's gradient (its output taken without a graph) must exceed; (b)
   ``launch.train.train`` on smollm-135m, B = 8, S = 512, 20 steps with
   ``use_flash`` and ``gw_align``, a checkpoint every 10 in a temporary
   directory: finite losses, the mean ce of the last 5 steps below the
   first 5's, K5 1200 launches (remat runs each forward twice); step wall
   (median), tokens/s, peak memory; one more step profiled (idle share,
   K5's forward and backward device time) and one without the alignment
   loss; K5's forward and plain backward timed at the step's shape; (c)
   under ``torch.use_deterministic_algorithms(True)``, 2 steps and a
   resume of 2 more bit for bit 4 straight (losses and parameters);
10. (after the train phase) the distributed layer at world size 1 over
   NCCL on a 1 x 1 ("data", "model") mesh: ``train(mesh=)`` on
   smollm-135m (B 8 x S 512, use_flash, 5 steps) against
   ``train(mesh=None)`` from the same seed, in turns (mesh, unsharded,
   mesh) under deterministic algorithms, losses within rtol 1e-5, K5 60
   launches a step, the checkpoint restored with ``shardings=`` onto the
   mesh bit for bit; ``compressed_psum`` within block max / 127 and a
   one-stage ``pipeline_forward`` against the sequential loop; zamba2-7b
   at full width with ``split_proj`` (weights split from phase 7's fused
   ``in_proj``), 1 superblock + tail fp32, against the fused route within
   SPLIT_PROJ_REL, K6 launching, with the first block's K6 inputs, each
   route against a float64-summed projection, and a TF32 stand-in that
   must miss the limit; and the dry run of llama3-8b ``train_4k`` on the
   (16, 16) fake mesh and of the sharded GW engine at 8192², in child
   processes on the host's CPU started before the train phase and run
   beside it (``mesh_path``);
8. time every kernel at its path's shapes against its plain version,
   its bound and, where one exists, one library call (K7, the sparse
   Sinkhorn half-step, at both benchmark cells' shapes, also a 50-iteration
   loop of each; K5 also at
   llama3-8b's attention shape, and in its row's ``arch_shapes`` at
   llama4-scout's (40 / 8 heads, hd 128) and musicgen-medium's (24 / 24,
   hd 64); K1's lane launch at (8, 8192) also
   against the 8 single-lane launches it replaces, with torch.baddbmm as
   the library call); print each Sinkhorn route's CTAs,
   shared memory a CTA and barriers a call. After K1's, K2's and K3's
   readings at the registry default, ``dispatch.autotune`` sweeps their
   blocks at the main path's shapes, holds each kernel at its winner to
   its plain version, asserts that ``block_size`` resolves to the winner
   from the autotune cache (``repro_kernel_block_resolutions_total``),
   times default and winner in turns, re-runs phase 4's two spar solves
   and phase 5's grid solve under the tuned blocks within IMPL_VALUE_RTOL
   (``tuned_solves``), dumps the records to
   ``artifacts/autotune/torch-cuda.json`` and clears the cache;
9. trace one grid solve, one spar solve (gather-fused), one unbalanced
   spar solve ("auto"), the low-rank solve cut to 3 outer steps and the
   n = 8192 quantized solve with its coarse solve cut to 1 outer step
   (both also timed once unprofiled), one zamba2-7b prefill and one
   full-depth bf16 decode step (B = 4) with
   ``torch.profiler`` and print each one's wall time, device-busy time,
   idle share and the kernels that take the most device time (with
   phase 7c's profile of one llama4-scout prefill); then each phase's
   wall time and phase 7c's per architecture.

The line before the last is the kernel JSON (K1's row also counts its
launches on phase 4f's ``gw_loss``; its lane launch's row, on phase 4g's
spar lanes; K5's row its launches in the train run, ``launches_train``,
and in each bf16 prefill of phase 7c, ``launches_archs``;
K6's in the zamba2 gradient, ``launches_train_grad``; K5's in phase
10's mesh run, ``launches_mesh``, and K6's in its split_proj forward,
``launches_split_proj``; K1's, K2's and K3's rows their ``autotune``
sweep, ``ms`` staying the default block's time); the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the JAX
package ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
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
# phase 4f, gradients: two routes or two devices on one support agree
# within this fraction of the largest entry of the gradient (the CPU
# parity tests' bound against the reference, tests/test_torch_diff.py)
GRAD_RTOL = 1e-4
# the envelope against the unrolled gradient at a converged fixed point:
# the reference's own bound on a relative gap in a directional derivative
# (tests/test_diff.py's REL_TOL); converged means a marginal error below
# 1e-4 and a last relative movement below 1e-5 (tests/test_torch_envelope)
ENVELOPE_REL_TOL = 1e-3
CONVERGED_ERR, CONVERGED_DELTA = 1e-4, 1e-5
N_ENVELOPE = 10        # the converged cases (tests/test_torch_envelope.py)
N_UNROLLED_SPAR = 200  # benchmarks/bench_diff.py --quick: s = 8n, 60 x 120
BARY_STEPS = 10

# phase 4g, serve: benchmarks/bench_serve.py's full catalog stream (64
# requests, 10 recurring queries against one 32-point reference), then
# spar lanes at the top default bucket (16 requests against one 512-point
# reference, s = 16·512, two flushes of 8 lanes)
SERVE_CATALOG_SIZES = (12, 14, 18, 22, 26, 28, 30, 38, 44, 60)
SERVE_CATALOG_REQUESTS, SERVE_CATALOG_QUERIES = 64, 10
SERVE_SPAR_SIZES = (400, 448, 480, 512)
SERVE_SPAR_N, SERVE_SPAR_REQUESTS, SERVE_LANES = 512, 16, 8
SERVE_SPAR_S = 16 * SERVE_SPAR_N
# a served dense value against its solo solve of the padded problem on the
# card: the same fp32 algorithm, batched (cuBLAS bmm, batched reductions)
# against single calls
SERVE_VALUE_RTOL = 1e-4

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
# phase 8, K7 (the sparse log-domain Sinkhorn half-step) at the two
# benchmark cells' shapes: (lanes, n, s a lane), the lib cell's one support
# of s = 131 072 over n = 8192 and the served cell's flush of 8 lanes of
# s = 32 768 over n = 2048 (one segment space of 8·2048 rows)
K7_SHAPES = ((1, 8192, 131072), (8, 2048, 32768))
K7_ITERS = 50
# phase 8's block sweeps at the main path's shapes: (family, candidates,
# reps of the host clock a candidate)
K1_TUNE = ("spar_cost", (64, 128, 256, 512, 1024), 20)
K2_TUNE = ("spar_cost_fused", (256, 512, 768, 1024), 10)
K3_TUNE = ("gw_cost", (32, 64, 128, 256), 50)


def gw_cost_rtol(L: int, P: int, S: int, threads: int) -> float:
    """K3's bound at ``threads`` a block: GW_COST_RTOL holds the terms a
    256-thread block sums in sequence plus the plain version's allowance;
    W = threads / 32 warps add ceil(L/S)·(ceil(p/W) per 192-p chunk) + W
    + S terms in sequence instead, each term 2^-24 more."""
    def terms(w):
        per_p = sum(-(-min(192, P - p0) // w) for p0 in range(0, P, 192))
        return -(-L // S) * per_p + w + S
    return GW_COST_RTOL + max(0, terms(threads // 32) - terms(8)) * 2.0 ** -24
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
# phase 7b: the reference's lm_main defaults (batch, prompt, new tokens),
# and its decode-vs-forward bound (tests/test_models.py)
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 4, 32, 16
DECODE_ATOL, DECODE_RTOL = 2e-2, 1e-2

# phase 4h: SaGroW's sample budget (benchmarks/bench_fig2.py: s' = s²/n²
# at s = 16n), EMD-GW's LP size, the alignment loss's hidden tensors
SAGROW_S_PRIME = 256
N_EMD = 40
ALIGN_SHAPE = (4, 512, 3584)
SHARDED_S, SHARDED_ARGS = 256, ("l2", 0.05, 10, 30)
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

# phase "train": smollm-135m at its published width and depth. (a) the loss
# gradient through K5 (and through K6 on zamba2-7b at 1 superblock + tail)
# against the plain versions' at B x S; (b) launch.train.train for
# TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ, a checkpoint every
# TRAIN_CKPT_EVERY; (c) N steps and a resume of N more against 2N straight,
# under deterministic algorithms
TRAIN_ARCH = "smollm_135m"
TRAIN_GRAD_BATCH, TRAIN_GRAD_SEQ = 2, 512
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 512, 20, 10
RESUME_STEPS, RESUME_BATCH, RESUME_SEQ = 2, 2, 512
# (a)'s limits on ||grad through the kernel - grad through its plain
# version|| / ||grad through the plain version|| (all leaves), set from
# readings on the H100 (PERF.md §6): K5 read 2.9e-6 against 0.90 for
# the route that drops its gradient (the ctypes output without a graph);
# K6 1.3e-4 against 0.999. The limits are phase 7's logit bounds: 1e-4
# for fp32 arithmetic (35x K5's reading), 12 x 1e-4 for K6's 3xTF32
# products (9x its reading); both lie far below the dropped routes,
# which the phase also checks
K5_GRAD_REL = LM_LOGIT_REL
K6_GRAD_REL = LM_LOGIT_REL_3XTF32

# phase 7c: the six architectures the port added last, at their published
# widths, each at the depth (superblocks) at which float32 weights and a
# bfloat16 copy (6 B a parameter) fit one 80 GB card beside phase 7's
# zamba2-7b, and K5's launches in its bf16 prefill (one a GQA
# self-attention layer; MLA and xLSTM have none)
ARCHS = (("minicpm3_4b", 62, 0), ("llama4_scout_17b_a16e", 2, 2),
         ("phi3_5_moe_42b_a6_6b", 4, 4), ("llama_3_2_vision_90b", 1, 4),
         ("xlstm_125m", 3, 0), ("musicgen_medium", 48, 48))
ARCH_FWD_SEQ = 1024        # (a) fp32 forward, 1 superblock, K5 vs plain
ARCH_PREFILL_SEQ = 4096    # (b) bf16 prefill at B = 1 (vision: 1024 images)
# xLSTM's sLSTM runs a Python loop of ~17 launches a position: its prefill
# takes this S, and one sLSTM block is timed alone at ARCH_PREFILL_SEQ
XLSTM_PREFILL_SEQ = 1024
ARCH_PREFILL_REPS = 3
# the MoE models' capacity factor where a run is held to another route:
# no token's drop may depend on rounding (tests/test_models.py's 100)
ARCH_MOE_CF = 100.0
# (d) the gradient at published width through K5 against its plain version
ARCH_GRAD = ("phi3_5_moe_42b_a6_6b", 2, 512)      # arch, B, S; 1 superblock

# phase 10: the mesh path at world size 1 over NCCL, a 1 x 1 ("data",
# "model") mesh. train(mesh=) on smollm-135m at its published width and
# depth against train(mesh=None) from the same seed, in turns (mesh,
# unsharded, mesh) under deterministic algorithms; losses within
# tests/test_elastic.py's rtol 1e-5
MESH_ARCH = "smollm_135m"
MESH_BATCH, MESH_SEQ, MESH_STEPS = 8, 512, 5
MESH_LOSS_RTOL = 1e-5
# the dry run's full-size cell (a child process each on the host's CPU,
# the fake group at 256 ranks) and the sharded GW engine at the
# reference's s_r = s_c
MESH_DRYRUN = ("llama3-8b", "train_4k")
MESH_DRYRUN_TIMEOUT = 400
MESH_PSUM_N = 1 << 20
# split_proj against the fused route (zamba2-7b, 1 superblock + tail,
# fp32, both through K6), in max |difference| over the fused route's
# largest logit. The routes differ only in how cuBLAS sums one fp32
# projection; the first block's K6 inputs read 2e-6 apart, and the stack
# carries that to the logits (phase 7: the plain route 1.6e-4 from a
# float64 K6). Readings on one H100: the fused route 5.79e-4 and the
# split route 2.80e-4 from a projection summed in float64; split vs
# fused 5.93e-4. Two routes each within 6e-4 of the float64 one differ
# by at most 1.2e-3; a TF32 stand-in (the projection's activations
# rounded to TF32) reads 0.115 and must miss it
SPLIT_PROJ_REL = 1.2e-3


def moon_points(n: int, seed: int = 0):
    """The paper's Moon pair (§6.1) as point clouds: two noisy interleaved
    half circles (float64), with Gaussian marginals N(n/3, n/20) and
    N(n/2, n/20) floored at 1e-9 (benchmarks/datasets.py)."""
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

    return (points(np.random.default_rng(seed)),
            points(np.random.default_rng(seed + 1)),
            weights(1 / 3), weights(1 / 2))


def moon(n: int, seed: int = 0):
    """The Moon pair with Euclidean distance matrices as costs."""
    def dist(x):
        sq = (x * x).sum(1)
        d2 = np.maximum(sq[:, None] + sq[None, :] - 2 * x @ x.T, 0.0)
        return np.sqrt(d2).astype(np.float32)

    x, y, a, b = moon_points(n, seed)
    return dist(x), a, dist(y), b


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


def k7_bytes(s: int, num: int, other: int) -> int:
    """The bytes a half-step needs from HBM, each counted once: lv and the
    other index (8 an entry), the segment offsets, marginal and output (12
    a segment) and the gathered potential (4 an entry of it). The second
    pass over lv and idx and the potential's repeated reads come from
    L1/L2."""
    return 8 * s + 12 * num + 4 * other


def k7_count(k7) -> int:
    """K7's launches since its last reset."""
    return k7.LAUNCHES["sparse_sinkhorn_half"]


def check_k7_launches(name, out, launched: int, solver):
    """A spar solve launches K7 twice an iteration of every outer step:
    exactly 2 · inner_iters · outer_iters without an ε-rescue (which
    re-runs steps), more with one."""
    want = 2 * solver.inner_iters * solver.outer_iters
    ok = launched == want if out.status.n_rescues == 0 else launched > want
    if not ok:
        raise AssertionError(f"{name}: K7 launched {launched} times, "
                             f"expected {want} ({out.status.n_rescues} "
                             f"rescues)")


def k7_phase(torch, dev, launches=None) -> list:
    """K7's half-step at ``K7_SHAPES`` on potentials 10 iterations in
    (uniform marginals, a uniform support, log-kernel -C/ε + log w with C
    in [0, 2], ε = 1e-2): held to the plain half-step (core/sinkhorn.py's
    body) within one half-step's summation-order bound, timed on CUDA
    events in turns (kernel, ρ, plain, plain, ρ, kernel) beside its byte
    bound, then each one's device time alone under torch.profiler, then
    50 iterations of each body on the host clock (the time a solve's
    Sinkhorn loop takes), in turns too. ρ is the unbalanced instantiation
    (ρ = 1/1.01, the ugw cell's), held to the plain unbalanced half-step
    within two ulps where the balanced takes one, and ρ = 1 bitwise the
    balanced launch. One row a shape; given phase 4's K7 counts, the lib
    shape's row carries them as ``launches``, the served shape's the serve
    flushes' count."""
    from repro_torch.core.utils import log_floor
    from repro_torch.kernels.sparse_sinkhorn import sparse_sinkhorn as k7
    from repro_torch.kernels.sparse_sinkhorn.ops import logdomain_body
    sk = importlib.import_module("repro_torch.core.sinkhorn")
    u = 2.0 ** -24
    out = []
    for lanes, n, s in K7_SHAPES:
        gen = torch.Generator(dev).manual_seed(29)
        num = lanes * n
        rows = sk._lane_flat(torch.randint(0, n, (lanes, s), generator=gen,
                                           device=dev), n)
        cols = sk._lane_flat(torch.randint(0, n, (lanes, s), generator=gen,
                                           device=dev), n)
        lv = (torch.rand(lanes * s, generator=gen, device=dev) * -200.0
              + math.log(n * n / s))
        la = log_floor(torch.full((num,), 1.0 / n, device=dev))

        rho = torch.tensor(1.0, device=dev) / (1.0 + torch.tensor(
            1e-2, device=dev))

        def plain_half(pot, keys, idx, r=None):
            d = la - sk.segment_logsumexp(lv + pot[idx], keys, num)
            return sk._finite(d if r is None else r * d)

        def plain_body(carry):
            f = plain_half(carry[1], rows, cols)
            return (f, plain_half(f, cols, rows))

        body = logdomain_body(la, la, rows, cols, lv, num, num)
        body_r = logdomain_body(la, la, rows, cols, lv, num, num, rho=rho)
        zero = (torch.zeros(num, device=dev), torch.zeros(num, device=dev))
        carry = zero
        for _ in range(10):
            carry = body(carry)
        g = carry[1]
        layout, perm = k7.segment_layout(rows, cols, num, num)
        lv_r = lv[perm]
        k7.reset_launch_counts()
        got = k7.half_step(layout, lv_r, g, la)
        want = plain_half(g, rows, cols)
        torch.cuda.synchronize()
        if k7.LAUNCHES["sparse_sinkhorn_half"] != 1:
            raise AssertionError("K7 did not launch once for a half-step")
        k = int(torch.diff(layout.off).max())
        tol = 2 * (k - 1) * u + 2 * u * float(want.abs().max())
        err = float((got - want).abs().max())
        if not err <= tol:
            raise AssertionError(f"K7 at {lanes} x (n={n}, s={s}): kernel "
                                 f"disagrees with plain: {err:.3g} > "
                                 f"{tol:.3g}")
        got_r = k7.half_step(layout, lv_r, g, la, rho=rho)
        want_r = plain_half(g, rows, cols, rho)
        tol_r = 2 * (k - 1) * u + 4 * u * float(want_r.abs().max())
        err_r = float((got_r - want_r).abs().max())
        one = torch.ones((), device=dev)
        if not err_r <= tol_r or not torch.equal(
                k7.half_step(layout, lv_r, g, la, rho=one), got):
            raise AssertionError(f"K7 with rho at {lanes} x (n={n}, s={s}): "
                                 f"{err_r:.3g} > {tol_r:.3g}, or rho = 1 "
                                 f"is not the balanced launch")
        launch = {"kernel": lambda: k7.half_step(layout, lv_r, g, la),
                  "rho": lambda: k7.half_step(layout, lv_r, g, la, rho=rho),
                  "plain": lambda: plain_half(g, rows, cols)}
        turns = {"kernel": [], "rho": [], "plain": []}
        for name in ("kernel", "rho", "plain", "plain", "rho", "kernel"):
            turns[name].append(time_ms(torch, launch[name], 200))

        def loop_s(step):
            c = zero
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(K7_ITERS):
                c = step(c)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        # device time alone (the events above time back-to-back launches,
        # which the host may pace): the kernel's a launch, the plain
        # half-step's summed over its kernels
        prof_k = profile_solve(torch, lambda: [launch["kernel"]()
                                               for _ in range(50)], top=1)
        prof_r = profile_solve(torch, lambda: [launch["rho"]()
                                               for _ in range(50)], top=1)
        prof_p = profile_solve(torch, lambda: [launch["plain"]()
                                               for _ in range(20)])
        device_us = {"kernel": 1e3 * prof_k["top"][0]["ms"]
                     / prof_k["top"][0]["calls"],
                     "rho": 1e3 * prof_r["top"][0]["ms"]
                     / prof_r["top"][0]["calls"],
                     "plain": 1e6 * prof_p["device_busy_s"] / 20,
                     "plain_kernels": prof_p["kernel_launches"] / 20}
        loops = {"kernel": [], "rho": [], "plain": []}
        for name, step in (("kernel", body), ("rho", body_r),
                           ("plain", plain_body), ("plain", plain_body),
                           ("rho", body_r), ("kernel", body)):
            loops[name].append(loop_s(step))
        bound_ms, bound_by = bound(k7_bytes(lanes * s, num, num), 0)
        out.append({
            "name": "sparse_sinkhorn_half", "route": "cuda",
            "source": "src/repro_torch/csrc/sparse_sinkhorn.cu",
            "replaces": None,
            "launches": (launches if launches is None or lanes == 1
                         else launches["serve_spar_lanes"]),
            "shape": f"{lanes} x (n={n}, s={s}), group {layout.group}",
            "max_abs_err": err, "err_bound": tol, "longest_segment": k,
            "rho_max_abs_err": err_r, "rho_err_bound": tol_r,
            "ms": sum(turns["kernel"]) / 2, "rho_ms": sum(turns["rho"]) / 2,
            "plain_ms": sum(turns["plain"]) / 2, "turns_ms": turns,
            "device_us": device_us,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            f"loop_{K7_ITERS}_iters_s": loops})
        print(json.dumps({"k7": out[-1]}))
    return out


def autotune_row(torch, dispatch, tune, bench, flops, nbytes,
                 check_at) -> dict:
    """Sweep a family's block with ``dispatch.autotune`` (one warm call,
    then the host clock over the reps, each call ending in
    ``torch.cuda.synchronize()``); hold the kernel at the winner to its
    plain version (``check_at(block)`` returns its max abs error); assert
    that ``block_size`` now resolves to the winner from the autotune cache
    and that the resolution counter saw it; then time the default and the
    winner on CUDA events in turns (default, tuned, tuned, default). The
    row's ``autotune`` object."""
    from repro_torch.obs.registry import registry as obs_registry

    family, candidates, reps = tune
    default = dispatch.registry()[family].default_block
    best = dispatch.autotune(family, candidates, bench, reps=reps,
                             flops_per_call=flops, bytes_per_call=nbytes)
    record = dispatch.autotune_records()[-1]
    if best is None or sorted(map(int, record["timings_s"])) != sorted(
            candidates):
        raise AssertionError(f"autotune {family}: a candidate was refused: "
                             f"{record if best is not None else None}")
    err = check_at(best)
    if dispatch.block_size(family) != best:
        raise AssertionError(f"block_size({family!r}) is not the winner")
    series = obs_registry().snapshot()["metrics"][
        "repro_kernel_block_resolutions_total"]["series"]
    from_cache = sum(r["value"] for r in series if r["labels"] == {
        "family": family, "source": "autotune"})
    if from_cache < 1:
        raise AssertionError(f"{family}: no resolution from the autotune "
                             f"cache counted")
    turns = {"default": [], "tuned": []}
    for name in ("default", "tuned", "tuned", "default"):
        block = default if name == "default" else best
        turns[name].append(time_ms(torch, lambda: bench(block), reps))
    return {"candidates": list(candidates),
            "timings_ms": {k: 1e3 * v for k, v in
                           record["timings_s"].items()},
            "best_block": best, "default_block": default,
            "tuned_ms": sum(turns["tuned"]) / 2, "turns_ms": turns,
            "gflops": record.get("gflops"),
            "gbytes_per_s": record.get("gbytes_per_s"),
            "max_abs_err_tuned": err,
            "resolutions_from_cache": from_cache}


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


def serve_geometry(repro_torch, n: int, seed: int):
    """benchmarks/bench_serve.py's geometry: n standard normal points in
    2-D, their Euclidean distances, uniform weights (on the CPU)."""
    pts = np.random.default_rng(seed).standard_normal((n, 2))
    C = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)).astype(np.float32)
    return repro_torch.Geometry(C, np.full(n, 1.0 / n, np.float32))


def serve_catalog(repro_torch) -> list:
    """bench_serve.py's catalog stream: recurring queries (the same
    Geometry objects) against one shared 32-point reference."""
    ref = serve_geometry(repro_torch, 32, 999)
    queries = [serve_geometry(repro_torch, SERVE_CATALOG_SIZES[
        i % len(SERVE_CATALOG_SIZES)], 100 + i)
        for i in range(SERVE_CATALOG_QUERIES)]
    return [repro_torch.QuadraticProblem(queries[i % len(queries)], ref)
            for i in range(SERVE_CATALOG_REQUESTS)]


def serve_spar_requests(repro_torch) -> list:
    """Queries of n in SERVE_SPAR_SIZES against one 512-point reference."""
    ref = serve_geometry(repro_torch, SERVE_SPAR_N, 999)
    return [repro_torch.QuadraticProblem(serve_geometry(
        repro_torch, SERVE_SPAR_SIZES[k % len(SERVE_SPAR_SIZES)], 200 + k),
        ref) for k in range(SERVE_SPAR_REQUESTS)]


def serve_fused_requests(repro_torch) -> list:
    """Four fused requests (n = 14 and 16, a random linear term, α = 0.5)
    for the poisoned flush."""
    out = []
    for k in range(4):
        n = 14 + 2 * (k % 2)
        M = np.random.default_rng(k).random((n, n)).astype(np.float32)
        out.append(repro_torch.QuadraticProblem(
            serve_geometry(repro_torch, n, 300 + k),
            serve_geometry(repro_torch, n, 400 + k), M=M, fused_penalty=0.5))
    return out


def k1_lanes_inputs(torch, dev):
    """K1's lane launch inputs at (SERVE_LANES, SERVE_SPAR_S): uniform
    matrices and t, off from a seeded generator on the card."""
    g = torch.Generator(device=dev).manual_seed(7)
    B, s = SERVE_LANES, SERVE_SPAR_S
    L = torch.rand(B, s, s, generator=g, device=dev)
    t = torch.rand(B, s, generator=g, device=dev) - 0.5
    off = torch.rand(B, s, generator=g, device=dev) - 3.0
    return L, t, off


def profile_solve(torch, fn, top: int = 8, extra=None) -> dict:
    """Trace ``fn()`` with torch.profiler: wall time, the summed device
    time of its CUDA kernels, the device's idle share, the top kernels,
    and what ``extra(prof)`` reads from the trace, if given.

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
            **(extra(prof) if extra else {}),
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


def k5_in_profile(prof) -> dict:
    """K5's device time in a profiled train step: its forward kernel's
    (self time), and its backward's (the device time under the autograd
    node ``FlashAttentionBackward``: plain torch ops)."""
    from torch.autograd import DeviceType

    def us(e, name):                 # device_* names; cuda_* before them
        value = getattr(e, f"{name}device_time_total", None)
        return getattr(e, f"{name}cuda_time_total") if value is None \
            else value

    fwd_us = bwd_us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            if "flash_attention_f32" in e.key:
                fwd_us += us(e, "self_")
        elif "FlashAttentionBackward" in e.key:      # the node and its range
            bwd_us = max(bwd_us, us(e, ""))
    return {"k5_forward_ms": fwd_us / 1e3,
            "k5_backward_ms": bwd_us / 1e3 if bwd_us else None}


def loss_grads(torch, model, params, batch, dev, **kw):
    """The loss of ``model`` on ``batch`` and its gradient with respect to
    every parameter, as float and tensors; a parameter the route leaves
    out of the graph (a kernel's output taken without one) gets zeros."""
    from repro_torch.optim import adamw

    live = adamw.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = model.loss(live, batch, device=dev, **kw)
    return float(loss.detach()), torch.autograd.grad(
        loss, adamw.tree_leaves(live), allow_unused=True,
        materialize_grads=True)


def rel_norm(got, want) -> float:
    """||got - want|| / ||want|| over all leaves (float64 sums)."""
    num = sum(float((a.double() - b.double()).pow(2).sum())
              for a, b in zip(got, want))
    return math.sqrt(num / sum(float(b.double().pow(2).sum())
                               for b in want))


def dropping_k5_gradient(fa, fa_ops):
    """A context in which K5's wrapper returns the kernel's output without
    a graph: the route whose gradient misses attention's q, k, v path."""
    @contextlib.contextmanager
    def ctx():
        launch = fa_ops.flash_attention_cuda
        fa_ops.flash_attention_cuda = lambda q, k, v, groups: \
            fa._flash_attention_forward(q.detach(), k.detach(), v.detach(),
                                        groups)
        try:
            yield
        finally:
            fa_ops.flash_attention_cuda = launch
    return ctx()


def train_phase(torch, dev, short, short_params) -> dict:
    """Phase "train": the training path on the card (see the module
    docstring). ``short`` is phase 7's zamba2-7b at 1 superblock + tail,
    ``short_params`` its bfloat16 weights. Returns the launches of K5 in
    the train run and of K6 in the zamba2 gradient, for the kernel line."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ssd
    from repro_torch.launch import steps as train_steps
    from repro_torch.launch import train as train_mod
    from repro_torch.models import Model
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.optim import adamw

    def batch_of(cfg, seq, batch, step=0):
        return {k: torch.as_tensor(v).to(dev) for k, v in TokenPipeline(
            cfg, seq, batch).global_batch_at(step).items()}

    def grads_of(model, params, batch, **kw):
        # the dropped routes leave wq, wk and wv out of the graph: zeros
        return loss_grads(torch, model, params, batch, dev, **kw)

    rel = rel_norm

    def launches():
        torch.cuda.synchronize()
        return {"flash_attention": fa.LAUNCHES["flash_attention"],
                "ssd_intra": ssd.LAUNCHES["ssd_intra"]}

    def reset():
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        ssd.reset_launch_counts()

    # (a) gradients through K5 (smollm-135m, full width and depth) and K6
    # (zamba2-7b, 1 superblock + tail), each against the plain version's and
    # against the route that drops the kernel's gradient (a ctypes output
    # with no graph: attention's q/k/v path, or the intra-chunk term, falls
    # out of the gradient)
    cfg = get_arch(TRAIN_ARCH)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    batch = batch_of(cfg, TRAIN_GRAD_SEQ, TRAIN_GRAD_BATCH)
    t0 = time.perf_counter()
    reset()
    loss_k, g_k = grads_of(model, params, batch, use_flash=True)
    k5_grad_launches = launches()
    k5_grad_wall = time.perf_counter() - t0
    loss_p, g_p = grads_of(model, params, batch, use_flash=True,
                           use_kernel=False)
    with dropping_k5_gradient(fa, fa_ops):
        loss_d, g_d = grads_of(model, params, batch, use_flash=True)
    attn_idx = [i for i, n in enumerate(leaf_names(params))
                if "/attn/w" in n]
    k5 = {"kernel": rel(g_k, g_p), "dropped": rel(g_d, g_p),
          "kernel_attn_weights": rel([g_k[i] for i in attn_idx],
                                     [g_p[i] for i in attn_idx]),
          "dropped_attn_weights": rel([g_d[i] for i in attn_idx],
                                      [g_p[i] for i in attn_idx]),
          "loss": {"kernel": loss_k, "plain": loss_p, "dropped": loss_d},
          "launches": k5_grad_launches, "wall_s": k5_grad_wall}
    del g_k, g_p, g_d, params
    torch.cuda.empty_cache()

    zparams = short._cast_params(short_params, torch.float32, dev)
    zbatch = batch_of(short.cfg, TRAIN_GRAD_SEQ, TRAIN_GRAD_BATCH)
    t0 = time.perf_counter()
    reset()
    zl_k, zg_k = grads_of(short, zparams, zbatch)
    k6_grad_launches = launches()
    k6_grad_wall = time.perf_counter() - t0
    zl_p, zg_p = grads_of(short, zparams, zbatch, use_kernel=False)
    launch_k6 = ssm_mod.ssd_intra
    ssm_mod.ssd_intra = lambda *a, device: ssd._ssd_intra_forward(
        *(t.detach().float().contiguous() for t in a))
    try:
        zl_d, zg_d = grads_of(short, zparams, zbatch)
    finally:
        ssm_mod.ssd_intra = launch_k6
    k6 = {"kernel": rel(zg_k, zg_p), "dropped": rel(zg_d, zg_p),
          "loss": {"kernel": zl_k, "plain": zl_p, "dropped": zl_d},
          "launches": k6_grad_launches, "wall_s": k6_grad_wall}
    del zg_k, zg_p, zg_d, zparams
    torch.cuda.empty_cache()
    print(json.dumps({"train_gradients": {
        "k5_smollm_135m": {"batch": TRAIN_GRAD_BATCH, "seq": TRAIN_GRAD_SEQ,
                           "limit": K5_GRAD_REL, **k5},
        "k6_zamba2_7b_1_superblock": {"batch": TRAIN_GRAD_BATCH,
                                      "seq": TRAIN_GRAD_SEQ,
                                      "limit": K6_GRAD_REL, **k6}}}))
    want_k5 = {"flash_attention": cfg.n_layers, "ssd_intra": 0}
    want_k6 = {"flash_attention": 0,
               "ssd_intra": len(short.cfg.block_pattern)
               + len(short.cfg.tail_blocks)}
    if k5_grad_launches != want_k5 or k6_grad_launches != want_k6 \
            or not k5["kernel"] <= K5_GRAD_REL < k5["dropped"] \
            or not k6["kernel"] <= K6_GRAD_REL < k6["dropped"]:
        raise AssertionError(
            f"train gradients: K5 {k5['kernel']:.3g} (dropped "
            f"{k5['dropped']:.3g}, limit {K5_GRAD_REL}), K6 "
            f"{k6['kernel']:.3g} (dropped {k6['dropped']:.3g}, limit "
            f"{K6_GRAD_REL}); launches {k5_grad_launches} / "
            f"{k6_grad_launches}, expected {want_k5} / {want_k6}")

    # (b) launch.train.train at full width and depth: flash attention and
    # the alignment loss on, a checkpoint every TRAIN_CKPT_EVERY steps
    log = io.StringIO()
    with tempfile.TemporaryDirectory() as ckpt:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            p_tr, s_tr, hist = train_mod.train(
                cfg, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, ckpt_dir=ckpt,
                ckpt_every=TRAIN_CKPT_EVERY, use_flash=True, gw_align=True,
                log_every=TRAIN_CKPT_EVERY)
        train_wall = time.perf_counter() - t0
        train_launches = launches()
        peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
        ckpt_steps = CheckpointManager(ckpt).all_steps()
    walls = sorted(h["step_s"] for h in hist)
    step_s = walls[len(walls) // 2]
    first = sum(h["ce"] for h in hist[:5]) / 5
    last = sum(h["ce"] for h in hist[-5:]) / 5
    want_train = {"flash_attention": 2 * cfg.n_layers * TRAIN_STEPS,
                  "ssd_intra": 0}          # remat runs each forward twice

    # one more step, profiled, after a warm one; K5 at the step's shape
    step_fn = train_steps.make_train_step(
        model, act_dtype=torch.float32, remat=True, use_flash=True,
        gw_align=True, warmup=max(1, TRAIN_STEPS // 10),
        total_steps=TRAIN_STEPS)
    state = [p_tr, s_tr]
    tb = batch_of(cfg, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS)

    def one_step():
        state[0], state[1], m = step_fn(state[0], state[1], tb)
        return float(m["loss"])

    one_step()
    prof = profile_solve(torch, one_step, top=10, extra=k5_in_profile)
    # the same step without the alignment loss (the same model path, warm):
    # the loss's share of the launches
    plain_fn = train_steps.make_train_step(
        model, act_dtype=torch.float32, remat=True, use_flash=True,
        warmup=max(1, TRAIN_STEPS // 10), total_steps=TRAIN_STEPS)

    def one_plain_step():
        state[0], state[1], m = plain_fn(state[0], state[1], tb)
        return float(m["loss"])

    prof_no_align = profile_solve(torch, one_plain_step, top=3)
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v, cot = (torch.randn(TRAIN_BATCH * n, TRAIN_SEQ, hd, generator=g,
                                device=dev) for n in (H, K, K, H))
    k5_fwd_ms = time_ms(torch, lambda: fa.flash_attention_cuda(
        q, k, v, H // K), 20)
    k5_bwd_ms = time_ms(torch, lambda: fa.flash_attention_backward_plain(
        q, k, v, H // K, cot), 10)
    del q, k, v, cot, state, p_tr, s_tr
    torch.cuda.empty_cache()

    # (c) N steps and a resume of N more against 2N straight, bit for bit,
    # under deterministic algorithms (the embedding's and the alignment
    # loss's index backwards otherwise sum with atomics)
    kw = dict(use_flash=True, gw_align=True, log_every=0)
    torch.use_deterministic_algorithms(True)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            pa, _, ha = train_mod.train(cfg, 2 * RESUME_STEPS, RESUME_BATCH,
                                        RESUME_SEQ, **kw)
            with tempfile.TemporaryDirectory() as ckpt:
                train_mod.train(cfg, RESUME_STEPS, RESUME_BATCH, RESUME_SEQ,
                                ckpt_dir=ckpt, ckpt_every=RESUME_STEPS,
                                schedule_total=2 * RESUME_STEPS, **kw)
                pb, _, hb = train_mod.train(cfg, 2 * RESUME_STEPS,
                                            RESUME_BATCH, RESUME_SEQ,
                                            ckpt_dir=ckpt,
                                            ckpt_every=RESUME_STEPS, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    resume_wall = time.perf_counter() - t0
    resume_losses = [h["loss"] for h in ha[RESUME_STEPS:]]
    bitwise = resume_losses == [h["loss"] for h in hb] and all(
        torch.equal(x, y) for x, y in zip(adamw.tree_leaves(pa),
                                          adamw.tree_leaves(pb)))
    del pa, pb
    torch.cuda.empty_cache()

    print(json.dumps({"train_path": {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "act_dtype": "float32", "use_flash": True, "gw_align": True,
        "remat": True, "wall_s": train_wall, "step_median_s": step_s,
        "step_walls_s": [h["step_s"] for h in hist],
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
        "peak_memory_gib_above_start": peak_gib,
        "ce_first_5": first, "ce_last_5": last,
        "losses": [h["loss"] for h in hist],
        "checkpoints": ckpt_steps, "launches": train_launches,
        "profiled_step": prof, "profiled_step_no_gw_align": prof_no_align,
        "k5_at_step_shape_ms": {"forward": k5_fwd_ms,
                                "backward_plain": k5_bwd_ms},
        "log": log.getvalue().strip().splitlines(),
        "resume": {"steps": RESUME_STEPS, "batch": RESUME_BATCH,
                   "seq_len": RESUME_SEQ, "deterministic": True,
                   "bitwise": bitwise, "losses": resume_losses,
                   "wall_s": resume_wall}}}))
    if not all(math.isfinite(h["loss"]) for h in hist) or not last < first \
            or train_launches != want_train \
            or ckpt_steps != [TRAIN_CKPT_EVERY, TRAIN_STEPS]:
        raise AssertionError(f"train: ce {first:.4f} -> {last:.4f}, "
                             f"launches {train_launches} (expected "
                             f"{want_train}), checkpoints {ckpt_steps}")
    if not bitwise:
        raise AssertionError("train: the resumed run is not bit for bit "
                             "the straight one")
    return {"flash_attention": train_launches["flash_attention"],
            "ssd_intra": k6_grad_launches["ssd_intra"]}


# the torch ops of the MoE dispatch (routing, slots, the token <-> slot
# hops); aten::index also serves the embedding lookup
MOE_DISPATCH_OPS = ("aten::sort", "aten::one_hot", "aten::cumsum",
                    "aten::gather", "aten::index_add_", "aten::index_put",
                    "aten::index", "aten::where")


def dispatch_in_profile(prof) -> dict:
    """Device time under each MoE dispatch op of a profiled run (the op's
    kernels), and their sum, in ms."""
    def us(e):                       # device_* names; cuda_* before them
        value = getattr(e, "device_time_total", None)
        return e.cuda_time_total if value is None else value

    ops = {e.key: us(e) / 1e3 for e in prof.key_averages()
           if e.key in MOE_DISPATCH_OPS}
    return {"moe_dispatch_ms": ops,
            "moe_dispatch_total_ms": sum(ops.values())}


def arch_phase(torch, dev) -> dict:
    """Phase 7c: each architecture of ``ARCHS`` in turn (see the module
    docstring), its weights freed before the next. Returns K5's launches
    in each bf16 prefill, llama4-scout's profiled prefill and the
    walls."""
    from repro_torch.configs import get_arch, get_reduced, scale_down
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve as lm_serve
    from repro_torch.launch import steps as train_steps
    from repro_torch.models import Model
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.optim import adamw

    def k5():
        torch.cuda.synchronize()
        return fa.LAUNCHES["flash_attention"]

    def depth(cfg, n_sb, **kw):
        return scale_down(cfg, n_superblocks=n_sb, n_layers=n_sb * len(
            cfg.block_pattern) + len(cfg.tail_blocks), **kw)

    def attn_layers(cfg):
        if cfg.attn_type == "mla":
            return 0
        return cfg.resolved_superblocks * sum(
            k in ("attn", "moe") for k in cfg.block_pattern)

    def draw_tokens(cfg, gen, B, S):
        shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, S)
        return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             device=dev)

    def draw_img(cfg, gen, B):
        if not cfg.n_image_tokens:
            return None
        return torch.randn((B, cfg.n_image_tokens, cfg.d_model),
                           generator=gen, device=dev)

    out = {"launches": {}, "walls_s": {}, "llama4_prefill_profile": None}
    for name, n_sb, want_k5 in ARCHS:
        t_arch = time.perf_counter()
        full = get_arch(name)
        cfg = depth(full, n_sb)
        model = Model(cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = model.init(gen, device=dev)                # float32
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in leaves(params))
        row = {"arch": cfg.name, "superblocks": n_sb,
               "of_published": full.resolved_superblocks,
               "n_params": n_params, "d_model": cfg.d_model}

        # (a) one fp32 forward at 1 superblock through K5 and through its
        # plain version (MoE at capacity factor 100)
        short = Model(depth(cfg, 1, capacity_factor=ARCH_MOE_CF
                            if cfg.n_experts else cfg.capacity_factor))
        sp = {**params, "blocks": params["blocks"][:1]}
        toks = draw_tokens(cfg, gen, 1, ARCH_FWD_SEQ)
        img1 = draw_img(cfg, gen, 1)
        with torch.no_grad():
            fa.reset_launch_counts()
            lk = short.forward(sp, toks, img=img1, use_flash=True)[0]
            a_k5 = k5()
            lp = short.forward(sp, toks, img=img1, use_flash=True,
                               use_kernel=False)[0]
        a_err = float((lk - lp).abs().max() / lp.abs().max())
        a_ok = bool(lk.isfinite().all())
        del lk, lp
        if a_k5 != attn_layers(short.cfg) or not a_ok \
                or not a_err <= LM_LOGIT_REL:
            raise AssertionError(f"{name} (a): K5 launches {a_k5} "
                                 f"(expected {attn_layers(short.cfg)}), "
                                 f"max rel err {a_err:.3g} (bound "
                                 f"{LM_LOGIT_REL}), finite {a_ok}")
        row["a_fp32_forward_1_superblock"] = {
            "seq": ARCH_FWD_SEQ, "k5_launches": a_k5,
            "max_rel_err_vs_plain": a_err, "bound": LM_LOGIT_REL}

        # (c) teacher-forced decode against the forward, 1 superblock, fp32
        prompt = toks[:, :DECODE_PROMPT]
        with torch.no_grad():
            fa.reset_launch_counts()
            fwd = short.forward(sp, prompt, img=img1, use_flash=True)[0]
            c_k5 = k5()
            cache = short.init_cache(1, DECODE_PROMPT, dtype=torch.float32,
                                     device=dev)
            steps = [short.decode_step(sp, prompt[:, t:t + 1], cache, t,
                                       img=img1, act_dtype=torch.float32)[0]
                     for t in range(DECODE_PROMPT)]
        dec = torch.cat(steps, dim=1)
        excess = float(((dec - fwd).abs() - DECODE_RTOL * fwd.abs()).max())
        dec_dist = float((dec - fwd).abs().max())
        if excess > DECODE_ATOL or not bool(dec.isfinite().all()) \
                or k5() != c_k5:
            raise AssertionError(f"{name} (c): decode vs forward max |diff| "
                                 f"{dec_dist}, excess over rtol "
                                 f"{DECODE_RTOL}: {excess} (atol "
                                 f"{DECODE_ATOL}); decode launched K5")
        row["c_decode_vs_forward"] = {
            "tokens": DECODE_PROMPT, "max_abs_diff": dec_dist,
            "max_abs_forward_logit": float(fwd.abs().max()),
            "bound": {"atol": DECODE_ATOL, "rtol": DECODE_RTOL}}
        del sp, toks, fwd, dec, steps, cache

        # (b) the bf16 prefill at the table's depth
        pb = model._cast_params(params, torch.bfloat16, dev)
        del params
        torch.cuda.empty_cache()
        S = XLSTM_PREFILL_SEQ if name == "xlstm_125m" else ARCH_PREFILL_SEQ
        toks = draw_tokens(cfg, gen, 1, S)
        img = draw_img(cfg, gen, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, cache = model.prefill(pb, toks, img=img, use_flash=True)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        b_k5 = k5()
        want_shape = (1, 1) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1
                               else ()) + (cfg.vocab_size,)
        if b_k5 != want_k5 or b_k5 != attn_layers(cfg) \
                or tuple(logits.shape) != want_shape \
                or not bool(logits.isfinite().all()):
            raise AssertionError(f"{name} (b): K5 launches {b_k5} (expected "
                                 f"{want_k5}), logits {tuple(logits.shape)},"
                                 f" finite {bool(logits.isfinite().all())}")
        del logits, cache
        walls = []
        for _ in range(ARCH_PREFILL_REPS):
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, cache = model.prefill(pb, toks, img=img,
                                              use_flash=True)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            del logits, cache
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        prefill_s = sorted(walls)[len(walls) // 2]
        out["launches"][name] = b_k5
        row["b_bf16_prefill"] = {
            "batch": 1, "seq": S, "images": cfg.n_image_tokens or None,
            "k5_launches": b_k5, "first_s": first_s, "walls_s": walls,
            "median_s": prefill_s, "tokens_per_s": S / prefill_s,
            "peak_memory_gib_above_start": peak,
            "params_gib": sum(t.numel() * t.element_size()
                              for t in leaves(pb)) / 2**30}
        if name == "llama4_scout_17b_a16e":
            def prefill_once():
                with torch.no_grad():
                    return model.prefill(pb, toks, img=img,
                                         use_flash=True)[0].sum().item()
            out["llama4_prefill_profile"] = profile_solve(
                torch, prefill_once, top=16, extra=dispatch_in_profile)
        if name == "xlstm_125m":
            # one sLSTM block alone at the full prefill length
            blk = next(i for i, k in enumerate(cfg.block_pattern)
                       if k == "slstm")
            lstm_p = pb["blocks"][0][f"b{blk}"]["lstm"]
            x = torch.randn((1, ARCH_PREFILL_SEQ, cfg.d_model),
                            generator=gen, device=dev).to(torch.bfloat16)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                ssm_mod.slstm_block(lstm_p, cfg, x)
            torch.cuda.synchronize()
            row["slstm_block_loop"] = {
                "seq": ARCH_PREFILL_SEQ, "wall_s": time.perf_counter() - t0}
            del x

        # (c) generate at the table's depth, bf16: B = 4, prompt 32, 16 new
        prompts = draw_tokens(cfg, gen, DECODE_BATCH, DECODE_PROMPT)
        img4 = draw_img(cfg, gen, DECODE_BATCH)
        t0 = time.perf_counter()
        with torch.no_grad():
            seqs = lm_serve.generate(model, pb, prompts, DECODE_NEW,
                                     act_dtype=torch.bfloat16, img=img4)
        torch.cuda.synchronize()
        gen_wall = time.perf_counter() - t0
        new = seqs[:, DECODE_PROMPT:]
        if tuple(seqs.shape) != (DECODE_BATCH, DECODE_PROMPT + DECODE_NEW) \
                + tuple(prompts.shape[2:]) \
                or not torch.equal(seqs[:, :DECODE_PROMPT], prompts) \
                or not bool(((new >= 0) & (new < cfg.vocab_size)).all()):
            raise AssertionError(f"{name} (c): generate gave "
                                 f"{tuple(seqs.shape)} or tokens out of "
                                 f"range")
        row["c_generate"] = {
            "batch": DECODE_BATCH, "prompt": DECODE_PROMPT,
            "new_tokens": DECODE_NEW, "wall_s": gen_wall,
            "tokens_per_s": DECODE_BATCH * DECODE_NEW / gen_wall}
        del pb, seqs, prompts, img, img1, img4, toks, model, short
        torch.cuda.empty_cache()

        # (d) one train step at the CPU tests' reduced config
        rcfg = get_reduced(name)
        rmodel = Model(rcfg)
        rp = rmodel.init(torch.Generator(device=dev).manual_seed(0),
                         device=dev)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in TokenPipeline(
            rcfg, 32, 2).global_batch_at(0).items()}
        step_fn = train_steps.make_train_step(
            rmodel, act_dtype=torch.float32, remat=True, use_flash=True,
            warmup=2, total_steps=10)
        new_p, _, m = step_fn(rp, adamw.init(rp), batch)
        m = {k: float(v) for k, v in m.items()}
        changed = all(not torch.equal(x, y) for x, y in zip(
            adamw.tree_leaves(rp), adamw.tree_leaves(new_p)))
        if not math.isfinite(m["loss"]) or not changed \
                or (m["aux"] > 0) != bool(rcfg.n_experts):
            raise AssertionError(f"{name} (d): train step {m}, every "
                                 f"parameter changed: {changed}")
        row["d_train_step_reduced"] = m
        del rp, new_p, batch, rmodel

        if name == ARCH_GRAD[0]:
            row["d_gradient"] = moe_gradient(torch, dev, full)
        out["walls_s"][name] = row["wall_s"] = time.perf_counter() - t_arch
        print(json.dumps({"arch_path": row}))
        torch.cuda.empty_cache()
    return out


def moe_gradient(torch, dev, full) -> dict:
    """Phase 7c (d): the loss gradient of ``full`` at published width, 1
    superblock, capacity factor 100, B x S of ``ARCH_GRAD``, fp32, through
    K5 against the gradient through K5's plain version, within
    ``K5_GRAD_REL``; the route that drops K5's gradient must miss it."""
    from repro_torch.configs import scale_down
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import Model

    _, B, S = ARCH_GRAD
    cfg = scale_down(full, n_superblocks=1, n_layers=len(full.block_pattern),
                     capacity_factor=ARCH_MOE_CF)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in TokenPipeline(
        cfg, S, B).global_batch_at(0).items()}
    t0 = time.perf_counter()
    fa.reset_launch_counts()
    loss_k, g_k = loss_grads(torch, model, params, batch, dev,
                             use_flash=True)
    torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_attention"]
    wall = time.perf_counter() - t0
    loss_p, g_p = loss_grads(torch, model, params, batch, dev,
                             use_flash=True, use_kernel=False)
    with dropping_k5_gradient(fa, fa_ops):
        loss_d, g_d = loss_grads(torch, model, params, batch, dev,
                                 use_flash=True)
    res = {"batch": B, "seq": S, "limit": K5_GRAD_REL,
           "kernel": rel_norm(g_k, g_p), "dropped": rel_norm(g_d, g_p),
           "loss": {"kernel": loss_k, "plain": loss_p, "dropped": loss_d},
           "k5_launches": launches, "wall_s": wall}
    del g_k, g_p, g_d, params
    torch.cuda.empty_cache()
    if launches != 1 or not res["kernel"] <= K5_GRAD_REL < res["dropped"]:
        raise AssertionError(f"{cfg.name} gradient: {res}")
    return res


def leaf_names(tree, prefix="") -> list:
    """Key paths of the tensors of a nest of dicts and lists, in the order
    ``optim.adamw.tree_leaves`` walks them."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(
            v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(
            v, f"{prefix}/{i}")]
    return [prefix]


def split_mamba(tree, cfg):
    """Every Mamba2 block's fused ``in_proj`` of a parameter tree split
    into ``split_proj``'s ``in_zx`` (columns [z, x]) and ``in_bcdt``
    ([B, C, dt]); the other leaves as they are."""
    if isinstance(tree, dict):
        if "in_proj" in tree:
            d_in = cfg.ssm_expand * cfg.d_model
            out = {k: v for k, v in tree.items() if k != "in_proj"}
            out["in_zx"] = tree["in_proj"][:, :2 * d_in].contiguous()
            out["in_bcdt"] = tree["in_proj"][:, 2 * d_in:].contiguous()
            return out
        return {k: split_mamba(v, cfg) for k, v in tree.items()}
    if isinstance(tree, list):
        return [split_mamba(v, cfg) for v in tree]
    return tree


def start_dryruns(tmp: Path) -> dict:
    """Phase 10's dry runs, started in child processes (the fake group is
    process-wide) on the host's CPU before the train phase, beside which
    they run: {name: (process, log path)}. They read no card."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    arch, shape = MESH_DRYRUN
    children = {}
    for name, args in (
            ("cell", ["--arch", arch, "--shape", shape, "--mesh", "single"]),
            ("gw", ["--gw", "--mesh", "single"])):
        log = tmp / f"dryrun_{name}.log"
        with open(log, "w") as f:
            children[name] = (subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                 "--device", "cpu", "--out", str(tmp / "dryrun")], env=env,
                stdout=f, stderr=subprocess.STDOUT), log)
    return children


def mesh_phase(torch, dev, short, short_params, tokens, tmp, dryruns,
               t_dryruns) -> dict:
    """Phase 10: the distributed layer on the card (see the module
    docstring). ``short`` is phase 7's zamba2-7b at 1 superblock + tail,
    ``short_params`` its bfloat16 weights and ``tokens`` phase 7's batch;
    ``dryruns`` the children of :func:`start_dryruns`, started at
    ``t_dryruns`` and writing under ``tmp``. Returns K5's launches in the
    mesh run and K6's in the split_proj forward, for the kernel line."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.distrib import compression, pipeline
    from repro_torch.distrib import sharding as shd
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssd import ssd
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.optim import adamw

    torch.distributed.init_process_group(
        "nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)
    try:
        out = _mesh_runs(torch, dev, tmp, make_host_mesh, get_arch, Model,
                         train_mod, CheckpointManager, shd, adamw, fa)
        out["collectives"] = _mesh_collectives(
            torch, dev, compression, pipeline, init_device_mesh)
    finally:
        torch.distributed.destroy_process_group()

    # zamba2-7b at full width with split_proj, against the fused route
    out["split_proj"] = _split_proj_check(torch, short, short_params,
                                          tokens, ssd)
    torch.cuda.empty_cache()

    # the dry runs' records
    t_wait = time.perf_counter()
    for name, (child, log) in dryruns.items():
        child.wait(timeout=MESH_DRYRUN_TIMEOUT)
        if child.returncode != 0:
            raise AssertionError(f"dry run {name} failed:\n"
                                 f"{log.read_text()}")
    now = time.perf_counter()
    out["dryrun_children_wall_s"] = now - t_dryruns
    out["dryrun_wait_in_phase_s"] = now - t_wait
    arch, shape = MESH_DRYRUN
    records = {}
    for name, fname in (
            ("cell", f"{arch}__{shape}__single.json"),
            ("gw", "spargw-engine__grid8192x8192__single.json")):
        with open(tmp / "dryrun" / fname) as f:
            rec = json.load(f)
        records[name] = {
            k: rec[k] for k in ("arch", "shape", "mesh_shape", "n_params",
                                "lower_s", "flops_per_device",
                                "bytes_per_device")}
        records[name]["memory"] = rec["memory"]
        records[name]["collectives"] = {
            k: v["count"] for k, v in rec["collectives"].items()}
        records[name]["wire_bytes"] = sum(
            v["wire_bytes"] for v in rec["collectives"].values())
    out["dryrun"] = records
    print(json.dumps({"mesh_path": out}))
    return {"flash_attention": out["train"]["k5_launches"],
            "ssd_intra": out["split_proj"]["k6_launches"]}


def _split_proj_check(torch, short, short_params, tokens, ssd):
    """zamba2-7b (phase 7's weights, 1 superblock + tail, fp32) with
    ``split_proj`` against the fused route. Both run K6; they differ only
    in how cuBLAS sums the fp32 input projection (one (d, 2·d_in + 2N + H)
    product, or two by columns). Read alongside: the first block's K6
    inputs on both routes; each route against one whose projection is
    summed in float64 and rounded once (the fp32 rounding each route
    carries); and a stand-in that rounds the projection's activations to
    TF32, held to fail SPLIT_PROJ_REL."""
    from repro_torch.models import ssm as ssm_mod

    def tf32(x):                      # rounded to TF32, to nearest
        return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    def projection(mode):
        """A weight type whose ``x @ w`` is summed in float64 (``exact``)
        or takes x rounded to TF32 (``tf32``)"""
        class Proj(torch.Tensor):
            @classmethod
            def __torch_function__(cls, func, types, args=(), kwargs=None):
                if func in (torch.Tensor.matmul, torch.Tensor.__matmul__):
                    x, w = (a.as_subclass(torch.Tensor) for a in args)
                    if mode == "exact":
                        return (x.double() @ w.double()).float()
                    return tf32(x) @ w
                return super().__torch_function__(func, types, args,
                                                  kwargs or {})
        return Proj

    def with_proj(tree, cls):
        if isinstance(tree, dict):
            return {k: v.as_subclass(cls) if k in (
                "in_proj", "in_zx", "in_bcdt") else with_proj(v, cls)
                for k, v in tree.items()}
        if isinstance(tree, list):
            return [with_proj(v, cls) for v in tree]
        return tree

    def run(params):
        """the logits and the first K6 call's inputs"""
        seen, k6 = [], ssm_mod.ssd_intra

        def first_inputs(*a, **kw):
            if not seen:
                seen.append([t.detach().clone() for t in a])
            return k6(*a, **kw)
        ssm_mod.ssd_intra = first_inputs
        try:
            logits = short.forward(params, tokens, act_dtype=torch.float32,
                                   use_flash=True)[0]
        finally:
            ssm_mod.ssd_intra = k6
        return logits, seen[0]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    split_params = split_mamba(short_params, short.cfg)
    fused, fused_in = run(short_params)
    torch.cuda.synchronize()
    ssd.reset_launch_counts()
    split, split_in = run(split_params)
    torch.cuda.synchronize()
    k6 = ssd.LAUNCHES["ssd_intra"]
    exact, _ = run(with_proj(short_params, projection("exact")))
    stand_in, _ = run(with_proj(split_params, projection("tf32")))
    want_k6 = sum(k == "mamba2" for k in short.cfg.block_pattern
                  + short.cfg.tail_blocks)
    out = {"arch": short.cfg.name, "d_model": short.cfg.d_model,
           "superblocks": 1,
           "max_rel_err_vs_fused": rel(split, fused),
           "first_k6_inputs_rel_err": {
               name: rel(a, b) for name, a, b in zip(
                   ("xdt", "cs", "Bm", "Cm"), split_in, fused_in)},
           "vs_float64_projection": {"fused": rel(fused, exact),
                                     "split": rel(split, exact)},
           "tf32_stand_in_vs_fused": rel(stand_in, fused),
           "limit": SPLIT_PROJ_REL, "k6_launches": k6}
    del fused, split, exact, stand_in, split_params, fused_in, split_in
    if not out["max_rel_err_vs_fused"] <= SPLIT_PROJ_REL \
            or not out["tf32_stand_in_vs_fused"] > SPLIT_PROJ_REL \
            or k6 != want_k6:
        raise AssertionError(f"split_proj forward: {out} (expected "
                             f"{want_k6} K6 launches, the split route "
                             f"within the limit, the TF32 stand-in past "
                             f"it)")
    return out


def _mesh_runs(torch, dev, tmp, make_host_mesh, get_arch, Model, train_mod,
               CheckpointManager, shd, adamw, fa):
    """train(mesh=) on a 1 x 1 mesh against train(mesh=None), in turns;
    the checkpoint restored onto the mesh."""
    cfg = get_arch(MESH_ARCH)
    mesh = make_host_mesh((1, 1))
    ckpt = str(tmp / "ckpt")
    kw = dict(use_flash=True, log_every=0)
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for name, on_mesh in (("mesh_a", True), ("unsharded", False),
                              ("mesh_b", True)):
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            extra = {"mesh": mesh} if on_mesh else {}
            if name == "mesh_a":
                extra.update(ckpt_dir=ckpt, ckpt_every=MESH_STEPS)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                p, s_, hist = train_mod.train(cfg, MESH_STEPS, MESH_BATCH,
                                              MESH_SEQ, **kw, **extra)
            torch.cuda.synchronize()
            walls = sorted(h["step_s"] for h in hist)
            runs[name] = {"wall_s": time.perf_counter() - t0,
                          "step_median_s": walls[len(walls) // 2],
                          "step_walls_s": [h["step_s"] for h in hist],
                          "losses": [h["loss"] for h in hist],
                          "k5_launches": fa.LAUNCHES["flash_attention"]}
            if name == "mesh_a":
                mesh_state = (p, s_)
            del p, s_
    finally:
        torch.use_deterministic_algorithms(False)
    model = Model(cfg)
    psh = shd.param_shardings(model.param_axes(), model.abstract_params(),
                              mesh)
    state_sh = {"params": psh,
                "opt": adamw.AdamWState(shd.replicated(mesh), psh, psh)}
    target = {"params": mesh_state[0], "opt": mesh_state[1]}
    restored, _ = CheckpointManager(ckpt).restore(MESH_STEPS, target,
                                                  state_sh)
    full = (lambda t: t.full_tensor() if shd.is_dtensor(t) else t)
    def state_leaves(state):          # AdamWState's fields walked too
        opt = state["opt"]
        return adamw.tree_leaves([state["params"], opt.step, opt.m, opt.v])

    pairs = list(zip(state_leaves(restored), state_leaves(target)))
    restore_bitwise = all(shd.is_dtensor(r)
                          and torch.equal(full(r), full(t))
                          for r, t in pairs)
    del restored, target, mesh_state, pairs
    torch.cuda.empty_cache()
    base = runs["unsharded"]["losses"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(
        runs["mesh_a"]["losses"], base))
    want_k5 = 2 * cfg.n_layers * MESH_STEPS       # remat: two forwards
    out = {"train": {"arch": cfg.name, "mesh": [1, 1], "backend": "nccl",
                     "batch": MESH_BATCH, "seq_len": MESH_SEQ,
                     "steps": MESH_STEPS, "use_flash": True,
                     "deterministic": True, "runs": runs,
                     "max_rel_loss_gap": gap, "limit": MESH_LOSS_RTOL,
                     "k5_launches": runs["mesh_a"]["k5_launches"],
                     "restore_bitwise": restore_bitwise}}
    if not gap <= MESH_LOSS_RTOL or not restore_bitwise \
            or runs["mesh_a"]["k5_launches"] != want_k5 \
            or not all(math.isfinite(x) for x in base):
        raise AssertionError(f"train(mesh=): max rel loss gap {gap} "
                             f"(limit {MESH_LOSS_RTOL}), K5 "
                             f"{runs['mesh_a']['k5_launches']} launches "
                             f"(expected {want_k5}), restore bitwise "
                             f"{restore_bitwise}")
    return out


def _mesh_collectives(torch, dev, compression, pipeline, init_device_mesh):
    """compressed_psum within the reference's bound (block max / 127) and
    pipeline_forward at one stage against the sequential loop."""
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(MESH_PSUM_N, generator=g, device=dev) * 3.0
    got = compression.compressed_psum(x)
    blocks = torch.nn.functional.pad(x, (0, (-x.numel()) % 256)).reshape(
        -1, 256)
    bound = (blocks.abs().amax(dim=1, keepdim=True) / 127.0).expand(
        -1, 256).reshape(-1)[:x.numel()]
    excess = float(((got - x).abs() - bound).max())
    W = torch.randn(16, 16, generator=g, device=dev) * 0.3
    xs = torch.randn(8, 2, 16, generator=g, device=dev)
    pmesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pipe",))
    piped = pipeline.pipeline_forward(pmesh, lambda w, v: torch.tanh(v @ w),
                                      1, 8)(W, xs)
    pipe_err = float((piped - torch.tanh(xs @ W)).abs().max())
    out = {"psum_n": MESH_PSUM_N, "psum_max_excess_over_bound": excess,
           "pipeline_max_abs_err": pipe_err}
    if not excess <= 0 or not pipe_err <= 1e-5:
        raise AssertionError(f"collectives: compressed_psum exceeds its "
                             f"bound by {excess}; pipeline err {pipe_err}")
    return out


def main(parent: Path | None = None) -> int:
    # the train phase's resume runs under deterministic algorithms, whose
    # cuBLAS needs this before the first cuBLAS call (32 MiB: the default
    # workspace on the H100)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    from repro_torch.core.utils import flush_subnormal, log_floor
    from repro_torch.kernels import cuda_lib, dispatch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_error_scale
    from repro_torch.kernels.gw_cost import gw_cost
    from repro_torch.kernels.gw_cost import ref as gw_ref
    from repro_torch.kernels.sinkhorn import ops as sinkhorn_ops
    from repro_torch.kernels.sinkhorn import sinkhorn
    from repro_torch.kernels.spar_cost import ops, ref, spar_cost
    from repro_torch.kernels.sparse_sinkhorn import sparse_sinkhorn as k7
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.ssd.ref import ssd_intra_error_scale
    from repro_torch.lowrank import solver as lowrank_solver
    from repro_torch.lowrank.init import LowRankDraws
    from repro_torch.core import sampling
    # the module (the package exports the function sinkhorn, as repro.core)
    sinkhorn_loops = importlib.import_module("repro_torch.core.sinkhorn")
    from repro_torch.health import FaultSpec, SolveDivergedError
    from repro_torch.lowrank.solver import LowRankGWSolver
    from repro_torch.multiscale import (
        QuantizedDraws,
        QuantizedGWSolver,
        compress_problem,
        select_anchors,
    )
    from repro_torch.multiscale.anchors import draw_anchors, draw_start
    from repro_torch import diff, obs
    from repro_torch.models import Model
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.serve import GWServer, ServeConfig, pad_problem
    from repro_torch.serve.batching import stack_items
    from repro_torch.serve.lanes import run_lanes

    dev = torch.device("cuda")

    # -- 1. the card -------------------------------------------------------
    stamps = [("1", time.perf_counter())]    # (phase, its start), host clock
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- 2. build ----------------------------------------------------------
    stamps.append(("2", time.perf_counter()))
    t0 = time.perf_counter()
    reports = cuda_lib.build(["spar_matvec", "spar_cost_fused", "gw_cost",
                              "sinkhorn", "flash_attention", "ssd_intra",
                              "sparse_sinkhorn"])
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
    # K1's autograd.Function (the kernel forward, a plain torch backward)
    # against autograd through the plain version, at a ragged s: dLmat =
    # g ⊗ t and doff = g exactly, dt = Lmatᵀ g within the kernel bound
    s_g = 1003
    ins = [rand(s_g, s_g), rand(s_g) - 0.5, rand(s_g, lo=-3.0)]
    w_g = rand(s_g) - 0.5
    got = [x.clone().requires_grad_(True) for x in ins]
    want = [x.clone().requires_grad_(True) for x in ins]
    out_k = spar_cost.spar_matvec_cuda(*got)
    if "SparMatvec" not in type(out_k.grad_fn).__name__:
        raise AssertionError(f"spar_matvec: no SparMatvec node "
                             f"({out_k.grad_fn})")
    g_k = torch.autograd.grad((out_k * w_g).sum(), got)
    g_p = torch.autograd.grad(
        (spar_cost.spar_matvec_plain(*want) * w_g).sum(), want)
    torch.cuda.synchronize()
    if not (torch.equal(g_k[0], g_p[0]) and torch.equal(g_k[2], g_p[2])):
        raise AssertionError("spar_matvec backward: dLmat or doff differ "
                             "from autograd through the plain version")
    check(torch, f"spar_matvec backward dt s={s_g}", g_k[1], g_p[1],
          ins[0].abs().t() @ w_g.abs())
    del L, ins, got, want, out_k, g_k, g_p
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
    del Cx, Cy
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
    k7.reset_launch_counts()
    t0 = time.perf_counter()
    out_auto = repro_torch.solve(problem,
                                 generator=torch.Generator(dev).manual_seed(0))
    v_auto = float(out_auto.value)
    torch.cuda.synchronize()
    wall_auto = time.perf_counter() - t0
    # K7's launches a solve: 2 a Sinkhorn iteration of every outer step
    k7_launches = {"main_path_auto": k7_count(k7)}
    k7.reset_launch_counts()
    support = (out_auto.coupling.rows, out_auto.coupling.cols)
    t0 = time.perf_counter()
    out_fused = repro_torch.solve(problem, forced, support=support)
    v_fused = float(out_fused.value)
    torch.cuda.synchronize()
    wall_fused = time.perf_counter() - t0
    k7_launches["main_path_pallas"] = k7_count(k7)
    # (value, wall) of both solves, for phase 8's re-runs under the tuned
    # blocks (phase 4b reuses the names v_auto and v_fused)
    spar_main = {"auto": (v_auto, wall_auto), "pallas": (v_fused, wall_fused)}
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
    for name, out in (("auto", out_auto), ("pallas", out_fused)):
        check_k7_launches(f"main path ({name})", out,
                          k7_launches[f"main_path_{name}"], auto)
    print(json.dumps({"main_path": {
        "n": N_MAIN, "s": s_main, "loss": problem.loss,
        "value_auto": v_auto, "value_pallas": v_fused,
        "status": out_auto.status.describe(), "n_iters": out_auto.n_iters,
        "last_err": out_auto.status.last_err,
        "wall_s_auto": wall_auto, "wall_s_pallas": wall_fused,
        "max_memory_allocated_gib": peak_gib, "launches": launches,
        "k7_launches": k7_launches}}))

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
        k7.reset_launch_counts()
        t0 = time.perf_counter()
        out = repro_torch.solve(ugw_problem, solver, support=ugw_support,
                                generator=torch.Generator(dev).manual_seed(0))
        value = float(out.value)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(spar_cost.LAUNCHES)
        check_solve(f"unbalanced path ({impl})", out, (ugw_solver.s,))
        # the unbalanced log-domain loop runs K7 with ρ, as the balanced
        k7_launches[f"unbalanced_{impl}"] = k7_count(k7)
        check_k7_launches(f"unbalanced path ({impl})", out,
                          k7_launches[f"unbalanced_{impl}"], solver)
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
        k7.reset_launch_counts()
        on_card = repro_torch.solve(qsmall, solver, draws=draws)
        vc = float(on_card.value)
        torch.cuda.synchronize()
        quant_launches[name] = dict(spar_cost.LAUNCHES)
        k7_launches[f"quantized_{name}"] = k7_count(k7)
        if k7_launches[f"quantized_{name}"] <= 0:
            raise AssertionError(f"quantized {name}: K7 never launched")
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

    # -- 4f. differentiation (diff) and telemetry (obs) --------------------
    stamps.append(("4f", time.perf_counter()))
    diff_runs = {"card": card}

    def peak_gib(base):
        return (torch.cuda.max_memory_allocated() - base) / 2**30

    def grad_gap(got, want):
        """max |got - want| over the largest |want|, raising above
        GRAD_RTOL (and on a non-finite entry)."""
        gap = max(float((g - w).abs().max() / w.abs().max())
                  for g, w in zip(got, want))
        if not (math.isfinite(gap) and gap <= GRAD_RTOL):
            raise AssertionError(f"gradients disagree: {gap} > {GRAD_RTOL}")
        return gap

    # gw_loss on the Moon pair at n = 2048 with no solver: auto-selected
    # spar_gw (s = 16n = 32768), cost_impl "auto" = the materialized loss
    # matrix and K1; the gradient with respect to both point clouds
    mx, my, ma, mb = moon_points(N_MAIN, seed=0)

    def clouds(x, y, grad=True):
        return [torch.tensor(v, dtype=torch.float32, device=dev,
                             requires_grad=grad) for v in (x, y)]

    def weights(a, b):
        return [torch.tensor(v, device=dev) for v in (a, b)]

    xg, yg = clouds(mx, my)
    wa, wb = weights(ma, mb)
    gp = repro_torch.QuadraticProblem(
        repro_torch.Geometry.from_points(xg, wa, validate=False),
        repro_torch.Geometry.from_points(yg, wb, validate=False),
        validate=False)
    d_auto = repro_torch.select_solver(gp)
    if not (isinstance(d_auto, SparGWSolver) and d_auto.s == 16 * N_MAIN
            and ops.resolve_impl(d_auto.cost_impl, d_auto.s, dev)
            == "materialized"):
        raise AssertionError(f"gw_loss: auto-selection gave {d_auto}")
    d_support = sampling.sample_pairs(
        torch.Generator(dev).manual_seed(0),
        sampling.balanced_probs(wa, wb, d_auto.shrink), d_auto.s)

    def moon_grad(label):
        """gw_loss and its gradient on the Moon pair: walls, peak memory
        and K1's launches of the forward and the backward."""
        x, y = clouds(mx, my)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        spar_cost.reset_launch_counts()
        k7.reset_launch_counts()
        t0 = time.perf_counter()
        value = diff.gw_loss(x, y, wa, wb, support=d_support)
        v = float(value.detach())
        forward_s = time.perf_counter() - t0
        fwd_launches = dict(spar_cost.LAUNCHES)
        k7_key = "diff_" + label.replace(" ", "_")
        k7_launches[k7_key] = k7_count(k7)
        if k7_launches[k7_key] <= 0:
            raise AssertionError(f"gw_loss ({label}): K7 never launched")
        t0 = time.perf_counter()
        grads = torch.autograd.grad(value, [x, y])
        torch.cuda.synchronize()
        backward_s = time.perf_counter() - t0
        bwd_launches = {k: c - fwd_launches[k]
                        for k, c in spar_cost.LAUNCHES.items()}
        if not all(bool(g.isfinite().all()) for g in grads):
            raise AssertionError(f"gw_loss ({label}): non-finite gradient")
        run = {"value": v, "forward_s": forward_s, "backward_s": backward_s,
               "peak_memory_gib_above_start": peak_gib(base),
               "launches_forward": fwd_launches,
               "launches_backward": bwd_launches,
               "grad_norm_x": float(grads[0].norm()),
               "grad_norm_y": float(grads[1].norm())}
        del value
        return run, grads

    diff_runs["gw_loss"], k1_grads = moon_grad("K1")
    diff_launches = diff_runs["gw_loss"]["launches_forward"]
    if diff_launches != {"spar_matvec": d_auto.outer_iters + 1,
                         "spar_cost_fused": 0} or any(
            diff_runs["gw_loss"]["launches_backward"].values()):
        raise AssertionError(f"gw_loss: launches {diff_runs['gw_loss']}, "
                             f"expected K1 {d_auto.outer_iters + 1} times "
                             f"in the forward and no kernel in the backward")
    # the same gradient with K1's plain version swapped in, on the card
    real_matvec = ops.spar_matvec_cuda
    ops.spar_matvec_cuda = (lambda Lmat, t, off, threads=256:
                            spar_cost.spar_matvec_plain(Lmat, t, off))
    try:
        diff_runs["gw_loss_plain_k1"], plain_grads = moon_grad("plain K1")
    finally:
        ops.spar_matvec_cuda = real_matvec
    diff_runs["gw_loss"]["grad_gap_vs_plain_k1"] = grad_gap(k1_grads,
                                                            plain_grads)
    del k1_grads, plain_grads

    # the card against the CPU port at n = 300 on one support
    sx, sy, sa, sb = moon_points(N_SMALL, seed=1)
    s_solver = SparGWSolver.default_config(N_SMALL)
    s_support = sampling.sample_pairs(
        torch.Generator().manual_seed(1),
        sampling.balanced_probs(torch.tensor(sa), torch.tensor(sb),
                                s_solver.shrink), s_solver.s)
    small_grads = {}
    for where in ("card", "cpu"):
        on = dev if where == "card" else torch.device("cpu")
        x, y = [torch.tensor(v, dtype=torch.float32, device=on,
                             requires_grad=True) for v in (sx, sy)]
        value = diff.gw_loss(x, y, torch.tensor(sa), torch.tensor(sb),
                             solver=s_solver, device=on,
                             support=tuple(t.to(on) for t in s_support))
        small_grads[where] = [g.cpu() for g in
                              torch.autograd.grad(value, [x, y])]
    diff_runs["small_grad_gap_card_vs_cpu"] = grad_gap(small_grads["card"],
                                                       small_grads["cpu"])

    # fgw_loss with features at n = 2048: the quadratic part of the
    # gradient (the point clouds' share) must be nonzero: through K1's
    # Function it flows; a kernel output with no gradient would drop it
    frng = np.random.default_rng(7)
    x, y = clouds(mx, my)
    fx, fy = clouds(frng.standard_normal((N_MAIN, 3)),
                    frng.standard_normal((N_MAIN, 3)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    spar_cost.reset_launch_counts()
    t0 = time.perf_counter()
    value = diff.fgw_loss(x, y, fx, fy, fused_penalty=0.5, a=wa, b=wb,
                          support=d_support)
    gq_x, gq_y, gl_x, gl_y = torch.autograd.grad(value, [x, y, fx, fy])
    torch.cuda.synchronize()
    quad_norm = float(torch.sqrt(gq_x.norm() ** 2 + gq_y.norm() ** 2))
    lin_norm = float(torch.sqrt(gl_x.norm() ** 2 + gl_y.norm() ** 2))
    if not (math.isfinite(quad_norm) and quad_norm > 0.0
            and math.isfinite(lin_norm) and lin_norm > 0.0):
        raise AssertionError(f"fgw_loss: quadratic part {quad_norm}, "
                             f"linear part {lin_norm}")
    diff_runs["fgw_loss"] = {
        "value": float(value.detach()), "wall_s": time.perf_counter() - t0,
        "grad_norm_quadratic_part": quad_norm,
        "grad_norm_linear_part": lin_norm,
        "peak_memory_gib_above_start": peak_gib(base),
        "launches": dict(spar_cost.LAUNCHES)}
    del value, gq_x, gq_y, gl_x, gl_y, x, y, fx, fy
    torch.cuda.empty_cache()

    # K2 and K3 refuse a gradient, as the reference's Pallas kernels do
    x, y = [torch.tensor(v, dtype=torch.float32, device=dev,
                         requires_grad=True) for v in (sx, sy)]
    refused = {}
    for kernel, kw in (
            ("spar_cost_fused", dict(solver=dataclasses.replace(
                s_solver, cost_impl="pallas"))),
            ("gw_cost", dict(loss=GRID_LOSS, solver=dataclasses.replace(
                GridGWSolver.default_config(N_SMALL), use_kernel=True)))):
        try:
            diff.gw_loss(x, y, torch.tensor(sa), torch.tensor(sb),
                         generator=torch.Generator(dev).manual_seed(2), **kw)
        except RuntimeError as exc:
            if kernel not in str(exc):
                raise
            refused[kernel] = str(exc).split(":")[0]
        else:
            raise AssertionError(f"{kernel}: a gradient did not raise")
    diff_runs["refused"] = refused

    # the envelope against the unrolled gradient, at converged fixed points
    # (tests/test_torch_envelope.py's cases on the card: dense, and spar on
    # the full n x n support, where it runs the dense dynamics through K1
    # and the sparse Sinkhorn), then at benchmarks/bench_diff.py --quick's
    # spar size, which these budgets do not converge
    def near_isometric(n):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((n, 2))
        th = 0.7
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        y = x @ rot.T + 0.1 * rng.standard_normal((n, 2))
        return [np.maximum((z * z).sum(1)[:, None] + (z * z).sum(1)[None]
                           - 2 * z @ z.T, 0).astype(np.float32)
                for z in (x, y)]

    def envelope_vs_unrolled(Cx_e, Cy_e, solver, converged, **kw):
        n_e = Cx_e.shape[0]
        w_e = torch.full((n_e,), 1.0 / n_e, device=dev)
        Cy_t = torch.tensor(Cy_e, device=dev)

        def problem_of(C):
            return repro_torch.QuadraticProblem(
                repro_torch.Geometry(C, w_e, validate=False),
                repro_torch.Geometry(Cy_t, w_e, validate=False),
                validate=False)
        D = torch.tensor(np.random.default_rng(1).standard_normal(
            (n_e, n_e)), dtype=torch.float32, device=dev)
        D = (D + D.t()) / 2
        row = {}
        for name in ("envelope", "unrolled"):
            C = torch.tensor(Cx_e, device=dev, requires_grad=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            if name == "envelope":
                out = repro_torch.solve(problem_of(C), solver, **kw)
                value = out.value
            else:
                value = diff.unrolled_value(problem_of(C), solver, **kw)
            g, = torch.autograd.grad(value, C)
            torch.cuda.synchronize()
            row[name] = {"wall_s": time.perf_counter() - t0,
                         "peak_memory_mib_above_start": peak_gib(base) * 1024,
                         "directional_derivative": float((g * D).sum())}
            if not bool(g.isfinite().all()):
                raise AssertionError(f"{name} gradient not finite")
        u, v = (row[k]["directional_derivative"]
                for k in ("envelope", "unrolled"))
        row["relative_gap"] = abs(u - v) / max(abs(u), abs(v), 1e-12)
        last = out.n_iters - 1
        row["marginal_err"] = float(out.errors[last])
        row["last_delta"] = float(out.trace.delta[last])
        row["converged"] = (row["marginal_err"] < CONVERGED_ERR
                            and row["last_delta"] < CONVERGED_DELTA)
        if converged and not (row["converged"] and
                              row["relative_gap"] <= ENVELOPE_REL_TOL):
            raise AssertionError(f"envelope vs unrolled: {row}")
        return row

    Cx_e, Cy_e = near_isometric(N_ENVELOPE)
    n2 = N_ENVELOPE * N_ENVELOPE
    full = (torch.arange(N_ENVELOPE, device=dev).repeat_interleave(
        N_ENVELOPE), torch.arange(N_ENVELOPE, device=dev).repeat(N_ENVELOPE))
    converged_kw = dict(epsilon=5e-2, outer_iters=20, inner_iters=50,
                        trace=True)
    envelope = {
        "dense_n10": envelope_vs_unrolled(
            Cx_e, Cy_e, DenseGWSolver(**converged_kw), True),
        "spar_n10_full_support": envelope_vs_unrolled(
            Cx_e, Cy_e, SparGWSolver(s=n2, **converged_kw), True,
            support=full)}
    bx = np.random.default_rng(0).standard_normal((N_UNROLLED_SPAR, 3))
    by = np.random.default_rng(1).standard_normal((N_UNROLLED_SPAR, 3))
    bcost = [(np.maximum((z * z).sum(1)[:, None] + (z * z).sum(1)[None]
                         - 2 * z @ z.T, 0) / 10.0).astype(np.float32)
             for z in (bx, by)]
    u_solver = SparGWSolver(epsilon=5e-2, s=8 * N_UNROLLED_SPAR,
                            outer_iters=60, inner_iters=120, trace=True)
    u_w = torch.full((N_UNROLLED_SPAR,), 1.0 / N_UNROLLED_SPAR, device=dev)
    u_support = sampling.sample_pairs(
        torch.Generator(dev).manual_seed(0),
        sampling.balanced_probs(u_w, u_w, u_solver.shrink), u_solver.s)
    spar_cost.reset_launch_counts()
    envelope[f"spar_n{N_UNROLLED_SPAR}_s8n"] = envelope_vs_unrolled(
        *bcost, u_solver, False, support=u_support)
    envelope[f"spar_n{N_UNROLLED_SPAR}_s8n"]["launches"] = dict(
        spar_cost.LAUNCHES)
    diff_runs["envelope_vs_unrolled"] = envelope

    # gw_barycenter of the two Moon clouds at n = 300 through spar_gw (K1)
    spar_cost.reset_launch_counts()
    t0 = time.perf_counter()
    bary = diff.gw_barycenter(
        [torch.tensor(v, dtype=torch.float32, device=dev) for v in (sx, sy)],
        N_SMALL, torch.Generator(dev).manual_seed(3), steps=BARY_STEPS,
        solver=s_solver)
    objectives = bary.objectives.tolist()
    if not (all(math.isfinite(o) for o in objectives)
            and objectives[0] > objectives[-1]):
        raise AssertionError(f"barycenter did not descend: {objectives}")
    diff_runs["barycenter"] = {
        "n": N_SMALL, "steps": BARY_STEPS, "objectives": objectives,
        "wall_s": time.perf_counter() - t0,
        "launches": dict(spar_cost.LAUNCHES)}
    print(json.dumps({"diff_path": diff_runs}))

    # one trace=True solve on each route; obs.report() of the run
    obs.registry().clear()
    obs.clear_spans()
    dxp, dap, dyp, dbp = moon(N_DENSE, seed=2)
    dense_p = repro_torch.QuadraticProblem(repro_torch.Geometry(dxp, dap),
                                           repro_torch.Geometry(dyp, dbp))
    traced = {
        "spar_auto": lambda: repro_torch.solve(
            problem, dataclasses.replace(auto, trace=True), support=support),
        "grid": lambda: repro_torch.solve(
            repro_torch.QuadraticProblem(repro_torch.Geometry(Cx_np, a_np),
                                         repro_torch.Geometry(Cy_np, b_np),
                                         loss=GRID_LOSS),
            dataclasses.replace(GridGWSolver.default_config(N_MAIN),
                                use_kernel=True, trace=True),
            generator=torch.Generator(dev).manual_seed(0)),
        "dense": lambda: repro_torch.solve(dense_p, dataclasses.replace(
            repro_torch.select_solver(dense_p), trace=True)),
        f"lowrank_{LOWRANK_PROFILE_STEPS}_steps": lambda: repro_torch.solve(
            lr_problem, dataclasses.replace(
                lr_solver, outer_iters=LOWRANK_PROFILE_STEPS, trace=True),
            generator=torch.Generator(dev).manual_seed(0)),
        # the coarse dense solve cut to 5 outer steps (its default 50 run
        # ~2000 inner iterations each, ~30 s on its own; phase 4e runs it)
        "quantized_polished": lambda: repro_torch.solve(
            qsmall, dataclasses.replace(polished, trace=True, base=(
                dataclasses.replace(polished.base, outer_iters=5))),
            draws=QuantizedDraws(*starts)),
    }
    trace_rows = {}
    for name, run in traced.items():
        out = run()
        n_rec = obs.n_valid(out.trace)
        if n_rec != out.n_iters or not out.status.is_healthy:
            raise AssertionError(f"trace {name}: {n_rec} recorded, "
                                 f"{out.n_iters} iterations, {out.status}")
        trace_rows[name] = {"n_iters": out.n_iters,
                            "last_objective": float(
                                out.trace.objective[out.n_iters - 1])}
    counted = sum(row["value"] for row in obs.registry().snapshot()[
        "metrics"]["repro_solves_total"]["series"])
    if counted != len(traced):
        raise AssertionError(f"repro_solves_total {counted}, "
                             f"{len(traced)} solves")
    print(json.dumps({"traces": trace_rows}))
    print(json.dumps({"obs_report": obs.report()}))
    del bary, out
    torch.cuda.empty_cache()

    # -- 4g. serve: GWServer, lane-batched dense_gw and spar_gw -----------
    stamps.append(("4g", time.perf_counter()))

    # the dense catalog stream (benchmarks/bench_serve.py's full stream):
    # a warm pass, then reset_stats() and the measured pass, then the same
    # stream as a sequential repro_torch.solve loop
    catalog = serve_catalog(repro_torch)
    d_solver = solvers.get_solver("dense_gw").default_config(48)
    srv = GWServer(ServeConfig(max_batch=8, max_wait_s=0.02))
    try:
        srv.results([srv.submit(p, d_solver) for p in catalog])
        srv.reset_stats()
        t0 = time.perf_counter()
        served = srv.results([srv.submit(p, d_solver) for p in catalog])
        served_wall = time.perf_counter() - t0
        served_stats = srv.stats()
    finally:
        srv.close()
    if served_stats["cache_hit_rate"] != 1.0 or any(
            r.failed or not math.isfinite(r.value) for r in served):
        raise AssertionError(f"catalog stream: {served_stats}")
    seq_lat = []
    t0 = time.perf_counter()
    for p in catalog:
        t1 = time.perf_counter()
        repro_torch.solve(p, d_solver).value.item()
        seq_lat.append(time.perf_counter() - t1)
    seq_wall = time.perf_counter() - t0
    # every served value against its solo solve of the padded problem
    solo_values, worst = {}, 0.0
    for p, r in zip(catalog, served):
        key = id(p.geom_x)
        if key not in solo_values:
            solo_values[key] = float(d_solver.run(pad_problem(
                p, *r.padded_shape).to(dev)).value)
        rel = abs(r.value - solo_values[key]) / abs(solo_values[key])
        worst = max(worst, rel)
    if worst > SERVE_VALUE_RTOL:
        raise AssertionError(f"catalog stream: a served value is {worst:.3g}"
                             f" off its solo solve")
    catalog_row = {
        "requests": len(catalog), "solver": "dense_gw default_config(48)",
        "served": {k: served_stats[k] for k in (
            "throughput_rps", "latency_p50_ms", "latency_p99_ms",
            "n_batches", "mean_batch_lanes", "filler_lane_frac",
            "cache_hit_rate")},
        "served_wall_s": served_wall,
        "sequential": {"throughput_rps": len(catalog) / seq_wall,
                       "latency_p50_ms": 1e3 * float(np.percentile(seq_lat,
                                                                   50)),
                       "latency_p99_ms": 1e3 * float(np.percentile(seq_lat,
                                                                   99)),
                       "wall_s": seq_wall},
        "speedup_vs_sequential": seq_wall / served_wall,
        "max_rel_err_vs_solo": worst}

    # spar lanes at the top default bucket: 16 requests against one
    # 512-point reference, s = 16·512, two flushes of 8 lanes; K1 once a
    # step (and once for the value) a flush
    spar_reqs = serve_spar_requests(repro_torch)
    s_solver = SparGWSolver(s=SERVE_SPAR_S)
    seeds = range(len(spar_reqs))
    spar_cost.reset_launch_counts()
    k7.reset_launch_counts()
    srv = GWServer(ServeConfig(max_batch=SERVE_LANES, max_wait_s=60.0))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spar_served = srv.results([srv.submit(
            p, s_solver, generator=torch.Generator(dev).manual_seed(k))
            for k, p in zip(seeds, spar_reqs)])
        spar_wall = time.perf_counter() - t0
        spar_stats = srv.stats()
    finally:
        srv.close()
    spar_launches = dict(spar_cost.LAUNCHES)
    # K7: one launch a half-step for all of a flush's lanes
    k7_launches["serve_spar_lanes"] = k7_count(k7)
    n_flush = len(spar_reqs) // SERVE_LANES
    if spar_stats["n_batches"] != n_flush or spar_launches != {
            "spar_matvec": n_flush * (s_solver.outer_iters + 1),
            "spar_cost_fused": 0}:
        raise AssertionError(f"spar lanes: {spar_stats['n_batches']} "
                             f"flushes, launches {spar_launches}")
    if any(r.output.status.n_rescues for r in spar_served) or \
            k7_launches["serve_spar_lanes"] != n_flush * 2 * \
            s_solver.inner_iters * s_solver.outer_iters:
        raise AssertionError(f"spar lanes: K7 launched "
                             f"{k7_launches['serve_spar_lanes']} times in "
                             f"{n_flush} flushes")
    # each lane against its solo solve from the same generator state; the
    # solo solves of the first flush's lanes are the 8 it replaces
    padded_spar = [pad_problem(p, SERVE_SPAR_N, SERVE_SPAR_N).to(dev)
                   for p in spar_reqs]

    def solo_spar(k):
        return s_solver.run(padded_spar[k], generator=torch.Generator(
            dev).manual_seed(k))

    worst, solo_walls = 0.0, []
    for k, r in zip(seeds, spar_served):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solo = solo_spar(k)
        value = float(solo.value)
        solo_walls.append(time.perf_counter() - t0)
        if not (torch.equal(solo.coupling.rows, r.output.coupling.rows)
                and solo.status.code == r.output.status.code):
            raise AssertionError(f"spar lane {k}: support or status differs "
                                 f"from its solo solve")
        worst = max(worst, abs(r.value - value) / abs(value))
    if worst > IMPL_VALUE_RTOL:
        raise AssertionError(f"spar lanes: a lane is {worst:.3g} off its "
                             f"solo solve")

    def one_flush():
        srv = GWServer(ServeConfig(max_batch=SERVE_LANES, max_wait_s=60.0))
        try:
            return [r.value for r in srv.results([srv.submit(
                p, s_solver, generator=torch.Generator(dev).manual_seed(k))
                for k, p in zip(seeds, spar_reqs[:SERVE_LANES])])]
        finally:
            srv.close()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_flush()
    flush_wall = time.perf_counter() - t0
    # the profiler's processing costs ~0.3 ms an event: one flush (~70 000
    # launches) and one of the solo solves it replaces (~69 000)
    spar_row = {
        "requests": len(spar_reqs), "n": SERVE_SPAR_SIZES,
        "bucket": [SERVE_SPAR_N, SERVE_SPAR_N], "s": SERVE_SPAR_S,
        "lanes": SERVE_LANES, "flushes": spar_stats["n_batches"],
        "launches": spar_launches,
        "k7_launches": k7_launches["serve_spar_lanes"], "wall_s_16": spar_wall,
        "max_rel_err_vs_solo": worst, "flush_wall_s": flush_wall,
        "solo_8_wall_s": sum(solo_walls[:SERVE_LANES]),
        "solo_wall_s": solo_walls,
        "profile_flush": profile_solve(torch, one_flush),
        "profile_1_solo": profile_solve(
            torch, lambda: solo_spar(0).value.item())}

    # K1's lane launch against 8 single-lane launches at (8, 8192):
    # bitwise (phase 8 times it)
    Ll, tl, offl = k1_lanes_inputs(torch, dev)
    lanes_out = spar_cost.spar_matvec_cuda(Ll, tl, offl)
    singles = torch.stack([spar_cost.spar_matvec_cuda(Ll[b], tl[b], offl[b])
                           for b in range(SERVE_LANES)])
    if not torch.equal(lanes_out, singles):
        raise AssertionError("K1's lane launch differs from single-lane "
                             "launches")
    del Ll, tl, offl, lanes_out, singles

    # width 1 against width 2 and the solo solve on the card (the CPU's
    # MIN_LANES finding; printed, not held: cuBLAS may pick other kernels)
    w_prob = pad_problem(catalog[0], *served[0].padded_shape).to(dev)
    w_items = [(w_prob, d_solver, None), (pad_problem(
        catalog[1], *served[0].padded_shape).to(dev), d_solver, None)]
    w1 = run_lanes(stack_items(w_items[:1]))[0]
    w2 = run_lanes(stack_items(w_items))[0]
    solo = d_solver.run(w_prob)
    width_bits = {"width1_eq_width2": bool(torch.equal(w1.coupling,
                                                       w2.coupling)),
                  "width1_eq_solo": bool(torch.equal(w1.coupling,
                                                     solo.coupling)),
                  "width2_eq_solo": bool(torch.equal(w2.coupling,
                                                     solo.coupling))}

    # a poisoned flush: a persistent NaN among 3 clean mates (fused dense
    # requests, so the ladder is quantized -> spar); the poisoned request
    # fails and falls back, the mates come back healthy
    persistent = dataclasses.replace(d_solver, max_rescues=0, fault=FaultSpec(
        at_iter=1, kind="nan", persistent=True))
    clean = dataclasses.replace(persistent, fault=dataclasses.replace(
        persistent.fault, at_iter=-1))
    fused_reqs = serve_fused_requests(repro_torch)
    srv = GWServer(ServeConfig(max_batch=4, max_wait_s=60.0))
    try:
        t0 = time.perf_counter()
        poisoned = srv.results([srv.submit(
            p, persistent if k == 1 else clean,
            generator=torch.Generator(dev).manual_seed(k))
            for k, p in enumerate(fused_reqs)])
        poisoned_wall = time.perf_counter() - t0
        p_stats = srv.stats()
    finally:
        srv.close()
    bad = poisoned[1]
    if not (bad.failed and bad.fell_back and bad.status.is_healthy
            and math.isfinite(bad.value) and p_stats["n_batches"] == 1
            and all(not r.failed and r.status.is_healthy
                    for k, r in enumerate(poisoned) if k != 1)):
        outcomes = [(r.status_name, r.failed, r.fell_back) for r in poisoned]
        raise AssertionError(f"poisoned flush: {outcomes}")
    print(json.dumps({"serve_path": {
        "catalog": catalog_row, "spar_lanes": spar_row,
        "k1_lanes_bitwise_vs_single": True, "lane_bits_on_card": width_bits,
        "poisoned_flush": {
            "statuses": [r.status_name for r in poisoned],
            "failed": [r.failed for r in poisoned],
            "fell_back": [r.fell_back for r in poisoned],
            "wall_s": poisoned_wall}}}))
    del spar_served, padded_spar
    torch.cuda.empty_cache()

    # -- 4h. the legacy core ------------------------------------------------
    stamps.append(("4h", time.perf_counter()))
    legacy = importlib.import_module("repro_torch.core")
    sagrow_mod = importlib.import_module("repro_torch.core.sagrow")
    from repro_torch.core import align as align_mod
    from repro_torch.core import emd as emd_mod
    from repro_torch.core import sharded_gw

    def same_bits(x, y) -> bool:
        return x.shape == y.shape and bool(torch.equal(x, y))

    def legacy_call(fn, *args, **kw):
        """a shim without its deprecation warning (the caller runs it
        under torch's deterministic algorithms: the sparse Sinkhorn's
        index_add_ otherwise sums with atomics in no fixed order)"""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return fn(*args, **kw)

    legacy_paths = {}
    tCx, ta, tCy, tb = (torch.as_tensor(x, device=dev)
                        for x in (Cx_np, a_np, Cy_np, b_np))
    M_fgw = rand(N_MAIN, N_MAIN)
    fgw_problem = repro_torch.QuadraticProblem(
        repro_torch.Geometry(Cx_np, a_np), repro_torch.Geometry(Cy_np, b_np),
        M=M_fgw, fused_penalty=0.6)
    grid_l1 = repro_torch.QuadraticProblem(
        repro_torch.Geometry(Cx_np, a_np), repro_torch.Geometry(Cy_np, b_np),
        loss=GRID_LOSS)
    grid_kernel = dataclasses.replace(GridGWSolver.default_config(N_MAIN),
                                      use_kernel=True)
    side = grid_kernel.s_r
    cases = {
        "spar_gw": (
            lambda g: legacy_call(legacy.spar_gw, g, ta, tb, tCx, tCy,
                                  s=16 * N_MAIN),
            lambda g: repro_torch.solve(problem, SparGWSolver(s=16 * N_MAIN),
                                        generator=g),
            spar_cost, "spar_matvec"),
        "spar_fgw_pallas": (
            lambda g: legacy_call(legacy.spar_fgw, g, ta, tb, tCx, tCy, M_fgw,
                                  s=16 * N_MAIN, cost_impl="pallas"),
            lambda g: repro_torch.solve(fgw_problem, SparGWSolver(
                s=16 * N_MAIN, cost_impl="pallas"), generator=g),
            spar_cost, "spar_cost_fused"),
        "grid_spar_gw_l1": (
            lambda g: legacy_call(legacy.grid_spar_gw, g, ta, tb, tCx, tCy,
                                  s_r=side, s_c=side, loss=GRID_LOSS,
                                  use_kernel=True),
            lambda g: repro_torch.solve(grid_l1, grid_kernel, generator=g),
            gw_cost, "gw_cost")}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, (shim, direct, kmod, kname) in cases.items():
            torch.cuda.synchronize()
            kmod.reset_launch_counts()
            k7.reset_launch_counts()
            t0 = time.perf_counter()
            value, coupling = shim(torch.Generator(dev).manual_seed(0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = dict(kmod.LAUNCHES)
            k7_launches[f"legacy_{name}"] = k7_count(k7)
            out = direct(torch.Generator(dev).manual_seed(0))
            # the spar shims' Sinkhorn runs on K7, the grid's dense loop not
            if kname == "gw_cost":
                if k7_launches[f"legacy_{name}"] != 0:
                    raise AssertionError(f"legacy {name}: K7 launched")
            else:
                check_k7_launches(f"legacy {name}", out,
                                  k7_launches[f"legacy_{name}"],
                                  SparGWSolver(s=16 * N_MAIN))
            c = out.coupling
            want = (c.rows, c.cols, c.block if hasattr(c, "block") else c.vals)
            bitwise = same_bits(value, out.value) and all(
                same_bits(x, y) for x, y in zip(coupling, want))
            if launched[kname] != 21 or not bitwise \
                    or not math.isfinite(float(value)):
                raise AssertionError(f"legacy {name}: {kname} launched "
                                     f"{launched[kname]} times (expected "
                                     f"21), bitwise {bitwise}, value "
                                     f"{float(value)}")
            legacy_paths[name] = {"value": float(value), "wall_s": wall,
                                  "bitwise_solve": bitwise,
                                  "launches": launched}
    finally:
        torch.use_deterministic_algorithms(False)
    del M_fgw, fgw_problem

    # SaGroW at n = 2048, s' = 256: the dense Sinkhorn of core/sinkhorn
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v_sag, T_sag = sagrow_mod.sagrow(torch.Generator(dev).manual_seed(0),
                                     ta, tb, tCx, tCy, SAGROW_S_PRIME)
    v_sag = float(v_sag)
    torch.cuda.synchronize()
    sag_wall = time.perf_counter() - t0
    if not (math.isfinite(v_sag) and bool(T_sag.isfinite().all())):
        raise AssertionError(f"sagrow: value {v_sag}, finite T "
                             f"{bool(T_sag.isfinite().all())}")
    legacy_paths["sagrow"] = {"n": N_MAIN, "s_prime": SAGROW_S_PRIME,
                              "value": v_sag, "wall_s": sag_wall,
                              "mass": float(T_sag.sum())}
    del T_sag

    # EMD-GW at n = 40: float32 cost on the card, float64 LP on the host
    ex, ea, ey, eb = moon(N_EMD, seed=2)
    t0 = time.perf_counter()
    v_emd, T_emd = emd_mod.emd_gw(ea, eb, ex, ey, device=dev)
    emd_wall = time.perf_counter() - t0
    v_emd_cpu, T_emd_cpu = emd_mod.emd_gw(ea, eb, ex, ey, device="cpu")
    emd_err = float(np.abs(T_emd - T_emd_cpu).max())
    if not (math.isfinite(v_emd) and emd_err <= 1e-9
            and abs(v_emd - v_emd_cpu) <= 1e-5 * abs(v_emd_cpu)):
        raise AssertionError(f"emd_gw: card {v_emd} vs CPU {v_emd_cpu}, "
                             f"plan max diff {emd_err}")
    legacy_paths["emd_gw"] = {"n": N_EMD, "value": v_emd,
                              "value_cpu": v_emd_cpu,
                              "plan_max_abs_diff": emd_err,
                              "wall_s": emd_wall}

    # the alignment loss and its gradient, card against CPU on one draw
    h_gen = torch.Generator().manual_seed(4)
    hx_cpu, hy_cpu = (torch.randn(ALIGN_SHAPE, generator=h_gen)
                      for _ in range(2))
    draws = tuple(torch.randint(0, ALIGN_SHAPE[1], (ALIGN_SHAPE[0], 64),
                                generator=h_gen) for _ in range(2))
    align_out = {}
    for where, on in (("card", dev), ("cpu", torch.device("cpu"))):
        hx = hx_cpu.to(on).requires_grad_(True)
        hy = hy_cpu.to(on).requires_grad_(True)
        t0 = time.perf_counter()
        val = align_mod.gw_alignment_loss(None, hx, hy, draws=draws)
        val.backward()
        torch.cuda.synchronize()
        align_out[where] = (float(val.detach()), hx.grad.cpu(),
                            hy.grad.cpu(), time.perf_counter() - t0)
    grad_err = max(float((g - w).abs().max() / w.abs().max())
                   for g, w in zip(align_out["card"][1:3],
                                   align_out["cpu"][1:3]))
    if not (math.isfinite(align_out["card"][0]) and grad_err <= GRAD_RTOL
            and abs(align_out["card"][0] - align_out["cpu"][0])
            <= 1e-5 * abs(align_out["cpu"][0])):
        raise AssertionError(f"gw_alignment_loss: card "
                             f"{align_out['card'][0]} vs CPU "
                             f"{align_out['cpu'][0]}, gradient max rel err "
                             f"{grad_err} (bound {GRAD_RTOL})")
    legacy_paths["gw_alignment_loss"] = {
        "shape": list(ALIGN_SHAPE), "value": align_out["card"][0],
        "value_cpu": align_out["cpu"][0], "grad_max_rel_err": grad_err,
        "wall_s_value_and_grad": align_out["card"][3]}
    del hx_cpu, hy_cpu, align_out

    # the sharded grid solver at world size 1 over NCCL, against the
    # unsharded loop on the card
    sh_gen = torch.Generator(dev).manual_seed(5)
    CxR = torch.rand(SHARDED_S, SHARDED_S, generator=sh_gen, device=dev)
    CyC = torch.rand(SHARDED_S, SHARDED_S, generator=sh_gen, device=dev)
    CxR, CyC = (CxR + CxR.t()) / 2, (CyC + CyC.t()) / 2
    aR = torch.full((SHARDED_S,), 1.0 / SHARDED_S, device=dev)
    w_sh = torch.ones(SHARDED_S, SHARDED_S, device=dev)
    loss, eps, outer, inner = SHARDED_ARGS
    with tempfile.TemporaryDirectory() as store_dir:
        torch.distributed.init_process_group(
            "nccl", init_method=f"file://{store_dir}/store", rank=0,
            world_size=1)
        try:
            mesh = sharded_gw.ProcessMesh(1, 1)
            fn = sharded_gw.make_sharded_grid_gw(mesh, SHARDED_S, SHARDED_S,
                                                 *SHARDED_ARGS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", FutureWarning)
                v_sh, T_sh = fn(CxR, CyC, aR, aR, w_sh)
            v_sh = float(v_sh)
            sh_wall = time.perf_counter() - t0
        finally:
            torch.distributed.destroy_process_group()
    T_ref = aR[:, None] * aR[None, :]
    for _ in range(outer):
        logK = (-grid_cost(CxR, CyC, T_ref, loss) / eps + torch.log(w_sh)
                + log_floor(T_ref))
        T_ref = sinkhorn_loops.sinkhorn_log(aR, aR, logK, inner)
    v_ref = float(torch.sum(T_ref * grid_cost(CxR, CyC, T_ref, loss)))
    sh_err = float(((T_sh - T_ref).abs()
                    - 1e-4 * T_ref.abs()).max())
    if not (abs(v_sh - v_ref) <= 1e-5 * abs(v_ref) and sh_err <= 1e-6):
        raise AssertionError(f"sharded grid gw: {v_sh} vs unsharded "
                             f"{v_ref}, block excess over 1e-4 rel "
                             f"{sh_err}")
    legacy_paths["sharded_grid_gw"] = {
        "world_size": 1, "backend": "nccl", "s": SHARDED_S,
        "value": v_sh, "value_unsharded": v_ref, "wall_s": sh_wall}
    del CxR, CyC, T_sh, T_ref, w_sh
    print(json.dumps({"legacy_path": legacy_paths}))
    torch.cuda.empty_cache()

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

    # -- 7b. the LM decode path ---------------------------------------------
    stamps.append(("7b", time.perf_counter()))
    from repro_torch.launch import serve as lm_serve
    # reduced depth, float32: teacher-forced decode against the forward
    short_params = short._cast_params(
        {**params, "blocks": params["blocks"][:1]}, torch.float32, dev)
    prompt = tokens[:, :DECODE_PROMPT]
    reset_lm_counts()
    fwd_logits = short.forward(short_params, prompt, act_dtype=torch.float32,
                               use_flash=True)[0]
    fwd_counts = lm_counts()
    cache = short.init_cache(prompt.shape[0], DECODE_PROMPT,
                             dtype=torch.float32, device=dev)
    steps = []
    for t in range(DECODE_PROMPT):
        lg, cache = short.decode_step(short_params, prompt[:, t:t + 1], cache,
                                      t, act_dtype=torch.float32)
        steps.append(lg)
    dec_logits = torch.cat(steps, dim=1)
    fwd_max = float(fwd_logits.abs().max())
    excess = float(((dec_logits - fwd_logits).abs()
                    - DECODE_RTOL * fwd_logits.abs()).max())
    dec_dist = float((dec_logits - fwd_logits).abs().max())
    if fwd_counts != {"flash_attention": 1, "ssd_intra": want_short[
            "ssd_intra"]} or excess > DECODE_ATOL \
            or not bool(dec_logits.isfinite().all()):
        raise AssertionError(f"decode vs forward: launches {fwd_counts}, "
                             f"max |diff| {dec_dist}, excess over rtol "
                             f"{DECODE_RTOL}: {excess} (atol {DECODE_ATOL})")
    del short_params, cache, steps, dec_logits, fwd_logits
    torch.cuda.empty_cache()

    # full depth, bfloat16: generate with the reference's lm_main defaults
    prompts = torch.randint(0, cfg.vocab_size, (DECODE_BATCH, DECODE_PROMPT),
                            generator=lm_gen, device=dev)
    def spec_bytes(tree):
        if hasattr(tree, "dtype"):              # one cache tensor's spec
            return math.prod(tree.shape) * torch.empty(
                (), dtype=tree.dtype).element_size()
        return sum(spec_bytes(t) for t in (
            tree.values() if isinstance(tree, dict) else tree))

    cache_bytes = spec_bytes(model.cache_spec(DECODE_BATCH,
                                              DECODE_PROMPT + DECODE_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen_base = torch.cuda.memory_allocated()
    finite = []                 # each decode step's logits finite
    decode = model.decode_step

    def checked_decode(*args, **kw):
        lg, c = decode(*args, **kw)
        finite.append(lg.isfinite().all())
        return lg, c

    model.decode_step = checked_decode
    reset_lm_counts()
    try:
        t0 = time.perf_counter()
        seqs = lm_serve.generate(model, params, prompts, DECODE_NEW,
                                 act_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        gen_wall = time.perf_counter() - t0
    finally:
        del model.decode_step
    gen_counts = lm_counts()
    gen_peak_gib = (torch.cuda.max_memory_allocated() - gen_base) / 2**30
    t0 = time.perf_counter()              # again, on warm cuBLAS plans
    warm_seqs = lm_serve.generate(model, params, prompts, DECODE_NEW,
                                  act_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    gen_warm_wall = time.perf_counter() - t0
    new = seqs[:, DECODE_PROMPT:]
    in_range = bool(((new >= 0) & (new < cfg.vocab_size)).all())
    all_finite = bool(torch.stack(finite).all())
    if tuple(seqs.shape) != (DECODE_BATCH, DECODE_PROMPT + DECODE_NEW) \
            or not torch.equal(seqs[:, :DECODE_PROMPT], prompts) \
            or tuple(warm_seqs.shape) != tuple(seqs.shape) \
            or not in_range or not all_finite \
            or len(finite) != DECODE_PROMPT + DECODE_NEW:
        raise AssertionError(f"generate: shape {tuple(seqs.shape)}, tokens "
                             f"in range {in_range}, logits finite "
                             f"{all_finite} over {len(finite)} steps")

    # gw_similarity at full depth in bfloat16: K6 in every Mamba2 layer of
    # both forwards
    per_forward = []
    forward = model.forward

    def counted_forward(*args, **kw):
        before = lm_counts()["ssd_intra"]
        out = forward(*args, **kw)
        per_forward.append(lm_counts()["ssd_intra"] - before)
        return out

    model.forward = counted_forward
    try:
        reset_lm_counts()
        t0 = time.perf_counter()
        sim = float(lm_serve.gw_similarity(model, params, prompts,
                                           prompts.flip(0),
                                           act_dtype=torch.bfloat16))
        torch.cuda.synchronize()
        sim_wall = time.perf_counter() - t0
    finally:
        del model.forward
    if per_forward != [want_lm["ssd_intra"]] * 2 or not math.isfinite(sim):
        raise AssertionError(f"gw_similarity: K6 launches per forward "
                             f"{per_forward} (expected "
                             f"{want_lm['ssd_intra']} each), value {sim}")

    # the CLI, on the card by default
    cli_out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cli_out):
        lm_serve.main(["--mode", "lm", "--arch", "zamba2-7b", "--reduced",
                       "--metric", "gw"])
    cli_wall = time.perf_counter() - t0
    if "GW(batch, reversed-batch)" not in cli_out.getvalue():
        raise AssertionError(f"--mode lm: {cli_out.getvalue()!r}")
    print(json.dumps({"lm_decode_path": {
        "decode_vs_forward": {
            "depth": "1 superblock + tail", "dtype": "float32",
            "tokens": DECODE_PROMPT, "max_abs_diff": dec_dist,
            "max_abs_forward_logit": fwd_max,
            "bound": {"atol": DECODE_ATOL, "rtol": DECODE_RTOL},
            "forward_launches": fwd_counts},
        "generate": {
            "batch": DECODE_BATCH, "prompt": DECODE_PROMPT,
            "new_tokens": DECODE_NEW, "dtype": "bfloat16",
            "wall_s": gen_wall, "warm_wall_s": gen_warm_wall,
            "tokens_per_s": DECODE_BATCH * DECODE_NEW / gen_wall,
            "warm_tokens_per_s": DECODE_BATCH * DECODE_NEW / gen_warm_wall,
            "decode_steps": DECODE_PROMPT + DECODE_NEW,
            "cache_bytes": cache_bytes,
            "peak_memory_gib_above_start": gen_peak_gib,
            "launches": gen_counts},
        "gw_similarity": {"value": sim, "wall_s": sim_wall,
                          "k6_launches_per_forward": per_forward},
        "cli": {"wall_s": cli_wall,
                "output": cli_out.getvalue().strip().splitlines()}}}))
    del seqs, warm_seqs, prompts, finite
    torch.cuda.empty_cache()

    # -- 7c. the other six architectures ------------------------------------
    stamps.append(("7c", time.perf_counter()))
    arch_out = arch_phase(torch, dev)

    # phase 10's dry runs start here, on the host's CPU beside the train
    # phase (two single-threaded processes of the host's 8 cores)
    mesh_tmp = Path(tempfile.mkdtemp(prefix="mesh_phase_"))
    dryruns = start_dryruns(mesh_tmp)
    t_dryruns = time.perf_counter()
    try:
        # -- train. the training path: smollm-135m, K5 and K6 gradients -----
        stamps.append(("train", time.perf_counter()))
        train_launches = train_phase(torch, dev, short, {
            **params, "blocks": params["blocks"][:1]})

        # -- 10. the mesh path: distrib, train(mesh=), split_proj, dry run ---
        stamps.append(("10", time.perf_counter()))
        mesh_launches = mesh_phase(torch, dev, short, {
            **params, "blocks": params["blocks"][:1]}, tokens, mesh_tmp,
            dryruns, t_dryruns)
    finally:
        for child, _ in dryruns.values():
            if child.poll() is None:
                child.kill()
                child.wait()
        shutil.rmtree(mesh_tmp, ignore_errors=True)

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
    k_bytes, k_ops = 4 * (s_main * s_main + 3 * s_main), 2 * s_main * s_main
    bound_ms, bound_by = bound(k_bytes, k_ops)
    # then the block sweep at this shape (one warp a row: every block
    # sums each row in the same order)
    k1_tuned = autotune_row(
        torch, dispatch, K1_TUNE,
        lambda b: spar_cost.spar_matvec_cuda(Lmat, t, off, threads=b),
        k_ops, k_bytes, lambda b: check(
            torch, f"spar_matvec main shape, {b} threads",
            spar_cost.spar_matvec_cuda(Lmat, t, off, threads=b),
            spar_cost.spar_matvec_plain(Lmat, t, off),
            Lmat.abs() @ t.abs() + off.abs()))
    kernels.append({
        "name": "spar_matvec", "route": "cuda",
        "source": "src/repro_torch/csrc/spar_matvec.cu",
        "replaces": "src/repro/kernels/spar_cost/spar_cost.py:132",
        "launches": launches["spar_matvec"],
        "launches_unbalanced": ugw_launches["spar_matvec"],
        "launches_quantized": quant_launches["polished"]["spar_matvec"],
        "launches_quantized_spar_base": quant_launches["spar_base"][
            "spar_matvec"],
        "launches_diff": diff_launches["spar_matvec"],
        "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib_ms, "autotune": k1_tuned})
    del Lmat
    torch.cuda.empty_cache()

    # K1's lane launch at phase 4g's shape: 8 lanes of s = 8192 in one
    # launch, against its plain version (a matvec a lane), the 8
    # single-lane launches it replaces and one torch.baddbmm
    Ll, tl, offl = k1_lanes_inputs(torch, dev)
    B_l, s_l = SERVE_LANES, SERVE_SPAR_S
    scale = torch.stack([Ll[b].abs() @ tl[b].abs() for b in range(B_l)]) \
        + offl.abs()
    err = check(torch, "spar_matvec lanes (8, 8192)",
                spar_cost.spar_matvec_cuda(Ll, tl, offl),
                spar_cost.spar_matvec_plain(Ll, tl, offl), scale)
    del scale
    # in turns (lanes, singles, singles, lanes): two readings apart by
    # 20 % came from two calls of one commit
    launch = {"lanes": lambda: spar_cost.spar_matvec_cuda(Ll, tl, offl),
              "single": lambda: [spar_cost.spar_matvec_cuda(
                  Ll[b], tl[b], offl[b]) for b in range(B_l)]}
    turns = {"lanes": [], "single": []}
    for name in ("lanes", "single", "single", "lanes"):
        turns[name].append(time_ms(torch, launch[name], 50))
    ms, single_ms = (sum(turns[k]) / 2 for k in ("lanes", "single"))
    plain_ms = time_ms(torch, lambda: spar_cost.spar_matvec_plain(
        Ll, tl, offl), 20)
    lib_ms = time_ms(torch, lambda: torch.baddbmm(
        offl[:, :, None], Ll, tl[:, :, None]), 20)
    bound_ms, bound_by = bound(4 * B_l * (s_l * s_l + 3 * s_l),
                               2 * B_l * s_l * s_l)
    kernels.append({
        "name": "spar_matvec_lanes", "route": "cuda",
        "source": "src/repro_torch/csrc/spar_matvec.cu",
        "replaces": "src/repro/kernels/spar_cost/spar_cost.py:132",
        "shape": f"{B_l} lanes, s={s_l}",
        "launches": spar_launches["spar_matvec"],
        "max_abs_err": err, "ms": ms, "single_lane_launches_ms": single_ms,
        "turns_ms": turns,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms})
    del Ll, tl, offl
    torch.cuda.empty_cache()

    # as the main path calls it: the support sorted by row once, t in the
    # sorted order, outputs scattered back through the permutation
    perm, rows_s, cols_s = ops.sort_support(rows, cols)
    rows_s, cols_s = rows_s.int().contiguous(), cols_s.int().contiguous()
    perm32, t_s = perm.int().contiguous(), t[perm].contiguous()
    threads = dispatch.registry()["spar_cost_fused"].default_block
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
    k_bytes = 4 * (N_MAIN * N_MAIN * 2 + 5 * s_main)
    k_ops = FUSED_OPS_PER_PAIR[problem.loss] * s_main * s_main
    bound_ms, bound_by = bound(k_bytes, k_ops)
    # the block sweep as the main path calls the kernel; a block of T
    # threads sums s/T + 5 + T/32 terms in sequence, at most 141 (T = 256)
    # against the 1029 that KERNEL_RTOL holds
    k2_tuned = autotune_row(
        torch, dispatch, K2_TUNE,
        lambda b: spar_cost.launch_fused(Cx, Cy, rows_s, cols_s, t_s, off,
                                         problem.loss, b, perm=perm32),
        k_ops, k_bytes, lambda b: check(
            torch, f"spar_cost_fused main shape, {b} threads",
            spar_cost.launch_fused(Cx, Cy, rows_s, cols_s, t_s, off,
                                   problem.loss, b, perm=perm32),
            want, scale))
    del want, scale
    kernels.append({
        "name": "spar_cost_fused", "route": "cuda",
        "source": "src/repro_torch/csrc/spar_cost_fused.cu",
        "replaces": "src/repro/kernels/spar_cost/spar_cost.py:79",
        "launches": launches["spar_cost_fused"],
        "launches_unbalanced": ugw_launches["spar_cost_fused"],
        "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None, "autotune": k2_tuned})
    other_shapes = [{**kernels[-1], "ms": unsorted_ms, "launches": None,
                     "autotune": None,
                     "max_abs_err": err_unsorted,
                     "shape": f"n={N_MAIN} s={s_main} {problem.loss}, "
                              f"support in sampled order"}]
    del Cx, Cy
    torch.cuda.empty_cache()

    # K7, the sparse Sinkhorn half-step, at the benchmark cells' shapes
    kernels.extend(k7_phase(torch, dev, k7_launches))
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
    k_bytes, k_ops = 4 * 4 * side * side, \
        FUSED_OPS_PER_PAIR[GRID_LOSS] * side ** 4
    bound_ms, bound_by = bound(k_bytes, k_ops)
    # the block sweep: fewer warps sum longer runs of p, so each block is
    # held to the bound of its own order (gw_cost_rtol)
    k3_splits = gw_cost.splits(side, side, side, dev)
    k3_tuned = autotune_row(
        torch, dispatch, K3_TUNE,
        lambda b: gw_cost.gw_cost_cuda(CxR, CyC, T_main, loss=GRID_LOSS,
                                       threads=b),
        k_ops, k_bytes, lambda b: check(
            torch, f"gw_cost main shape, {b} threads",
            gw_cost.gw_cost_cuda(CxR, CyC, T_main, loss=GRID_LOSS,
                                 threads=b),
            gw_cost.gw_cost_plain(CxR, CyC, T_main, GRID_LOSS),
            gw_ref.gw_cost_error_scale(CxR, CyC, T_main, GRID_LOSS),
            rtol=gw_cost_rtol(side, side, k3_splits, b)))
    k3_tuned["rtol_tuned"] = gw_cost_rtol(side, side, k3_splits,
                                          k3_tuned["best_block"])
    kernels.append({
        "name": "gw_cost", "route": "cuda",
        "source": "src/repro_torch/csrc/gw_cost.cu",
        "replaces": "src/repro/kernels/gw_cost/gw_cost.py:58",
        "launches": grid_launches["gw_cost"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None, "autotune": k3_tuned})

    # the main path under the tuned blocks: phase 4's two spar solves and
    # phase 5's grid solve, each against its value there
    tuned_solves = {}
    for name, run, (v_then, wall_then), kmod, kname in (
            ("auto", lambda: repro_torch.solve(
                problem, generator=torch.Generator(dev).manual_seed(0)),
             spar_main["auto"], spar_cost, "spar_matvec"),
            ("pallas", lambda: repro_torch.solve(
                problem, forced, support=support),
             spar_main["pallas"], spar_cost, "spar_cost_fused"),
            ("grid", lambda: repro_torch.solve(
                grid_problem, grid_solver, support=grid_support),
             (v_grid, wall_grid), gw_cost, "gw_cost")):
        before = kmod.LAUNCHES[kname]
        t0 = time.perf_counter()
        out = run()
        v = float(out.value)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = kmod.LAUNCHES[kname] - before
        if launched <= 0 or abs(v - v_then) > IMPL_VALUE_RTOL * abs(v_then):
            raise AssertionError(f"tuned {name} solve: {v} vs {v_then}, "
                                 f"{kname} launched {launched} times")
        tuned_solves[name] = {"value": v, "value_default_blocks": v_then,
                              "wall_s": wall, "wall_s_default_blocks":
                              wall_then, kname: launched}
        if name == "auto":
            tuned_solves[name]["bitwise"] = v == v_then and torch.equal(
                out.coupling.vals, out_auto.coupling.vals)
        del out
    records = dispatch.dump_autotune_records()
    dispatch.clear_autotune_cache()
    for family, *_ in (K1_TUNE, K2_TUNE, K3_TUNE):
        if dispatch.block_size(family) != \
                dispatch.registry()[family].default_block:
            raise AssertionError(f"{family}: the autotune cache survived")
    print(json.dumps({"tuned_solves": tuned_solves,
                      "autotune_records": str(records.relative_to(ROOT)),
                      "blocks_after_clear": {
                          f: dispatch.block_size(f) for f, *_ in (
                              K1_TUNE, K2_TUNE, K3_TUNE)}}))
    torch.cuda.empty_cache()

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
    # path, llama3-8b's attention shape; then phase 7c's: llama4-scout's
    # (a group of 5) and musicgen-medium's (hd 64); bf16, B = 1, S = 4096
    import torch.nn.functional as F
    k5_arch_shapes = []
    for arch, H, K, hd in (("zamba2-7b", cfg.n_heads, cfg.n_kv_heads,
                            cfg.resolved_head_dim), ("llama3-8b", 32, 8, 128),
                           ("llama4-scout-17b-a16e", 40, 8, 128),
                           ("musicgen-medium", 24, 24, 64)):
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
               "launches_train": train_launches["flash_attention"],
               "launches_mesh": mesh_launches["flash_attention"],
               "launches_archs": arch_out["launches"],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms}
        shape = f"{arch} B=1 S={S} H={H} K={K} hd={hd} bf16"
        if arch == "zamba2-7b":
            kernels.append(row)
            k5_row = row
        elif arch == "llama3-8b":
            other_shapes.append({**row, "shape": shape, "launches": None})
        else:
            k5_arch_shapes.append({
                "shape": shape, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms})
        del q, k, v
    k5_row["arch_shapes"] = k5_arch_shapes

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
        "launches": lm_launches["ssd_intra"],
        "launches_train_grad": train_launches["ssd_intra"],
        "launches_split_proj": mesh_launches["ssd_intra"],
        "max_abs_err": err, "ms": ms,
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
    # one full-depth bf16 decode step of phase 7b's generate (B = 4), after
    # a warm-up step on the same cache
    dec_cache = model.init_cache(DECODE_BATCH, DECODE_PROMPT + DECODE_NEW,
                                 device=dev)
    dec_tok = torch.zeros((DECODE_BATCH, 1), dtype=torch.int64, device=dev)

    def decode_one():
        return model.decode_step(params, dec_tok, dec_cache,
                                 DECODE_PROMPT)[0].sum().item()

    decode_one()
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
            params, tokens, use_flash=True)[0].sum().item(), top=12),
        "zamba2_decode_step": profile_solve(torch, decode_one, top=12),
        # taken in phase 7c, while its weights were on the card
        "llama4_scout_prefill": arch_out["llama4_prefill_profile"]}}))
    print(json.dumps({"arch_walls_s": arch_out["walls_s"]}))

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
