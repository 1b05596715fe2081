"""Distributed Grid-SPAR-GW over ``torch.distributed``.

Counterpart of ``repro.core.sharded_gw``, which runs under ``shard_map``
on a (data, model) device mesh. Here the mesh is logical: the ranks of the
default process group are laid out row-major on a (data, model) grid, and
each axis gets a family of subgroups (:class:`ProcessMesh`). The O(s²)
phase (cost assembly and Sinkhorn on the s_r x s_c grid block) shards as

  CxR (s_r, s_r): rows over 'data'            P('data', None)
  CyC (s_c, s_c): rows over 'model'           P('model', None)
  T   (s_r, s_c): 2-D block-sharded           P('data', 'model')

The collectives stand for the reference's one for one:
``all_gather_into_tensor`` for ``lax.all_gather(tiled=True)`` and
``all_reduce`` with SUM or MAX for ``psum`` and ``pmax``. The per-rank
code is that of the reference's ``solver`` closure. The reference's
unused helper ``_local_grid_cost_decomposable`` has no counterpart.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import ground_cost as gc
from repro_torch.core.utils import flush_subnormal, log_floor

AXES = ("data", "model")


class ProcessMesh:
    """A (data, model) layout of the default process group's ranks.

    Rank r sits at (r // model, r % model). Along each axis the ranks that
    share the other coordinate form a subgroup (``dist.new_group``; every
    rank creates every group, in one order, as ``new_group`` requires).
    """

    def __init__(self, data: int, model: int):
        world = dist.get_world_size()
        if data * model != world:
            raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                             f"ranks, the process group has {world}")
        self.shape = {"data": data, "model": model}
        rank = dist.get_rank()
        self.coords = {"data": rank // model, "model": rank % model}
        rows = [dist.new_group([i * model + j for j in range(model)])
                for i in range(data)]
        cols = [dist.new_group([i * model + j for i in range(data)])
                for j in range(model)]
        # the group along an axis: the ranks that share the other coordinate
        self.groups = {"model": rows[self.coords["data"]],
                       "data": cols[self.coords["model"]]}


def make_sharded_grid_gw(mesh: ProcessMesh, s_r: int, s_c: int,
                         loss: str = "l2", epsilon: float = 1e-2,
                         outer_iters: int = 10, inner_iters: int = 30,
                         comm_dtype=None):
    """Returns fn(CxR, CyC, aR, bC, w) -> (gw_value, T_block).

    Every rank passes the whole inputs (on its device: the card's for
    NCCL, the CPU for gloo) and takes its own block; every rank gets the
    value and the whole (s_r, s_c) block back. Decomposable losses only
    (the ``l2`` production configuration).

    ``comm_dtype=torch.bfloat16`` ships the two large gathers (T's rows,
    and the partial product M) in bfloat16; they are upcast to float32 on
    arrival and the products run in float32. The reference's
    mixed-precision dot takes the other operand in the gathered dtype too,
    so the port rounds h2(CyC) and h1(CxR) to bfloat16 as well: both
    multiply the same rounded operands.
    """
    dec = gc.get_decomposition(loss)
    assert dec is not None, "sharded path implements decomposable costs"
    dp, mp = mesh.shape["data"], mesh.shape["model"]
    if s_r % dp or s_c % mp:
        raise ValueError(f"the block ({s_r}, {s_c}) does not split over a "
                         f"{dp} x {mp} mesh")
    rb, cb = s_r // dp, s_c // mp
    i, j = mesh.coords["data"], mesh.coords["model"]

    def psum(x, axis):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.groups[axis])
        return x

    def pmax(x, axis):
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.groups[axis])
        return x

    def gather(x, axis, dim=0, dtype=None):
        """Tiled all-gather along ``axis``, concatenated on ``dim``."""
        size = mesh.shape[axis]
        x = x if dtype is None else x.to(dtype)
        x = (x if dim == 0 else x.t()).contiguous()
        out = torch.empty((size * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=mesh.groups[axis])
        return out if dim == 0 else out.t()

    def comm_round(x):
        """An operand as the reference's mixed-precision dot takes it."""
        return x if comm_dtype is None else x.to(comm_dtype).float()

    def solver(CxR_l, CyC_l, aR_l, bC_l, w_l):
        f1x, f2y = dec.f1(CxR_l), dec.f2(CyC_l)
        h1x, h2y = comm_round(dec.h1(CxR_l)), comm_round(dec.h2(CyC_l))
        la_l, lb_l = log_floor(aR_l), log_floor(bC_l)

        def cost(T_l):
            # marginals (global): partial sums over the opposing axis
            mu = gather(psum(T_l.sum(dim=1), "model"), "data")     # (s_r,)
            nu = gather(psum(T_l.sum(dim=0), "data"), "model")     # (s_c,)
            t1 = (f1x @ mu)[:, None]                               # (rb, 1)
            t2 = (f2y @ nu)[None, :]                               # (1, cb)
            # ht = h1(CxR) @ T @ h2(CyC)ᵀ, block-sharded: T's full rows
            # gathered over 'model', then M's full rows over 'data'
            T_rows = gather(T_l, "model", 1, comm_dtype).float()   # (rb, s_c)
            M_l = T_rows @ h2y.t()                                 # (rb, cb)
            M_full = gather(M_l, "data", 0, comm_dtype).float()    # (s_r, cb)
            return t1 + t2 - h1x @ M_full

        def sinkhorn_log_block(logK_l):
            f_l = torch.zeros_like(aR_l)
            g_l = torch.zeros_like(bC_l)
            for _ in range(inner_iters):
                z = logK_l + g_l[None, :]
                m_l = pmax(torch.amax(z, dim=1), "model")
                sums = psum(torch.exp(z - m_l[:, None]).sum(dim=1), "model")
                f_l = la_l - (log_floor(sums) + m_l)
                z = logK_l + f_l[:, None]
                m_c = pmax(torch.amax(z, dim=0), "data")
                sums = psum(torch.exp(z - m_c[None, :]).sum(dim=0), "data")
                g_l = lb_l - (log_floor(sums) + m_c)
            return flush_subnormal(torch.exp(logK_l + f_l[:, None]
                                             + g_l[None, :]))

        T_l = flush_subnormal(aR_l[:, None] * bC_l[None, :])
        log_w = torch.log(w_l)
        for _ in range(outer_iters):
            logK_l = -cost(T_l) / epsilon + log_w + log_floor(T_l)
            T_l = sinkhorn_log_block(logK_l)
        val = psum(psum(torch.sum(cost(T_l) * T_l), "model"), "data")
        return val, T_l

    def fn(CxR, CyC, aR, bC, w):
        rows, cols = slice(i * rb, (i + 1) * rb), slice(j * cb, (j + 1) * cb)
        val, T_l = solver(CxR[rows].contiguous(), CyC[cols].contiguous(),
                          aR[rows].contiguous(), bC[cols].contiguous(),
                          w[rows, cols].contiguous())
        return val, gather(gather(T_l, "model", 1), "data", 0)

    return fn
