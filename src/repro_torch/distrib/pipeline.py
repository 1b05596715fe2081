"""GPipe-style pipeline parallelism over a ``pipe`` group, the port of
``repro.distrib.pipeline``.

Each rank of the group is one stage and holds only its stage's
parameters; microbatches stream through with point-to-point handoffs
(the reference's ``ppermute(i -> i+1 mod n)``, here one
``dist.batch_isend_irecv`` a tick). The schedule is the standard GPipe
fill-drain: ``n_micro + n_stages - 1`` ticks. The last stage writes tick
t's output to slot ``t - (n_stages - 1)``; the outputs are then summed
over the group (the other stages contribute zeros), as the reference's
``psum`` broadcasts them.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def pipeline_forward(mesh, stage_fn, n_stages: int, n_micro: int):
    """Build a pipelined forward: x (n_micro, mb, ...) -> (n_micro, mb,
    ...) on every rank of ``mesh``'s ``pipe`` dim (a ``DeviceMesh`` with a
    dim named ``pipe`` of size ``n_stages``).

    ``pipelined(stage_params, x)`` takes this rank's stage's parameters
    (the reference's leading-axis slice ``stage_params[stage]``) and the
    microbatches (read on stage 0 only); ``stage_fn(params, x)`` applies
    one stage.
    """
    group = mesh.get_group("pipe")
    size = dist.get_world_size(group)
    if size != n_stages:
        raise ValueError(f"the pipe group has {size} ranks, not "
                         f"{n_stages} stages")
    stage = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prev = dist.get_global_rank(group, (stage - 1) % n_stages)

    def pipelined(stage_params, x):
        mb_shape = tuple(x.shape[1:])
        buf = torch.zeros(mb_shape, dtype=x.dtype, device=x.device)
        outputs = torch.zeros((n_micro,) + mb_shape, dtype=x.dtype,
                              device=x.device)
        for t in range(n_micro + n_stages - 1):
            # stage 0 injects microbatch t (while there is one)
            cur = x[t] if stage == 0 and t < n_micro else buf
            y = stage_fn(stage_params, cur)
            slot = t - (n_stages - 1)
            if stage == n_stages - 1 and slot >= 0:
                outputs[slot] = y
            if n_stages == 1:
                buf = y
                continue
            recv = torch.empty_like(y)
            ops = [dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                   dist.P2POp(dist.irecv, recv, prev, group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            buf = recv
        dist.all_reduce(outputs, op=dist.ReduceOp.SUM, group=group)
        return outputs

    return pipelined
