"""Public wrappers + impl dispatch for the COO spar_cost family.

Three interchangeable implementations of the affine contract
``fn(t, off) = L-matvec(t) + off``, under the reference's impl names:

- ``"jnp"``          — the plain row-chunked version (``ref.spar_cost_ref``);
                       gathers (chunk, s) support blocks every call.
- ``"pallas"``       — the gather-fused kernel (``spar_cost_cuda``); no
                       (s, s) storage. The closure sorts the support by
                       row once (:func:`sort_support`) and the kernel
                       scatters its outputs back. On CPU tensors, its
                       plain version on the same sorted support.
- ``"materialized"`` — the iteration-invariant loss matrix is built once
                       (O(s²) device memory, budget-gated) and every call
                       is the matvec kernel (``spar_matvec_cuda``). On CPU
                       tensors, ``Lmat @ t + off``.

``"auto"`` picks ``materialized`` while s²·4 bytes fit the budget, else
``pallas`` on CUDA tensors and ``jnp`` on CPU tensors. Nothing is padded:
the kernels mask their ragged edges themselves.

:func:`make_spar_cost_fn_lanes` is the same contract over the B lanes of
a server flush, ``fn(t (B, s), off) -> (B, s)``. The budget gate is per
lane, as the reference's ``vmap`` applies it: materialized lanes share
one (B, s, s) stack and one matvec launch a call; past the gate each
lane runs its own closure (the gather-fused kernel once per lane).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.spar_cost.ref import materialize_loss, spar_cost_ref
from repro_torch.kernels.spar_cost.spar_cost import (
    check_support_range,
    check_threads,
    launch_fused,
    spar_cost_cuda,
    spar_matvec_cuda,
)

dispatch.register("spar_cost", default_block=256,
                  description="COO cost assembly (SPAR-GW hot path); block "
                              "= CUDA threads per block of the matvec "
                              "kernel, one warp per row")
dispatch.register("spar_cost_fused", default_block=1024,
                  description="gather-fused COO cost; block = CUDA threads "
                              "per block (one block per SM holds its rows "
                              "in shared memory, so all 32 warps stream)")


def resolve_impl(impl: str, s: int, device) -> str:
    """Resolve ``"auto"`` to a concrete impl for a support of size s."""
    if impl != "auto":
        return impl
    if s * s * 4 <= dispatch.materialize_budget():
        return "materialized"
    return "pallas" if torch.device(device).type == "cuda" else "jnp"


def kernel_route(impl: str, s: int, device) -> str:
    """The kernel a cost closure of this impl launches: ``"K1"`` (the
    materialized matvec) or ``"K2"`` (the gather-fused kernel) on the card,
    ``"plain"`` where neither runs (``"jnp"``, or CPU tensors)."""
    if torch.device(device).type != "cuda":
        return "plain"
    return {"materialized": "K1", "pallas": "K2"}.get(
        resolve_impl(impl, s, device), "plain")


def _vec(x, s: int, device):
    """A scalar or (s,) offset as a contiguous (s,) float32 on ``device``."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x.expand(s).contiguous() if x.ndim == 0 else x.contiguous()


def sort_support(rows, cols):
    """The support ordered by row: ``(perm, rows[perm], cols[perm])`` with
    ``perm`` (int64) a stable argsort of ``rows``. Entry k of the sorted
    support is entry ``perm[k]`` of the original, so an output computed on
    it is scattered back with ``out[perm] = out_sorted``."""
    perm = torch.argsort(rows, stable=True)
    return perm, rows[perm], cols[perm]


def spar_cost_fused(Cx, Cy, rows, cols, t, off=0.0, loss: str = "l2",
                    block: Optional[int] = None):
    """One-shot gather-fused cost: L @ t + off on the COO support, (s,)."""
    s, dev = rows.shape[0], rows.device
    b = dispatch.block_size("spar_cost_fused", block)
    return spar_cost_cuda(Cx.float().contiguous(), Cy.float().contiguous(),
                          rows.int().contiguous(), cols.int().contiguous(),
                          _vec(t, s, dev), _vec(off, s, dev), loss=loss,
                          threads=b)


def spar_matvec(Lmat, t, off=0.0, block: Optional[int] = None):
    """One-shot materialized-support matvec: Lmat @ t + off, (s,)."""
    s, dev = Lmat.shape[0], Lmat.device
    b = dispatch.block_size("spar_cost", block)
    return spar_matvec_cuda(Lmat.float().contiguous(), _vec(t, s, dev),
                            _vec(off, s, dev), threads=b)


def make_spar_cost_fn(Cx, Cy, rows, cols, loss: str, impl: str = "auto",
                      chunk: int = 1024, block: Optional[int] = None
                      ) -> Callable[..., torch.Tensor]:
    """Build ``fn(t, off=0.0) -> (s,) f32`` computing L-matvec(t) + off.

    Per-support setup (impl resolution, index conversion, loss
    materialization) happens here, once; every outer iteration then pays
    only the fused kernel or the matvec.
    """
    s, dev = rows.shape[0], rows.device
    impl = resolve_impl(impl, s, dev)

    if impl == "jnp":
        def fn(t, off=0.0):
            return spar_cost_ref(Cx, Cy, rows, cols, t, loss, chunk) + off
        return fn

    if impl == "pallas":
        b = dispatch.block_size("spar_cost_fused", block)
        # once per support: the index range check (one host sync) and the
        # sort by row; every call then gathers t into the sorted order and
        # launches without a sync, the kernel scattering its outputs back
        Cxc, Cyc = Cx.float().contiguous(), Cy.float().contiguous()
        check_threads(b)
        check_support_range(rows, cols, Cxc.shape[0], Cyc.shape[0])
        perm, rows_s, cols_s = sort_support(rows, cols)
        rows_s, cols_s = rows_s.int().contiguous(), cols_s.int().contiguous()
        perm32 = perm.int().contiguous()

        def fn(t, off=0.0):
            t_s = _vec(t, s, dev).index_select(0, perm)
            return launch_fused(Cxc, Cyc, rows_s, cols_s, t_s,
                                _vec(off, s, dev), loss, b, perm=perm32)
        return fn

    if impl == "materialized":
        b = dispatch.block_size("spar_cost", block)
        # the gate bounds the resident s² matrix; the one-shot gather also
        # needs a ~3·s² transient (Gx, Gy, result), so past that build it
        # in row chunks with an O(chunk·s) transient
        direct_ok = 3 * s * s * 4 <= dispatch.materialize_budget()
        Lmat = materialize_loss(Cx, Cy, rows, cols, loss,
                                None if direct_ok else chunk).contiguous()

        def fn(t, off=0.0):
            return spar_matvec_cuda(Lmat, _vec(t, s, dev), _vec(off, s, dev),
                                    threads=b)
        return fn

    raise ValueError(f"unknown spar_cost impl: {impl!r}")


def _lanes_vec(x, B: int, s: int, device):
    """An offset that broadcasts to (B, s) (a scalar, (B, 1) or (B, s)) as
    a contiguous (B, s) float32."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x.expand(B, s).contiguous()


def materialize_lanes(Cxs, Cys, rows, cols, loss: str, chunk: int = 1024):
    """The (B, s, s) float32 loss matrices of B lanes (lane b from
    ``Cxs[b]``, ``Cys[b]`` and the support ``rows[b]``, ``cols[b]``).

    One buffer whose lane stride is s² rounded up to a multiple of 4
    floats: every lane's matrix is then 16-byte aligned, as a matrix of
    its own is, and the lanes launch sums each lane bitwise as a
    single-lane launch does. Each lane is built as the single-lane route
    builds it (one gather, or row chunks past a third of the budget).
    """
    B, s = rows.shape
    dev = rows.device
    stride = -(-s * s // 4) * 4
    Lmat = torch.empty(B * stride, dtype=torch.float32,
                       device=dev).as_strided((B, s, s), (stride, s, 1))
    direct_ok = 3 * s * s * 4 <= dispatch.materialize_budget()
    for b in range(B):
        materialize_loss(Cxs[b], Cys[b], rows[b], cols[b], loss,
                         None if direct_ok else chunk, out=Lmat[b])
    return Lmat


def make_spar_cost_fn_lanes(Cxs, Cys, rows, cols, loss: str,
                            impl: str = "auto", chunk: int = 1024,
                            block: Optional[int] = None
                            ) -> Callable[..., torch.Tensor]:
    """Build ``fn(t, off=0.0) -> (B, s) f32`` computing L-matvec(t) + off
    for B lanes: ``Cxs[b]`` (m, m) and ``Cys[b]`` (n, n) the lanes' costs,
    ``rows`` and ``cols`` (B, s) their supports, ``t`` and ``off`` (B, s)
    (``off`` may be a scalar).

    Materialized (``"auto"`` under the budget, per lane): one (B, s, s)
    stack, built once (:func:`materialize_lanes`), and one matvec launch
    over all lanes a call. Any other impl: each lane's own
    :func:`make_spar_cost_fn` closure, called lane by lane.
    """
    B, s = rows.shape
    dev = rows.device
    impl = resolve_impl(impl, s, dev)
    if impl == "materialized":
        b = dispatch.block_size("spar_cost", block)
        Lmat = materialize_lanes(Cxs, Cys, rows, cols, loss, chunk)

        def fn(t, off=0.0):
            return spar_matvec_cuda(Lmat, t.contiguous(),
                                    _lanes_vec(off, B, s, dev), threads=b)
        return fn

    fns = [make_spar_cost_fn(Cxs[k], Cys[k], rows[k], cols[k], loss,
                             impl=impl, chunk=chunk, block=block)
           for k in range(B)]

    def fn_lanes(t, off=0.0):
        offs = _lanes_vec(off, B, s, dev)
        return torch.stack([f(t[k], offs[k]) for k, f in enumerate(fns)])
    return fn_lanes
