"""Public wrapper of the SSD intra-chunk block.

The counterpart of ``repro.kernels.ssd.ops.ssd_intra``. Inputs of any
float dtype are computed in float32, as the reference's kernel casts them;
the output is float32. The kernel has no head-tile knob (14 heads a
block).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.ssd.ssd import ssd_intra_cuda


def ssd_intra(xdt, cs, Bm, Cm, device=None):
    """xdt: (G, k, H, P), cs: (G, k, H), Bm/Cm: (G, k, N) -> (G, k, H, P),
    on ``device`` (the card unless given; the CPU runs the kernel's plain
    version). DTensor inputs (the mesh path) run on each rank's shards,
    split over the chunk rows and heads (``dispatch.on_local_shards``)."""
    dev = dispatch.resolve_device(device)
    args = tuple(t.to(device=dev, dtype=torch.float32)
                 for t in (xdt, cs, Bm, Cm))
    return dispatch.on_local_shards(
        _ssd_intra, args, (("batch", None, "heads", None),
                           ("batch", None, "heads"), ("batch", None, None),
                           ("batch", None, None)),
        ("batch", None, "heads", None))


def _ssd_intra(xdt, cs, Bm, Cm):
    return ssd_intra_cuda(*(t.contiguous() for t in (xdt, cs, Bm, Cm)))
