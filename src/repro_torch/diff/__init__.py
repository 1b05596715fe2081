"""``repro_torch.diff``: differentiation of GW solves (counterpart of
``repro.diff``).

Makes ``repro_torch.solve(...).value`` a trainable loss: the loop driver
runs the outer loop without autograd and solvers recompute their value
from live data (the Danskin envelope, fixed_point.py), so a backward
pass through a solve costs one cost-gradient contraction instead of
unrolling the loop. On top of that sit

* :func:`~repro_torch.diff.losses.gw_loss` /
  :func:`~repro_torch.diff.losses.fgw_loss` /
  :func:`~repro_torch.diff.losses.quadratic_loss` — scalar losses;
* :func:`~repro_torch.diff.barycenter.gw_barycenter` — free-support GW
  barycenters by AdamW descent on the support;
* :func:`~repro_torch.diff.unrolled.unrolled_value` — the unrolled
  reference (the correctness and cost baseline, not the product).

``fixed_point`` is imported eagerly (``api/driver`` needs it at import
time); the other layers load lazily to keep the driver → diff → losses
→ api.solve import cycle open.
"""
from __future__ import annotations

from repro_torch.diff.fixed_point import envelope_loop, locally_constant

__all__ = [
    "envelope_loop",
    "locally_constant",
    "gw_loss",
    "fgw_loss",
    "quadratic_loss",
    "gw_barycenter",
    "BarycenterResult",
    "unrolled_value",
]

_LAZY = {
    "gw_loss": "repro_torch.diff.losses",
    "fgw_loss": "repro_torch.diff.losses",
    "quadratic_loss": "repro_torch.diff.losses",
    "gw_barycenter": "repro_torch.diff.barycenter",
    "BarycenterResult": "repro_torch.diff.barycenter",
    "unrolled_value": "repro_torch.diff.unrolled",
}


def __getattr__(name):  # PEP 562
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'repro_torch.diff' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
