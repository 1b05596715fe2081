"""Call-time device resolution, block sizing and memory budgets.

The PyTorch counterpart of ``repro.kernels.dispatch``. Two rules carry
over:

1. **Nothing is decided at import.** :func:`resolve_device` picks the
   device when an entry point is called: the caller's ``device`` if given,
   else the CUDA card. With no card and no explicit device it raises; it
   never falls back to the CPU silently.
2. **One knob surface.** Block sizes resolve as explicit argument >
   ``REPRO_BLOCK_<FAMILY>`` env var > registry default, and the memory
   budget comes from one place.

The reference's ``vmem_budget`` has no counterpart: no kernel here reads
an on-chip budget (K4 picks its route from the card's own numbers,
``kernels/sinkhorn/sinkhorn.sinkhorn_route``). Its padding helpers and
autotune cache are not ported: no kernel here pads (K1-K6 mask their
ragged edges) and no caller tunes a block size.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on, resolved now (not at import).

    ``device`` wins when given (``"cpu"`` runs the plain PyTorch versions
    of the kernels). Otherwise the port runs on the CUDA card and raises
    if there is none.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return torch.device("cuda")


def refuse_grad(kernel: str, *inputs) -> None:
    """Raise if autograd would have to differentiate through ``kernel``.

    The reference's Pallas kernels have no reverse-mode rule (``jax.grad``
    through them raises, in interpret mode too), and neither have their
    CUDA counterparts here: with grad enabled and any tensor among
    ``inputs`` requiring grad, this raises a ``RuntimeError`` that names
    the kernel instead of returning an output with no gradient. It looks
    at the inputs, not the device, so the plain version on the CPU
    refuses as the kernel does.
    """
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in inputs):
        raise RuntimeError(
            f"{kernel} has no backward: the reference's Pallas kernel "
            f"refuses reverse mode, and so does its port. Differentiate "
            f"through another impl (spar_gw: cost_impl='materialized' or "
            f"'jnp'; grid_gw: use_kernel=False), or call it under "
            f"torch.no_grad()")


def _env_bytes(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if not raw:
        return default
    return int(float(raw))


def materialize_budget() -> int:
    """Device-memory budget for materializing the (s, s) spar_cost loss matrix.

    16 GiB, a fifth of an 80 GB H100. It admits the main path's support
    (n = 2048, s = 16n = 32768: a 4 GiB matrix, built in one gather with a
    12 GiB transient) and leaves most of the card to the caller. Above it
    ``"auto"`` takes the gather-fused kernel, which needs no (s, s) storage.
    """
    return _env_bytes("REPRO_SPAR_MATERIALIZE_BUDGET", 16 * 2**30)


@dataclass
class KernelFamily:
    name: str
    default_block: int
    description: str = ""


_REGISTRY: dict[str, KernelFamily] = {}


def register(name: str, default_block: int,
             description: str = "") -> KernelFamily:
    """Register (or re-register, idempotently) a kernel family."""
    fam = KernelFamily(name, default_block, description)
    _REGISTRY[name] = fam
    return fam


def block_size(family: str, override: Optional[int] = None,
               cap: Optional[int] = None) -> int:
    """Resolve the block size for a kernel family.

    Priority: ``override`` arg > ``REPRO_BLOCK_<FAMILY>`` env > registry
    default (128 for an unregistered family). ``cap`` clamps from above
    while keeping the result >= 1.
    """
    bs = override
    if bs is None:
        env = os.environ.get(f"REPRO_BLOCK_{family.upper()}")
        if env:
            bs = int(env)
    if bs is None:
        fam = _REGISTRY.get(family)
        bs = fam.default_block if fam is not None else 128
    if cap is not None:
        bs = min(bs, cap)
    return max(int(bs), 1)
