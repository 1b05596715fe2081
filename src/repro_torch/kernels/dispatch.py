"""Call-time device resolution, block sizing, padding and micro-autotune.

The PyTorch counterpart of ``repro.kernels.dispatch``. Two rules carry
over:

1. **Nothing is decided at import.** :func:`resolve_device` picks the
   device when an entry point is called: the caller's ``device`` if given,
   else the CUDA card. With no card and no explicit device it raises; it
   never falls back to the CPU silently. :func:`backend` is resolved at
   call time too.
2. **One knob surface.** Block sizes resolve as explicit argument >
   ``REPRO_BLOCK_<FAMILY>`` env var > autotune cache > registry default,
   and the memory budget comes from one place.

The reference's ``interpret_mode`` and ``vmem_budget`` have no
counterpart: nothing here is interpreted, and no kernel reads an on-chip
budget (K4 picks its route from the card's own numbers,
``kernels/sinkhorn/sinkhorn.sinkhorn_route``). The padding helpers are
ported with the reference's contract, but no kernel here calls them:
K1-K6 mask their ragged edges.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Optional

import torch
import torch.nn.functional as F

from repro_torch.obs.registry import registry as _obs_registry


def backend() -> str:
    """The platform the port runs on, resolved now (not at import):
    ``"cuda"`` when a card is available, else ``"cpu"``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


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


def registry() -> dict[str, KernelFamily]:
    """A copy of the kernel family table."""
    return dict(_REGISTRY)


def block_size(family: str, override: Optional[int] = None,
               cap: Optional[int] = None) -> int:
    """Resolve the block size for a kernel family.

    Priority: ``override`` arg > ``REPRO_BLOCK_<FAMILY>`` env > autotune
    cache (filled by :func:`autotune`) > registry default (128 for an
    unregistered family). ``cap`` clamps from above while keeping the
    result >= 1.

    Each call adds one to ``repro_kernel_block_resolutions_total`` with the
    family and the winning source (``override``, ``env``, ``autotune`` or
    ``default``). The port is eager, so it counts every resolution; the
    reference resolves under ``jit`` and counts traces.
    """
    bs, source = override, "override"
    if bs is None:
        env = os.environ.get(f"REPRO_BLOCK_{family.upper()}")
        if env:
            bs, source = int(env), "env"
    if bs is None:
        bs, source = _AUTOTUNE_CACHE.get(family), "autotune"
    if bs is None:
        fam = _REGISTRY.get(family)
        bs = fam.default_block if fam is not None else 128
        source = "default"
    _obs_registry().counter(
        "repro_kernel_block_resolutions_total",
        "block_size() resolutions by family and winning source",
        family=family, source=source).inc()
    if cap is not None:
        bs = min(bs, cap)
    return max(int(bs), 1)


def pad_to_multiple(x, mults):
    """Zero-pad each dim of ``x`` up to a multiple of ``mults[i]``.

    Returns ``(padded, original_shape)``; ``x`` itself (no copy) when
    already aligned. Slice back with :func:`unpad`. No kernel of the port
    pads: K1-K6 mask their ragged edges.
    """
    pads = [(-x.shape[i]) % mults[i] for i in range(x.ndim)]
    if any(pads):
        # F.pad lists (before, after) from the last dim to the first
        return F.pad(x, [w for p in reversed(pads) for w in (0, p)]), x.shape
    return x, x.shape


def pad_dim(x, mult: int, axis: int = 0, value=0):
    """Pad one axis of ``x`` up to a multiple of ``mult`` with ``value``;
    ``x`` itself when already aligned."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - axis % x.ndim) + 1] = pad
    return F.pad(x, widths, value=value)


def unpad(x, shape):
    """Slice ``x`` back to ``shape`` (inverse of :func:`pad_to_multiple`)."""
    if tuple(x.shape) == tuple(shape):
        return x
    return x[tuple(slice(0, d) for d in shape)]


_AUTOTUNE_CACHE: dict[str, int] = {}
_AUTOTUNE_RECORDS: list[dict] = []


def _tensors(out):
    """The tensors in ``out``: a tensor, or a tuple, list or dict of them."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list, dict)):
        for o in (out.values() if isinstance(out, dict) else out):
            yield from _tensors(o)


def _synchronize(out) -> None:
    """Wait for the card to finish the work behind ``out``:
    ``torch.cuda.synchronize()`` on the device of its first CUDA tensor;
    nothing on the CPU."""
    dev = next((t.device for t in _tensors(out) if t.is_cuda), None)
    if dev is not None:
        torch.cuda.synchronize(dev)


def autotune(family: str, candidates: Iterable[int],
             bench_fn: Callable[[int], object], reps: int = 3,
             flops_per_call: Optional[float] = None,
             bytes_per_call: Optional[float] = None) -> Optional[int]:
    """Time ``bench_fn(block)`` over candidate block sizes; cache the best.

    Each candidate gets one warm call (it builds the kernel), then the
    host clock over ``reps`` calls, each waited for with
    ``torch.cuda.synchronize()`` on its result's device (nothing on the
    CPU). The winner feeds later :func:`block_size` resolutions for
    ``family`` (below any explicit or env override) and its record is
    appended to :func:`autotune_records`.

    One departure from the reference, which skips a candidate that raises
    anything: here only a ``ValueError`` from the warm call, the kernel's
    own argument check refusing the block (``spar_cost.check_threads``,
    ``gw_cost_cuda``'s ``THREADS``), skips it. Any other error is raised:
    a sweep must not hide a kernel that does not build or launch. With no
    candidate left it returns ``None`` and leaves the cache as it was.

    ``flops_per_call`` / ``bytes_per_call`` (analytic counts for one
    ``bench_fn`` call) turn the winner's time into achieved GFLOP/s and
    GB/s, recorded and exported as ``repro_autotune_*`` gauges.
    """
    timings: dict[int, float] = {}
    for cand in candidates:
        try:
            _synchronize(bench_fn(cand))                # build + warm
        except ValueError:
            continue                      # the kernel refuses this block
        t0 = time.perf_counter()
        for _ in range(reps):
            _synchronize(bench_fn(cand))
        timings[int(cand)] = (time.perf_counter() - t0) / reps
    if not timings:
        return None
    best = min(timings, key=timings.get)
    best_s = timings[best]
    _AUTOTUNE_CACHE[family] = best
    on = backend()
    record = {"family": family, "backend": on, "best_block": best,
              "timings_s": {str(k): v for k, v in timings.items()}}
    reg = _obs_registry()
    reg.gauge("repro_autotune_best_block", "autotune-selected block size",
              family=family, backend=on).set(best)
    reg.gauge("repro_autotune_best_time_seconds",
              "best per-call time of the autotune winner",
              family=family, backend=on).set(best_s)
    if flops_per_call is not None and best_s > 0:
        record["gflops"] = flops_per_call / best_s / 1e9
        reg.gauge("repro_autotune_gflops",
                  "achieved GFLOP/s of the autotune winner (roofline y)",
                  family=family, backend=on).set(record["gflops"])
    if bytes_per_call is not None and best_s > 0:
        record["gbytes_per_s"] = bytes_per_call / best_s / 1e9
        reg.gauge("repro_autotune_gbytes_per_s",
                  "achieved GB/s of the autotune winner",
                  family=family, backend=on).set(record["gbytes_per_s"])
    _AUTOTUNE_RECORDS.append(record)
    return best


def autotune_records() -> list[dict]:
    return list(_AUTOTUNE_RECORDS)


def autotune_artifact_dir() -> Path:
    """``<repo>/artifacts/autotune``, where the records are dumped."""
    return Path(__file__).resolve().parents[3] / "artifacts" / "autotune"


def dump_autotune_records(path: Optional[os.PathLike] = None
                          ) -> Optional[Path]:
    """Write this process's autotune records as JSON; ``None`` if there
    are none. By default to ``torch-<backend>.json`` in
    :func:`autotune_artifact_dir`, beside the reference's files."""
    if not _AUTOTUNE_RECORDS:
        return None
    if path is None:
        path = autotune_artifact_dir() / f"torch-{backend()}.json"
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(_AUTOTUNE_RECORDS, f, indent=1)
    return path


def clear_autotune_cache() -> None:
    """Forget every autotune winner and record."""
    _AUTOTUNE_CACHE.clear()
    _AUTOTUNE_RECORDS.clear()


def on_local_shards(fn, args, roles, out_roles):
    """``fn(*args)`` on each rank's shards where ``args`` are DTensors
    (the mesh path): ``fn(*args)`` itself otherwise.

    A kernel takes plain tensors, and the SSD is independent per batch
    row and per head (attention too, :func:`gqa_on_local_shards`); so a
    kernel entry point runs on the local shards of its inputs, never on a
    gathered full tensor.
    ``roles[i]`` names the role of each dim of ``args[i]`` (e.g.
    ``("batch", None, "heads", None)``), ``out_roles`` those of the
    output's. On each mesh dim the first argument's split is kept where it
    falls on a role that every argument having it divides evenly;
    elsewhere the inputs are redistributed to replicated (a ``Partial``
    input is reduced). The output is a DTensor with the kept splits.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    anchor = next(a for a in args if isinstance(a, DTensor))
    mesh = anchor.device_mesh
    args = [a if isinstance(a, DTensor) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False) for a in args]
    kept = []                          # per mesh dim: a role or None
    for i, pl in enumerate(args[0].placements):
        role = roles[0][pl.dim] if isinstance(pl, Shard) else None
        if role is not None and all(
                a.shape[r.index(role)] % mesh.size(i) == 0
                for a, r in zip(args, roles) if role in r) and \
                role not in kept:
            kept.append(role)
        else:
            kept.append(None)

    def placements(r):
        return [Shard(r.index(k)) if k is not None and k in r
                else Replicate() for k in kept]

    local = [a.redistribute(mesh, placements(r)).to_local()
             for a, r in zip(args, roles)]
    out = fn(*local)
    return DTensor.from_local(out, mesh, placements(out_roles),
                              run_check=False)


def gqa_on_local_shards(fn, q, k, v):
    """``fn(q, k, v)`` for causal GQA attention, q (B, S, H, hd) and k, v
    (B, S, K, hd), on each rank's shards where they are DTensors;
    ``fn(q, k, v)`` itself otherwise. ``fn`` reads the group size from
    its inputs' shapes (q head h reads kv head h // (H / K)).

    As :func:`on_local_shards` with the roles (batch, -, heads, -), except
    that q keeps a head split that its own H divides even where the kv
    heads do not split as far (llama3-8b's 8 kv heads on 16 'model'
    ranks). Then k and v are gathered over that mesh dim and each rank
    takes the kv heads its own q heads read: one head read by all of them
    (G a multiple of the rank's q heads), else one kv head per q head. So
    ``fn`` runs on the rank's q heads only, never on all H. The gradient
    of the gathered k and v is each rank's part of the sum, a ``Partial``
    reduced over the mesh dim on the way back.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not any(isinstance(a, DTensor) for a in (q, k, v)):
        return fn(q, k, v)
    mesh = next(a for a in (q, k, v) if isinstance(a, DTensor)).device_mesh
    q, k, v = (a if isinstance(a, DTensor) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for a in (q, k, v))
    B, _, H, _ = q.shape
    K = k.shape[2]
    G = H // K
    roles = ("batch", None, "heads", None)
    kept = []                          # per mesh dim: a role or None
    for i, pl in enumerate(q.placements):
        role = roles[pl.dim] if isinstance(pl, Shard) else None
        size = {"batch": B, "heads": H}.get(role, 1)
        kept.append(role if role is not None and role not in kept
                    and size % mesh.size(i) == 0 else None)
    q_pl = [Shard(roles.index(r)) if r else Replicate() for r in kept]
    i_h = kept.index("heads") if "heads" in kept else None
    if i_h is None or K % mesh.size(i_h) == 0:
        kv_pl = grad_pl = q_pl
    else:
        kv_pl = [Replicate() if i == i_h else p for i, p in enumerate(q_pl)]
        grad_pl = [Partial() if i == i_h else p for i, p in enumerate(q_pl)]
    ql = q.redistribute(mesh, q_pl).to_local()
    kl, vl = (a.redistribute(mesh, kv_pl).to_local(grad_placements=grad_pl)
              for a in (k, v))
    if kv_pl is not q_pl:
        Hl = H // mesh.size(i_h)
        h0 = mesh.get_local_rank(i_h) * Hl
        if G % Hl == 0:
            kl, vl = (a[:, :, h0 // G:h0 // G + 1] for a in (kl, vl))
        else:
            idx = torch.arange(h0, h0 + Hl, device=kl.device) // G
            kl, vl = (a.index_select(2, idx) for a in (kl, vl))
    return DTensor.from_local(fn(ql, kl, vl), mesh, q_pl, run_check=False)
