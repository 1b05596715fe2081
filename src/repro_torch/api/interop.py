"""Carry state between the JAX reference and the port, through numpy.

For GW the state that both sides must share is the problem's data (cost
matrices or point clouds, marginals, the fused linear term, λ), the
solver's fields, the random draws (the sampled support, the low-rank
solver's init and sketch inputs, the quantized solver's anchor draws:
JAX's threefry draws cannot be reproduced with a torch generator), and
an injected fault. The reference side hands these over as numpy arrays
and plain dicts of fields; the port's output comes back as numpy. A
parity hook for the tests, not a feature.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.geometry import Geometry
from repro_torch.api.output import (
    GridCoupling,
    GWOutput,
    LowRankCoupling,
    QuantizedCoupling,
)
from repro_torch.api.problem import QuadraticProblem
from repro_torch.api.solvers import get_solver
from repro_torch.health.faults import FaultSpec
from repro_torch.lowrank.init import LowRankDraws
from repro_torch.multiscale.solver import QuantizedDraws


def _f32(x):
    return None if x is None else np.asarray(x, np.float32)


def _geometry(C, w, points):
    if C is None:
        return Geometry.from_points(_f32(points), _f32(w))
    return Geometry(_f32(C), _f32(w), points=_f32(points))


def to_problem(Cx, a, Cy, b, loss: str = "l2", device="cpu", *, lam=None,
               M=None, fused_penalty=None, points_x=None, points_y=None
               ) -> QuadraticProblem:
    """A problem on ``device`` from numpy data: cost matrices ``Cx``, ``Cy``
    (None for a point cloud, given as ``points_x`` / ``points_y``),
    marginals, and the optional fused term (``M``, ``fused_penalty``) and
    unbalanced strength ``lam``."""
    problem = QuadraticProblem(_geometry(Cx, a, points_x),
                               _geometry(Cy, b, points_y), loss=loss,
                               fused_penalty=fused_penalty, M=_f32(M),
                               lam=None if lam is None else float(lam))
    return problem.to(torch.device(device))


def to_solver(fields: dict, name: str = "spar_gw"):
    """The port's config of solver ``name`` (``"spar_gw"``, ``"grid_gw"``,
    ``"dense_gw"``, ``"lowrank_gw"``, ``"quantized_gw"``) from the
    reference's field values. A ``fault`` given as a dict of fields goes
    through :func:`to_fault_spec`; a quantized solver's ``base`` given as
    ``(name, fields)`` through this function."""
    fields = dict(fields)
    if isinstance(fields.get("fault"), dict):
        fields["fault"] = to_fault_spec(**fields["fault"])
    if isinstance(fields.get("base"), tuple):
        fields["base"] = to_solver(fields["base"][1], fields["base"][0])
    return get_solver(name)(**fields)


def to_fault_spec(at_iter=-1, kind="nan", site="iterate",
                  persistent=False) -> FaultSpec:
    """The reference's ``FaultSpec`` fields as the port's FaultSpec."""
    return FaultSpec(at_iter=int(at_iter), kind=str(kind), site=str(site),
                     persistent=bool(persistent))


def to_support(rows, cols, device="cpu"):
    """The reference's sampled support (COO pairs, or the grid's row and
    col sets) as int64 index tensors."""
    return (torch.tensor(np.asarray(rows), dtype=torch.int64, device=device),
            torch.tensor(np.asarray(cols), dtype=torch.int64, device=device))


def to_lowrank_draws(device="cpu", **draws) -> LowRankDraws:
    """The reference's low-rank draws (``start_x``, ``start_y``,
    ``omega_x``, ``omega_y``, ``zq``, ``zr``; any subset) as tensors."""
    out = {}
    for name, value in draws.items():
        dtype = torch.int64 if name.startswith("start") else torch.float32
        out[name] = torch.tensor(np.asarray(value), dtype=dtype,
                                 device=device)
    return LowRankDraws(**out)


def to_quantized_draws(device="cpu", anchors_x=None, anchors_y=None,
                       base=None) -> QuantizedDraws:
    """The reference's quantized draws as tensors: each side's anchor draw
    (the FPS start, or the k random anchors) and the base solver's, a
    ``(rows, cols)`` support or a dict of low-rank draws."""
    def index(x):
        return None if x is None else torch.tensor(
            np.asarray(x), dtype=torch.int64, device=device)

    if isinstance(base, dict):
        base = to_lowrank_draws(device, **base)
    elif base is not None:
        base = to_support(*base, device=device)
    return QuantizedDraws(index(anchors_x), index(anchors_y), base)


def output_to_numpy(out: GWOutput) -> dict:
    """The port's output as numpy arrays and Python numbers. The coupling
    comes as ``rows``, ``cols`` and ``vals`` (COO), ``rows``, ``cols`` and
    ``block`` (grid), ``q``, ``r`` and ``g`` (low rank), the fields of a
    ``QuantizedCoupling`` or ``dense``."""
    st = out.status
    c = out.coupling
    if isinstance(c, QuantizedCoupling):
        coupling = c._asdict()
    elif isinstance(c, GridCoupling):
        coupling = {"rows": c.rows, "cols": c.cols, "block": c.block}
    elif isinstance(c, LowRankCoupling):
        coupling = {"q": c.q, "r": c.r, "g": c.g}
    elif isinstance(c, torch.Tensor):
        coupling = {"dense": c}
    else:
        coupling = {"rows": c.rows, "cols": c.cols, "vals": c.vals}
    return {
        "value": float(out.value),
        **{k: v.cpu().numpy() for k, v in coupling.items()},
        "errors": out.errors.cpu().numpy(),
        "converged": bool(out.converged),
        "n_iters": int(out.n_iters),
        "status": {"code": st.code, "fail_iter": st.fail_iter,
                   "last_err": st.last_err, "n_rescues": st.n_rescues},
    }
