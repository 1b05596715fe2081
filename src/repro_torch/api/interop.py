"""Carry state between the JAX reference and the port, through numpy.

For GW the state that both sides must share is the problem's data (cost
matrices and marginals), the solver's fields, and the sampled support
(JAX's threefry draws cannot be reproduced with a torch generator). The
reference side hands these over as numpy arrays and a plain dict of the
solver's fields; the port's output comes back as numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.geometry import Geometry
from repro_torch.api.output import GridCoupling, GWOutput
from repro_torch.api.problem import QuadraticProblem
from repro_torch.api.solvers import get_solver


def to_problem(Cx, a, Cy, b, loss: str = "l2", device="cpu"
               ) -> QuadraticProblem:
    """A balanced problem on ``device`` from numpy costs and marginals."""
    gx = Geometry(np.asarray(Cx, np.float32), np.asarray(a, np.float32))
    gy = Geometry(np.asarray(Cy, np.float32), np.asarray(b, np.float32))
    return QuadraticProblem(gx, gy, loss=loss).to(torch.device(device))


def to_solver(fields: dict, name: str = "spar_gw"):
    """The port's config of solver ``name`` (``"spar_gw"``, ``"grid_gw"``)
    from the reference's field values."""
    return get_solver(name)(**fields)


def to_support(rows, cols, device="cpu"):
    """The reference's sampled support (COO pairs, or the grid's row and
    col sets) as int64 index tensors."""
    return (torch.tensor(np.asarray(rows), dtype=torch.int64, device=device),
            torch.tensor(np.asarray(cols), dtype=torch.int64, device=device))


def output_to_numpy(out: GWOutput) -> dict:
    """The port's output as numpy arrays and Python numbers: the coupling
    as ``rows``, ``cols`` and ``vals`` (COO) or ``block`` (grid)."""
    st = out.status
    c = out.coupling
    key = "block" if isinstance(c, GridCoupling) else "vals"
    return {
        "value": float(out.value),
        "rows": c.rows.cpu().numpy(),
        "cols": c.cols.cpu().numpy(),
        key: c[2].cpu().numpy(),
        "errors": out.errors.cpu().numpy(),
        "converged": bool(out.converged),
        "n_iters": int(out.n_iters),
        "status": {"code": st.code, "fail_iter": st.fail_iter,
                   "last_err": st.last_err, "n_rescues": st.n_rescues},
    }
