"""Carry state between the JAX reference and the port, through numpy.

For GW the state that both sides must share is the problem's data (cost
matrices and marginals), the solver's fields, and the sampled support
(JAX's threefry draws cannot be reproduced with a torch generator). The
reference side hands these over as numpy arrays and a plain dict of
``SparGWSolver`` fields; the port's output comes back as numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.geometry import Geometry
from repro_torch.api.output import GWOutput
from repro_torch.api.problem import QuadraticProblem
from repro_torch.api.solvers import SparGWSolver


def to_problem(Cx, a, Cy, b, loss: str = "l2", device="cpu"
               ) -> QuadraticProblem:
    """A balanced problem on ``device`` from numpy costs and marginals."""
    gx = Geometry(np.asarray(Cx, np.float32), np.asarray(a, np.float32))
    gy = Geometry(np.asarray(Cy, np.float32), np.asarray(b, np.float32))
    return QuadraticProblem(gx, gy, loss=loss).to(torch.device(device))


def to_solver(fields: dict) -> SparGWSolver:
    """A port ``SparGWSolver`` from the reference's field values."""
    return SparGWSolver(**fields)


def to_support(rows, cols, device="cpu"):
    """The reference's sampled support as int64 index tensors."""
    return (torch.tensor(np.asarray(rows), dtype=torch.int64, device=device),
            torch.tensor(np.asarray(cols), dtype=torch.int64, device=device))


def output_to_numpy(out: GWOutput) -> dict:
    """The port's output as numpy arrays and Python numbers."""
    st = out.status
    return {
        "value": float(out.value),
        "rows": out.coupling.rows.cpu().numpy(),
        "cols": out.coupling.cols.cpu().numpy(),
        "vals": out.coupling.vals.cpu().numpy(),
        "errors": out.errors.cpu().numpy(),
        "converged": bool(out.converged),
        "n_iters": int(out.n_iters),
        "status": {"code": st.code, "fail_iter": st.fail_iter,
                   "last_err": st.last_err, "n_rescues": st.n_rescues},
    }
