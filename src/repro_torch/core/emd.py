"""Exact OT via linear programming (scipy HiGHS) and the EMD-GW baseline.

Counterpart of ``repro.core.emd``. The paper's EMD-GW replaces Sinkhorn
with an exact OT solve in each outer iteration. The LP has O(mn)
variables, so it serves at small n only (it is the slowest baseline in
the paper as well). numpy/scipy on the host, as in the reference.

The reference hands its float64 plan to ``dense_cost`` through
``jnp.asarray`` with x64 off, so its cost is a float32 computation and
only the LP runs in float64. The port does the same: the float32
``dense_cost`` on the problem's device, then the LP in float64 on the
host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gw import dense_cost, gw_objective
from repro_torch.kernels import dispatch


def exact_ot(a: np.ndarray, b: np.ndarray, M: np.ndarray) -> np.ndarray:
    """min <M, T> s.t. T 1 = a, Tᵀ 1 = b, T ≥ 0 (one redundant row dropped)."""
    from scipy.optimize import linprog
    from scipy.sparse import csr_matrix

    m, n = M.shape
    rows = []
    cols = []
    for i in range(m):
        rows.append(np.full(n, i))
        cols.append(np.arange(i * n, (i + 1) * n))
    for j in range(n - 1):
        rows.append(np.full(m, m + j))
        cols.append(np.arange(j, m * n, n))
    A = csr_matrix(
        (np.ones(sum(len(r) for r in rows)),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(m + n - 1, m * n),
    )
    rhs = np.concatenate([a, b[:-1]])
    res = linprog(M.reshape(-1), A_eq=A, b_eq=rhs, bounds=(0, None),
                  method="highs")
    if not res.success:
        raise RuntimeError(f"exact OT LP failed: {res.message}")
    return res.x.reshape(m, n)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def emd_gw(a, b, Cx, Cy, loss: str = "l2", outer_iters: int = 20,
           device=None):
    """EMD-GW: Algorithm 1 with the Sinkhorn projection replaced by exact
    OT. Each cost is float32 on ``device`` (the card unless given), each
    LP float64 on the host. Returns (value, T) with T a float64 array."""
    dev = dispatch.resolve_device(device)

    def f32(x):
        return torch.as_tensor(_host(x), dtype=torch.float32, device=dev)

    Cx_d, Cy_d = f32(Cx), f32(Cy)
    a = _host(a).astype(np.float64)
    b = _host(b).astype(np.float64)
    T = a[:, None] * b[None, :]
    for _ in range(outer_iters):
        C = dense_cost(Cx_d, Cy_d, f32(T), loss).cpu().numpy()
        T_new = exact_ot(a, b, C)
        if np.abs(T_new - T).sum() < 1e-12:
            T = T_new
            break
        T = T_new
    val = float(gw_objective(Cx_d, Cy_d, f32(T), loss))
    return val, T
