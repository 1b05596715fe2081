"""Importance-sparsified Gromov-Wasserstein distances in PyTorch, with
hand-written CUDA kernels for Hopper.

The port of the JAX package ``repro`` (which stays as the reference).
Build a :class:`QuadraticProblem` from two :class:`Geometry` objects and
call :func:`solve`; it runs on the CUDA card unless ``device="cpu"``.
:mod:`repro_torch.diff` makes a solve's value a trainable loss
(``diff.gw_loss``), :mod:`repro_torch.obs` holds its telemetry
(convergence traces, spans, the metrics registry).
"""
from repro_torch.api import (
    DenseGWSolver,
    Geometry,
    GridCoupling,
    GridGWSolver,
    GWOutput,
    LowRankCoupling,
    LowRankGWSolver,
    QuadraticProblem,
    QuantizedCoupling,
    QuantizedGWSolver,
    SparGWSolver,
    SparseCoupling,
    available_solvers,
    get_solver,
    register_solver,
    select_solver,
    solve,
)
from repro_torch import diff, obs, optim

__all__ = [
    "Geometry",
    "QuadraticProblem",
    "GWOutput",
    "SparseCoupling",
    "GridCoupling",
    "LowRankCoupling",
    "QuantizedCoupling",
    "solve",
    "select_solver",
    "SparGWSolver",
    "GridGWSolver",
    "DenseGWSolver",
    "LowRankGWSolver",
    "QuantizedGWSolver",
    "get_solver",
    "register_solver",
    "available_solvers",
    "diff",
    "obs",
    "optim",
]
