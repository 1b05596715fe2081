"""Importance-sparsified Gromov-Wasserstein distances in PyTorch, with
hand-written CUDA kernels for Hopper.

The port of the JAX package ``repro`` (which stays as the reference).
Build a :class:`QuadraticProblem` from two :class:`Geometry` objects and
call :func:`solve`; it runs on the CUDA card unless ``device="cpu"``.
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
    SparGWSolver,
    SparseCoupling,
    available_solvers,
    get_solver,
    register_solver,
    select_solver,
    solve,
)

__all__ = [
    "Geometry",
    "QuadraticProblem",
    "GWOutput",
    "SparseCoupling",
    "GridCoupling",
    "LowRankCoupling",
    "solve",
    "select_solver",
    "SparGWSolver",
    "GridGWSolver",
    "DenseGWSolver",
    "LowRankGWSolver",
    "get_solver",
    "register_solver",
    "available_solvers",
]
