"""Problem/Solver/Output API of the port (counterpart of repro.api)."""
from repro_torch.api.geometry import Geometry
from repro_torch.api.output import GridCoupling, GWOutput, SparseCoupling
from repro_torch.api.problem import QuadraticProblem
from repro_torch.api.solve import select_solver, solve
from repro_torch.api.solvers import (
    GridGWSolver,
    SparGWSolver,
    available_solvers,
    get_solver,
    register_solver,
)

__all__ = [
    "Geometry",
    "QuadraticProblem",
    "GWOutput",
    "SparseCoupling",
    "GridCoupling",
    "solve",
    "select_solver",
    "SparGWSolver",
    "GridGWSolver",
    "get_solver",
    "register_solver",
    "available_solvers",
]
