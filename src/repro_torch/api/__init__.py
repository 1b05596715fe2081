"""Problem/Solver/Output API of the port (counterpart of repro.api)."""
from repro_torch.api.geometry import Geometry
from repro_torch.api.output import (
    GridCoupling,
    GWOutput,
    LowRankCoupling,
    SparseCoupling,
)
from repro_torch.api.problem import QuadraticProblem
from repro_torch.api.solve import select_solver, solve
from repro_torch.api.solvers import (
    DenseGWSolver,
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

# registers "lowrank_gw"; lowrank.solver imports api.solvers, so it comes last
from repro_torch.lowrank.solver import LowRankGWSolver  # noqa: E402
